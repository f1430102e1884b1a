"""Syndrome-gated adaptive BCC decoding: algebraic inverse + Viterbi fallback.

At working SNR most packets arrive with ZERO hard-decision errors in the
coded stream, and when the received hard bits form a valid codeword the
ML (Viterbi) output is exactly that codeword's data — so the decode
reduces to *inverting the encoder*, a GF(2) linear map.  The punctured
802.11 BCC (K=7, g0=133o/g1=171o, all four rates) is non-catastrophic
and keeps >= 1 coded bit per trellis step at every rate, so a CAUSAL
windowed FIR left inverse exists: each 240-data-bit block is recovered
from a 3-block window of the (zero-filled) depunctured hard bits by ONE
precomputed GF(2) matrix — a matmul, exact in any precision
(0/1 inputs, f32 accumulation).  Causality (asserted at matrix build:
data bit t uses depunctured coded positions <= 2t+1 only) means the
stencil is exact up to and including the LAST bit of any stream — no
separate tail system — and, crucially, that a per-row real length
``n_real`` inside a longer canonicalized trellis leaves every real bit
exact: positions >= 2*n_real never feed bits t < n_real.

A re-encode syndrome then counts hard errors per packet (restricted to
kept, within-``n_real`` positions):

* syndrome == 0 everywhere   -> the algebraic inverse IS the Viterbi
  output on the real region (codeword-prefix case) — no trellis sweep;
* 0 < n_fail <= tier         -> only failing rows are gathered into the
  smallest sufficient row tile (fallback, 4x, 16x fallback) and run
  through the Viterbi (``ops.viterbi_gpu``);
* n_fail > largest tier      -> the whole batch falls back to the full
  Viterbi sweep (exact at any SNR).

The branches are ``lax.cond`` at batch scope — one compiled program
serves every SNR, paying the ACS+traceback cost only when the channel
actually demands it.  The reference decoder (lib/decode_impl.cc, 93-250
ticks per LLR item) runs the full Viterbi unconditionally.

Matrix derivation (host, cached per code rate): Gaussian elimination
over GF(2) on a 5-block encoding window — the solution's support is
restricted to the 3 center coded blocks, so the same stencil is
position-independent and exact for every block including the first
(zero left padding = zero preceding data = zero encoder state) and the
last (causal support).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..spec import tables as T
from . import viterbi as VXLA
from . import viterbi_gpu as VG

#: data bits per interior block — divisible by every puncture period's
#: data count (1, 2, 3, 5) so one stencil matrix serves all block offsets.
#: SMALL blocks localize the inverse: one channel hard error corrupts the
#: candidate (and its re-encode mismatch) over at most the 3-block
#: stencil span, so KB=60 confines each error's dirty footprint to ~180
#: steps (~1-2 re-decode windows) where KB=240 smeared it over ~720
#: (measured: 24 dB dirty windows 18.9k -> with KB=60 the same batch
#: fits the windowed tier).  All four rates stay solvable and causal
#: down to KB=30 (asserted at matrix build).
KB = 60

#: first fallback row-tile capacity (rows re-decoded by the Viterbi when
#: their syndrome is nonzero); 128 rows cover sync outliers at working
#: SNR.  A second 4x tier softens the mid-SNR cliff before the full sweep.
FALLBACK_B = 128

#: windowed local re-decode (mid-SNR band): when many rows fail the
#: syndrome but each carries only a few hard errors, the Viterbi runs on
#: WIN_K-step windows around the error positions only, with WIN_W steps
#: of overlap-save warmup on each side (>= the ~96-step survivor-merge
#: depth, 64-step-aligned so the window fetch is a whole-row take).
#: Dirty flags dilate WIN_MARGIN steps across window boundaries so every
#: data bit an error event can flip lands inside some re-decoded window's
#: kept region.  Mirrors the reference's always-full Viterbi output
#: (lib/decode_impl.cc:205-281) at a fraction of the
#: sweep: dirty windows cost WIN_T lane-steps each vs T per full row.
WIN_K = 256
WIN_W = 128
WIN_T = WIN_K + 2 * WIN_W          # 512
WIN_MARGIN = 64
#: front-pad LLR strongly favoring coded bit 0: window 0 decodes its
#: WIN_W-step pre-history as forced zero bits, which reproduces the
#: state-0 start pin under the shared uniform initial metrics
PIN_LLR = -1e5
#: dirty-window count tiers (per batch) for the windowed lax.cond ladder
WIN_TIERS = (2048, 8192, 16384)


def _enc_matrix(nd: int) -> np.ndarray:
    """(2*nd, nd) GF(2) encoding matrix (zero initial state)."""
    E = np.zeros((2 * nd, nd), np.uint8)
    for t in range(nd):
        for k in range(7):
            if t - k >= 0:
                E[2 * t, t - k] ^= T.G0_TAPS[k]
                E[2 * t + 1, t - k] ^= T.G1_TAPS[k]
    return E


def _keep_mask(cr: str, ncoded: int) -> np.ndarray:
    """Puncture keep mask over a depunctured stream, shared with the
    depuncture scatter (single source of truth: viterbi.depuncture_indices)."""
    idx, _ = VXLA.depuncture_indices(cr, -(-ncoded // 2))
    m = np.zeros(2 * (-(-ncoded // 2)), bool)
    m[idx] = True
    return m[:ncoded]


def _gf2_solve(M: np.ndarray, Rhs: np.ndarray) -> np.ndarray | None:
    """Solve M X = Rhs over GF(2); returns X ((cols, k)) or None."""
    M = M.copy().astype(np.uint8)
    R = Rhs.copy().astype(np.uint8)
    r, c = M.shape
    piv_of_col = {}
    row = 0
    for col in range(c):
        sel = np.nonzero(M[row:, col])[0]
        if len(sel) == 0:
            continue
        p = row + sel[0]
        if p != row:
            M[[row, p]] = M[[p, row]]
            R[[row, p]] = R[[p, row]]
        hit = np.nonzero(M[:, col])[0]
        hit = hit[hit != row]
        M[hit] ^= M[row]
        R[hit] ^= R[row]
        piv_of_col[col] = row
        row += 1
        if row == r:
            break
    if R[~M.any(axis=1)].any():
        return None
    X = np.zeros((c, R.shape[1]), np.uint8)
    for col, pr in piv_of_col.items():
        X[col] = R[pr]
    return X


@functools.lru_cache(maxsize=None)
def _interior_matrix(cr: str) -> np.ndarray:
    """(3*2KB, KB) f32 stencil: data block i from depunctured coded
    blocks [i-1, i, i+1] (2KB pre-puncture bits each; punctured rows 0).

    Solved on a 5-block window with support restricted to the center 3
    coded blocks and zero required on every other data column, so the
    stencil is position-independent.  The returned solution is CAUSAL
    (asserted): column k's support ends at window position 2*(KB+k)+1,
    which makes the stencil exact at stream ends and under per-row
    ``n_real`` masking (see module docstring)."""
    nd = 5 * KB
    Ep = _enc_matrix(nd)
    keep = _keep_mask(cr, 2 * nd)
    S2 = 2 * KB
    rows = np.arange(S2, 4 * S2)
    sub_keep = keep[rows]
    A = Ep[rows][sub_keep]                         # (kept, 5KB)
    tgt = np.zeros((5 * KB, KB), np.uint8)
    tgt[np.arange(2 * KB, 3 * KB), np.arange(KB)] = 1
    X = _gf2_solve(A.T, tgt)
    if X is None:                                  # pragma: no cover
        raise ValueError(f"no windowed inverse for rate {cr}")
    Xd = np.zeros((3 * S2, KB), np.float32)
    Xd[np.nonzero(sub_keep)[0]] = X
    for k in range(KB):                            # causality certificate
        nz = np.nonzero(Xd[:, k])[0]
        assert nz.max() <= 2 * (KB + k) + 1, (cr, k, nz.max())
    return Xd


def _hard_inverse(hard_flat: jax.Array, cr: str, n_trellis: int) -> jax.Array:
    """(B, 2T) depunctured hard bits (f32 0/1) -> (B, T) data bits f32.

    Exact on every bit of an error-free stream (causal stencil); if the
    stream is only a codeword PREFIX of length n_real < T (canonicalized
    buckets, positions >= 2*n_real zeroed), bits [0, n_real) are exact."""
    B = hard_flat.shape[0]
    S2 = 2 * KB
    nblk = -(-n_trellis // KB)
    total = nblk * S2
    x = jnp.pad(hard_flat, ((0, 0), (S2, total + S2 - 2 * n_trellis)))

    def view(off):
        return jax.lax.slice_in_dim(x, off, off + total, axis=1).reshape(
            B, nblk, S2)

    w = jnp.concatenate([view(0), view(S2), view(2 * S2)], axis=-1)
    Xi = jnp.asarray(_interior_matrix(cr))
    d = jnp.einsum("bnw,wk->bnk", w, Xi,
                   preferred_element_type=jnp.float32) % 2
    return d.reshape(B, -1)[:, :n_trellis]


def _mismatch(d: jax.Array, hard_flat: jax.Array, cr: str, n_trellis: int,
              live: jax.Array | None = None) -> jax.Array:
    """(B, 2*n_trellis) 0/1 indicator of kept (and live) coded positions
    where re-encode(d) != hard."""
    B = d.shape[0]
    h = jnp.pad(d, ((0, 0), (6, 0)))

    def tap(k):
        return jax.lax.slice_in_dim(h, 6 - k, 6 - k + n_trellis, axis=1)

    a = (tap(0) + tap(2) + tap(3) + tap(5) + tap(6)) % 2
    c = (tap(0) + tap(1) + tap(2) + tap(3) + tap(6)) % 2
    re = jnp.stack([a, c], axis=-1).reshape(B, 2 * n_trellis)
    keep = jnp.asarray(_keep_mask(cr, 2 * n_trellis).astype(np.float32))
    mism = jnp.abs(re - hard_flat) * keep[None, :]
    if live is not None:
        mism = mism * live
    return mism


def inverse_and_syndrome(coded_llr: jax.Array, cr: str, n_trellis: int,
                         n_real: jax.Array | None = None):
    """Algebraic-invert and re-encode-check a batch of punctured LLRs.

    Builds the depunctured HARD-bit stream directly (no f32 LLR-pair
    tensor: the (B, T, 2) depuncture is only needed by the Viterbi
    fallback branches, and materializing it as a lax.cond operand costs
    ~145 MB of traffic the fast path never uses).  Returns (d8 (B, T)
    uint8 candidate, syn (B,) int32 per-row hard-error count over kept
    positions in [0, n_real)); the mismatch tensor fuses into the syn
    reduction here — the windowed deep branch recomputes it privately
    (see _mism_recompute)."""
    B = coded_llr.shape[0]
    idx, nk = VXLA.depuncture_indices(cr, n_trellis)
    hard = jnp.zeros((B, 2 * n_trellis), jnp.float32)
    hard = hard.at[:, idx].set((coded_llr[:, :nk] > 0).astype(jnp.float32))
    live = None
    if n_real is not None:
        live = (jnp.arange(2 * n_trellis, dtype=jnp.int32)[None, :]
                < 2 * n_real.astype(jnp.int32)[:, None]).astype(jnp.float32)
        hard = hard * live
    d = _hard_inverse(hard, cr, n_trellis)
    mism = _mismatch(d, hard, cr, n_trellis, live)
    syn = jnp.sum(mism, axis=1).astype(jnp.int32)
    return d.astype(jnp.uint8), syn


def _mism_recompute(coded_llr: jax.Array, d8: jax.Array, cr: str,
                    n_trellis: int, n_real: jax.Array | None) -> jax.Array:
    """Recompute the (B, 2T) mismatch indicator from the candidate d8.

    Called INSIDE the deep lax.cond branch: passing the mismatch tensor
    computed by inverse_and_syndrome across the cond boundary would
    force its ~145 MB materialization on the fast path too (cond branch
    operands cannot stay fused); recomputing it here costs the deep
    path a few cheap elementwise passes and the fast path nothing."""
    B = coded_llr.shape[0]
    idx, nk = VXLA.depuncture_indices(cr, n_trellis)
    hard = jnp.zeros((B, 2 * n_trellis), jnp.float32)
    hard = hard.at[:, idx].set((coded_llr[:, :nk] > 0).astype(jnp.float32))
    live = None
    if n_real is not None:
        live = (jnp.arange(2 * n_trellis, dtype=jnp.int32)[None, :]
                < 2 * n_real.astype(jnp.int32)[:, None]).astype(jnp.float32)
        hard = hard * live
    return _mismatch(d8.astype(jnp.float32), hard, cr, n_trellis, live)


def _window_dirty(mism: jax.Array, n_trellis: int, nwin: int) -> jax.Array:
    """(B, 2T) per-position mismatch -> (B, nwin) dirty window flags.

    A window is dirty when any mismatch falls inside it or within
    WIN_MARGIN steps on either side (an error event near a boundary can
    flip decoded bits in the neighbor window's kept region).  Operates
    on the flat depunctured view throughout (step t = flat 2t, 2t+1) —
    a (B, T, 2) reshape here would force the 64x tile-padded layout."""
    B = mism.shape[0]
    m = jnp.pad(mism, ((0, 0), (0, 2 * (nwin * WIN_K - n_trellis))))
    w = m.reshape(B, nwin, 2 * WIN_K)
    own = jnp.sum(w, axis=2)
    last = jnp.sum(w[:, :, 2 * (WIN_K - WIN_MARGIN):], axis=2)
    first = jnp.sum(w[:, :, :2 * WIN_MARGIN], axis=2)
    left = jnp.pad(last, ((0, 0), (1, 0)))[:, :nwin]
    right = jnp.pad(first, ((0, 0), (0, 1)))[:, 1:]
    return (own + left + right) > 0


def _win_tile_fn(k: int, coded_llr: jax.Array, d8: jax.Array,
                 dirty: jax.Array, cr: str, n_trellis: int, nwin: int):
    """Windowed re-decode branch: Viterbi over the <=k dirty WIN_K-step
    windows only (each with WIN_W warmup/overlap on both sides), merged
    back into the algebraic candidate.

    The window fetch is a row-take of whole 256-step rows (no per-row
    dynamic slices), and the merge-back is a rank-cumsum + row-take (no
    dynamic-row scatter)."""
    B = coded_llr.shape[0]

    def tile(_):
        # depuncture to the FLAT (B, 2T) stream: windows are whole rows
        # of its (B*(nwin+1), 512) view
        idxk, nk = VXLA.depuncture_indices(cr, n_trellis)
        full = jnp.zeros((B, 2 * n_trellis), jnp.float32)
        full = full.at[:, idxk].set(coded_llr[:, :nk])
        P = WIN_W + nwin * WIN_K + WIN_W        # 2P = 512 * (nwin + 1)
        flat = jnp.pad(full, ((0, 0), (2 * WIN_W,
                                       2 * (P - WIN_W - n_trellis))))
        # state-0 start pin for window 0: its WIN_W-step pre-history
        # carries LLRs forcing coded bit 0 (windows w>0 never read it)
        pin = (jnp.arange(2 * P, dtype=jnp.int32) < 2 * WIN_W)[None, :]
        flat = jnp.where(pin, PIN_LLR, flat)
        # window (b, w) spans flat positions [2wK, 2wK + 2*WIN_T) of row
        # b = exactly rows [b*(nwin+1) + w, +2) of the (B*(nwin+1), 512)
        # view — a whole-row take, no per-row dynamic slices
        v = flat.reshape(B * (nwin + 1), 512)
        dflat = dirty.reshape(-1)
        flat_idx = jnp.nonzero(dflat, size=k, fill_value=B * nwin)[0]
        safe = jnp.minimum(flat_idx, B * nwin - 1)
        b = safe // nwin
        w = safe % nwin
        base = b * (nwin + 1) + w
        bidx = base[:, None] + jnp.arange(2, dtype=jnp.int32)[None, :]
        win = jnp.take(v, bidx, axis=0).reshape(k, WIN_T, 2)
        # uniform warmup metrics, traceback from the argmax end state
        bits = VG.decoder()(win, False, jnp.zeros((k, 64), jnp.float32))
        kept = bits[:, WIN_W: WIN_W + WIN_K]                 # (k, WIN_K)
        # merge back: each dirty slot's rank among dirty slots IS its row
        # in `kept` (nonzero compaction preserves ascending order)
        df = dflat.astype(jnp.int32)
        rank = jnp.cumsum(df) - df
        taken = jnp.take(kept, jnp.minimum(rank, k - 1), axis=0)
        d8p = jnp.pad(d8, ((0, 0), (0, nwin * WIN_K - n_trellis)))
        d8p = d8p.reshape(B * nwin, WIN_K)
        sel = dflat & (rank < k)
        merged = jnp.where(sel[:, None], taken.astype(jnp.uint8), d8p)
        return merged.reshape(B, nwin * WIN_K)[:, :n_trellis]

    return tile


def adaptive_decode(coded_llr: jax.Array, cr: str, n_trellis: int,
                    fallback: int = FALLBACK_B,
                    n_real: jax.Array | None = None,
                    win_tiers: tuple = WIN_TIERS) -> jax.Array:
    """Depuncture + decode with the syndrome-gated fast path.

    coded_llr: (B, >=n_kept) punctured LLRs (positive = coded bit 1).
    n_real: optional (B,) int32 true trellis length per row for
    canonicalized (rounded-up) buckets — the syndrome and fast path then
    cover only each row's real region (pad-region bits are discarded by
    the caller; for the Viterbi fallback the >= 96-step survivor-merge
    margin the canon ladder guarantees keeps the real bits identical at
    working SNR — a heuristic bound, same as SEG_OVERLAP, not a
    worst-case guarantee over pathological pad-region LLRs).
    Returns (B, n_trellis) uint8 — identical to the pure Viterbi path on
    every row whose decode matters: zero-syndrome rows are codeword
    prefixes (fast path IS the ML output); few failing rows run the real
    Viterbi via a gathered row tile; mid-SNR batches where MANY rows
    fail but each carries only sparse hard errors re-decode the dirty
    WIN_K-step windows only (windowed tier ladder on the total dirty
    count); dense-error batches fall back to the full, monolithic sweep
    (exact at any SNR).
    """
    B = coded_llr.shape[0]
    d8, syn = inverse_and_syndrome(coded_llr, cr, n_trellis, n_real)
    need = syn > 0
    n_fail = jnp.sum(need.astype(jnp.int32))

    def fast(_):
        return d8

    def tile_fn(k):
        def tile(_):
            idx = jnp.nonzero(need, size=k, fill_value=B)[0]
            rows = jnp.minimum(idx, B - 1)
            # depuncture only the k gathered rows (the fast path never
            # materializes the (B, T, 2) pairs tensor at all);
            # "auto": small tiles on long trellises decode segmented,
            # which spreads one row's trellis over several parallel rows
            pairs_k = VXLA.depuncture(coded_llr[rows], cr, n_trellis)
            bits = VG.viterbi_decode(pairs_k, segmented="auto")  # (k, T)
            # merge via a one-hot matmul (exact on 0/1 values in any
            # precision) instead of a dynamic row scatter
            onehot = (idx[None, :]
                      == jnp.arange(B, dtype=jnp.int32)[:, None])
            merged = jnp.dot(onehot.astype(jnp.float32),
                             bits.astype(jnp.float32),
                             preferred_element_type=jnp.float32)
            return jnp.where(need[:, None], merged.astype(jnp.uint8), d8)
        return tile

    def full(_):
        # monolithic on purpose: dense-error batches get the exact
        # Viterbi (segment warmups assume the survivor paths merge, which
        # low-SNR trellises do not promise)
        return VG.viterbi_decode(VXLA.depuncture(coded_llr, cr, n_trellis))

    nwin = -(-n_trellis // WIN_K)
    wtiers = [t for t in sorted(win_tiers, reverse=True) if t < B * nwin]
    use_win = n_trellis >= 4 * WIN_K and wtiers
    body = full
    if use_win:
        def deep(_):
            # dirty-window extraction traced INSIDE this branch only: the
            # fast/row-tile paths never touch the mismatch tensor
            mism = _mism_recompute(coded_llr, d8, cr, n_trellis, n_real)
            dirty = _window_dirty(mism, n_trellis, nwin)
            n_dirty = jnp.sum(dirty.astype(jnp.int32))
            inner = full
            for k in wtiers:
                def wtier(_, k=k, nxt=inner):
                    return jax.lax.cond(
                        n_dirty <= k,
                        _win_tile_fn(k, coded_llr, d8, dirty, cr,
                                     n_trellis, nwin), nxt, None)
                inner = wtier
            return inner(None)

        # cheap gate on the already-reduced total error count: when it is
        # large (low-SNR sweeps: hundreds of hard errors per row) n_dirty
        # is certainly over every tier, so skip the deep branch's
        # mismatch recompute and go straight to the full sweep.  The
        # 16x-per-window headroom reflects the measured mid-SNR regime where many weak (low-|LLR|) mismatches share
        # windows (26 dB bench: 48k errors but only 3.6k dirty windows;
        # 24 dB: 420k errors, 28k dirty -> correctly gated to full).
        tot2 = 2 * jnp.sum(syn)

        def gated(_):
            return jax.lax.cond(tot2 <= 32 * wtiers[0], deep, full, None)

        body = gated
        row_tiers = (fallback,)
    else:
        row_tiers = (16 * fallback, 4 * fallback, fallback)
    for k in [t for t in row_tiers if t < B]:
        def tier(_, k=k, nxt=body):
            return jax.lax.cond(n_fail <= k, tile_fn(k), nxt, None)
        body = tier
    return jax.lax.cond(n_fail == 0, fast, body, None)
