"""Batched RX front end: STF/LTF correlators, trigger metrics, CFO.

Everything operates on :class:`~gr_ieee80211.ops.cplx.CF` float-pair
arrays (see ops.cplx).  The streaming detectors are
cumulative-sum moving windows over the whole sample stream (one fused pass);
per-packet sync/CFO refinement operates on gathered (B, n) windows.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .cplx import CF, expj

FS = 20e6


_MOVSUM_BLK = 1 << 15


def _movsum(x: jax.Array, w: int) -> jax.Array:
    """Moving window sum, aligned so out[n] = sum x[n:n+w].

    Supports any w with w - 1 <= _MOVSUM_BLK (asserted); small windows
    (detection correlators) and the larger confirm windows used by the
    sharded front end (parallel.mesh) both qualify.

    A single cumsum-difference drifts in float32 over multi-megasample
    streams (observed as missed triggers beyond ~5M samples), so the
    stream is cut into 32k blocks with w-sample overlap and the cumsum is
    reset per block, bounding the accumulated error.
    """
    assert w - 1 <= _MOVSUM_BLK, w
    n_out = x.shape[-1] - w + 1
    if x.ndim > 1 or x.shape[-1] <= _MOVSUM_BLK:
        c = jnp.cumsum(x, axis=-1)
        zero = jnp.zeros_like(c[..., :1])
        c = jnp.concatenate([zero, c], axis=-1)
        return c[..., w:] - c[..., :-w]
    K = _MOVSUM_BLK
    nblk = -(-n_out // K)
    pad = (nblk + 1) * K - x.shape[-1]
    xp = jnp.pad(x, (0, pad))
    main = xp[: nblk * K].reshape(nblk, K)
    ov = xp[K:].reshape(nblk, K)[:, : w - 1]
    blocks = jnp.concatenate([main, ov], axis=1)
    c = jnp.cumsum(blocks, axis=-1)
    zero = jnp.zeros_like(c[:, :1])
    c = jnp.concatenate([zero, c], axis=-1)
    out = (c[:, w:] - c[:, :-w]).reshape(-1)
    return out[:n_out]


def _movsum_cf(x: CF, w: int) -> CF:
    return CF(_movsum(x.re, w), _movsum(x.im, w))


#: relative power floor for the plateau metric: windows more than 30 dB
#: below the stream's average windowed power cannot trigger.  Without it,
#: exactly-silent stream regions divide two cumsum float residues and the
#: junk ratio forms spurious plateaus (real streams always carry noise, but
#: file replays and unit fixtures may be literal zeros).
_POWER_FLOOR_REL = 1e-3


def _floor(p: jax.Array) -> jax.Array:
    return jnp.maximum(_POWER_FLOOR_REL * jnp.mean(p), 1e-12)


@jax.jit
def stf_metrics(x: CF):
    """x (n,) -> (metric m, lag-16 autocorr CF), aligned to x[0]."""
    prod = x[: x.shape[-1] - 16].mul_conj(x[16:])
    c = _movsum_cf(prod, 48)
    p = _movsum(x.abs2(), 64)
    n = min(c.shape[-1], p.shape[-1])
    c = c[..., :n]
    m = c.abs() / jnp.maximum(p[..., :n], _floor(p))
    return m, c


#: detection decimation: the STF plateau spans ~100 samples, so evaluating
#: the metric every DETECT_STRIDE samples keeps detection intact while
#: cutting the streaming prefix-sum work 16x; sync refines timing anyway
#: (the LTF search spans [trig+80, trig+448), far beyond the <=16-sample
#: trigger quantization).  Raised 4 -> 8 in round 3 and 8 -> 16 in round 4
#: (the metric VALUES are unchanged 48-sample correlations, only sampled
#: sparser; run/confirm rules rescale with the stride) — the PER detection
#: limb is re-validated by the sweeps each time.
DETECT_STRIDE = 16


#: row length for the 2-D detection layout: the stream is viewed as
#: (n_rows, ROW+overlap) with windows never crossing a row's private span,
#: so every moving sum is a short-axis 2-D op.
DETECT_ROW = 8192
_DET_OV = 96  # lag 16 + 48-corr window + chunk alignment lookahead


def _chunk4_rows(x: jax.Array) -> jax.Array:
    """Sum every DETECT_STRIDE lanes, accumulating in f32 (inputs may be
    bf16: the downstream moving sums are cumsum-differences and need f32)."""
    r, n = x.shape
    n4 = n // DETECT_STRIDE
    return (x[:, : n4 * DETECT_STRIDE].reshape(r, n4, DETECT_STRIDE)
            .astype(jnp.float32).sum(axis=-1))


@jax.jit
def stf_metric_strided(x: CF) -> jax.Array:
    """Plateau metric at DETECT_STRIDE positions: m4[k] ~= m[4k], flat (n//4,).

    Internally row-blocked: each row computes its ROW-sample span from
    ROW+_DET_OV samples, so all moving sums are short-axis 2-D ops.
    """
    s = DETECT_STRIDE
    n = x.shape[-1]
    n_rows = -(-n // DETECT_ROW)
    # rows[i] = xp[i*ROW : i*ROW + ROW + OV], built gather-free from two
    # reshapes: the main (n_rows, ROW) view plus the ROW-shifted view's first OV cols.
    pad = (n_rows + 1) * DETECT_ROW - n

    def mk(v):
        vp = jnp.pad(v, (0, pad))
        main = vp[: n_rows * DETECT_ROW].reshape(n_rows, DETECT_ROW)
        ov = vp[DETECT_ROW:].reshape(n_rows, DETECT_ROW)[:, :_DET_OV]
        return jnp.concatenate([main, ov], axis=1)

    rows = CF(mk(x.re), mk(x.im))
    prod = rows[:, : rows.shape[-1] - 16].mul_conj(rows[:, 16:])
    cre = _movsum(_chunk4_rows(prod.re), 48 // s)
    cim = _movsum(_chunk4_rows(prod.im), 48 // s)
    p = _movsum(_chunk4_rows(rows.abs2()), 64 // s)
    k = DETECT_ROW // s
    m = (jnp.sqrt(cre[:, :k] ** 2 + cim[:, :k] ** 2)
         / jnp.maximum(p[:, :k], _floor(p)))
    return m.reshape(-1)[: n // s]


@functools.partial(jax.jit, static_argnames=("max_out",))
def detect_plateaus_strided(m4: jax.Array, thresh: float = 0.3,
                            max_out: int = 4096) -> jax.Array:
    """Candidate trigger sample indices from the strided metric (padded -1).

    run = 3 strided points (48 samples) ~ the reference's 20-sample
    plateau rule at this stride.

    Two refinements over the raw plateau-edge rule (both measured on
    clean + 8 dB streams, round 4):

    * plateau-length confirmation ``confirm=(8, 6)``: a real L-STF
      plateau spans 10-11 strided points (~164 samples), the VHT/HT-STF
      mid-packet re-fire at +560 only 4-5 — requiring >= 6 of the 8
      points after the edge to sit above threshold drops re-fires at the
      source.  Without this, a re-fire candidate between two close
      packets (<1260 samples apart) bridges the dedup chain and swallows
      the second packet's start.
    * suppress=_SUPPRESS_STRIDED: any surviving start within ~688 samples
      of another is removed BEFORE the K-per-row compaction, so the
      _COMPACT_K capacity bound holds per packet, not per plateau edge."""
    idx = detect_plateaus(m4, thresh=thresh, run=3, max_out=max_out,
                          suppress=_SUPPRESS_STRIDED, confirm=(8, 6))
    return jnp.where(idx >= 0, idx * DETECT_STRIDE, -1)


#: pre-compaction cluster suppression window, in strided points: any start
#: within 696 samples of an earlier start would be dropped by trigger dedup
#: (spacing 700) anyway, so removing it early is a strict refinement
_SUPPRESS_STRIDED = 700 // DETECT_STRIDE

_COMPACT_ROW = 512
#: max plateau starts per 512-lane row AFTER cluster suppression: surviving
#: starts are >= _SUPPRESS_STRIDED = 43 points apart, so a row (8192
#: samples at stride 16) holds at most ceil(512/43)+1 = 13 starts; K=14
#: leaves margin (without suppression a row would see ~11 packets x up to
#: 3 plateau edges each, far over any practical K)
_COMPACT_K = 14


def _compact_indices(start: jax.Array, max_out: int) -> jax.Array:
    """Ascending indices of set bits in a large bool vector, -1 padded.

    Instead of one ``jnp.nonzero`` over a multi-megapoint vector, this
    two-level scheme extracts the first K set positions of each 512-lane row
    with K=_COMPACT_K vectorized argmin passes (see the bound at its
    definition), then runs the cheap nonzero over the (rows*K,) candidate
    list only.
    """
    n = start.shape[-1]
    R = -(-n // _COMPACT_ROW)
    s = jnp.pad(start, (0, R * _COMPACT_ROW - n)).reshape(R, _COMPACT_ROW)
    pos = jax.lax.broadcasted_iota(jnp.int32, (R, _COMPACT_ROW), 1)
    base = jax.lax.broadcasted_iota(jnp.int32, (R, 1), 0)[:, 0] * _COMPACT_ROW
    BIG = jnp.int32(_COMPACT_ROW + 1)
    cands = []
    for _ in range(_COMPACT_K):
        p = jnp.min(jnp.where(s, pos, BIG), axis=1)          # (R,)
        found = p < BIG
        cands.append(jnp.where(found, base + p, -1))
        s = s & (pos != p[:, None])
    cand = jnp.stack(cands, axis=1).reshape(-1)              # (R*K,) row-major
    keep = cand >= 0
    slot = jnp.nonzero(keep, size=max_out, fill_value=-1)[0]
    # row-major with ascending per-row slots => compacted order is ascending
    return jnp.where(slot >= 0, cand[jnp.maximum(slot, 0)], -1)


@functools.partial(jax.jit,
                   static_argnames=("max_out", "run", "suppress", "confirm"))
def detect_plateaus(m: jax.Array, thresh: float = 0.3, run: int = 20,
                    max_out: int = 4096, suppress: int = 0,
                    confirm: tuple | None = None) -> jax.Array:
    """Device-side plateau-start detection; returns (max_out,) candidate
    indices padded with -1.  Only these indices cross to the host — the full
    metric array never leaves the device.

    ``confirm=(win, need)``: keep a start only if >= ``need`` of the
    ``win`` points from it are above threshold (dip-tolerant plateau-length
    check; rejects the short mid-packet STF re-fire plateaus).

    ``suppress`` > 0 then drops any confirmed start with another confirmed
    start within the preceding ``suppress`` points (one movsum).  Every
    such start has a <= suppress-point gap to its predecessor, which
    downstream trigger dedup (spacing >= suppress) would discard anyway —
    removing it here keeps the per-row _COMPACT_K capacity for true packet
    starts."""
    above = (m > thresh).astype(jnp.float32)
    run_ok = _movsum(above, run) >= run            # all `run` above from n
    nr = run_ok.shape[-1]
    prev = jnp.concatenate([jnp.zeros(1), above[:-1]])
    start = run_ok & (prev[:nr] == 0) & (above[:nr] > 0)
    if confirm is not None:
        win, need = confirm
        cnt = _movsum(jnp.concatenate([above, jnp.zeros(win)]), win)[:nr]
        start = start & (cnt >= need)
    if suppress:
        padded = jnp.concatenate(
            [jnp.zeros(suppress), start.astype(jnp.float32)])
        prev_cnt = _movsum(padded, suppress)[:nr]  # starts in (i-s, i)
        start = start & (prev_cnt == 0)
    return _compact_indices(start, max_out).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("max_out", "spacing"))
def dedup_triggers_device(cand: jax.Array, max_out: int,
                          spacing: int = 700) -> jax.Array:
    """Device-side cluster dedup of ascending -1-padded candidate indices.

    Keeps the first candidate of each >spacing-gap cluster (the device twin
    of models.rx.dedup_triggers) so a fused detect->sync->decode program
    never has to surface candidates to the host."""
    prev = jnp.concatenate([jnp.full((1,), -(1 << 30), cand.dtype), cand[:-1]])
    keep = (cand >= 0) & (cand - prev > spacing)
    pos = jnp.nonzero(keep, size=max_out, fill_value=-1)[0]
    return jnp.where(pos >= 0, cand[jnp.maximum(pos, 0)], -1).astype(jnp.int32)


def _gather_blocked(v, starts16: jax.Array, n: int, dt) -> jax.Array:
    """Core blocked gather: 16-aligned starts -> (B, n) rows of ``v``
    staged through dtype ``dt``, via whole-64-block row takes + a
    4-residual masked combine (see gather_windows_blocked_bf16).

    Windows overrunning the stream tail read ZEROS past the end (the
    padded block view), unlike the old vmap(dynamic_slice) path which
    clamped the start and returned real tail samples — callers must
    valid-mask rows whose window exceeds the stream (they all do)."""
    B = starts16.shape[0]
    base_blk = starts16 // _GW_BL
    r = starts16 - base_blk * _GW_BL              # {0, 16, 32, 48}
    nb = -(-(n + _GW_BL - 16) // _GW_BL)          # covers r=48 + n span
    pad = (-v.shape[0]) % _GW_BL + _GW_BL
    rows = jnp.pad(v.astype(dt), (0, pad)).reshape(-1, _GW_BL)
    bidx = base_blk[:, None] + jnp.arange(nb, dtype=jnp.int32)[None, :]
    a = jnp.take(rows, bidx, axis=0).reshape(B, nb * _GW_BL)
    out = a[:, 0: n]
    for k in (16, 32, 48):
        out = jnp.where((r == k)[:, None], a[:, k: k + n], out)
    return out                                    # stays in dt


def _gather_any(v, starts: jax.Array, n: int, dt) -> jax.Array:
    """Blocked gather for ARBITRARY starts: fetch n+16 at the 16-aligned
    base, then align the residual [0, 16) with a log2 shift cascade (4
    masked select passes) — no per-row dynamic addressing anywhere."""
    s16 = (starts // 16) * 16
    rem = starts - s16
    w = _gather_blocked(v, s16, n + 16, dt)       # combine + cascade in dt
    width = n + 16
    for bit in (8, 4, 2, 1):
        width -= bit
        take = ((rem & bit) > 0)[:, None]
        w = jnp.where(take, w[:, bit: bit + width], w[:, :width])
    return w[:, :n].astype(jnp.float32)


@functools.partial(jax.jit, static_argnames=("n",))
def gather_windows(x: CF, starts: jax.Array, n: int) -> CF:
    """x (N,) + starts (B,) -> (B, n) windows (f32-staged blocked gather,
    arbitrary starts; zeros past the stream end — see _gather_blocked)."""
    return CF(_gather_any(x.re, starts, n, jnp.float32),
              _gather_any(x.im, starts, n, jnp.float32))


_GW_BL = 64


@functools.partial(jax.jit, static_argnames=("n",))
def gather_windows_blocked_bf16(x: CF, starts: jax.Array, n: int) -> CF:
    """(B, n) window gather for 16-sample-aligned starts.

    A ROW gather of whole 64-sample blocks from the (N/64, 64) stream view
    replaces per-row dynamic slices.  Starts aligned to 16 (detection triggers are DETECT_STRIDE
    multiples) leave only 4 possible 64-block residuals {0,16,32,48},
    combined with masked shifted views of the fetched superset — three
    extra elementwise passes, no per-row addressing.  Unaligned starts
    are rounded DOWN to 16 (callers measuring offsets inside the window
    must use the same rounding)."""
    s16 = (starts // 16) * 16
    return CF(_gather_blocked(x.re, s16, n, jnp.bfloat16
                              ).astype(jnp.float32),
              _gather_blocked(x.im, s16, n, jnp.bfloat16
                              ).astype(jnp.float32))


@functools.partial(jax.jit, static_argnames=("n",))
def gather_windows_bf16(x: CF, starts: jax.Array, n: int) -> CF:
    """Window gather through a bfloat16 staging copy of the stream.

    bf16 halves the staged bytes; its ~49 dB SQNR per sample is an order
    of magnitude below the channel noise at any decodable SNR (MCS9 needs
    ~ -32 dB EVM), and finer than the 12-bit ADCs feeding a real front
    end.  The fetch is the blocked row-take + shift cascade
    (_gather_any); arbitrary starts."""
    return CF(_gather_any(x.re, starts, n, jnp.bfloat16),
              _gather_any(x.im, starts, n, jnp.bfloat16))


@jax.jit
def ltf_fine_sync(wins: CF):
    """Per-packet L-LTF timing on (B, 368) windows starting at trigger+80.

    Returns (offsets (B,), peak (B,)): offset of the chosen ltf_idx within
    the window (mid of the 80% shoulders of the lag-64 autocorr peak, +8).
    Thin wrapper over :func:`ltf_fine_sync_cfo` (single source of truth
    for the timing algorithm) discarding the CFO/RSSI outputs."""
    off, peak, _, _ = ltf_fine_sync_cfo(wins, jnp.zeros(wins.shape[0]))
    return off, peak


@jax.jit
def ltf_fine_sync_cfo(wins: CF, cfo0: jax.Array):
    """Fused fine timing + fine CFO on (B, 368) windows at trigger+80.

    Same shoulder-midpoint timing as :func:`ltf_fine_sync`, but the fine
    CFO comes for free from the lag-64 autocorrelation the timing metric
    already computed: the 128-sample CFO window at the chosen offset is
    exactly one lane of the movsum, so the separate per-row 128-sample
    gather + derotation + product pass of the (row128 -> fine_cfo_batch)
    path disappears.  The lag-64 angle is +-156 kHz ambiguous; the coarse
    STF estimate ``cfo0`` resolves the wrap (identical math to
    fine_cfo_batch, which derotates by cfo0 first — here the rotation is
    added to the angle instead of the samples).

    Returns (offset (B,) int32, peak (B,), cfo_hz (B,), rssi (B,)):
    ``rssi`` is the mean 64-sample windowed power at the autocorrelation
    peak — the reference's per-packet ``rssi`` tag
    (lib/sync_impl.cc:124-136, d_tmpPwr[maxIndex]/64).
    """
    B, n = wins.shape
    npts = n - 128
    prod = wins[:, : n - 64].mul_conj(wins[:, 64:])
    a = _movsum_cf(prod, 64)                       # (B, n-127)
    pw = _movsum(wins.abs2(), 64)
    den = jnp.sqrt(jnp.maximum(pw[:, :npts] * pw[:, 64: 64 + npts], 1e-24))
    ac = a[:, :npts].abs() / den
    k = jnp.argmax(ac, axis=1)
    peak = jnp.take_along_axis(ac, k[:, None], axis=1)[:, 0]
    idx = np.arange(npts)
    tgt = 0.8 * peak[:, None]
    d = jnp.abs(ac - tgt)
    in_l = (idx[None, :] <= k[:, None]) & (idx[None, :] >= k[:, None] - 32)
    in_r = (idx[None, :] >= k[:, None]) & (idx[None, :] <= k[:, None] + 32)
    big = jnp.full_like(d, 1e9)
    lo = jnp.argmin(jnp.where(in_l, d, big), axis=1)
    hi = jnp.argmin(jnp.where(in_r, d, big), axis=1)
    # Aim the sampling point EARLY into the GI (reference C8P_SYM_SAMP_SHIFT=8,
    # lib/cloud80211phy.h:33): the TX blends the edge samples of every symbol
    # (PY-TB procConcat2Symbol), so an FFT window that starts exactly at
    # GI+16 picks up a blended boundary sample (0.09 EVM noiseless).  The
    # shoulder midpoint jitters about +-6 around (true - 4), so a +8 bias
    # keeps the earliness within the safe [2, 14] span (GI is 16).
    mid = (lo + hi) // 2 + 8
    ci = jnp.clip(mid, 0, a.shape[1] - 1)[:, None]
    s_re = jnp.take_along_axis(a.re, ci, axis=1)[:, 0]
    s_im = jnp.take_along_axis(a.im, ci, axis=1)[:, 0]
    phase0 = 2 * np.pi * 64.0 * cfo0 / FS
    ang = jnp.arctan2(s_im, s_re) + phase0
    ang = ang - 2 * np.pi * jnp.round(ang / (2 * np.pi))   # wrap to [-pi, pi)
    cfo = cfo0 - ang / 64 / (2 * np.pi) * FS
    rssi = jnp.take_along_axis(pw, k[:, None], axis=1)[:, 0] / 64.0
    return mid.astype(jnp.int32), peak, cfo, rssi


@jax.jit
def coarse_cfo_batch(stf_wins: CF) -> jax.Array:
    """(B, >=80) windows at the trigger -> CFO Hz from lag-16 autocorr."""
    prod = stf_wins[:, :64].mul_conj(stf_wins[:, 16:80])
    s = CF(jnp.mean(prod.re, axis=1), jnp.mean(prod.im, axis=1))
    return -s.angle() / 16 / (2 * np.pi) * FS


@jax.jit
def fine_cfo_batch(ltf_wins: CF, cfo0: jax.Array) -> jax.Array:
    """(B, 128) LTF windows + coarse CFO -> refined CFO Hz."""
    n = np.arange(128)
    rot = expj(-2 * np.pi * cfo0[:, None] / FS * n[None, :])
    w = ltf_wins * rot
    prod = w[:, :64].mul_conj(w[:, 64:128])
    s = CF(jnp.mean(prod.re, axis=1), jnp.mean(prod.im, axis=1))
    return cfo0 - s.angle() / 64 / (2 * np.pi) * FS


def _derotate_factored(wins: CF, cfo: jax.Array, n: int) -> CF:
    """wins * exp(-j 2pi cfo t / FS) with t = 64*q + r factored phasors.

    sin/cos lower to polynomial chains; computing the (B, n) rotation
    directly makes transcendentals the derotation cost.  exp(j w t) = exp(j w 64 q) * exp(j w r) needs only (B, n/64 + 64)
    of them.  The factors multiply the samples as two BROADCAST complex
    products (by the lane phasor, then the block phasor) instead of
    materializing the (B, n) rotation tensor: one extra complex multiply
    per sample, but ~140 MB less memory traffic at (4096, 2116)."""
    B = wins.shape[0]
    w = (-2 * np.pi / FS) * cfo                      # (B,) rad/sample
    n_hi = -(-n // 64)
    hi = expj(w[:, None] * (64.0 * np.arange(n_hi, dtype=np.float32))[None])
    lo = expj(w[:, None] * np.arange(64, dtype=np.float32)[None])
    pad = n_hi * 64 - n
    re = jnp.pad(wins.re, ((0, 0), (0, pad))).reshape(B, n_hi, 64)
    im = jnp.pad(wins.im, ((0, 0), (0, pad))).reshape(B, n_hi, 64)
    out = CF(re, im) * CF(lo.re[:, None, :], lo.im[:, None, :])
    out = out * CF(hi.re[:, :, None], hi.im[:, :, None])
    return CF(out.re.reshape(B, -1)[:, :n], out.im.reshape(B, -1)[:, :n])


@functools.partial(jax.jit, static_argnames=("n", "low_prec"))
def derotate_batch(x: CF, starts: jax.Array, cfo: jax.Array, n: int,
                   low_prec: bool = False) -> CF:
    """Gather (B, n) windows at ``starts`` and derotate each by its CFO.

    low_prec=True stages the gather through bf16 (see gather_windows_bf16);
    used for the long payload windows where the fetch dominates.
    Uses the factored-phasor path, which fuses with the gather upcast and
    the downstream symbol windows."""
    gw = gather_windows_bf16 if low_prec else gather_windows
    wins = gw(x, starts, n)
    return _derotate_factored(wins, cfo, n)
