"""Syndrome-gated adaptive decoder (ops.fastdecode) vs gold/Viterbi.

The claim under test: when the received hard bits form a codeword the
algebraic inverse equals the data exactly; otherwise the fallback
Viterbi tiers reproduce the pure Viterbi path on every row (psdu region —
traceback garbage past the tail may differ, as documented)."""
import numpy as np
import jax.numpy as jnp
import pytest

from gr_ieee80211.gold import bits as GB
from gr_ieee80211.ops import fastdecode as FD
from gr_ieee80211.ops.viterbi_gpu import viterbi_decode
from gr_ieee80211.ops import viterbi as VXLA

RATES = ("1/2", "2/3", "3/4", "5/6")


def _llr_batch(rng, cr, T, B, flips_per_row=None):
    """Encode B random data rows (UNterminated — nonzero final bits
    exercise the causal stencil at the stream end); return
    (coded LLRs (B, Ns), data)."""
    data = rng.integers(0, 2, (B, T)).astype(np.uint8)
    llrs, Ns = [], None
    for b in range(B):
        cs = GB.bcc_encode_punct(data[b], cr)
        Ns = len(cs)
        llr = (cs.astype(np.float32) * 2 - 1) * 4.0
        if flips_per_row:
            pos = rng.choice(Ns, flips_per_row[b], replace=False)
            llr[pos] = -llr[pos]
        llrs.append(llr)
    return np.stack(llrs), data, Ns


@pytest.mark.parametrize("cr", RATES)
def test_error_free_equals_data(cr):
    rng = np.random.default_rng(3)
    T = 733
    llr, data, _ = _llr_batch(rng, cr, T, 4)
    out = np.asarray(FD.adaptive_decode(jnp.asarray(llr), cr, T))
    assert np.array_equal(out, data)


def test_interior_and_tail_matrices_all_lengths():
    rng = np.random.default_rng(4)
    for cr in RATES:
        for T in (4420, 1021, 241, 30):
            llr, data, _ = _llr_batch(rng, cr, T, 2)
            out = np.asarray(FD.adaptive_decode(jnp.asarray(llr), cr, T))
            assert np.array_equal(out, data), (cr, T)


def test_tile_fallback_matches_pure_viterbi():
    """A few corrupted rows route through the fallback tile and match the
    pure Viterbi decode bit-for-bit on the non-tail region."""
    rng = np.random.default_rng(5)
    cr, T, B = "3/4", 600, 8
    flips = [0, 3, 0, 0, 7, 0, 0, 1]
    llr, data, _ = _llr_batch(rng, cr, T, B, flips_per_row=flips)
    out = np.asarray(FD.adaptive_decode(jnp.asarray(llr), cr, T, fallback=4))
    pure = np.asarray(viterbi_decode(
        VXLA.depuncture(jnp.asarray(llr), cr, T)))
    assert np.array_equal(out[:, : T - 96], pure[:, : T - 96])
    # clean rows kept the algebraic answer
    for b in (0, 2, 3, 5, 6):
        assert np.array_equal(out[b], data[b])


def test_full_fallback_when_over_capacity():
    """More failing rows than the tile -> whole batch = pure Viterbi."""
    rng = np.random.default_rng(6)
    cr, T, B = "1/2", 480, 6
    flips = [2, 2, 2, 2, 2, 0]
    llr, data, _ = _llr_batch(rng, cr, T, B, flips_per_row=flips)
    out = np.asarray(FD.adaptive_decode(jnp.asarray(llr), cr, T, fallback=2))
    pure = np.asarray(viterbi_decode(
        VXLA.depuncture(jnp.asarray(llr), cr, T)))
    assert np.array_equal(out, pure)
    # light corruption at strong |LLR|: Viterbi corrects it back to the data
    assert np.array_equal(out[:, : T - 96], data[:, : T - 96])


def test_syndrome_counts_flips():
    rng = np.random.default_rng(7)
    cr, T = "5/6", 500
    llr, data, Ns = _llr_batch(rng, cr, T, 3, flips_per_row=[0, 4, 1])
    _, syn = FD.inverse_and_syndrome(jnp.asarray(llr), cr, T)
    syn = np.asarray(syn)
    assert syn[0] == 0
    assert syn[1] >= 4 and syn[2] >= 1


def _canon_llr_batch(rng, cr, T_canon, n_reals, snr_garbage=True):
    """Rows are codeword PREFIXES: row b encodes n_reals[b] data bits;
    LLR positions past the real kept count are random garbage (what a
    canonicalized bucket demodulates beyond the real packet end)."""
    B = len(n_reals)
    from gr_ieee80211.ops.viterbi import depuncture_indices
    _, nk_canon = depuncture_indices(cr, T_canon)
    data = np.zeros((B, T_canon), np.uint8)
    llr = rng.normal(size=(B, nk_canon)).astype(np.float32) * 4.0
    for b, nr in enumerate(n_reals):
        d = rng.integers(0, 2, nr).astype(np.uint8)
        data[b, :nr] = d
        cs = GB.bcc_encode_punct(d, cr)
        llr[b, : len(cs)] = (cs.astype(np.float32) * 2 - 1) * 4.0
    return llr, data


@pytest.mark.parametrize("cr", RATES)
def test_canon_bucket_keeps_fast_path(cr):
    """Mixed-length rows inside one canonicalized trellis: with per-row
    n_real the syndrome is 0 on every clean row (the VERDICT round-2
    'weak #1' scenario) and the algebraic answer is exact on the real
    region."""
    rng = np.random.default_rng(11)
    T_canon = 1500
    n_reals = [1500, 1404, 1250, 990]
    llr, data = _canon_llr_batch(rng, cr, T_canon, n_reals)
    n_real = jnp.asarray(n_reals, jnp.int32)
    d8, syn = FD.inverse_and_syndrome(jnp.asarray(llr), cr, T_canon,
                                         n_real=n_real)
    assert np.array_equal(np.asarray(syn), np.zeros(4, np.int32))
    out = np.asarray(FD.adaptive_decode(jnp.asarray(llr), cr, T_canon,
                                        n_real=n_real))
    for b, nr in enumerate(n_reals):
        assert np.array_equal(out[b, :nr], data[b, :nr]), (cr, nr)
    # without n_real the garbage region poisons the syndrome (the round-2
    # failure mode this feature removes)
    _, syn_bad = FD.inverse_and_syndrome(jnp.asarray(llr), cr, T_canon)
    assert np.asarray(syn_bad)[1:].min() > 0


def test_canon_bucket_fallback_rows_exact():
    """Corrupted canon rows route through the Viterbi tier and still
    decode their real region exactly (merge-margin argument)."""
    rng = np.random.default_rng(12)
    cr, T_canon = "3/4", 1200
    n_reals = [1040, 1040, 880, 1200]
    llr, data = _canon_llr_batch(rng, cr, T_canon, n_reals)
    # flip a few strong coded bits inside row 0's and row 2's real region
    for b in (0, 2):
        llr[b, 40:43] = -llr[b, 40:43]
    out = np.asarray(FD.adaptive_decode(
        jnp.asarray(llr), cr, T_canon, fallback=2,
        n_real=jnp.asarray(n_reals, jnp.int32)))
    for b, nr in enumerate(n_reals):
        assert np.array_equal(out[b, :nr], data[b, :nr]), (b, nr)


def test_tier_ladder_routes_mid_counts():
    """n_fail between fallback and 4*fallback uses the middle tier (and
    stays exact); above 4*fallback the full sweep runs."""
    rng = np.random.default_rng(13)
    cr, T, B = "1/2", 480, 32
    flips = [3] * 6 + [0] * (B - 6)       # 6 failing rows, tiers (2, 8)
    llr, data, _ = _llr_batch(rng, cr, T, B, flips_per_row=flips)
    out = np.asarray(FD.adaptive_decode(jnp.asarray(llr), cr, T, fallback=2))
    pure = np.asarray(viterbi_decode(
        VXLA.depuncture(jnp.asarray(llr), cr, T)))
    assert np.array_equal(out[:, : T - 96], pure[:, : T - 96])
    flips = [3] * 12 + [0] * (B - 12)     # 12 > 4*fallback -> full sweep
    llr, data, _ = _llr_batch(rng, cr, T, B, flips_per_row=flips)
    out = np.asarray(FD.adaptive_decode(jnp.asarray(llr), cr, T, fallback=2))
    pure = np.asarray(viterbi_decode(
        VXLA.depuncture(jnp.asarray(llr), cr, T)))
    assert np.array_equal(out, pure)


def test_windowed_redecode_matches_pure_viterbi():
    """Sparse hard errors across many rows route through the windowed
    tier (n_fail > row tile, n_dirty <= win tier) and reproduce the pure
    Viterbi decode bit-for-bit, including first/last-window errors (the
    state-0 pin and the zero-LLR tail)."""
    rng = np.random.default_rng(7)
    cr, T, B = "3/4", 1300, 32
    flips = [2] * B          # every row fails the syndrome
    llr, data, _ = _llr_batch(rng, cr, T, B, flips_per_row=flips)
    llr[0, 1] = -llr[0, 1]            # first-window boundary
    llr[1, -2] = -llr[1, -2]          # last-window tail
    x = jnp.asarray(llr)
    # fallback=16 < flips rows, so the 128-row tile can't take it; the
    # (128,) win tier must (B*nwin = 192 slots, dirty ~70)
    out = np.asarray(FD.adaptive_decode(x, cr, T, fallback=16,
                                        win_tiers=(128,)))
    ref = np.asarray(viterbi_decode(
        jnp.asarray(VXLA.depuncture(x, cr, T))))
    assert np.array_equal(out, ref)


def test_windowed_dirty_overflow_falls_back_full():
    """More dirty windows than the largest win tier -> full sweep, still
    exact vs the pure Viterbi decode."""
    rng = np.random.default_rng(8)
    cr, T, B = "1/2", 1300, 16
    llr, data, Ns = _llr_batch(rng, cr, T, B)
    mask = rng.random(llr.shape) < 0.03          # dense errors everywhere
    llr = np.where(mask, -llr, llr)
    x = jnp.asarray(llr.astype(np.float32))
    out = np.asarray(FD.adaptive_decode(x, cr, T, fallback=4,
                                        win_tiers=(128,)))
    ref = np.asarray(viterbi_decode(
        jnp.asarray(VXLA.depuncture(x, cr, T))))
    assert np.array_equal(out, ref)


def test_windowed_canon_n_real_rows_exact():
    """Windowed tier + canonicalized rows: per-row n_real keeps the real
    region exact when errors hit only live positions."""
    rng = np.random.default_rng(9)
    cr, T = "3/4", 1536
    T_real = 1100
    B = 24
    data = rng.integers(0, 2, (B, T_real)).astype(np.uint8)
    idx, nk = VXLA.depuncture_indices(cr, T)
    _, nk_real = VXLA.depuncture_indices(cr, T_real)
    llr = np.zeros((B, nk), np.float32)
    for b in range(B):
        cs = GB.bcc_encode_punct(data[b], cr)
        llr[b, :len(cs)] = (cs.astype(np.float32) * 2 - 1) * 4.0
    for b in range(B):                       # 2 live-region flips per row
        pos = rng.choice(nk_real - 8, 2, replace=False)
        llr[b, pos] = -llr[b, pos]
    n_real = jnp.full((B,), T_real, jnp.int32)
    out = np.asarray(FD.adaptive_decode(jnp.asarray(llr), cr, T,
                                        fallback=4, n_real=n_real,
                                        win_tiers=(128,)))
    assert np.array_equal(out[:, :T_real], data)
