"""Spec-layer self-consistency + parity with reference-derived tables."""
import numpy as np

from gr_ieee80211.spec import tables as T
from gr_ieee80211.gold import bits as B


def test_pilot_polarity_matches_reference(golden):
    assert np.array_equal(T.PILOT_POLARITY, golden["pilot_ps"])


def test_vht_eof_bits_match_reference(golden):
    assert np.array_equal(T.VHT_EOF_BITS, golden["vht_eof"])


def test_scramble_seed93_first_bits():
    # seed 93 scrambling of zeros = raw LFSR output; spot-check via round trip
    seq = T.scramble_seq(93, 127)
    assert seq.sum() == 64  # maximal-length sequence property: 64 ones
    z = np.zeros(300, np.uint8)
    s = B.scramble(z, 93)
    out, seed = B.descramble(s)
    assert seed == 93
    assert not out.any()


def test_scramble_roundtrip():
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, 500).astype(np.uint8)
    data = bits.copy()
    data[:7] = 0  # service bits start zero so seed is recoverable
    scr = B.scramble(data, 71)
    out, seed = B.descramble(scr)
    assert seed == 71
    assert np.array_equal(out[7:], data[7:])


def test_bcc_encode_known():
    # all-zero input -> all-zero output; single 1 -> both generator impulse
    assert not B.bcc_encode(np.zeros(10, np.uint8)).any()
    imp = np.zeros(8, np.uint8)
    imp[0] = 1
    coded = B.bcc_encode(imp)
    a, c = coded[0::2], coded[1::2]
    assert np.array_equal(a[:7], T.G0_TAPS)
    assert np.array_equal(c[:7], T.G1_TAPS)


def test_viterbi_hard_decisions_roundtrip():
    rng = np.random.default_rng(1)
    for cr in ("1/2", "2/3", "3/4", "5/6"):
        bits = rng.integers(0, 2, 200).astype(np.uint8)
        bits[-6:] = 0  # tail returns trellis to state 0
        coded = B.bcc_encode_punct(bits, cr)
        llr = (2.0 * coded - 1.0).astype(np.float64)
        pairs = B.depuncture_llr(llr, cr, len(bits))
        dec = B.viterbi_decode(pairs)
        assert np.array_equal(dec, bits), cr


def test_interleave_roundtrip():
    rng = np.random.default_rng(2)
    for nbpscs in (1, 2, 4, 6, 8):
        for legacy in (True, False):
            if legacy and nbpscs == 8:
                continue
            n = (48 if legacy else 52) * nbpscs * 3
            bits = rng.integers(0, 2, n).astype(np.uint8)
            for iss, nss in ((0, 1), (0, 2), (1, 2)):
                inted = B.interleave(bits, nbpscs, legacy, iss, nss)
                assert np.array_equal(
                    B.deinterleave(inted, nbpscs, legacy, iss, nss), bits)


def test_stream_parse_roundtrip():
    rng = np.random.default_rng(3)
    for nbpscs in (1, 2, 4, 6, 8):
        nsym = 4
        ncbps = 52 * nbpscs * 2
        coded = rng.integers(0, 2, ncbps * nsym).astype(np.uint8)
        ss = B.stream_parse(coded, nbpscs, 2, nsym)
        back = B.stream_deparse(ss.astype(np.float32), nbpscs, nsym)
        assert np.array_equal(back.astype(np.uint8), coded)


def test_qam_tables_normalized():
    for nbpscs in (1, 2, 4, 6, 8):
        tab = T.qam_table(nbpscs)
        assert np.isclose(np.mean(np.abs(tab) ** 2), 1.0)
        # gray property: adjacent lattice points differ by one bit
        if nbpscs >= 2:
            m = nbpscs // 2
            lev = np.round(tab.real * T.KMOD[nbpscs]).astype(int)
            for a in range(1 << nbpscs):
                for b in range(a + 1, 1 << nbpscs):
                    if abs(lev[a] - lev[b]) == 2 and tab[a].imag == tab[b].imag:
                        assert bin(a ^ b).count("1") == 1


def test_crc8_reference_vector():
    # CRC8 of 34 zero bits should match the bit-serial reference recursion
    def ref_crc8(bits_in):
        c = [1] * 8
        for b in bits_in:
            nc = [0] * 8
            nc[0] = b ^ c[7]
            nc[1] = b ^ c[7] ^ c[0]
            nc[2] = b ^ c[7] ^ c[1]
            nc[3:8] = c[2:7]
            c = nc
        return [1 - x for x in c[::-1]]

    rng = np.random.default_rng(4)
    for n in (16, 20, 34):
        bits = rng.integers(0, 2, n).tolist()
        assert np.array_equal(T.crc8_bits(bits), ref_crc8(bits))


def test_viterbi_tables_consistent_with_encoder():
    nxt, out = T.viterbi_tables()
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, 50).astype(np.uint8)
    coded = B.bcc_encode(bits)
    s = 0
    for t, b in enumerate(bits):
        o = out[s, b]
        assert (o >> 1) & 1 == coded[2 * t]
        assert o & 1 == coded[2 * t + 1]
        s = nxt[s, b]


def test_viterbi_segmented_matches_monolithic():
    """Opt-in segmented (windowed) decode == monolithic at working SNR."""
    import jax.numpy as jnp
    from gr_ieee80211.ops.viterbi_gpu import viterbi_decode
    from gr_ieee80211.gold import bits as GB
    rng = np.random.default_rng(5)
    B_, T_ = 4, 2200
    msg = rng.integers(0, 2, (B_, T_)).astype(np.uint8)
    msg[:, -6:] = 0
    llr = np.empty((B_, T_, 2), np.float32)
    for i in range(B_):
        enc = GB.bcc_encode(msg[i]).astype(np.float32)
        llr[i] = (2 * enc - 1).reshape(-1, 2)
    llr += rng.normal(size=llr.shape).astype(np.float32) * 0.4
    mono = np.asarray(viterbi_decode(jnp.asarray(llr)))
    seg = np.asarray(viterbi_decode(jnp.asarray(llr), segmented=True))
    assert np.array_equal(mono, seg)
    assert np.array_equal(mono, msg)


def test_segmented_pays_policy():
    """Measured H100 policy: trellises of at least two target segments
    decode segmented at every measured batch; shorter ones, where a
    segment is as long as the trellis, stay monolithic (timings in the
    segmented_pays docstring)."""
    from gr_ieee80211.ops.viterbi_gpu import segmented_pays
    assert segmented_pays(128, 32318)
    assert segmented_pays(128, 2288)
    assert segmented_pays(128, 4420)
    assert segmented_pays(512, 4420)
    assert segmented_pays(2048, 4420)
    assert segmented_pays(4096, 4420)
    assert not segmented_pays(128, 1040)
    assert not segmented_pays(4096, 1040)


def test_fused_sync_cfo_matches_two_step():
    """ltf_fine_sync_cfo == (ltf_fine_sync -> per-row 128 slice ->
    fine_cfo_batch) on noisy packets: same offsets/peaks, CFO within
    float rounding (the round-3 fusion must not change sync behavior)."""
    import jax
    import jax.numpy as jnp
    from gr_ieee80211.ops import frontend as FE
    from gr_ieee80211.ops.cplx import CF, from_host
    from gr_ieee80211.gold import tx as gtx2, mac as gmac, channel
    from gr_ieee80211.spec.params import PhyConfig, Fmt
    rng = np.random.default_rng(17)
    mpdu = gmac.qos_data_frame(b"y" * 60, "02:00:00:00:00:01",
                               "02:00:00:00:00:02", "02:00:00:00:00:01", 1)
    am = gmac.ampdu_aggregate_vht([mpdu])
    cfg = PhyConfig(Fmt.VHT, 4, 1, len(am), ampdu=True)
    wave = channel.apply_cfo(gtx2.tx_waveform(cfg, am)[0], 1234.0)
    B = 8
    stream = np.zeros(B * 3000 + 2000, np.complex64)
    trigs = []
    for i in range(B):
        p = 500 + i * 3000 + int(rng.integers(0, 8))
        stream[p: p + len(wave)] = wave
        trigs.append(p)
    rms = np.sqrt(np.mean(np.abs(wave) ** 2))
    stream = channel.awgn(stream, rms / 10 ** (25 / 20), rng)
    dev = from_host(stream[None])
    tj = jnp.asarray(np.asarray(trigs, np.int32))
    wins = FE.gather_windows_bf16(dev[0], tj, 464)
    cfo0 = FE.coarse_cfo_batch(wins[:, :80])
    off_o, peak_o = FE.ltf_fine_sync(wins[:, 80:448])

    def row128(re, im, o):
        return (jax.lax.dynamic_slice(re, (o,), (128,)),
                jax.lax.dynamic_slice(im, (o,), (128,)))

    lre, lim = jax.vmap(row128)(wins.re, wins.im, 80 + off_o)
    cfo_o = FE.fine_cfo_batch(CF(lre, lim), cfo0)
    off_n, peak_n, cfo_n, _rssi = FE.ltf_fine_sync_cfo(wins[:, 80:448], cfo0)
    assert np.array_equal(np.asarray(off_o), np.asarray(off_n))
    assert np.allclose(np.asarray(peak_o), np.asarray(peak_n))
    assert np.abs(np.asarray(cfo_o) - np.asarray(cfo_n)).max() < 0.01
    assert np.abs(np.asarray(cfo_n) - 1234.0).max() < 2000.0


def test_viterbi_segmented_geometry_traces():
    """Every fallback tier x realistic trellis length must trace: the
    segment windows are whole 512-float rows (K a multiple of 256 steps)."""
    import jax
    import jax.numpy as jnp
    from gr_ieee80211.ops.viterbi_gpu import (
        viterbi_decode, _seg_geometry, SEG_W)
    for B_ in (128, 256, 512, 2048):
        for T_ in (1040, 2288, 4420, 5304, 33000):
            S, K = _seg_geometry(B_, T_)
            assert K % (2 * SEG_W) == 0 and S * K >= T_, (B_, T_, S, K)
            jax.eval_shape(
                lambda x: viterbi_decode(x, segmented=True),
                jax.ShapeDtypeStruct((B_, T_, 2), jnp.float32))


def test_viterbi_pallas_adaptive_lane_tile():
    """Odd batches and trellis lengths decode exactly through the
    platform's decoder (row and step padding are invisible)."""
    import jax.numpy as jnp
    from gr_ieee80211.ops.viterbi_gpu import viterbi_decode
    from gr_ieee80211.gold import bits as GB
    rng = np.random.default_rng(6)
    for B_, T_ in ((5, 200), (130, 100), (200, 391)):
        msg = rng.integers(0, 2, (B_, T_)).astype(np.uint8)
        msg[:, -6:] = 0
        llr = np.empty((B_, T_, 2), np.float32)
        for i in range(B_):
            enc = GB.bcc_encode(msg[i]).astype(np.float32)
            llr[i] = (2 * enc - 1).reshape(-1, 2)
        llr += rng.normal(size=llr.shape).astype(np.float32) * 0.3
        out = np.asarray(viterbi_decode(jnp.asarray(llr)))
        assert np.array_equal(out, msg), (B_, T_)


def test_dense_min_spacing_packets_all_detected():
    """ADVICE round-3 stress: VHT packets at near-minimum spacing (~1000
    samples) produce 2-3 plateau edges each (NL-STF re-fire at +560); a
    4096-sample compaction row then sees more raw edges than _COMPACT_K, so
    without pre-compaction cluster suppression real packet starts are
    silently dropped BEFORE dedup."""
    from gr_ieee80211.spec.params import PhyConfig, Fmt
    from gr_ieee80211.gold import tx as gtx, mac, channel
    from gr_ieee80211.models.rx import RxEngine
    rng = np.random.default_rng(51)
    mpdu = mac.qos_data_frame(b"dense!" * 5, "02:00:00:00:00:01",
                              "02:00:00:00:00:02", "02:00:00:00:00:01", 1)
    am = mac.ampdu_aggregate_vht([mpdu])
    cfg = PhyConfig(Fmt.VHT, 7, 1, len(am), ampdu=True)
    wave = gtx.tx_waveform(cfg, am, group_id=0, partial_aid=0)
    n_pkts = 40
    stream = channel.frame_stream(wave, 1.0, 300.0, num=n_pkts, gap=60)
    rms = np.sqrt(np.mean(np.abs(wave) ** 2))
    stream = channel.awgn(stream, rms / 10 ** (30 / 20), rng)
    eng = RxEngine(nrx=1)
    from gr_ieee80211.ops.cplx import from_host
    trigs = eng.detect(from_host(stream)[0])
    assert len(trigs) == n_pkts, len(trigs)
    res = [r for r in eng.process(stream) if r.ok and r.mpdus[0] == mpdu]
    assert len(res) == n_pkts, len(res)


def test_blocked_gather_matches_numpy():
    """The blocked row-take + shift-cascade gather == plain numpy windows
    for arbitrary (unaligned) starts, f32 and bf16-staged, including
    starts near the stream tail (clip semantics only affect rows whose
    window overruns the stream, which callers valid-mask)."""
    import jax.numpy as jnp
    from gr_ieee80211.ops import frontend as FE
    from gr_ieee80211.ops.cplx import CF
    rng = np.random.default_rng(9)
    N, Bw = 100000, 64
    x = rng.normal(size=N).astype(np.float32)
    y = rng.normal(size=N).astype(np.float32)
    for n in (464, 531, 2116):
        starts = np.concatenate([
            rng.integers(0, N - n - 64, Bw - 4),
            [0, 16, N - n - 1, N - n - 17]]).astype(np.int32)
        cf = CF(jnp.asarray(x), jnp.asarray(y))
        got = FE.gather_windows(cf, jnp.asarray(starts), n)
        exp = np.stack([x[s: s + n] for s in starts])
        assert np.array_equal(np.asarray(got.re), exp), n
        got16 = FE.gather_windows_bf16(cf, jnp.asarray(starts), n)
        err = np.abs(np.asarray(got16.re) - exp)
        assert err.max() < 0.02, (n, err.max())   # bf16 quantization only
