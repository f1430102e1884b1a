"""Jitted TX/RX engine parity vs the gold model (CPU backend)."""
import numpy as np
import pytest

from gr_ieee80211.spec.params import PhyConfig, Fmt
from gr_ieee80211.gold import tx as gtx, mac, channel
from gr_ieee80211.models.tx import TxEngine
from gr_ieee80211.models.rx import RxEngine, dedup_triggers


CONFIGS = [(Fmt.L, 0, 1), (Fmt.L, 7, 1), (Fmt.HT, 4, 1), (Fmt.HT, 12, 2),
           (Fmt.VHT, 8, 1), (Fmt.VHT, 5, 2)]


def _mk(rng, fmt, mcs, nss, n=120):
    mpdu = mac.qos_data_frame(bytes(rng.integers(0, 256, n, dtype=np.uint8)),
                              "02:00:00:00:00:01", "02:00:00:00:00:02",
                              "02:00:00:00:00:01", 1)
    if fmt == Fmt.VHT:
        payload = mac.ampdu_aggregate_vht([mpdu])
        return mpdu, payload, PhyConfig(fmt, mcs, nss, len(payload), ampdu=True)
    return mpdu, mpdu, PhyConfig(fmt, mcs, nss, len(mpdu))


@pytest.mark.parametrize("fmt,mcs,nss", CONFIGS)
def test_tx_engine_matches_gold(fmt, mcs, nss):
    rng = np.random.default_rng(17)
    _, payload, cfg = _mk(rng, fmt, mcs, nss)
    batch = TxEngine().tx(cfg, [payload] * 3)
    gold = gtx.tx_waveform(cfg, payload, **(
        dict(group_id=0, partial_aid=0) if fmt == Fmt.VHT else {}))
    assert batch.shape == (3,) + gold.shape
    assert np.abs(batch - gold).max() < 2e-6


@pytest.mark.parametrize("mcs,snr_set", [(2, 14.0), (4, 22.0)])
def test_rx_engine_snr_rssi_metadata(mcs, snr_set):
    """Device per-packet SNR/RSSI/sssnr0 vs gold and the injected AWGN level
    (the reference's sync-tag metadata, lib/sync_impl.cc:124-136)."""
    from gr_ieee80211.gold import rx as grx
    rng = np.random.default_rng(101)
    mpdu, payload, cfg = _mk(rng, Fmt.VHT, mcs, 1)
    wave = gtx.tx_waveform(cfg, payload, group_id=0, partial_aid=0)
    rms = np.sqrt(np.mean(np.abs(wave) ** 2))
    stream = channel.frame_stream(wave, 1.0, 650.0, num=4, gap=1100)
    sigma = rms / 10 ** (snr_set / 20)
    stream = channel.awgn(stream, sigma, rng)
    res = [r for r in RxEngine(nrx=1).process(stream) if r.ok]
    gold = [p for p in grx.receive(stream) if p.ok]
    assert len(res) == 4 and len(gold) == 4
    for r, g in zip(res, gold):
        # device vs gold sync-SNR within 1 dB (both estimate from the same
        # autocorr peak; windows/precision differ slightly)
        assert abs(r.snr_db - g.snr_db) < 1.0, (r.snr_db, g.snr_db)
        # vs injected level: the ac-peak estimator is biased low at high SNR
        # (timing jitter) — allow 3 dB
        assert abs(r.snr_db - snr_set) < 3.0, (r.snr_db, snr_set)
        assert abs(r.rssi / g.rssi - 1.0) < 0.3, (r.rssi, g.rssi)
        # windowed LTF power ~ signal power + noise power
        exp_p = rms ** 2 + sigma ** 2
        assert abs(r.rssi / exp_p - 1.0) < 0.5, (r.rssi, exp_p)
        # SIG-B re-encode SNR present for SISO VHT; it reads ~3 dB low at
        # moderate SNR (the 1-LTF channel-estimate noise doubles the
        # residual — the reference's estimator shares this bias)
        assert r.sssnr0 is not None
        assert -6.0 < r.sssnr0 - snr_set < 2.0, (r.sssnr0, snr_set)


def test_rx_engine_bf16_ingest_loopback():
    """ingest_bf16=True (half the transport bytes) decodes identically at
    working SNR."""
    rng = np.random.default_rng(61)
    mpdu, payload, cfg = _mk(rng, Fmt.VHT, 7, 1)
    wave = gtx.tx_waveform(cfg, payload, group_id=0, partial_aid=0)
    rms = np.sqrt(np.mean(np.abs(wave) ** 2))
    stream = channel.frame_stream(wave, 1.0, 650.0, num=4, gap=1100)
    stream = channel.awgn(stream, rms / 10 ** (30 / 20), rng)
    res = [r for r in RxEngine(nrx=1, ingest_bf16=True).process(stream)
           if r.ok and r.mpdus[0] == mpdu]
    assert len(res) == 4


def test_tx_engine_mu_matches_gold():
    """Device-batched MU TX (tx_batch_mu) vs the gold MU waveform."""
    from gr_ieee80211.spec.params import MuConfig
    from gr_ieee80211.models.tx import TxEngine
    rng = np.random.default_rng(41)
    _, a0, _ = _mk(rng, Fmt.VHT, 4, 1, n=100)
    _, a1, _ = _mk(rng, Fmt.VHT, 2, 1, n=57)
    mu = MuConfig((PhyConfig(Fmt.VHT, 4, 1, len(a0), ampdu=True),
                   PhyConfig(Fmt.VHT, 2, 1, len(a1), ampdu=True)),
                  group_id=2)
    q = (rng.normal(size=(64, 2, 2)) + 1j * rng.normal(size=(64, 2, 2)))
    q /= np.sqrt(2)
    gold = gtx.tx_waveform_mu(mu, [a0, a1], q)
    dev = TxEngine().tx_mu(mu, [[a0] * 3, [a1] * 3], q)
    assert dev.shape == (3,) + gold.shape
    assert np.abs(dev - gold[None]).max() < 2e-5


@pytest.mark.parametrize("fmt,mcs,nss", CONFIGS)
def test_rx_engine_loopback(fmt, mcs, nss):
    rng = np.random.default_rng(23 + mcs)
    mpdu, payload, cfg = _mk(rng, fmt, mcs, nss)
    wave = gtx.tx_waveform(cfg, payload, **(
        dict(group_id=0, partial_aid=0) if fmt == Fmt.VHT else {}))
    rms = np.sqrt(np.mean(np.abs(wave) ** 2))
    h = None
    if nss == 2:
        h = np.eye(2) + 0.3 * (rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2)))
    stream = channel.frame_stream(wave, 1.0, 650.0, num=3, gap=1100)
    if h is not None:
        stream = channel.mimo_channel(stream, h)
    stream = channel.awgn(stream, rms / 10 ** (35 / 20), rng)
    eng = RxEngine(nrx=stream.shape[0])
    res = eng.process(stream)
    good = [r for r in res if r.ok and r.mpdus and r.mpdus[0] == mpdu]
    assert len(good) == 3
    assert all(r.fmt == fmt and r.mcs == mcs for r in good)


def test_rx_engine_mixed_formats_one_stream():
    rng = np.random.default_rng(31)
    parts = []
    sent = []
    for fmt, mcs, nss in [(Fmt.L, 3, 1), (Fmt.VHT, 4, 1), (Fmt.HT, 6, 1)]:
        mpdu, payload, cfg = _mk(rng, fmt, mcs, nss, n=90)
        wave = gtx.tx_waveform(cfg, payload, **(
            dict(group_id=0, partial_aid=0) if fmt == Fmt.VHT else {}))
        parts.append(channel.frame_stream(wave, 1.0, 300.0, gap=900)[0])
        sent.append((fmt, mcs, mpdu))
    stream = np.concatenate(parts)
    rms = np.sqrt(np.mean(np.abs(stream[np.abs(stream) > 0]) ** 2))
    stream = channel.awgn(stream[None], rms / 10 ** (35 / 20), rng)
    res = RxEngine(nrx=1).process(stream)
    got = [(r.fmt, r.mcs, r.mpdus[0]) for r in res if r.ok and r.mpdus]
    assert got == sent


def test_dedup_triggers():
    c = np.array([100, 160, 660, 3000, 3560, 9000])
    assert dedup_triggers(c).tolist() == [100, 3000, 9000]
    assert dedup_triggers(np.array([], dtype=np.int64)).tolist() == []


def test_tx_engine_random_seeds_decode():
    rng = np.random.default_rng(41)
    mpdu, payload, cfg = _mk(rng, Fmt.VHT, 3, 1)
    seeds = [11, 93, 127]
    batch = TxEngine().tx(cfg, [payload] * 3, seeds=seeds)
    stream = channel.frame_stream(batch[1], 1.0, 0.0, gap=1000)
    res = RxEngine(nrx=1).process(stream)
    assert res and res[0].ok and res[0].mpdus[0] == mpdu


def test_dedup_triggers_device_matches_host():
    import jax.numpy as jnp
    from gr_ieee80211.ops.frontend import dedup_triggers_device
    c = np.array([100, 160, 660, 3000, 3560, 9000, -1, -1], dtype=np.int32)
    out = np.asarray(dedup_triggers_device(jnp.asarray(c), 5))
    assert out.tolist() == [100, 3000, 9000, -1, -1]


def test_rx_chain_count_fused():
    """Single-dispatch detect->sync->decode counting (the bench hot path)."""
    from gr_ieee80211.models.rx import rx_chain_count
    from gr_ieee80211.ops.cplx import from_host
    rng = np.random.default_rng(53)
    mpdu, payload, cfg = _mk(rng, Fmt.VHT, 7, 1)
    wave = gtx.tx_waveform(cfg, payload, group_id=0, partial_aid=0)
    stream = channel.frame_stream(wave[0], 1.0, 900.0, num=5, gap=500)
    rms = np.sqrt(np.mean(np.abs(wave) ** 2))
    stream = channel.awgn(stream, rms / 10 ** (32 / 20), rng)
    n_ok, n_det = rx_chain_count(cfg, from_host(stream), nrx=1,
                                 mpdu_len=len(mpdu), max_pkts=8)
    assert int(n_det) == 5 and int(n_ok) == 5


def test_rx_chain_count_chunked_matches():
    """chunk= decodes the synced batch in lax.scan chunks INSIDE the one
    program (bounds the Viterbi decision-plane memory for long trellises);
    counts must match the unchunked program exactly."""
    from gr_ieee80211.models.rx import rx_chain_count
    from gr_ieee80211.ops.cplx import from_host
    rng = np.random.default_rng(53)
    mpdu, payload, cfg = _mk(rng, Fmt.VHT, 7, 1)
    wave = gtx.tx_waveform(cfg, payload, group_id=0, partial_aid=0)
    stream = channel.frame_stream(wave[0], 1.0, 900.0, num=5, gap=500)
    rms = np.sqrt(np.mean(np.abs(wave) ** 2))
    stream = channel.awgn(stream, rms / 10 ** (32 / 20), rng)
    dev = from_host(stream)
    ref = tuple(int(x) for x in rx_chain_count(
        cfg, dev, nrx=1, mpdu_len=len(mpdu), max_pkts=8))
    chunked = tuple(int(x) for x in rx_chain_count(
        cfg, dev, nrx=1, mpdu_len=len(mpdu), max_pkts=8, chunk=4))
    assert chunked == ref == (5, 5)


def test_rx_engine_multi_mpdu_ampdu():
    """3-MPDU VHT A-MPDU: delimiter walk recovers every subframe."""
    rng = np.random.default_rng(61)
    mpdus = [mac.qos_data_frame(bytes(rng.integers(0, 256, 40 + 30 * k,
                                                   dtype=np.uint8)),
                                "02:00:00:00:00:01", "02:00:00:00:00:02",
                                "02:00:00:00:00:01", k) for k in range(3)]
    am = mac.ampdu_aggregate_vht(mpdus)
    cfg = PhyConfig(Fmt.VHT, 5, 1, len(am), ampdu=True)
    wave = gtx.tx_waveform(cfg, am, group_id=0, partial_aid=0)[0]
    rms = np.sqrt(np.mean(np.abs(wave) ** 2))
    stream = channel.frame_stream(wave, 1.0, 400.0, num=2, gap=1000)
    stream = channel.awgn(stream, rms / 10 ** (32 / 20), rng)
    res = [r for r in RxEngine(nrx=1).process(stream) if r.ok]
    assert len(res) == 2
    assert all(r.mpdus == mpdus for r in res)


def test_rx_engine_rx_diversity_1ss_2rx():
    """1 spatial stream received on 2 antennas (MRC via the general ZF)."""
    rng = np.random.default_rng(67)
    mpdu, payload, cfg = _mk(rng, Fmt.VHT, 6, 1)
    wave = gtx.tx_waveform(cfg, payload, group_id=0, partial_aid=0)
    h = (rng.normal(size=(2, 1)) + 1j * rng.normal(size=(2, 1))) / np.sqrt(2)
    stream = channel.frame_stream(wave, 1.0, 500.0, num=3, gap=1100)
    stream = channel.mimo_channel(stream, h)
    rms = np.sqrt(np.mean(np.abs(stream[np.abs(stream) > 0]) ** 2))
    stream = channel.awgn(stream, rms / 10 ** (28 / 20), rng)
    res = [r for r in RxEngine(nrx=2).process(stream)
           if r.ok and r.mpdus and r.mpdus[0] == mpdu]
    assert len(res) == 3


def test_rx_engine_multi_mpdu_ampdu_ht():
    """3-MPDU HT A-MPDU through the jitted engine path: the HT delimiter
    walk (4-byte delimiters, no EOF padding subframes) recovers every
    subframe (reference walk: lib/decode_impl.cc:325-427)."""
    rng = np.random.default_rng(62)
    mpdus = [mac.qos_data_frame(bytes(rng.integers(0, 256, 36 + 24 * k,
                                                   dtype=np.uint8)),
                                "02:00:00:00:00:01", "02:00:00:00:00:02",
                                "02:00:00:00:00:01", k) for k in range(3)]
    am = mac.ampdu_aggregate_ht(mpdus)
    cfg = PhyConfig(Fmt.HT, 4, 1, len(am), ampdu=True)
    wave = gtx.tx_waveform(cfg, am)[0]
    rms = np.sqrt(np.mean(np.abs(wave) ** 2))
    stream = channel.frame_stream(wave, 1.0, 400.0, num=2, gap=1000)
    stream = channel.awgn(stream, rms / 10 ** (32 / 20), rng)
    res = [r for r in RxEngine(nrx=1).process(stream) if r.ok]
    assert len(res) == 2
    assert all(r.mpdus == mpdus for r in res)


def test_rx_engine_i8_ingest_loopback():
    """int8 block-AGC ingest (~41 dB SQNR, quarter transport bytes)
    decodes the loopback stream like the f32 path."""
    rng = np.random.default_rng(77)
    mpdu, payload, cfg = _mk(rng, Fmt.VHT, 7, 1)
    wave = gtx.tx_waveform(cfg, payload, group_id=0, partial_aid=0)
    stream = channel.frame_stream(wave, 1.0, 500.0, num=4, gap=1100)
    rms = np.sqrt(np.mean(np.abs(wave) ** 2))
    stream = channel.awgn(stream, rms / 10 ** (30 / 20), rng)
    res = [r for r in RxEngine(nrx=1, ingest="i8").process(stream)
           if r.ok and r.mpdus and r.mpdus[0] == mpdu]
    assert len(res) == 4


def test_rx_engine_speculative_one_crossing():
    """Homogeneous traffic arms the one-crossing speculation; the next
    block decodes through the fused _spec_core program with identical
    results, and a config change falls back to the bucket path."""
    rng = np.random.default_rng(91)
    mpdu7, pay7, cfg7 = _mk(rng, Fmt.VHT, 7, 1)
    mpdu4, pay4, cfg4 = _mk(rng, Fmt.VHT, 4, 1, n=90)
    def blk(pay, cfg):
        wave = gtx.tx_waveform(cfg, pay, group_id=0, partial_aid=0)
        s = channel.frame_stream(wave, 1.0, 450.0, num=3, gap=1100)
        rms = np.sqrt(np.mean(np.abs(wave) ** 2))
        return channel.awgn(s, rms / 10 ** (30 / 20), rng)
    eng = RxEngine(nrx=1)
    assert eng._spec_canon is None
    r1 = eng.finish_process(eng.begin_process(blk(pay7, cfg7)))
    assert eng._spec_canon is not None            # armed
    spec = eng._spec_canon
    r2 = eng.finish_process(eng.begin_process(blk(pay7, cfg7)))   # spec hit
    assert eng._spec_canon == spec
    # config change: speculation misses, bucket path decodes anyway
    r3 = eng.finish_process(eng.begin_process(blk(pay4, cfg4)))
    for res, m in ((r1, mpdu7), (r2, mpdu7), (r3, mpdu4)):
        good = [r for r in res if r.ok and r.mpdus and r.mpdus[0] == m]
        assert len(good) == 3
