"""Gold RX loopback: TX -> impairment channel -> RX -> payload match."""
import numpy as np
import pytest

from gr_ieee80211.spec.params import PhyConfig, Fmt
from gr_ieee80211.gold import tx, rx, mac, channel


def _mpdu(rng, n=200):
    return mac.qos_data_frame(bytes(rng.integers(0, 256, n, dtype=np.uint8)),
                              "02:00:00:00:00:01", "02:00:00:00:00:02",
                              "02:00:00:00:00:01", 1)


def _loop(cfg, payload, rng, snr=35.0, cfo=800.0, h=None, mu_pos=None):
    kw = dict(group_id=0, partial_aid=0) if cfg.fmt == Fmt.VHT else {}
    wave = tx.tx_waveform(cfg, payload, **kw)
    rms = np.sqrt(np.mean(np.abs(wave) ** 2))
    stream = channel.frame_stream(wave, amp=1.0, cfo_hz=cfo, gap=1500)
    if h is not None:
        stream = channel.mimo_channel(stream, h)
    stream = channel.awgn(stream, rms / 10 ** (snr / 20), rng)
    return rx.receive(stream, mu_pos=mu_pos)


CONFIGS = ([(Fmt.L, m, 1) for m in (0, 3, 5, 7)]
           + [(Fmt.HT, m, 1) for m in (0, 4, 7)]
           + [(Fmt.HT, m, 2) for m in (8, 12, 15)]
           + [(Fmt.VHT, m, 1) for m in (0, 4, 8)]
           + [(Fmt.VHT, m, 2) for m in (0, 5, 8)])


@pytest.mark.parametrize("fmt,mcs,nss", CONFIGS)
def test_loopback(fmt, mcs, nss, subtests=None):
    rng = np.random.default_rng(1000 + fmt * 100 + mcs * 4 + nss)
    mpdu = _mpdu(rng)
    h = None
    if nss == 2:
        h = np.eye(2) + 0.3 * (rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2)))
    if fmt == Fmt.VHT:
        payload = mac.ampdu_aggregate_vht([mpdu])
        cfg = PhyConfig(fmt, mcs, nss, len(payload), ampdu=True)
    else:
        payload, cfg = mpdu, PhyConfig(fmt, mcs, nss, len(mpdu))
    pkts = _loop(cfg, payload, rng, h=h)
    assert len(pkts) == 1
    p = pkts[0]
    assert p.ok and p.fmt == fmt and p.mcs == mcs and p.nss == nss
    assert p.mpdus[0] == mpdu
    assert abs(p.cfo_hz - 800.0) < 600


def test_ht_ampdu():
    rng = np.random.default_rng(9)
    m1, m2 = _mpdu(rng, 150), _mpdu(rng, 80)
    payload = mac.ampdu_aggregate_ht([m1, m2])
    cfg = PhyConfig(Fmt.HT, 6, 1, len(payload), ampdu=True)
    pkts = _loop(cfg, payload, rng)
    assert pkts[0].ok and pkts[0].mpdus == [m1, m2]


def test_vht_multi_mpdu_ampdu():
    rng = np.random.default_rng(10)
    m1, m2 = _mpdu(rng, 150), _mpdu(rng, 90)
    payload = mac.ampdu_aggregate_vht([m1, m2])
    cfg = PhyConfig(Fmt.VHT, 5, 1, len(payload), ampdu=True)
    pkts = _loop(cfg, payload, rng)
    assert pkts[0].ok and pkts[0].mpdus == [m1, m2]


def test_ndp_detection_and_channel_export():
    rng = np.random.default_rng(11)
    h = np.eye(2) + 0.3 * (rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2)))
    cfg = PhyConfig(Fmt.VHT, 0, 2, 0, ampdu=True)
    pkts = _loop(cfg, b"", rng, h=h, cfo=300.0)
    p = pkts[0]
    assert p.is_ndp and p.ok
    assert p.ndp_chan.shape == (2, 2, 64)
    # estimate is the air channel up to a common scale and a linear phase ramp
    from gr_ieee80211.spec import tables as T
    K = T.DATA_IDX_NL
    ratio = p.ndp_chan[0, 0, K] / h[0, 0]
    ph = np.unwrap(np.angle(ratio))
    slope, icept = np.polyfit(K - 32.0, ph, 1)
    resid = ph - (slope * (K - 32.0) + icept)
    assert np.abs(resid).max() < 0.2
    mag = np.abs(ratio)
    assert mag.std() / mag.mean() < 0.1


def test_multiple_packets_in_stream():
    rng = np.random.default_rng(12)
    mpdu = _mpdu(rng, 120)
    cfg = PhyConfig(Fmt.L, 3, 1, len(mpdu))
    wave = tx.tx_waveform(cfg, mpdu)
    rms = np.sqrt(np.mean(np.abs(wave) ** 2))
    stream = channel.frame_stream(wave, amp=1.0, cfo_hz=-500.0, num=5, gap=900)
    stream = channel.awgn(stream, rms / 10 ** (30 / 20), rng)
    pkts = rx.receive(stream)
    assert len(pkts) == 5
    assert all(p.ok and p.mpdus[0] == mpdu for p in pkts)


def test_noise_only_no_false_decode():
    rng = np.random.default_rng(13)
    stream = channel.awgn(np.zeros((1, 50000), complex), 0.1, rng)
    pkts = rx.receive(stream)
    assert all(not p.ok for p in pkts)
