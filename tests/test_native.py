"""Native host runtime (C++ lib) parity with the python gold paths."""
import numpy as np
import pytest

from gr_ieee80211.runtime import native as N
from gr_ieee80211.gold import mac, bits as B, tx as gtx, channel
from gr_ieee80211.spec.params import PhyConfig, Fmt

pytestmark = pytest.mark.skipif(not N.available(), reason="no native toolchain")


def test_crc32_fcs():
    rng = np.random.default_rng(0)
    for n in (10, 64, 333, 4000):
        frame = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        good = frame + B.fcs32(frame)
        assert N.fcs_ok(good)
        assert N.fcs_ok(good) == B.fcs_ok(good)
        bad = bytearray(good)
        bad[3] ^= 1
        assert not N.fcs_ok(bytes(bad))


def test_deagg_vht_matches_python():
    rng = np.random.default_rng(1)
    m1 = mac.qos_data_frame(bytes(rng.integers(0, 256, 150, dtype=np.uint8)),
                            "02:00:00:00:00:01", "02:00:00:00:00:02",
                            "02:00:00:00:00:01", 1)
    m2 = mac.qos_data_frame(bytes(rng.integers(0, 256, 60, dtype=np.uint8)),
                            "02:00:00:00:00:01", "02:00:00:00:00:02",
                            "02:00:00:00:00:01", 2)
    psdu = mac.ampdu_aggregate_vht([m1, m2])
    from gr_ieee80211.spec import tables as T
    psdu += T.bits_to_bytes(T.VHT_EOF_BITS) * 2
    assert N.deagg_vht(psdu) == mac.ampdu_deaggregate(psdu) == [m1, m2]


def test_stf_detect_matches_gold():
    rng = np.random.default_rng(2)
    cfg = PhyConfig(Fmt.L, 0, 1, 100)
    wave = gtx.tx_waveform(cfg, bytes(100))
    rms = np.sqrt(np.mean(np.abs(wave) ** 2))
    stream = channel.frame_stream(wave, 1.0, 0.0, num=4, gap=2000)
    stream = channel.awgn(stream, rms / 10 ** (30 / 20), rng)[0]
    idx = N.stf_detect(stream.astype(np.complex64))
    assert len(idx) == 4
    # triggers land just before each STF (gap 2000 + preamble)
    expect = 2000 + np.arange(4) * (2000 + len(wave[0]))
    assert np.all(np.abs(idx - expect) < 64)


def test_iq_ring_overlap_save():
    rb = N.IqRing(1 << 14)
    x = (np.arange(6000) + 1j * np.arange(6000)).astype(np.complex64)
    assert rb.write(x[:5000]) == 5000
    blk = rb.read_block(4096, halo=512)
    assert blk is not None and len(blk) == 4608
    assert np.array_equal(blk, x[:4608])
    # read pointer advanced by n, not n+halo: next block re-covers the halo
    assert rb.read_block(4096, halo=512) is None  # only 904 left
    rb.write(x[5000:])
    blk2 = rb.read_block(1024, halo=128)
    assert np.array_equal(blk2, x[4096: 4096 + 1152])
    rb.close()
