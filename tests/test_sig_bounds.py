"""Negative tests: CRC-valid but implausible SIG fields must be rejected,
mirroring the reference's plausibility bounds (lib/demod_impl.cc:158-199,
lib/cloud80211phy.cc:730-771)."""
import numpy as np

from gr_ieee80211.spec import tables as T
from gr_ieee80211.spec.params import Fmt, PhyConfig
from gr_ieee80211.gold import sig as S


def _with_crc(body34):
    """Rebuild a 48-bit HT-SIG/VHT-SIG-A word with a fresh CRC8 + tail."""
    bits = list(body34) + list(T.crc8_bits(body34)) + [0] * 6
    return np.array(bits, dtype=np.uint8)


def test_htsig_ess_rejected():
    cfg = PhyConfig(Fmt.HT, 3, 1, 100)
    bits = S.htsig_bits(cfg)
    assert S.parse_htsig(bits).ok
    body = list(bits[:34])
    body[32] = 1                       # extension spatial streams
    assert not S.parse_htsig(_with_crc(body)).ok
    body[32], body[33] = 0, 1
    assert not S.parse_htsig(_with_crc(body)).ok


def test_htsig_stbc_ldpc_rejected():
    cfg = PhyConfig(Fmt.HT, 3, 1, 100)
    for bit in (28, 29, 30):
        body = list(S.htsig_bits(cfg)[:34])
        body[bit] = 1
        assert not S.parse_htsig(_with_crc(body)).ok


def test_vhtsigb_su_reserved_and_tail_validated():
    cfg = PhyConfig(Fmt.VHT, 5, 1, 200, ampdu=True)
    bits, _ = S.vhtsigb_bits(cfg)
    assert S.parse_vhtsigb(bits).ok
    bad = bits.copy()
    bad[18] = 0                        # reserved bits must be all-ones
    assert not S.parse_vhtsigb(bad).ok
    bad = bits.copy()
    bad[22] = 1                        # decoded tail must be zero
    assert not S.parse_vhtsigb(bad).ok


def test_vhtsigb_mu_tail_validated():
    cfg = PhyConfig(Fmt.VHT, 4, 1, 120, ampdu=True)
    bits, _ = S.vhtsigb_bits_mu(cfg)
    assert S.parse_vhtsigb(bits, mu=True).ok
    bad = bits.copy()
    bad[24] = 1
    assert not S.parse_vhtsigb(bad, mu=True).ok


def test_ht_lsig_budget_bound_classifier():
    """models.rx._classify rejects an HT-SIG whose nSym exceeds the L-SIG
    sample budget even though its CRC8 is valid."""
    from gr_ieee80211.models.rx import RxEngine

    eng = RxEngine(nrx=1)
    real = PhyConfig(Fmt.HT, 1, 1, 100)
    lsig = S.parse_lsig(S.lsig_bits(real))
    ok_bits = S.htsig_bits(real)
    cfg, ndp = eng._classify(lsig, ok_bits, np.zeros(48, np.uint8))
    assert cfg is not None and cfg.fmt == Fmt.HT and ndp is None

    # same L-SIG, but HT-SIG announces 4x the length: CRC passes, budget fails
    forged = S.htsig_bits(PhyConfig(Fmt.HT, 1, 1, 400))
    assert S.parse_htsig(forged).ok
    cfg, ndp = eng._classify(lsig, forged, np.zeros(48, np.uint8))
    assert cfg is None and ndp is None


def test_ht_lsig_budget_bound_gold():
    """gold.rx._rx_ht enforces the same budget."""
    from gr_ieee80211.gold import rx as RX

    class _Rx:  # minimal RxPacket stand-in
        ok = False

    real = PhyConfig(Fmt.HT, 1, 1, 100)
    lsig = S.parse_lsig(S.lsig_bits(real))
    htsig = S.parse_htsig(S.htsig_bits(PhyConfig(Fmt.HT, 1, 1, 400)))
    assert htsig.ok
    xs = np.zeros((1, 8000), dtype=np.complex128)
    rx = RX._rx_ht(xs, lsig, htsig, RX.RxPacket(False))
    assert not rx.ok
