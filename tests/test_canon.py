"""Bucket-shape canonicalization: many payload lengths -> few compiled
programs, decode bit-identical to the exact-shape path."""
import numpy as np

from gr_ieee80211.spec.params import PhyConfig, Fmt
from gr_ieee80211.gold import tx, mac, channel
from gr_ieee80211.models.rx import RxEngine, canonical_cfg


def test_ladder_collapses_shapes():
    lens = list(range(40, 600, 7))
    exact = {PhyConfig(Fmt.VHT, 7, 1, n, ampdu=True) for n in lens}
    canon = {canonical_cfg(PhyConfig(Fmt.VHT, 7, 1, n, ampdu=True))
             for n in lens}
    # 80 distinct lengths collapse onto the ladder rungs (the low rungs are
    # deliberately dense: small shapes, cheap compiles)
    assert len(canon) <= 12 < len(exact)
    for n in lens:
        cfg = PhyConfig(Fmt.VHT, 7, 1, n, ampdu=True)
        c = canonical_cfg(cfg)
        assert c.nsym >= cfg.nsym and c.psdu_len >= cfg.psdu_len
        assert (c.fmt, c.mcs, c.nss, c.ampdu) == \
            (cfg.fmt, cfg.mcs, cfg.nss, cfg.ampdu)
        # exact hit or >= 96 trellis steps of survivor-merge margin
        assert c.nsym == cfg.nsym or \
            (c.nsym - cfg.nsym) * cfg.ndbps >= 96


def test_near_cap_falls_back_exact():
    cfg = PhyConfig(Fmt.VHT, 0, 1, 4060, ampdu=True)
    c = canonical_cfg(cfg)
    assert c.psdu_len >= cfg.psdu_len


def test_mixed_lengths_one_bucket_decode():
    rng = np.random.default_rng(21)
    parts = [np.zeros(400, np.complex64)]
    mpdus = []
    for k, plen in enumerate((60, 75, 92, 120, 133)):
        body = bytes([k]) * plen
        mpdu = mac.qos_data_frame(body, "f4:69:d5:80:0f:a0",
                                  "00:c0:ca:b1:5b:e1",
                                  "f4:69:d5:80:0f:a0", 3)
        am = mac.ampdu_aggregate_vht([mpdu])
        cfg = PhyConfig(Fmt.VHT, 4, 1, len(am), ampdu=True)
        w = tx.tx_waveform(cfg, am, group_id=0, partial_aid=0)[0]
        parts += [channel.apply_cfo(w, 300.0).astype(np.complex64),
                  np.zeros(300, np.complex64)]
        mpdus.append(mpdu)
    stream = np.concatenate(parts)
    stream = channel.awgn(stream, 0.02 / 10 ** (30 / 20), rng)
    # all five lengths canonicalize onto at most two programs
    cfgs = {canonical_cfg(PhyConfig(Fmt.VHT, 4, 1,
                                    len(mac.ampdu_aggregate_vht([m])),
                                    ampdu=True)) for m in mpdus}
    assert len(cfgs) <= 3
    res = RxEngine(nrx=1).process(stream * 5.0)
    ok = [r for r in res if r.ok]
    assert len(ok) == len(mpdus)
    got = {r.mpdus[0] for r in ok}
    assert got == set(mpdus)
