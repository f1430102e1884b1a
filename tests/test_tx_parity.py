"""Gold TX waveform parity against reference PY-TB golden vectors."""
import numpy as np
import pytest

from gr_ieee80211.spec.params import PhyConfig, Fmt, MuConfig
from gr_ieee80211.gold import tx as gtx

TOL = 2e-7  # golden vectors stored as complex64


def _cfg_from_meta(meta, n_payload):
    fmt, mcs, nss, ampdu = (int(x) for x in meta)
    return PhyConfig(Fmt(fmt), mcs, nss, n_payload, ampdu=bool(ampdu))


def test_all_su_waveforms(golden):
    names = [str(n) for n in golden["names"]]
    for name in names:
        ref = golden[f"{name}_sig"]
        payload = golden[f"{name}_payload"].tobytes()
        cfg = _cfg_from_meta(golden[f"{name}_meta"], len(payload))
        kw = {}
        if cfg.fmt == Fmt.VHT:
            kw = dict(group_id=0, partial_aid=0)
        mine = gtx.tx_waveform(cfg, payload, **kw)
        assert mine.shape == ref.shape, name
        assert np.abs(mine - ref).max() < TOL, name


def test_mu_waveform(golden):
    ref = golden["mu_sig"]
    q = golden["mu_q"].astype(np.complex128)
    p0 = golden["mu_payload0"].tobytes()
    p1 = golden["mu_payload1"].tobytes()
    mcs0, mcs1, _, _, gid = (int(x) for x in golden["mu_meta"])
    mu = MuConfig((PhyConfig(Fmt.VHT, mcs0, 1, len(p0), ampdu=True),
                   PhyConfig(Fmt.VHT, mcs1, 1, len(p1), ampdu=True)), group_id=gid)
    mine = gtx.tx_waveform_mu(mu, [p0, p1], q)
    assert mine.shape == ref.shape
    assert np.abs(mine - ref).max() < 1e-5  # random Q amplifies fp32 storage error


def test_nsamples_property(golden):
    names = [str(n) for n in golden["names"]]
    for name in names:
        payload = golden[f"{name}_payload"].tobytes()
        cfg = _cfg_from_meta(golden[f"{name}_meta"], len(payload))
        assert cfg.n_samples == golden[f"{name}_sig"].shape[-1], name
