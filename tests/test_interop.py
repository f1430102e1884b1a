"""Stored-capture / cross-implementation interop evidence.

The reference validates against WIME gr-ieee802-11 and a commercial Intel
AX210 capture (tools/performance/perf_wime.py, perf_sisotx.py) — neither
GNU Radio nor radio hardware exists in this environment, so these tests
cover the closest honest substitutes:

* waveforms generated by the REFERENCE'S OWN PY-TB transmitter
  (/root/reference/tools/phy80211.py — independent code, run as an
  oracle subprocess-free import) pass through an independent impairment
  chain and decode on OUR engine (their TX -> our RX, no shared code);
* the reference's SHIPPED hardware channel captures
  (/root/reference/tools/cmu_chan{0,1}.bin, real USRP VHT-LTF
  recordings) produce the same beamforming feedback V through our
  sounding path as through the reference's own processing chain.
"""
import os
import sys

import numpy as np
import pytest

from gr_ieee80211.spec.params import PhyConfig, Fmt
from gr_ieee80211.gold import mac, channel
from gr_ieee80211.models.rx import RxEngine

REF_TOOLS = "/root/reference/tools"
pytestmark = pytest.mark.skipif(not os.path.isdir(REF_TOOLS),
                                reason="reference oracle not mounted")


def _ref_tx(psdu: bytes, fmt, mcs: int, nss: int) -> np.ndarray:
    """Reference PY-TB transmitter -> time-domain waveform (their code)."""
    sys.path.insert(0, REF_TOOLS)
    import phy80211 as p8
    import phy80211header as p8h
    f = {Fmt.L: p8h.F.L, Fmt.HT: p8h.F.HT, Fmt.VHT: p8h.F.VHT}[fmt]
    phy = p8.phy80211(ifDebug=False)
    mod = p8h.modulation(f, mcs, p8h.BW.BW20, nss, False)
    if fmt == Fmt.VHT:                  # reference: VHT A-MPDU only
        phy.genFromAmpdu(psdu, mod, 0, 0)
    else:                               # L / HT single-MPDU path
        phy.genFromMpdu(psdu, mod)
    return np.asarray(phy.ssPhySig[0], np.complex64)


@pytest.mark.parametrize("fmt,mcs,snr_db", [
    (Fmt.L, 3, 22.0), (Fmt.HT, 4, 24.0), (Fmt.VHT, 7, 30.0)])
def test_reference_tx_decodes_on_engine(fmt, mcs, snr_db):
    """Their transmitter, our receiver: the reference PY-TB waveform
    through an independent multipath+CFO+AWGN chain decodes on the
    engine with the original MPDU recovered."""
    rng = np.random.default_rng(mcs)
    payload = bytes(rng.integers(0, 256, 180, dtype=np.uint8))
    mpdu = mac.qos_data_frame(payload, "f4:69:d5:80:0f:a0",
                              "00:c0:ca:b1:5b:e1", "f4:69:d5:80:0f:a0", 3)
    if fmt == Fmt.VHT:
        psdu = mac.ampdu_aggregate_vht([mpdu])
    else:
        psdu = mpdu
    wave = _ref_tx(psdu, fmt, mcs, 1)
    # independent impairments: 2-tap multipath + CFO + AWGN, plain numpy
    taps = np.array([1.0, 0.18 - 0.12j])
    faded = np.convolve(wave, taps)[: len(wave)].astype(np.complex64)
    n = np.arange(len(faded))
    faded = faded * np.exp(2j * np.pi * 950.0 / 20e6 * n)
    stream = np.zeros(3 * (len(faded) + 1200) + 2048, np.complex64)
    for k in range(3):
        s = 1024 + k * (len(faded) + 1200)
        stream[s: s + len(faded)] = faded
    rms = float(np.sqrt(np.mean(np.abs(wave) ** 2)))
    stream += ((rng.normal(size=len(stream))
                + 1j * rng.normal(size=len(stream)))
               * rms / 10 ** (snr_db / 20) / np.sqrt(2)).astype(np.complex64)
    res = [r for r in RxEngine(nrx=1).process(stream)
           if r.ok and r.mpdus and r.mpdus[0] == mpdu]
    assert len(res) == 3, (fmt, mcs, len(res))


def test_shipped_hw_captures_feedback_parity():
    """The reference's REAL USRP channel captures produce the same
    per-tone beamforming direction through our sounding chain as through
    the reference's own feedback processing (phase-invariant alignment
    |<v_ours, v_ref>| ~ 1)."""
    sys.path.insert(0, REF_TOOLS)
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    import phy80211header as p8h
    from cmu_offline import feedback_from_capture
    for u in range(2):
        path = os.path.join(REF_TOOLS, f"cmu_chan{u}.bin")
        row = feedback_from_capture(path)                 # ours: (2, 56)
        # reference's own processing of the same bytes
        raw = np.fromfile(path, np.float32).view(np.complex64)
        ltf = [p8h.procRemovePilots(p8h.procToneDescaling(
                   p8h.procRmDcNonDataSc(
                       p8h.procFftDemod(list(raw[i * 64: (i + 1) * 64])),
                       p8h.F.VHT),
                   p8h.C_SCALENTF_LTF_VHT[p8h.BW.BW20.value], 2))
               for i in range(2)]
        v_ref = p8h.procVhtChannelFeedback(ltf, p8h.BW.BW20, 2, 1)
        vr = np.array([np.asarray(v).reshape(-1) for v in v_ref])  # (56, 2)
        w = np.linalg.norm(vr, axis=1)
        vrn = vr / np.maximum(w, 1e-12)[:, None]
        v_ours = (row / np.linalg.norm(row, axis=0, keepdims=True)
                  ).T                                     # (56, 2)
        align = np.abs(np.sum(v_ours.conj() * vrn, axis=1))
        # energy-weighted: deep-faded tones of the real capture have
        # noise-dominated direction estimates in BOTH chains
        wmean = float(np.sum(w * align) / np.sum(w))
        assert wmean > 0.97 and np.median(align) > 0.98, (u, wmean)
