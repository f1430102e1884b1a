"""cmu_v4 offline analysis: saved VHT-LTF captures -> V feedback -> ZF Q
-> MU waveform file.

Parity tool for ``/root/reference/tools/cmu_v4/cmu_ap_offline.py``: the
post-hoc MU inspection stage of the demo evolution.  Reads each STA's
captured VHT-LTF time samples (``cmu_chan{0,1}.bin``, 128 cf32 = two
GI-stripped LTF symbols for the 2-antenna AP — the exact file format the
reference tool consumes), recomputes the compressed beamforming feedback
the STA would send (Givens compress -> VHT action frame -> parse ->
recover, i.e. the full wire round trip, mirroring the reference's
procVhtVCompress/procVhtVRecover step), builds the ZF spatial matrix Q
from the recovered V columns, and synthesizes the 2-user MU-MIMO A-MPDU
waveform to ``<out>_2x2_*.bin`` files.

``--demo`` synthesizes the two capture files first (random 1x2 channels
applied to the gold NDP's VHT-LTF symbols) so the tool runs self-
contained; point ``--chan0/--chan1`` at real captures (e.g. saved by an
RxEngine NDP export) to analyze a live run.

Usage:
  python tools/cmu_offline.py --demo [--out /tmp/cmu_mu]
  python tools/cmu_offline.py --chan0 c0.bin --chan1 c1.bin
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from gr_ieee80211.spec import tables as T
from gr_ieee80211.spec.params import Fmt, MuConfig, PhyConfig
from gr_ieee80211.gold import mac, rx as grx, sounding, tx as gtx
from gr_ieee80211.utils.io import read_cf32, write_streams


def synthesize_captures(rng, paths):
    """Demo captures: the NDP's 2 VHT-LTF symbols through random 1x2
    channels, stored GI-stripped (the reference capture format)."""
    ndp = gtx.tx_waveform(PhyConfig(Fmt.VHT, 0, 2, 0, ampdu=True), b"",
                          group_id=0, partial_aid=0)
    ltf_start = 640  # L(480) + VHT-SIG-A(160)... recompute: see below
    # locate the VHT-LTF symbols: 160 STF + 160 LTF + 80 LSIG + 160 SIGA
    # + 80 VHT-STF = 640; two 80-sample LTF symbols follow
    h_sta = []
    for u, p in enumerate(paths):
        h = (rng.normal(size=(1, 2)) + 1j * rng.normal(size=(1, 2))
             ) / np.sqrt(2)
        h_sta.append(h)
        rx = np.tensordot(h, ndp, axes=(1, 0))[0]
        sym1 = rx[ltf_start + 16: ltf_start + 80]
        sym2 = rx[ltf_start + 96: ltf_start + 160]
        buf = np.concatenate([sym1, sym2]).astype(np.complex64)
        inter = np.empty(256, np.float32)
        inter[0::2], inter[1::2] = buf.real, buf.imag
        with open(p, "wb") as f:
            inter.tofile(f)
        print(f"demo capture STA{u}: {p} (|h| = {np.abs(h).mean():.3f})")
    return h_sta


def feedback_from_capture(path: str) -> np.ndarray:
    """128-sample LTF capture -> (2, 56) effective channel row (CSD off,
    pilots interpolated) — what the STA derives before compressing."""
    x = read_cf32(path)
    assert len(x) == 128, f"{path}: expected 128 cf32 samples"
    grids = np.stack([np.fft.fftshift(np.fft.fft(x[:64])),
                      np.fft.fftshift(np.fft.fft(x[64:]))])[:, None]
    h = grx.nl_chan_est(grids, 2, Fmt.VHT)                # (1, 2, 64)
    return sounding.feedback_from_ndp(h)[0]               # (2, 56)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--chan0", default="/tmp/cmu_chan0.bin")
    ap.add_argument("--chan1", default="/tmp/cmu_chan1.bin")
    ap.add_argument("--demo", action="store_true",
                    help="synthesize the capture files first")
    ap.add_argument("--out", default="/tmp/cmu_mu")
    ap.add_argument("--mcs", type=int, default=0)
    args = ap.parse_args()
    rng = np.random.default_rng(7)
    if args.demo:
        synthesize_captures(rng, [args.chan0, args.chan1])

    # STA side: V feedback through the compressed-report WIRE round trip
    v_rows = []
    for u, path in enumerate((args.chan0, args.chan1)):
        row = feedback_from_capture(path)                 # (2, 56)
        v56 = (row.conj() / np.linalg.norm(row, axis=0, keepdims=True)
               ).T[:, :, None]                            # (56, 2, 1)
        body = sounding.mgmt_vht_bf_body(v56, [30.0], group=1, codebook=1,
                                         token=23 + u)
        frame = mac.action_no_ack("f4:69:d5:80:0f:a0", "00:c0:ca:b1:5b:e1",
                                  "f4:69:d5:80:0f:a0", 10 + u, 21, body)
        rep = sounding.parse_mgmt_vht_bf(frame[24:-4][1:])
        assert rep["nc"] == 1 and rep["nr"] == 2
        v_rows.append(rep["v56"][:, :, 0].conj().T)       # (2, 56)
        q_err = np.abs(np.abs(np.sum(v_rows[-1].conj() * (row /
                 np.linalg.norm(row, axis=0, keepdims=True)), axis=0)) - 1)
        print(f"STA{u}: compressed V recovered, report {len(body)} B, "
              f"mean quantization alignment error {q_err.mean():.4f}")

    # AP side: ZF Q from the recovered V columns (the reference's
    # bfH/bfQ/bfQNormd sequence), identity on unused bins
    q56 = sounding.zf_q(np.stack(v_rows))
    bfq = sounding.q_to_grid(q56)
    print(f"ZF Q built: per-tone Frobenius norm "
          f"{np.linalg.norm(q56, axis=(1, 2)).mean():.3f} (target sqrt(2))")

    # MU downlink synthesis (reference: genAmpduMu + genFinalSig)
    def mk_ampdu(text: str):
        pay = mac.llc_ip_udp(text.encode(), "10.10.0.6", "10.10.0.1",
                             39379, 8889)
        m = mac.qos_data_frame(pay, "f4:69:d5:80:0f:a0",
                               "00:c0:ca:b1:5b:e1", "f4:69:d5:80:0f:a0",
                               2704)
        return mac.ampdu_aggregate_vht([m])

    a0 = mk_ampdu("1234567 packet for station 000")
    a1 = mk_ampdu("7654321 packet for station 111")
    mu = MuConfig((PhyConfig(Fmt.VHT, args.mcs, 1, len(a0), ampdu=True),
                   PhyConfig(Fmt.VHT, args.mcs, 1, len(a1), ampdu=True)),
                  group_id=2)
    wave = gtx.tx_waveform_mu(mu, [a0, a1], bfq)
    write_streams(args.out, wave)
    print(f"MU waveform: {wave.shape[1]} samples x {wave.shape[0]} streams"
          f" -> {args.out}_2x2_*.bin")


if __name__ == "__main__":
    from gr_ieee80211.utils.device import setup_compile_cache
    setup_compile_cache()
    main()
