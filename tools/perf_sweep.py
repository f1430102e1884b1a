"""PER-vs-SNR sweep — the reference evaluation protocol on the batched engine.

Mirrors ``/root/reference/tools/performance/perf_siso.py``: per MCS, N
packets of 500 B payload, AWGN calibrated against the signal RMS, SNR swept
0..30 dB; PER = fraction of packets whose MPDU fails FCS.  Instead of
spawning a GNU Radio flowgraph per SNR point and grepping its stdout, ALL
SNR points of one MCS are laid out on a single IQ timeline (N packets per
SNR segment) and decoded by the full fused chain — trigger detection, LTF
sync, CFO, demod, Viterbi, FCS — in ONE device dispatch; a missed trigger
counts as a lost packet exactly as in the reference harness.

Usage:
  python tools/perf_sweep.py [--formats L HT VHT] [--n 100] \
      [--snrs 0 31 1] [--payload 500] [--out per_results.json] [--cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def run_mu_sweep(args, snrs, rng):
    """2-user MU downlink PER-vs-SNR for STA position 0.

    Protocol mirror of the SISO sweep on the cmu_v3 operating loop: fixed
    per-STA 1x2 channels, ZF Q from the (noise-free) channel rows, both
    users at the swept MCS, device-batched MU TX (models.tx.tx_batch_mu),
    per-SNR AWGN segments on one timeline, STA0's fused MU chain
    (detect -> SIG-B CRC/MCS gate -> own-column decode -> FCS) in one
    dispatch; PER counts missed triggers as lost like the reference."""
    import numpy as np
    from gr_ieee80211.spec.params import PhyConfig, Fmt, MuConfig
    from gr_ieee80211.gold import mac, channel, sounding
    from gr_ieee80211.models import rx as RXM
    from gr_ieee80211.models.tx import TxEngine
    from gr_ieee80211.ops.cplx import from_host
    import json
    import time

    h_sta = [(rng.normal(size=(1, 2)) + 1j * rng.normal(size=(1, 2)))
             / np.sqrt(2) for _ in range(2)]
    h_rows = np.repeat(np.stack(h_sta)[:, 0][:, :, None], 56, axis=2)
    bfq = sounding.q_to_grid(sounding.zf_q(h_rows))
    results = {}
    eng = TxEngine()
    for mcs in (args.mcs or range(9)):
        payload = bytes(rng.integers(0, 256, args.payload, dtype=np.uint8))
        mpdu = mac.qos_data_frame(payload, "f4:69:d5:80:0f:a0",
                                  "00:c0:ca:b1:5b:e1",
                                  "f4:69:d5:80:0f:a0", 7)
        psdu0 = mac.ampdu_aggregate_vht([mpdu])
        mpdu1 = mac.qos_data_frame(payload[:300], "02:00:00:00:00:11",
                                   "00:c0:ca:b1:5b:e1",
                                   "02:00:00:00:00:11", 8)
        psdu1 = mac.ampdu_aggregate_vht([mpdu1])
        mu = MuConfig((PhyConfig(Fmt.VHT, mcs, 1, len(psdu0), ampdu=True),
                       PhyConfig(Fmt.VHT, mcs, 1, len(psdu1), ampdu=True)),
                      group_id=2)
        t0 = time.time()
        wave2 = eng.tx_mu(mu, [[psdu0], [psdu1]], bfq)[0]   # (2, n)
        wave = (h_sta[0] @ wave2)                           # STA0 sees (1, n)
        wave = channel.apply_cfo(wave[0], 800.0).astype(np.complex64)
        rms = float(np.sqrt(np.mean(np.abs(wave) ** 2)))
        nsnr = len(snrs)
        spacing = len(wave) + 400
        seg = args.n * spacing + 1024
        stream = np.empty(nsnr * seg, np.complex64)
        for s, snr in enumerate(snrs):
            namp = rms / 10 ** (snr / 20)
            block = (rng.normal(size=seg) + 1j * rng.normal(size=seg)
                     ).astype(np.complex64) * (namp / np.sqrt(2))
            for i in range(args.n):
                o = 512 + i * spacing
                block[o: o + len(wave)] += wave
            stream[s * seg: (s + 1) * seg] = block
        u0 = mu.users[0]
        cfg = PhyConfig(Fmt.VHT, mcs, 1, u0.psdu_len, ampdu=True,
                        mu_nsym=mu.nsym)
        max_pkts = -(-(nsnr * args.n * 5) // (4 * 128)) * 128
        ok, ltf_idx, valid = (np.asarray(x) for x in RXM.rx_chain_ok_mu(
            cfg, from_host(stream[None]), n_total=2, own=0, nrx=1,
            mpdu_len=len(mpdu), max_pkts=max_pkts))
        ok_slot = np.zeros(nsnr * args.n, bool)
        for j in range(max_pkts):
            if not (valid[j] and ok[j]):
                continue
            s, rem = divmod(int(ltf_idx[j]), seg)
            i = (rem - 512) // spacing
            if 0 <= i < args.n and abs(rem - 512 - i * spacing - 186) < 300:
                ok_slot[s * args.n + i] = True
        pers = [1.0 - ok_slot[s * args.n:(s + 1) * args.n].mean()
                for s in range(nsnr)]
        results[f"MU_mcs{mcs}_sta0"] = {
            "snr_db": snrs.tolist(), "per": pers,
            "payload": args.payload, "n": args.n, "users": 2}
        print(f"MU mcs{mcs}: {time.time()-t0:.1f}s  "
              + " ".join(f"{p:.2f}" for p in pers), file=sys.stderr)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(json.dumps({"points": sum(len(v["per"]) for v in results.values()),
                      "out": args.out}))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--formats", nargs="+", default=["L", "HT", "VHT"])
    ap.add_argument("--mcs", nargs="+", type=int, default=None)
    ap.add_argument("--n", type=int, default=100)
    ap.add_argument("--snrs", nargs=3, type=float, default=[0, 31, 1])
    ap.add_argument("--payload", type=int, default=500)
    ap.add_argument("--nss", type=int, default=1, choices=(1, 2),
                    help="2 = SU-MIMO sweep (perf_sumimo parity): HT mcs8-15"
                         " / VHT 2SS through a mildly coupled 2x2 channel")
    ap.add_argument("--mu", action="store_true",
                    help="2-user MU-MIMO downlink sweep: device tx_batch_mu"
                         " with ZF Q from the per-STA channels, STA0 decodes"
                         " its own stream via rx_chain_ok_mu (cmu_v3's"
                         " operating loop swept over MCS/SNR)")
    ap.add_argument("--out", default="per_results.json")
    args = ap.parse_args()
    from gr_ieee80211.utils.device import setup_compile_cache
    setup_compile_cache()

    import numpy as np
    import jax.numpy as jnp
    from gr_ieee80211.spec.params import PhyConfig, Fmt
    from gr_ieee80211.gold import tx as gtx, mac, channel
    from gr_ieee80211.models import rx as RXM
    from gr_ieee80211.ops.cplx import from_host

    rng = np.random.default_rng(2026)
    snrs = np.arange(*args.snrs)
    if args.mu:
        run_mu_sweep(args, snrs, rng)
        return
    if args.nss == 2:
        mcs_by_fmt = {"HT": range(8, 16), "VHT": range(9)}
        if args.formats == ["L", "HT", "VHT"]:
            args.formats = ["HT", "VHT"]
    else:
        mcs_by_fmt = {"L": range(8), "HT": range(8), "VHT": range(9)}
    results = {}

    for fname in args.formats:
        fmt = Fmt[fname]
        for mcs in (args.mcs or mcs_by_fmt[fname]):
            payload = bytes(rng.integers(0, 256, args.payload, dtype=np.uint8))
            mpdu = mac.qos_data_frame(payload, "f4:69:d5:80:0f:a0",
                                      "00:c0:ca:b1:5b:e1",
                                      "f4:69:d5:80:0f:a0", 7)
            if fmt == Fmt.VHT:
                psdu = mac.ampdu_aggregate_vht([mpdu])
                cfg = PhyConfig(fmt, mcs, args.nss, len(psdu), ampdu=True)
            else:
                psdu = mpdu
                cfg = PhyConfig(fmt, mcs, args.nss, len(psdu))
            kw = dict(group_id=0, partial_aid=0) if fmt == Fmt.VHT else {}
            wave = gtx.tx_waveform(cfg, psdu, **kw)   # (nss, n)
            if args.nss == 2:
                h2 = np.eye(2) + 0.25 * (rng.normal(size=(2, 2))
                                         + 1j * rng.normal(size=(2, 2)))
                wave = h2 @ wave
            nrx = args.nss
            rms = float(np.sqrt(np.mean(np.abs(wave[0]) ** 2)))
            t0 = time.time()
            # one timeline: args.n packets per SNR segment, AWGN per segment
            nsnr = len(snrs)
            spacing = wave.shape[1] + 400
            seg = args.n * spacing + 1024
            total = nsnr * seg
            stream = np.empty((nrx, total), np.complex64)
            w = np.stack([channel.apply_cfo(wv, 800.0) for wv in wave]
                         ).astype(np.complex64)
            starts = np.empty(nsnr * args.n, np.int64)
            for s, snr in enumerate(snrs):
                namp = rms / 10 ** (snr / 20)
                block = (rng.normal(size=(nrx, seg))
                         + 1j * rng.normal(size=(nrx, seg))
                         ).astype(np.complex64) * (namp / np.sqrt(2))
                for i in range(args.n):
                    o = 512 + i * spacing
                    block[:, o: o + w.shape[1]] += w
                    starts[s * args.n + i] = s * seg + o
                stream[:, s * seg: (s + 1) * seg] = block
            # headroom: mid-packet/noise false triggers must not evict real
            # packets at the end of the timeline (they decode to garbage and
            # simply fail the slot-mapping below)
            max_pkts = -(-(nsnr * args.n * 5) // (4 * 128)) * 128
            ok, ltf_idx, valid = RXM.rx_chain_ok(
                cfg, from_host(stream), nrx=nrx,
                mpdu_len=len(mpdu) if fmt == Fmt.VHT else 0,
                max_pkts=max_pkts)
            ok, ltf_idx, valid = (np.asarray(x) for x in (ok, ltf_idx, valid))
            # map detections back to transmit slots by sync position
            ok_slot = np.zeros(nsnr * args.n, bool)
            for j in range(max_pkts):
                if not (valid[j] and ok[j]):
                    continue
                s, rem = divmod(int(ltf_idx[j]), seg)
                i = (rem - 512) // spacing
                if 0 <= i < args.n and abs(rem - 512 - i * spacing - 186) < 300:
                    ok_slot[s * args.n + i] = True
            pers = [1.0 - ok_slot[s * args.n:(s + 1) * args.n].mean()
                    for s in range(nsnr)]
            results[f"{fname}_mcs{mcs}" + ("_2ss" if args.nss == 2 else "")] = {
                "snr_db": snrs.tolist(), "per": pers,
                "payload": args.payload, "n": args.n,
            }
            print(f"{fname} mcs{mcs}: {time.time()-t0:.1f}s  "
                  + " ".join(f"{p:.2f}" for p in pers), file=sys.stderr)
            # incremental dump: a time-boxed run still lands its artifact
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)

    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps({"points": sum(len(v["per"]) for v in results.values()),
                      "out": args.out}))


if __name__ == "__main__":
    main()
