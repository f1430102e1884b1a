"""Headline benchmark: full-chain RX throughput, VHT MCS7, on one GPU.

Protocol mirrors the reference PER harness packet shape
(tools/performance/perf_siso.py: ~500 B payloads, VHT) but measures the
batched engine: device-side detection -> sync/CFO -> batched demod ->
adaptive BCC decode -> descramble -> CRC32, fused into one program per
batch (models.rx.rx_chain_count).  Only the two counts cross the host
boundary.

Baseline: the reference decode block alone costs 93-250 CPU ticks per LLR
item (Gr_WiFi_Time_Complexity_Report, Table 1).  Taking its most favorable
point (93 ticks at the i7-11700's 4.9 GHz boost) for a VHT MCS7 500 B packet
(19 symbols x 312 coded bits = 5928 LLR items) gives 4.9e9/(5928*93) ~= 8888
packets/s as the reference ceiling for its bottleneck stage on one core --
the denominator for vs_baseline (the reference's full chain is slower).

Each batch is timed on the host clock around a call that ends in
block_until_ready; the median of N_REP batches is reported.  Exits 1 when
JAX has no GPU.  Prints ONE json line to stdout; diagnostics go to stderr.
"""
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

B = 4096
N_REP = 20


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    from gr_ieee80211.utils import device as D
    D.setup_compile_cache()
    summary = D.require_gpu()
    import jax
    from gr_ieee80211.models import rx as RXM
    from gr_ieee80211.ops.cplx import from_host
    from gr_ieee80211.utils import workload as W

    cfg, mpdu, wave = W.vht_packet()
    log(f"cfg: VHT mcs7 1ss, mpdu {len(mpdu)} B, psdu {cfg.psdu_len} B, "
        f"nsym {cfg.nsym}, wave {wave.shape[1]} samples")
    ref_pkts_s = 4.9e9 / (cfg.nsym * 312 * 93)

    def full_chain(dev):
        return RXM.rx_chain_count(cfg, dev, nrx=1, mpdu_len=len(mpdu),
                                  max_pkts=B)

    out = {}
    for snr in (32, 18):
        dev = from_host(W.packet_train(wave, B, snr, seed=snr))
        n_ok, n_det = (int(x) for x in full_chain(dev))
        ts = []
        for _ in range(N_REP):
            t0 = time.perf_counter()
            jax.block_until_ready(full_chain(dev))
            ts.append(time.perf_counter() - t0)
        dt = statistics.median(ts)
        out[snr] = (dt, n_ok)
        log(f"{snr} dB: {dt * 1e3:.3f} ms/batch (median of {N_REP}), "
            f"{B / dt:,.0f} pkt/s, detected {n_det}, FCS ok {n_ok}/{B}")

    dt, _ = out[32]
    print(json.dumps({
        "metric": "rx_full_chain_packets_per_s_vht_mcs7_500B",
        "value": B / dt,
        "unit": "packets/s",
        "vs_baseline": B / dt / ref_pkts_s,
        "low_snr_18dB_packets_per_s": B / out[18][0],
        "fcs_ok": {"32dB": out[32][1], "18dB": out[18][1]},
        "device": summary,
        "card": D.card_name_and_power(),
    }))


if __name__ == "__main__":
    main()
