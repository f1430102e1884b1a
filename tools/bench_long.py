"""Long-trellis throughput: VHT MCS0 4095 B at full batch via chunk=.

The MCS0 4095 B trellis is ~33k steps, so the Viterbi decision planes of
an unchunked 4096-packet program would be large.  ``rx_chain_count(chunk=)``
scans the synced batch in fixed-size chunks INSIDE the single fused
program: decision planes are per-chunk temporaries while the dispatch
still amortizes over the whole batch (the reference streams any length
through its per-sample decoder, lib/decode_impl.h:35-36).

  python tools/bench_long.py [B] [chunk]

Each batch is timed with block_until_ready; exits 1 without a GPU.
Prints one JSON line to stdout.
"""
import json
import os
import statistics
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    from gr_ieee80211.utils import device as D
    D.setup_compile_cache()
    summary = D.require_gpu()
    from gr_ieee80211.spec.params import PhyConfig, Fmt
    from gr_ieee80211.gold import tx, mac, channel
    from gr_ieee80211.models import rx as RXM
    from gr_ieee80211.ops.cplx import from_host

    B = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    chunk = int(sys.argv[2]) if len(sys.argv) > 2 else 128
    rng = np.random.default_rng(1)
    payload = bytes(rng.integers(0, 256, 4000, dtype=np.uint8))
    mpdu = mac.qos_data_frame(payload, "f4:69:d5:80:0f:a0",
                              "00:c0:ca:b1:5b:e1", "f4:69:d5:80:0f:a0", 7)
    am = mac.ampdu_aggregate_vht([mpdu])
    cfg = PhyConfig(Fmt.VHT, 0, 1, len(am), ampdu=True)
    wave = tx.tx_waveform(cfg, am, group_id=0, partial_aid=0)[0]
    print(f"cfg: VHT mcs0 1ss, psdu {cfg.psdu_len} B, nsym {cfg.nsym}, "
          f"trellis {cfg.n_trellis}, wave {len(wave)}; B={B} chunk={chunk}",
          file=sys.stderr, flush=True)
    spacing = len(wave) + 240
    stream = np.zeros(B * spacing + 2048, np.complex64)
    w = channel.apply_cfo(wave, 900.0).astype(np.complex64)
    for i in range(B):
        stream[1024 + i * spacing: 1024 + i * spacing + len(wave)] = w
    rms = float(np.sqrt(np.mean(np.abs(wave) ** 2)))
    stream += (rng.normal(size=len(stream)) + 1j * rng.normal(size=len(stream))
               ).astype(np.complex64) * (rms / 10 ** (32 / 20) / np.sqrt(2))
    dev = from_host(stream[None])
    print(f"stream: {len(stream)/1e6:.1f} M samples", file=sys.stderr,
          flush=True)

    def chain(d):
        return RXM.rx_chain_count(cfg, d, nrx=1, mpdu_len=len(mpdu),
                                  max_pkts=B, chunk=chunk)

    n_ok, n_det = (int(x) for x in chain(dev))
    print(f"warmup: detected {n_det}, ok {n_ok}/{B}", file=sys.stderr,
          flush=True)
    dt = statistics.median(D.time_ms(lambda: chain(dev), 8)) / 1e3
    # reference ceiling at its best-case 93 ticks/LLR item for this shape
    ref_pkts_s = 4.9e9 / (cfg.nsym * 52 * 93)
    print(f"{dt*1e3:.1f} ms/batch; {B/dt:,.0f} pkt/s; "
          f"{len(stream)/dt/1e6:.0f} Msamp/s; ok {n_ok}/{B}; "
          f"ref ceiling {ref_pkts_s:,.0f} pkt/s "
          f"({B/dt/ref_pkts_s:.1f}x)", file=sys.stderr, flush=True)
    print(json.dumps({"config": f"VHT mcs0 1ss 4000B (trellis "
                                f"{cfg.n_trellis}), B={B} chunk={chunk}",
                      "ms_per_batch": dt * 1e3, "pkt_per_s": B / dt,
                      "n_ok": n_ok, "n_det": n_det,
                      "vs_ref_ceiling": B / dt / ref_pkts_s,
                      "device": summary, "card": D.card_name_and_power()}))


if __name__ == "__main__":
    main()
