"""Per-packet latency / RTT measurement through the streaming daemons.

Counterpart of the reference's latency study
(tools/performance/Measurement_Report.pdf):
  Fig 1-4  per-packet block latency, VHT MCS0-8, 30 B / 300 B payloads
  Fig 6-9  TX -> channel -> RX round-trip time (no USRP, channel model only)

Here the measured loop is the full daemon path with the reference wire
protocol at both ends:

  MAC UDP :9528 request -> PhyTxServer (waveform synth) -> TxStreamer
  -> cf32 UDP -> native UdpIngest -> IqRing -> RxStreamer (overlap-save
  blocks, batched RxEngine on the accelerator) -> PhyRxReporter -> MAC UDP

RTT = (MAC report received) - (MAC request sent), one packet in flight at a
time, the packet's block flushed with trailing silence (the no-USRP protocol:
samples flow as fast as the pipe moves them, like the reference's
channel-model loop).  Each MPDU carries a sequence tag so reports match
requests exactly.

Also reports the single-dispatch fused-chain device latency
(models.rx.rx_chain_count): the engine's known-config path crosses the host
boundary once — at B packets per block the same number amortizes B-fold
per packet.

Everything runs in this one process (TX synthesis, RX engine, sockets), so
one JAX process holds the card: this is the live MAC->PHY->MAC loopback.

  python tools/latency_report.py [mcs,list] [n_pkts] [batch,list]

Exits 1 without a GPU; prints one JSON line to stdout.
"""
import json
import os
import socket
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def pctl(xs, q):
    xs = sorted(xs)
    i = min(len(xs) - 1, int(round(q / 100 * (len(xs) - 1))))
    return xs[i]


def run_daemon_rtt(mcs_list, payload_lens, n_pkts, block_len=1 << 16,
                   halo=16384):
    from gr_ieee80211.runtime import native as NAT
    from gr_ieee80211.runtime.udp_phy import (
        PhyTxServer, PhyRxReporter, parse_phy_to_mac)
    from gr_ieee80211.runtime.streaming import RxStreamer, TxStreamer
    from gr_ieee80211.models.rx import RxEngine
    from gr_ieee80211.gold import mac

    mac_rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    mac_rx.bind(("127.0.0.1", 0))
    mac_rx.settimeout(0.05)
    ring = NAT.IqRing(1 << 22)
    ing = NAT.UdpIngest(ring, port=0)
    streamer = RxStreamer(ring, RxEngine(nrx=1), block_len=block_len,
                          halo=halo, poll_s=0.002,
                          reporter=PhyRxReporter(
                              port=mac_rx.getsockname()[1]))
    streamer.start()
    tx_sink = TxStreamer(udp_addr=("127.0.0.1", ing.port), gap=1200, amp=0.2)
    phy_tx = PhyTxServer(sink=tx_sink, port=0)
    phy_tx.start()
    mac_tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    silence = np.zeros(4096, np.complex64).tobytes()
    sil_sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def flush_block():
        # trailing silence so the burst's overlap-save block leaves the ring
        # (the no-more-samples condition of the reference's file-input runs)
        for _ in range(0, block_len + halo + 8192, 4096):
            sil_sock.sendto(silence, ("127.0.0.1", ing.port))

    results = {}
    try:
        for mcs in mcs_list:
            for plen in payload_lens:
                rtts = []
                lost = 0
                for it in range(n_pkts + 2):   # first 2 = jit warmup, dropped
                    seq = (mcs << 20) | (plen << 8) | (it & 0xFF)
                    body = seq.to_bytes(4, "big") + bytes(plen - 4)
                    mpdu = mac.qos_data_frame(
                        body, "f4:69:d5:80:0f:a0", "00:c0:ca:b1:5b:e1",
                        "f4:69:d5:80:0f:a0", 1)
                    psdu = mac.ampdu_aggregate_vht([mpdu])
                    hdr = bytes([2, mcs, 1, len(psdu) & 0xFF, len(psdu) >> 8])
                    nb0 = tx_sink.n_bursts
                    t0 = time.perf_counter()
                    mac_tx.sendto(hdr + psdu, ("127.0.0.1", phy_tx.port))
                    while tx_sink.n_bursts == nb0:     # burst fully emitted
                        time.sleep(0.0002)
                    flush_block()
                    deadline = time.time() + (600 if it < 2 else 15)
                    got = None
                    while time.time() < deadline:
                        assert streamer.error is None, streamer.error
                        try:
                            data, _ = mac_rx.recvfrom(65536)
                        except socket.timeout:
                            continue
                        parsed = parse_phy_to_mac(data)
                        if parsed is None:
                            continue
                        _, pl, _ = parsed
                        if len(pl) >= 30 and pl[26:30] == body[:4]:
                            got = time.perf_counter()
                            break
                    if got is None:
                        lost += 1
                    elif it >= 2:
                        rtts.append((got - t0) * 1e3)
                if rtts:
                    results[(mcs, plen)] = {
                        "n": len(rtts), "lost": lost,
                        "p50_ms": round(pctl(rtts, 50), 1),
                        "p95_ms": round(pctl(rtts, 95), 1),
                        "mean_ms": round(statistics.mean(rtts), 1),
                    }
                else:
                    results[(mcs, plen)] = {"n": 0, "lost": lost}
                r = results[(mcs, plen)]
                print(f"daemon RTT vht mcs{mcs} {plen}B: {r}",
                      file=sys.stderr, flush=True)
    finally:
        streamer.stop()
        phy_tx.stop()
        ing.stop()
    return results


def run_fused_latency(mcs_list, payload_lens, batches=(1, 256, 4096)):
    """Single-dispatch rx_chain_count latency per batch size (device path)."""
    from gr_ieee80211.utils import device as D
    from gr_ieee80211.spec.params import PhyConfig, Fmt
    from gr_ieee80211.gold import tx, mac, channel
    from gr_ieee80211.models import rx as RXM
    from gr_ieee80211.ops.cplx import from_host

    rng = np.random.default_rng(7)
    out = {}
    for mcs in mcs_list:
        for plen in payload_lens:
            mpdu = mac.qos_data_frame(bytes(rng.integers(0, 256, plen,
                                                         dtype=np.uint8)),
                                      "f4:69:d5:80:0f:a0",
                                      "00:c0:ca:b1:5b:e1",
                                      "f4:69:d5:80:0f:a0", 1)
            am = mac.ampdu_aggregate_vht([mpdu])
            cfg = PhyConfig(Fmt.VHT, mcs, 1, len(am), ampdu=True)
            wave = channel.apply_cfo(
                tx.tx_waveform(cfg, am, group_id=0, partial_aid=0)[0], 500.0
            ).astype(np.complex64)
            for B in batches:
                spacing = len(wave) + 240
                stream = np.zeros(B * spacing + 2048, np.complex64)
                for i in range(B):
                    stream[1024 + i * spacing: 1024 + i * spacing
                           + len(wave)] = wave
                rms = float(np.sqrt(np.mean(np.abs(wave) ** 2)))
                stream += (rng.normal(size=len(stream))
                           + 1j * rng.normal(size=len(stream))
                           ).astype(np.complex64) * (rms / 10 ** (30 / 20)
                                                     / np.sqrt(2))
                dev = from_host(stream[None])
                f = lambda d: RXM.rx_chain_count(cfg, d, nrx=1,
                                                 mpdu_len=len(mpdu),
                                                 max_pkts=max(B, 16))
                n_ok, _ = (int(x) for x in f(dev))       # warmup/compile
                ts = D.time_ms(lambda: f(dev), 5)
                out[(mcs, plen, B)] = {
                    "ok": n_ok, "of": B,
                    "p50_ms": pctl(ts, 50),
                    "per_pkt_us": pctl(ts, 50) * 1e3 / B,
                }
                print(f"fused vht mcs{mcs} {plen}B B={B}: "
                      f"{out[(mcs, plen, B)]}", file=sys.stderr, flush=True)
    return out


def main():
    from gr_ieee80211.utils import device as D
    D.setup_compile_cache()
    summary = D.require_gpu()
    mcs_list = [int(x) for x in
                (sys.argv[1].split(",") if len(sys.argv) > 1
                 else range(9))]
    n_pkts = int(sys.argv[2]) if len(sys.argv) > 2 else 25
    batches = tuple(int(x) for x in sys.argv[3].split(",")) \
        if len(sys.argv) > 3 else (1, 256, 4096)
    payload_lens = (30, 300)

    fused = run_fused_latency(mcs_list, payload_lens, batches=batches)
    daemon = run_daemon_rtt(mcs_list, payload_lens, n_pkts)
    print(json.dumps({
        "device": summary, "card": D.card_name_and_power(),
        "daemon_rtt": {f"mcs{m}_{p}B": v for (m, p), v in daemon.items()},
        "fused_chain": {f"mcs{m}_{p}B_B{b}": v
                        for (m, p, b), v in fused.items()},
    }))


if __name__ == "__main__":
    main()
