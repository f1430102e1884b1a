"""Streaming RX daemon — the rx.grc flowgraph equivalent.

IQ in from a cf32 UDP stream (native C++ ingest thread) or a .bin file
replayed at a given rate; decoded MPDUs / NDP channel reports out on the
reference MAC wire (UDP :9527).  The reference's macExampleGrRx.py works
unmodified as the listener.

  python tools/rx_daemon.py --udp-iq 9000            # live cf32 in
  python tools/rx_daemon.py --file capture.bin       # replay
  python tools/rx_daemon.py --udp-iq 9000 9001       # 2-antenna rx2.grc
  python tools/rx_daemon.py --file ant0.bin ant1.bin # 2-antenna replay
      [--block 524288] [--halo 16384] [--report-port 9527]
      [--mu-pos N] [--mu-gid G] [--stats-every 5]
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--udp-iq", type=int, nargs="+", default=None,
                    help="UDP port(s) receiving interleaved-cf32 datagrams, "
                         "one per RX antenna")
    ap.add_argument("--file", nargs="+", default=None,
                    help="cf32 .bin file(s) to replay, one per RX antenna")
    ap.add_argument("--block", type=int, default=1 << 19)
    ap.add_argument("--halo", type=int, default=16384)
    ap.add_argument("--report-port", type=int, default=9527)
    ap.add_argument("--mu-pos", type=int, default=None)
    ap.add_argument("--mu-gid", type=int, default=None)
    ap.add_argument("--stats-every", type=float, default=5.0)
    ap.add_argument("--once", action="store_true",
                    help="with --file: drain and exit (the default; kept "
                         "for existing command lines)")
    ap.add_argument("--f32-ingest", action="store_true",
                    help="upload blocks as f32 pairs instead of bf16 "
                         "(bf16 halves the host->device bytes; ~49 dB "
                         "SQNR, below channel noise at any decodable SNR)")
    args = ap.parse_args()
    if (args.udp_iq is None) == (args.file is None):
        ap.error("exactly one of --udp-iq / --file required")
    from gr_ieee80211.utils.device import setup_compile_cache
    setup_compile_cache()
    from gr_ieee80211.runtime import native as NAT
    from gr_ieee80211.runtime.udp_phy import PhyRxReporter
    from gr_ieee80211.runtime.streaming import RxStreamer, replay
    from gr_ieee80211.models.rx import RxEngine

    nrx = len(args.udp_iq or args.file)
    if args.file is not None:
        streams = [np.fromfile(f, np.complex64) for f in args.file]
        print(f"replaying {min(map(len, streams))/1e6:.1f} M samples x "
              f"{nrx}", file=sys.stderr)
        eng = RxEngine(nrx=nrx, mu_pos=args.mu_pos, mu_gid=args.mu_gid,
                       ingest_bf16=not args.f32_ingest)
        st = replay(streams, eng, block_len=args.block, halo=args.halo,
                    reporter=PhyRxReporter(port=args.report_port))
        print(f"done: {st.n_blocks} blocks, {st.n_ok}/{st.n_packets} "
              f"packets ok", file=sys.stderr)
        return
    rings = [NAT.IqRing(1 << 23) for _ in range(nrx)]
    ings = [NAT.UdpIngest(r, port=p) for r, p in zip(rings, args.udp_iq)]
    print("ingesting cf32 on udp:"
          + ",".join(str(i.port) for i in ings), file=sys.stderr)
    eng = RxEngine(nrx=nrx, mu_pos=args.mu_pos, mu_gid=args.mu_gid,
                   ingest_bf16=not args.f32_ingest)
    streamer = RxStreamer(rings, eng, block_len=args.block, halo=args.halo,
                          reporter=PhyRxReporter(port=args.report_port))
    streamer.start()
    print(f"reporting decoded packets to udp:{args.report_port}",
          file=sys.stderr)

    try:
        while True:
            time.sleep(args.stats_every)
            s = [i.stats for i in ings]
            # per-(fmt, mcs) tallies with mean SNR/RSSI: the reference
            # decode block's debug print (lib/decode_impl.cc:393-411)
            tallies = "  ".join(
                f"{k[0].name if k[0] is not None else '?'}{k[1]}:"
                f"{v['ok']}/{v['total']}"
                f"@{v['snr_db_mean']:.0f}dB"
                for k, v in sorted(streamer.counter_summary().items(),
                                   key=str))
            print(f"blocks {streamer.n_blocks}  pkts ok "
                  f"{streamer.n_ok}/{streamer.n_packets}  ingest {s}  "
                  f"[{tallies}]", file=sys.stderr)
    except KeyboardInterrupt:
        pass
    finally:
        streamer.stop()
        for i in ings:
            i.stop()


if __name__ == "__main__":
    main()
