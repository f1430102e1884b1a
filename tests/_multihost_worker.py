"""Worker process for the 2-host scale-out tests (see test_multihost.py).

Usage: python tests/_multihost_worker.py <process_id> <num_processes> <port>
           [sp|dp] [b_local]
Builds the SAME deterministic packet stream as the parent test, ingests only
its own slice, joins the global mesh and runs either the fused time-sharded
RX chain (``sp``) or the packet-sharded decode (``dp``, with a steady-state
timing line for the weak-scaling measurement); prints
"RESULT ok=<n> det=<n>" (and for dp "DPTIME ms=<median>") on success.
"""
import sys
import os
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
jax.config.update("jax_platforms", "cpu")


def build_stream():
    import numpy as np
    from gr_ieee80211.spec.params import PhyConfig, Fmt
    from gr_ieee80211.gold import tx, mac

    mpdu = mac.qos_data_frame(b"x" * 40, "02:00:00:00:00:01",
                              "02:00:00:00:00:02", "02:00:00:00:00:01", 1)
    am = mac.ampdu_aggregate_vht([mpdu])
    cfg = PhyConfig(Fmt.VHT, 2, 1, len(am), ampdu=True)
    wave = tx.tx_waveform(cfg, am, group_id=0, partial_aid=0)[0]
    n_pkt = int(os.environ.get("MH_NPKT", "16"))   # weak scaling: ∝ procs
    spacing = len(wave) + 1400
    n_total = -(-(n_pkt * spacing + 4096) // 8) * 8
    stream = np.zeros(n_total, np.complex64)
    for i in range(n_pkt):
        stream[1000 + i * spacing: 1000 + i * spacing + len(wave)] = wave
    return cfg, mpdu, stream, n_pkt


def main():
    pid, n_proc, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    mode = sys.argv[4] if len(sys.argv) > 4 else "sp"
    b_local = int(sys.argv[5]) if len(sys.argv) > 5 else 64
    n_dev = int(sys.argv[6]) if len(sys.argv) > 6 else 4
    from gr_ieee80211.parallel import distributed as D

    D.bootstrap(f"localhost:{port}", num_processes=n_proc, process_id=pid,
                local_device_count=n_dev)
    cfg, mpdu, stream, n_pkt = build_stream()
    if mode == "sp":
        mesh = D.global_mesh(("sp",))
        n_local = len(stream) // n_proc
        local = stream[pid * n_local: (pid + 1) * n_local]  # per-host ingest
        gstream = D.distribute_stream(local, mesh)
        chain, _halo = D.rx_chain_multihost(cfg, mesh, mpdu_len=len(mpdu),
                                            max_pkts_per_shard=max(8, n_pkt))
        with mesh:
            n_ok, n_det = (int(x) for x in chain(gstream))
            ts = []
            for _ in range(5):           # steady-state chain timing
                t0 = time.perf_counter()
                int(chain(gstream)[1])
                ts.append((time.perf_counter() - t0) * 1e3)
        ts = sorted(ts)
        print(f"RESULT ok={n_ok} det={n_det}", flush=True)
        print(f"SPTIME ms={ts[len(ts) // 2]:.1f}", flush=True)
        return

    # dp: packet-sharded decode across hosts, per-host window ingest +
    # steady-state timing (weak scaling: b_local windows per process)
    import numpy as np
    mesh = D.global_mesh(("dp",))
    step, n_samp = D.payload_decode_multihost(cfg, mesh, mpdu_len=len(mpdu))
    pkt0 = int(np.flatnonzero(np.abs(stream) > 0)[0])    # first packet start
    win = stream[pkt0 + 188: pkt0 + 188 + n_samp]
    wins = np.tile(win[None], (b_local, 1)).astype(np.complex64)
    gwins = D.distribute_windows(wins, mesh)
    with mesh:
        _, _, total = step(gwins)
        n_ok = int(total)                                # compile + warmup
        ts = []
        for _ in range(7):
            t0 = time.perf_counter()
            int(step(gwins)[2])
            ts.append((time.perf_counter() - t0) * 1e3)
    ts = sorted(ts)[1:-1]
    print(f"RESULT ok={n_ok} det={b_local * n_proc}", flush=True)
    print(f"DPTIME ms={ts[len(ts) // 2]:.1f}", flush=True)


if __name__ == "__main__":
    main()
