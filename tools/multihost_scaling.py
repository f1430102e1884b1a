"""Weak-scaling curve for the multihost paths on a CPU-virtual mesh.

Runs 1 / 2 / 4 jax.distributed processes with FIXED per-process work
(dp: a constant window batch per process; sp: a constant stream slice
per process) over the time-sharded RX chain (``rx_chain_multihost``) and
the packet-sharded decode (``payload_decode_multihost``), and records
the per-step medians as one JSON line on stdout.

All processes share one machine's CPU cores, so the wall-clock curve
measures the PROCESS-BOUNDARY cost (Gloo collectives + multi-controller
dispatch) under CPU contention, not network or accelerator scaling.  Its
value is the trend and that every configuration decodes all its packets.

Usage: JAX_PLATFORMS=cpu python tools/multihost_scaling.py
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_multihost_worker.py")


def run_workers(n_proc: int, mode: str, b_local: int, n_dev: int,
                n_pkt: int, port: int):
    env = dict(os.environ, JAX_PLATFORMS="cpu", MH_NPKT=str(n_pkt))
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(p), str(n_proc), str(port), mode,
         str(b_local), str(n_dev)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=REPO) for p in range(n_proc)]
    outs = [p.communicate(timeout=900)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-2000:]}"
    res, times = [], []
    for out in outs:
        m = re.search(r"RESULT ok=(\d+) det=(\d+)", out)
        assert m, out[-1500:]
        res.append((int(m.group(1)), int(m.group(2))))
        t = re.search(r"(?:DP|SP)TIME ms=([0-9.]+)", out)
        if t:
            times.append(float(t.group(1)))
    return res, times


def main():
    port = 29877
    curve = {"dp": [], "sp": []}
    for n in (1, 2, 4):
        # dp weak scaling: 32 windows AND 2 virtual devices per process
        res, ts = run_workers(n, "dp", b_local=32, n_dev=2, n_pkt=16,
                              port=port)
        port += 1
        assert all(r == (32 * n, 32 * n) for r in res), res
        curve["dp"].append({"n_proc": n, "b_local": 32,
                            "ms_per_step_max": max(ts),
                            "ms_per_step_all": ts})
        print(f"dp n={n}: {ts}")
        # sp weak scaling: 8 packets of stream per process
        res, ts = run_workers(n, "sp", b_local=0, n_dev=2, n_pkt=8 * n,
                              port=port)
        port += 1
        tot_ok = sum(r[0] for r in res) // n    # every proc prints global
        assert tot_ok == 8 * n, res
        curve["sp"].append({"n_proc": n, "pkts_per_proc": 8,
                            "ms_per_chain_max": max(ts),
                            "ms_per_chain_all": ts})
        print(f"sp n={n}: {ts}")
    print(json.dumps({
        "mode": "weak_scaling_fixed_work_per_process",
        "backend": "cpu-virtual mesh, 2 devices/process, one host",
        "curve": curve}))

if __name__ == "__main__":
    main()
