"""2-process multi-host scale-out: per-host ingest + cross-host halo exchange
must decode exactly the same packets as the single-process 8-device run.

Each worker owns 4 virtual CPU devices and HALF the IQ timeline; the chain's
halo ppermute crosses the host boundary (Gloo stands in for DCN on the CPU
backend).  The single-process reference runs in-process on this test's own
8-device mesh — identical shard count, identical program."""
import os
import socket
import subprocess
import sys
import re

import numpy as np
import pytest


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_chain_matches_single_process():
    # single-process reference on this process's 8 virtual devices
    sys.path.insert(0, os.path.dirname(__file__))
    from _multihost_worker import build_stream
    from gr_ieee80211.parallel import mesh as M
    from gr_ieee80211.ops.cplx import from_host

    cfg, mpdu, stream, n_pkt = build_stream()
    mesh = M.make_mesh(8, axes=("sp",))
    chain, _ = M.rx_chain_sp(cfg, mesh, mpdu_len=len(mpdu),
                             max_pkts_per_shard=max(8, n_pkt))
    with mesh:
        ref_ok, ref_det = (int(x) for x in chain(from_host(stream)))
    assert ref_ok == n_pkt

    # two workers, 4 devices each, half the stream each
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    worker = os.path.join(os.path.dirname(__file__), "_multihost_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, worker, str(i), "2", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
        for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            pytest.fail(f"multihost worker timed out:\n{out[-2000:]}")
        outs.append(out)
        assert p.returncode == 0, f"worker failed:\n{out[-2000:]}"

    results = []
    for out in outs:
        m = re.search(r"RESULT ok=(\d+) det=(\d+)", out)
        assert m, f"no RESULT line:\n{out[-2000:]}"
        results.append((int(m.group(1)), int(m.group(2))))
    # the psum'd totals are replicated: both hosts see the same global counts,
    # and they equal the single-process reference exactly
    assert results[0] == results[1] == (ref_ok, ref_det), \
        f"multihost {results} != single-process {(ref_ok, ref_det)}"


def _run_workers(n_proc, mode, b_local, n_dev=4):
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    worker = os.path.join(os.path.dirname(__file__), "_multihost_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, worker, str(i), str(n_proc), str(port), mode,
         str(b_local), str(n_dev)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
        for i in range(n_proc)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            pytest.fail(f"worker timed out:\n{out[-2000:]}")
        assert p.returncode == 0, f"worker failed:\n{out[-2000:]}"
        outs.append(out)
    res, times = [], []
    for out in outs:
        m = re.search(r"RESULT ok=(\d+) det=(\d+)", out)
        assert m, f"no RESULT line:\n{out[-2000:]}"
        res.append((int(m.group(1)), int(m.group(2))))
        t = re.search(r"DPTIME ms=([0-9.]+)", out)
        if t:
            times.append(float(t.group(1)))
    return res, times


def test_two_process_dp_decode_and_scaling():
    """payload_decode_multihost across 2 processes decodes every window,
    and the cross-process overhead is measured at FIXED hardware: 4
    virtual devices and a 128-window batch, run as 1 process vs 2
    processes of 2 devices (this host has 2 cores, so adding virtual
    'hosts' adds no silicon — true weak scaling is unmeasurable here;
    what CAN be isolated is the process-boundary cost: Gloo collectives
    + multi-controller dispatch vs in-process).  Recorded to
    results/multihost_scaling.json against the BASELINE ">80% at N>=2
    hosts" target (labeled cpu-virtual)."""
    B = 128
    res1, t1 = _run_workers(1, "dp", B, n_dev=4)
    assert res1[0] == (B, B)
    res2, t2 = _run_workers(2, "dp", B // 2, n_dev=2)
    assert res2[0] == res2[1] == (B, B)
    assert t1 and t2, "worker output missing DPTIME line"
    eff = t1[0] / max(t2)
    blob = {"mode": "dp_fixed_hardware_2proc_vs_1proc",
            "backend": "cpu-virtual (4 devices total, 2-core host)",
            "b_global": B, "t_1proc_ms": t1[0], "t_2proc_ms": max(t2),
            "efficiency": round(eff, 3)}
    print(f"dp process-boundary scaling: {blob}")
    # the committed results/multihost_scaling.json artifact is written only
    # on request (WRITE_SCALING_ARTIFACT=1) so routine test runs don't
    # clobber the recorded definitive measurement
    import json
    if os.environ.get("WRITE_SCALING_ARTIFACT"):
        out = os.path.join(os.path.dirname(__file__), "..", "results",
                           "multihost_scaling.json")
        with open(out, "w") as f:
            json.dump(blob, f, indent=1)
    # wall-clock efficiency on a shared 2-core host is load-sensitive; the
    # correctness assertions above are the gate, this is a soft perf check
    if eff <= 0.5:
        import warnings
        warnings.warn(f"dp process-boundary efficiency low: {blob}")
