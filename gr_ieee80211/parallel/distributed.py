"""Multi-host scale-out: jax.distributed bootstrap + per-host stream ingest.

The reference is strictly single-host (GNU Radio ring buffers + UDP localhost,
SURVEY.md section 2.7 "distributed comm backend"); its only cross-host
transport is scp'd channel files in the cmu demos.  Here the IQ timeline
scales across HOSTS:

* every process calls :func:`bootstrap` (one coordinator), contributing its
  local chips to one global :func:`global_mesh`;
* each host ingests only its OWN contiguous time-slice of the stream (file
  segment or local UDP front end) — :func:`distribute_stream` assembles the
  global sharded array from purely process-local data, so no host ever
  materializes the full timeline;
* the fused detect->sync->decode chain (``parallel.mesh.rx_chain_sp``) runs
  unchanged on the global mesh: its ``ppermute`` halo exchange rides
  NVLink between the cards of one host (all to all) and the network
  between hosts — XLA picks the transport, the program text does not
  change;
* packet-batch decode (``parallel.mesh.payload_decode_dp``) similarly spans
  hosts with a single psum.

Launch recipe (N hosts, same binary everywhere)::

    # host k of N (coordinator on host 0):
    python -c "
    from gr_ieee80211.parallel import distributed as D
    D.bootstrap('host0:9876', num_processes=N, process_id=k)
    mesh = D.global_mesh()
    local_iq = <this host's time slice, np.complex64>
    stream = D.distribute_stream(local_iq, mesh)
    n_ok, n_det = D.rx_chain_multihost(cfg, mesh, mpdu_len=..., )(stream)
    "

Tested two-process on a virtual-CPU mesh in ``tests/test_multihost.py``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.cplx import CF
from ..spec.params import PhyConfig
from . import mesh as M


def bootstrap(coordinator_address: str, num_processes: int, process_id: int,
              local_device_count: int | None = None) -> None:
    """Join the global JAX runtime.  Call once per process before any
    computation.  ``local_device_count`` forces N virtual CPU devices
    (testing); on GPU hosts leave it None."""
    if local_device_count is not None:
        import os
        flags = os.environ.get("XLA_FLAGS", "")
        os.environ["XLA_FLAGS"] = (
            f"{flags} --xla_force_host_platform_device_count="
            f"{local_device_count}")
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def global_mesh(axes: tuple[str, ...] = ("sp",)) -> Mesh:
    """All devices of all processes as one mesh (1-D by default).  Device
    order is process-major, so contiguous ``sp`` shards of the timeline map
    to contiguous device ranks and the halo ppermute's host-boundary hops
    are exactly one per host pair."""
    devs = np.array(jax.devices())
    if len(axes) == 1:
        return Mesh(devs, axes)
    a = int(np.sqrt(len(devs)))
    while len(devs) % a:
        a -= 1
    return Mesh(devs.reshape(a, len(devs) // a), axes)


def distribute_stream(local_iq: np.ndarray, mesh: Mesh,
                      axis: str = "sp") -> CF:
    """Per-host ingest fan-in: each process contributes its own contiguous
    time-slice (equal length across processes, divisible by its local device
    count); returns the global (N,) CF sharded along ``axis``.  Only
    process-local data is touched — the full timeline never exists on any
    single host."""
    local_iq = np.ascontiguousarray(local_iq)
    sh = NamedSharding(mesh, P(axis))
    re = jax.make_array_from_process_local_data(
        sh, np.real(local_iq).astype(np.float32))
    im = jax.make_array_from_process_local_data(
        sh, np.imag(local_iq).astype(np.float32))
    return CF(re, im)


def rx_chain_multihost(cfg: PhyConfig, mesh: Mesh, mpdu_len: int = 0,
                       max_pkts_per_shard: int = 512):
    """Fused detect->sync->decode->count over the global mesh.  Identical
    program to the single-host ``rx_chain_sp`` — the mesh is simply bigger;
    halo exchange between the last chip of host k and the first chip of
    host k+1 rides DCN."""
    chain, halo = M.rx_chain_sp(cfg, mesh, mpdu_len=mpdu_len,
                                max_pkts_per_shard=max_pkts_per_shard)
    return chain, halo


def payload_decode_multihost(cfg: PhyConfig, mesh: Mesh, mpdu_len: int = 0):
    """Packet-batch (dp) decode across all hosts' chips."""
    return M.payload_decode_dp(cfg, mesh, mpdu_len=mpdu_len)


def distribute_windows(local_wins: np.ndarray, mesh: Mesh,
                       axis: str = "dp") -> CF:
    """Per-host packet-window fan-in for the dp path: each process
    contributes (b_local, n_samp) aligned windows."""
    sh = NamedSharding(mesh, P(axis, None))
    re = jax.make_array_from_process_local_data(
        sh, np.real(local_wins).astype(np.float32))
    im = jax.make_array_from_process_local_data(
        sh, np.imag(local_wins).astype(np.float32))
    return CF(re, im)
