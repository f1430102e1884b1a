"""Multi-chip sharding paths on the virtual 8-device CPU mesh.

Covers the three scale-out programs in ``parallel.mesh``: packet-sharded
decode (dp), time-sharded detection with ppermute halo exchange (sp), and the
full end-to-end time-sharded RX chain (sp), asserting they reproduce the
single-device results.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gr_ieee80211.spec.params import PhyConfig, Fmt
from gr_ieee80211.gold import tx as gtx, mac, channel
from gr_ieee80211.parallel import mesh as M
from gr_ieee80211.ops.cplx import from_host


def _need_devices(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} devices")


def _mk_cfg(rng, n=80):
    mpdu = mac.qos_data_frame(bytes(rng.integers(0, 256, n, dtype=np.uint8)),
                              "02:00:00:00:00:01", "02:00:00:00:00:02",
                              "02:00:00:00:00:01", 1)
    am = mac.ampdu_aggregate_vht([mpdu])
    return mpdu, PhyConfig(Fmt.VHT, 4, 1, len(am), ampdu=True), am


def test_payload_decode_dp():
    _need_devices(8)
    rng = np.random.default_rng(7)
    mpdu, cfg, am = _mk_cfg(rng)
    wave = gtx.tx_waveform(cfg, am, group_id=0, partial_aid=0)[0]
    mesh = M.make_mesh(8, axes=("dp",))
    step, n_samp = M.payload_decode_dp(cfg, mesh, mpdu_len=len(mpdu))
    B = 16
    wins = np.tile(wave[188: 188 + n_samp][None], (B, 1)).astype(np.complex64)
    with mesh:
        psdu, ok, total = step(from_host(wins))
    assert int(total) == B
    assert bool(np.asarray(ok).all())


def test_rx_chain_sp_matches_single_device():
    _need_devices(8)
    rng = np.random.default_rng(11)
    mpdu, cfg, am = _mk_cfg(rng)
    wave = gtx.tx_waveform(cfg, am, group_id=0, partial_aid=0)[0]
    n_pkt = 12
    stream = channel.frame_stream(wave, 1.0, 600.0, num=n_pkt, gap=1400)[0]
    rms = np.sqrt(np.mean(np.abs(wave) ** 2))
    stream = channel.awgn(stream[None], rms / 10 ** (30 / 20), rng)[0]
    # pad to a multiple of 8 shards
    n = -(-len(stream) // 8) * 8
    stream = np.pad(stream, (0, n - len(stream)))
    mesh = M.make_mesh(8, axes=("sp",))
    chain, halo = M.rx_chain_sp(cfg, mesh, mpdu_len=len(mpdu),
                                max_pkts_per_shard=16)
    with mesh:
        n_ok, n_det = chain(from_host(stream))
    assert int(n_det) == n_pkt
    assert int(n_ok) == n_pkt
    # packets deliberately straddle shard boundaries (block = n/8 samples,
    # packet span ~ wave+gap): the halo exchange must cover them
    blk = n // 8
    starts = 1000 + np.arange(n_pkt) * (len(wave) + 1400)
    assert any(s // blk != (s + len(wave)) // blk for s in starts)


def test_frontend_sp_detects_across_boundaries():
    _need_devices(8)
    rng = np.random.default_rng(13)
    _, cfg, am = _mk_cfg(rng)
    wave = gtx.tx_waveform(cfg, am, group_id=0, partial_aid=0)[0]
    stream = channel.frame_stream(wave, 1.0, 0.0, num=6, gap=2000)[0]
    n = -(-len(stream) // 8) * 8
    stream = np.pad(stream, (0, n - len(stream)))
    mesh = M.make_mesh(8, axes=("sp",))
    fe = M.frontend_sp(mesh, max_out_per_shard=64)
    with mesh:
        cand = np.asarray(fe(from_host(stream)))
    cand = cand.reshape(-1)
    cand = np.sort(cand[cand >= 0])
    # one candidate cluster per packet, at the packet start
    from gr_ieee80211.models.rx import dedup_triggers
    ded = dedup_triggers(cand)
    assert len(ded) == 6
