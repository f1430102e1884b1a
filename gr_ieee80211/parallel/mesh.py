"""Device-mesh scale-out for the PHY pipelines.

The reference scales by GNU Radio scheduler threads and bounded ring buffers
on one host (SURVEY.md section 2.7).  Here the two parallel axes that exist
in the workload map onto a JAX mesh:

* ``dp`` — packet-batch data parallelism: buckets of same-config packets are
  sharded across chips; each chip runs the identical demod+decode program;
  per-packet results need no communication (a psum only for counters).
* ``sp`` — sample-stream (time) parallelism: the IQ timeline is split into
  contiguous blocks with a >=512-sample halo exchanged from the right
  neighbor (``jax.lax.ppermute``), so the sliding STF/LTF correlators see
  across block boundaries (overlap-save).

Every card reaches every other at the same rate (NVLink, all to all on one
host), so the mesh is one flat axis and follows the algorithm alone: the
sp halo goes to the next card in stream order, whichever card that is.
"""
from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..spec.params import PhyConfig, Fmt
from ..spec import tables as T
from ..ops import frontend as FE
from ..ops.cplx import CF, expj, csum
from ..ops import ofdm as OF
from ..ops import viterbi as VXLA
from ..ops import viterbi_gpu as VG
from ..ops import crc as CRC


def make_mesh(n_devices: int | None = None, axes=("dp",)) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    devs = np.array(devs[:n])
    if len(axes) == 1:
        return Mesh(devs.reshape(n), axes)
    # 2D: split as evenly as possible
    a = int(np.sqrt(n))
    while n % a:
        a -= 1
    return Mesh(devs.reshape(a, n // a), axes)


# ---------------------------------------------------------------------------
# dp: packet-sharded payload decode
# ---------------------------------------------------------------------------

def payload_decode_dp(cfg: PhyConfig, mesh: Mesh, mpdu_len: int = 0,
                      nrx: int = 1):
    """Build a jitted packet-sharded decode step.

    Input: aligned CFO-corrected sample windows (B, n_samp) — or
    (B, nrx, n_samp) for nrx > 1 (the demod2 2x2 MIMO role) — with B
    divisible by the dp axis size; output: (psdu bytes (B, psdu_len),
    fcs_ok (B,), global ok count).  Every packet runs the full Viterbi,
    the platform's own (``ops.viterbi_gpu.viterbi_decode``).
    """
    from ..models.rx import _data_start

    n_samp = _data_start(cfg) + 80 * cfg.nsym

    def local_decode(xs_re, xs_im):
        # xs: (b_local, nrx, n_samp), t=0 at the L-LTF window; fine CFO
        # from antenna 0's LTF lag-64 autocorrelation, then the full
        # demod+decode chain (ZF across nrx for 2x2)
        xs = CF(xs_re, xs_im)
        cfo = FE.fine_cfo_batch(xs[:, 0, :128], jnp.zeros(xs.shape[0]))
        t = np.arange(n_samp)
        xs = xs * expj(-2 * np.pi * cfo[:, None, None] / FE.FS
                       * t[None, None, :])
        if cfg.fmt == Fmt.L:
            h0 = OF.legacy_chanest(xs[:, 0], 0)
            h = h0[:, None, None, :]
            pilot_h = h0[:, T.PILOT_IDX][:, None, :]
        else:
            h, pilot_h = OF.nl_chanest(xs, 208 + 160 + 80,
                                       cfg.nltf, cfg.nss, nrx_axis=True)
            if cfg.fmt == Fmt.HT:
                pilot_h = csum(h[:, :, :, T.PILOT_IDX], axis=2)
        from ..ops.cplx import cstack
        grids = OF.fft_syms(cstack(
            [OF.extract_sym_windows(xs[:, r], _data_start(cfg), cfg.nsym)
             for r in range(nrx)], axis=1))
        llr = OF.equalize_and_demap(grids, h, pilot_h, cfg, nrx_axis=True)
        coded = OF.deinterleave_deparse(llr, cfg)
        bits = VG.viterbi_decode(VXLA.depuncture(coded, cfg.cr,
                                                 cfg.n_trellis))
        data = OF.descramble_bits(bits)
        psdu_bits = data[:, 16: 16 + 8 * cfg.psdu_len]
        psdu = OF.bits_to_bytes_batch(psdu_bits)
        if cfg.fmt == Fmt.VHT and mpdu_len > 4:
            ok = CRC.fcs_ok_batch(psdu_bits[:, 32: 32 + 8 * mpdu_len],
                                  8 * mpdu_len)
        elif cfg.fmt != Fmt.VHT and cfg.psdu_len > 4:
            ok = CRC.fcs_ok_batch(psdu_bits, 8 * cfg.psdu_len)
        else:
            ok = jnp.zeros(xs.shape[0], bool)
        total = jax.lax.psum(jnp.sum(ok.astype(jnp.int32)), "dp")
        return psdu, ok, total

    spec = P("dp", None, None)
    # check_vma=False: the GPU Viterbi kernels carry no varying-mesh-axes
    # annotation; each shard runs them purely locally
    fn = shard_map(local_decode, mesh=mesh,
                   in_specs=(spec, spec),
                   out_specs=(P("dp", None), P("dp"), P()), check_vma=False)

    def wrapped(wins_cf: CF):
        re = wins_cf.re if wins_cf.ndim == 3 else wins_cf.re[:, None]
        im = wins_cf.im if wins_cf.ndim == 3 else wins_cf.im[:, None]
        return fn(re, im)

    return jax.jit(wrapped), n_samp


# ---------------------------------------------------------------------------
# sp: time-sharded streaming front end with halo exchange
# ---------------------------------------------------------------------------

HALO = 512  # >= preamble + SIG span the correlators need across a boundary


def frontend_sp(mesh: Mesh, max_out_per_shard: int = 512):
    """Build a jitted time-sharded detector.

    Input: IQ stream (N,) with N divisible by the sp axis; each shard pulls
    a HALO tail from its right neighbor (ppermute), computes the
    STF plateau metric on block+halo, and reports global candidate indices
    (padded with -1).
    """
    sp = mesh.axis_names[-1]

    def local_fe(block_re, block_im):
        blk = CF(block_re.reshape(-1), block_im.reshape(-1))
        n_local = blk.shape[0]
        n_dev = jax.lax.axis_size(sp)
        left = [(i, (i - 1) % n_dev) for i in range(n_dev)]
        halo = CF(
            jax.lax.ppermute(jax.lax.dynamic_slice(blk.re, (0,), (HALO,)),
                             sp, perm=left),
            jax.lax.ppermute(jax.lax.dynamic_slice(blk.im, (0,), (HALO,)),
                             sp, perm=left))         # my right neighbor's head
        ext = CF(jnp.concatenate([blk.re, halo.re]),
                 jnp.concatenate([blk.im, halo.im]))
        m, _ = FE.stf_metrics(ext)
        # per-sample twin of detect_plateaus_strided's refire rejection:
        # real L-STF plateaus span ~160 samples, mid-packet STF refires ~70
        cand = FE.detect_plateaus(m, max_out=max_out_per_shard,
                                  confirm=(128, 96))
        cand = jnp.where((cand >= 0) & (cand < n_local),
                         cand + jax.lax.axis_index(sp) * n_local, -1)
        return cand[None]

    fn = shard_map(local_fe, mesh=mesh, in_specs=(P(sp), P(sp)),
                   out_specs=P(sp))

    def wrapped(stream_cf: CF):
        return fn(stream_cf.re, stream_cf.im)

    return jax.jit(wrapped)


# ---------------------------------------------------------------------------
# sp: full end-to-end time-sharded RX chain
# ---------------------------------------------------------------------------

def rx_chain_sp(cfg: PhyConfig, mesh: Mesh, mpdu_len: int = 0,
                max_pkts_per_shard: int = 512):
    """Build the fused detect->sync->decode->count chain, time-sharded.

    The IQ timeline is split into contiguous per-chip blocks.  Each chip
    pulls a halo of (packet span + sync lookahead) samples from its right
    neighbor (``ppermute``), runs the identical local fused chain
    (models.rx.rx_chain_count's body) on block+halo, owns exactly the
    packets whose trigger falls inside its private block, and the global
    (n_fcs_ok, n_detected) pair is one psum.  This is the overlap-save
    translation of the reference's streaming state machines
    (SURVEY.md section 5 "long-context handling").
    """
    from ..models.rx import (_sync_core, _payload_core, _data_start,
                             TRIG_DEDUP_SPACING)

    sp = mesh.axis_names[-1]
    n_need = _data_start(cfg) + 80 * cfg.nsym
    halo = n_need + 700          # packet span + trigger->ltf slack
    LH = 256                     # left halo: correlator context so a plateau
    #                              straddling the boundary is not re-detected
    #                              as a fresh edge start by the right shard

    def local_chain(block_re, block_im):
        blk = CF(block_re.reshape(-1), block_im.reshape(-1))
        n_local = blk.shape[0]
        n_dev = jax.lax.axis_size(sp)
        left = [(i, (i - 1) % n_dev) for i in range(n_dev)]
        right = [(i, (i + 1) % n_dev) for i in range(n_dev)]

        def pull_head(v):    # right neighbor's head -> my tail extension
            return jax.lax.ppermute(
                jax.lax.dynamic_slice(v, (0,), (halo,)), sp, perm=left)

        def pull_tail(v):    # left neighbor's tail -> my left context
            return jax.lax.ppermute(
                jax.lax.dynamic_slice(v, (v.shape[0] - LH,), (LH,)),
                sp, perm=right)

        ext = CF(jnp.concatenate([pull_tail(blk.re), blk.re, pull_head(blk.re)]),
                 jnp.concatenate([pull_tail(blk.im), blk.im, pull_head(blk.im)]))
        m4 = FE.stf_metric_strided(ext)
        cand = FE.detect_plateaus_strided(m4, max_out=3 * max_pkts_per_shard)
        # ownership rule: a packet belongs to the shard holding its trigger
        # (candidates in the halos are the neighbors'); -1 holes stay safe
        # for dedup (diff vs -1 is large, -1 itself is dropped)
        cand = jnp.where((cand >= LH) & (cand < LH + n_local), cand, -1)
        # -1s sort to the front of dedup's ascending diff chain; mask after
        trigs = FE.dedup_triggers_device(cand, max_pkts_per_shard,
                                         spacing=TRIG_DEDUP_SPACING)
        valid = trigs >= 0
        trigs = jnp.maximum(trigs, 0)
        ltf_idx, peak, cfo, _rssi = _sync_core(ext, trigs)
        valid &= (peak > 0.5) & (ltf_idx + n_need < ext.shape[-1])
        ltf_idx = jnp.clip(ltf_idx, 0, ext.shape[-1] - n_need - 1)
        out = _payload_core(cfg, CF(ext.re[None], ext.im[None]), ltf_idx,
                            cfo, nrx=1, mpdu_len=mpdu_len)
        ok = out.get("mpdu_fcs_ok", out.get("fcs_ok"))
        n_ok = jax.lax.psum(jnp.sum((ok & valid).astype(jnp.int32)), sp)
        n_det = jax.lax.psum(jnp.sum(valid.astype(jnp.int32)), sp)
        return n_ok, n_det

    # check_vma=False: the GPU Viterbi inside _payload_core has no
    # varying-mesh-axes annotation; each shard runs it purely locally
    fn = jax.shard_map(local_chain, mesh=mesh, in_specs=(P(sp), P(sp)),
                       out_specs=(P(), P()), check_vma=False)

    def wrapped(stream_cf: CF):
        return fn(stream_cf.re, stream_cf.im)

    return jax.jit(wrapped), halo


# ---------------------------------------------------------------------------
# dp: MU-STA fused chain, one stream shard per chip
# ---------------------------------------------------------------------------

def mu_chain_dp(cfg: PhyConfig, mesh: Mesh, n_total: int, own: int,
                mpdu_len: int = 0, max_pkts_per_shard: int = 16):
    """Build a dp-sharded MU-STA chain: each chip runs the fused
    detect -> SIG-B -> per-user payload program (models.rx.rx_chain_count_mu)
    on its own (L,) stream shard; global counts are one psum.  This is the
    demod(mupos) MU receiver scaled across a device mesh — input shape
    (n_dev, L), one independent capture per chip."""
    from ..models import rx as RXM

    def local(stream_re, stream_im):
        dev = CF(stream_re.reshape(1, -1), stream_im.reshape(1, -1))
        n_ok, n_det = RXM.rx_chain_count_mu(
            cfg, dev, n_total=n_total, own=own, nrx=1, mpdu_len=mpdu_len,
            max_pkts=max_pkts_per_shard)
        return jax.lax.psum(n_ok, "dp"), jax.lax.psum(n_det, "dp")

    fn = jax.shard_map(local, mesh=mesh,
                       in_specs=(P("dp", None), P("dp", None)),
                       out_specs=(P(), P()), check_vma=False)

    def wrapped(streams_cf: CF):
        return fn(streams_cf.re, streams_cf.im)

    return jax.jit(wrapped)
