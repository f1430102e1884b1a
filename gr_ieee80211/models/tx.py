"""Batched transmit engine.

One jitted program per :class:`PhyConfig` maps a (B, psdu_len) byte batch to
(B, nss, n_samples) baseband CF waveforms:

* bit pipeline (scramble/BCC/puncture/stream-parse/interleave) as XOR
  convolutions and one static gather;
* QAM mapping as table lookups, grid assembly as static scatters;
* the IFFT as a matmul (``cplx.idft64``) over (B*nss*nsym, 64);
* the preamble as a per-config constant template and the symbol-boundary
  windowing as one static scale mask over the whole waveform.

Everything before the payload bits is identical across the batch, so XLA
folds it; numerics match the gold TX (= reference PY-TB) to float32.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..spec import tables as T
from ..spec.params import Fmt, PhyConfig, MuConfig
from ..gold import tx as GTX
from ..ops.cplx import CF, idft64
from ..ops import ofdm as OF


@functools.lru_cache(maxsize=None)
def _static_parts(cfg: PhyConfig, group_id: int, partial_aid: int):
    """Per-config constants: preamble template, pad bits, perms, masks."""
    from ..gold import sig as S

    nss = cfg.nss
    chunks = GTX.legacy_training(nss) + [GTX.lsig_field(cfg, nss)]
    sigb_crc = np.zeros(8, np.uint8)
    if cfg.fmt == Fmt.HT:
        chunks += GTX._dual_sym_sig(S.htsig_bits(cfg), nss, qbpsk_first=True)
        chunks += GTX.nl_training(nss, cfg.nltf, Fmt.HT)
    elif cfg.fmt == Fmt.VHT:
        chunks += GTX._dual_sym_sig(S.vhtsiga_bits(cfg, group_id, partial_aid),
                                    nss, qbpsk_first=False)
        chunks += GTX.nl_training(nss, cfg.nltf, Fmt.VHT)
        sigb, sigb_crc = S.vhtsigb_bits(cfg)
        chunks.append(GTX.vhtsigb_field(GTX.interleave_sigb(sigb), nss))
    pre = np.concatenate(chunks, axis=-1)          # (nss, n_pre), unhalved
    chunk_lens = [c.shape[-1] for c in chunks] + [80] * cfg.nsym

    # boundary window mask over the full waveform
    n_total = sum(chunk_lens)
    mask = np.ones(n_total, np.float32)
    pos = 0
    for ln in chunk_lens[:-1]:
        pos += ln
        mask[pos - 1] *= 0.5
        mask[pos] *= 0.5

    # service/pad bit template
    service = np.zeros(16, np.uint8)
    if cfg.fmt == Fmt.VHT:
        service[8:] = sigb_crc
        tail_bits = np.concatenate(
            [np.tile(T.VHT_EOF_BITS, cfg.n_pad_eof),
             np.zeros(8 * cfg.n_pad_octet, np.uint8),
             np.zeros(cfg.n_pad_bits, np.uint8)])
    else:
        tail_bits = np.zeros(6 * cfg.nes + cfg.n_pad_bits, np.uint8)

    # TX interleave+stream-parse permutation: the RX gather has
    # coded[i] = inter_flat[rxp[i]], so inter_flat = coded[:, g] with
    # g = rxp^{-1} (g[rxp[i]] = i)
    rxp = OF._deint_deparse_perm(cfg.fmt, cfg.nbpscs, cfg.nss, cfg.nsym)
    g = np.empty_like(rxp)
    g[rxp] = np.arange(len(rxp))

    # puncture keep indices
    pat = T.PUNCTURE[cfg.cr]
    n2 = 2 * cfg.n_trellis
    keep = np.tile(pat, -(-n2 // len(pat)))[:n2].astype(bool)
    punct_idx = np.nonzero(keep)[0].astype(np.int32)

    # pilots, CSD, per-symbol data grids scaffolding
    pilots = OF._pilot_matrix(cfg.fmt, cfg.nss, cfg.nsym)    # (nsym, nss, 4)
    csd = np.stack([T.csd_phase(T.CSD_NL_NS[nss - 1][s]) for s in range(nss)])
    qtab = T.qam_table(cfg.nbpscs)
    scale = 1.0 / np.sqrt((T.NTF_DATA_L if cfg.fmt == Fmt.L else T.NTF_DATA_NL) * nss)
    return dict(
        pre_re=pre.real.astype(np.float32), pre_im=pre.imag.astype(np.float32),
        mask=mask, service=service, tail=tail_bits, tx_perm=g,
        punct_idx=punct_idx, pilots=pilots,
        csd_re=csd.real.astype(np.float32), csd_im=csd.imag.astype(np.float32),
        qam_re=qtab.real.astype(np.float32), qam_im=qtab.imag.astype(np.float32),
        scale=np.float32(scale), n_total=n_total,
    )


def _bcc_encode_batch(bits: jax.Array) -> jax.Array:
    """(B, n) -> (B, 2n) rate-1/2 coded, via XOR of tap-shifted slices."""
    B, n = bits.shape
    h = jnp.concatenate([jnp.zeros((B, 6), bits.dtype), bits], axis=1)
    def tap(k):  # b_{t-k}
        return h[:, 6 - k: 6 - k + n]
    a = tap(0) ^ tap(2) ^ tap(3) ^ tap(5) ^ tap(6)
    c = tap(0) ^ tap(1) ^ tap(2) ^ tap(3) ^ tap(6)
    out = jnp.stack([a, c], axis=-1).reshape(B, 2 * n)
    return out


def _scramble_batch(bits: jax.Array, seeds: jax.Array) -> jax.Array:
    """XOR with the 127-periodic sequence starting at each packet's seed."""
    seq127, off_tab = OF._descramble_tables()
    # seed -> its first-7-output word -> cyclic offset
    word = np.zeros(128, np.int32)
    for sd in range(1, 128):
        w7 = T.scramble_seq(sd)[:7]
        word[sd] = int(sum(int(b) << i for i, b in enumerate(w7)))
    off = jnp.asarray(off_tab)[jnp.asarray(word)[seeds]]
    n = bits.shape[1]
    # one-hot matmul instead of a (B, n) dynamic gather (as in
    # ofdm.descramble_bits; exact on 0/1 values)
    onehot = (off[:, None] == np.arange(127)[None, :]).astype(jnp.float32)
    seq = jnp.dot(onehot, jnp.asarray(OF._descramble_matrix(n)),
                  preferred_element_type=jnp.float32)
    return bits ^ seq.astype(bits.dtype)


@functools.partial(jax.jit, static_argnames=("cfg", "group_id", "partial_aid"))
def tx_batch(cfg: PhyConfig, payload: jax.Array, seeds: jax.Array,
             group_id: int = 0, partial_aid: int = 0) -> CF:
    """(B, psdu-ish bytes) uint8 + (B,) seeds -> (B, nss, n_samples) CF.

    ``payload`` carries cfg.length bytes per packet (the A-MPDU for VHT).
    """
    st = _static_parts(cfg, group_id, partial_aid)
    B = payload.shape[0]
    pbits = ((payload[:, :, None] >> np.arange(8)[None, None, :]) & 1
             ).reshape(B, -1).astype(jnp.uint8)
    data_bits = jnp.concatenate(
        [jnp.tile(jnp.asarray(st["service"]), (B, 1)), pbits,
         jnp.tile(jnp.asarray(st["tail"]), (B, 1))], axis=1).astype(jnp.uint8)
    scrambled = _scramble_batch(data_bits, seeds)
    if cfg.fmt == Fmt.VHT:
        enc_in = jnp.concatenate(
            [scrambled[:, : cfg.n_trellis - 6],
             jnp.zeros((B, 6), jnp.uint8)], axis=1)
    else:
        enc_in = scrambled.at[:, 16 + 8 * cfg.psdu_len:
                              16 + 8 * cfg.psdu_len + 6 * cfg.nes].set(0)
    coded = _bcc_encode_batch(enc_in)[:, st["punct_idx"]]
    inter = coded[:, st["tx_perm"]]            # (B, nss*nsym*ncbpss) flat
    chips = inter.reshape(B, cfg.nss, cfg.nsym, cfg.nsd, cfg.nbpscs)
    chips = jnp.sum(chips.astype(jnp.int32) * (1 << np.arange(cfg.nbpscs)),
                    axis=-1)
    sym = CF(jnp.asarray(st["qam_re"])[chips], jnp.asarray(st["qam_im"])[chips])

    grids = CF(jnp.zeros((B, cfg.nss, cfg.nsym, 64)),
               jnp.zeros((B, cfg.nss, cfg.nsym, 64)))
    didx = T.DATA_IDX_L if cfg.fmt == Fmt.L else T.DATA_IDX_NL
    grids = CF(grids.re.at[:, :, :, didx].set(sym.re),
               grids.im.at[:, :, :, didx].set(sym.im))
    pil = st["pilots"].transpose(1, 0, 2)      # (nss, nsym, 4)
    grids = CF(grids.re.at[:, :, :, T.PILOT_IDX].set(pil[None]),
               grids.im)
    csd = CF(jnp.asarray(st["csd_re"])[None, :, None, :],
             jnp.asarray(st["csd_im"])[None, :, None, :])
    grids = grids * csd
    xt = idft64(grids) * st["scale"]           # (B, nss, nsym, 64)
    gi = xt[:, :, :, 48:]
    syms80 = CF(jnp.concatenate([gi.re, xt.re], axis=-1),
                jnp.concatenate([gi.im, xt.im], axis=-1))
    data_time = syms80.reshape(B, cfg.nss, cfg.nsym * 80)
    pre = CF(jnp.tile(jnp.asarray(st["pre_re"])[None], (B, 1, 1)),
             jnp.tile(jnp.asarray(st["pre_im"])[None], (B, 1, 1)))
    wave = CF(jnp.concatenate([pre.re, data_time.re], axis=-1),
              jnp.concatenate([pre.im, data_time.im], axis=-1))
    return wave * jnp.asarray(st["mask"])


# ---------------------------------------------------------------------------
# MU-MIMO / beamformed transmit
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _static_parts_mu(mu: MuConfig):
    """Per-MU-config constants.

    Everything before the non-legacy STF is Q-independent (the reference
    only spatially maps NL-STF/LTF/SIG-B and data symbols,
    /root/reference/lib/modulation2_impl.cc:121-126,203,362-363), so the
    legacy preamble + VHT-SIG-A is one static time-domain template; the
    Q-dependent fields are kept as CSD'd frequency grids and mixed with the
    runtime Q inside the jitted program.
    """
    from ..gold import sig as S

    nss = mu.nss_total
    assert nss <= 2, "reference envelope: <=2 total space-time streams"
    # -- Q-independent legacy/SIG-A template (nss, 640) --------------------
    leg_chunks = (GTX.legacy_training(nss) + [GTX.lsig_field(mu, nss)]
                  + GTX._dual_sym_sig(S.vhtsiga_bits(mu), nss,
                                      qbpsk_first=False))
    leg = np.concatenate(leg_chunks, axis=-1)
    # -- Q-dependent grids (CSD applied, Q deferred to runtime) ------------
    pilot_mask = np.zeros(64, dtype=bool)
    pilot_mask[T.PILOT_IDX] = True
    nl_grids = [GTX._apply_csd(np.tile(T.STF_GRID, (nss, 1)), nss, False)]
    nl_scales = [1.0 / np.sqrt(T.NTF_STF_NL * nss)]
    for i in range(mu.nltf):
        g = np.empty((nss, 64), dtype=np.complex128)
        for iss in range(nss):
            row = T.LTF_NL_GRID * T.P_LTF[iss, i]
            g[iss] = np.where(pilot_mask, T.LTF_NL_GRID * T.R_LTF[i], row)
        nl_grids.append(GTX._apply_csd(g, nss, False))
        nl_scales.append(1.0 / np.sqrt(T.NTF_LTF_NL * nss))
    # SIG-B: per-user bits, user streams stacked in order, then CSD
    sigb_streams, crcs = [], []
    for ucfg in mu.users:
        sigb, crc = S.vhtsigb_bits_mu(ucfg)
        crcs.append(crc)
        inted = GTX.interleave_sigb(sigb)
        for _ in range(ucfg.nss):
            sigb_streams.append(T.qam_table(1)[inted])
    g = np.zeros((nss, 64), dtype=np.complex128)
    for iss in range(nss):
        g[iss, T.DATA_IDX_NL] = sigb_streams[iss]
        g[iss, T.PILOT_IDX] = T.PILOT_VHT
    nl_grids.append(GTX._apply_csd(g, nss, False))
    nl_scales.append(1.0 / np.sqrt(T.NTF_SIGB * nss))
    nl_g = np.stack(nl_grids)                       # (nltf+2, nss, 64)

    # -- per-user bit-pipeline constants -----------------------------------
    users = []
    for u, ucfg0 in enumerate(mu.users):
        ucfg = mu.user_padded(u)
        service = np.zeros(16, np.uint8)
        service[8:] = crcs[u]
        tail = np.concatenate(
            [np.tile(T.VHT_EOF_BITS, ucfg.n_pad_eof),
             np.zeros(8 * ucfg.n_pad_octet, np.uint8),
             np.zeros(ucfg.n_pad_bits, np.uint8)])
        rxp = OF._deint_deparse_perm(Fmt.VHT, ucfg.nbpscs, ucfg.nss, ucfg.nsym)
        perm = np.empty_like(rxp)
        perm[rxp] = np.arange(len(rxp))
        pat = T.PUNCTURE[ucfg.cr]
        n2 = 2 * ucfg.n_trellis
        keep = np.tile(pat, -(-n2 // len(pat)))[:n2].astype(bool)
        qtab = T.qam_table(ucfg.nbpscs)
        users.append(dict(
            cfg=ucfg, service=service, tail=tail, tx_perm=perm,
            punct_idx=np.nonzero(keep)[0].astype(np.int32),
            qam_re=qtab.real.astype(np.float32),
            qam_im=qtab.imag.astype(np.float32)))

    # -- data-field constants ----------------------------------------------
    pilots = GTX.data_pilots(Fmt.VHT, nss, mu.nsym)  # (nsym, nss, 4)
    csd = np.stack([T.csd_phase(T.CSD_NL_NS[nss - 1][s]) for s in range(nss)])
    data_scale = 1.0 / np.sqrt(T.NTF_DATA_NL * nss)

    # -- boundary window mask ----------------------------------------------
    chunk_lens = ([c.shape[-1] for c in leg_chunks]
                  + [80] * (mu.nltf + 2) + [80] * mu.nsym)
    n_total = sum(chunk_lens)
    mask = np.ones(n_total, np.float32)
    pos = 0
    for ln in chunk_lens[:-1]:
        pos += ln
        mask[pos - 1] *= 0.5
        mask[pos] *= 0.5
    return dict(
        leg_re=leg.real.astype(np.float32), leg_im=leg.imag.astype(np.float32),
        nl_re=nl_g.real.astype(np.float32), nl_im=nl_g.imag.astype(np.float32),
        nl_scales=np.asarray(nl_scales, np.float32), users=tuple(users),
        pilots=pilots.astype(np.float32),
        csd_re=csd.real.astype(np.float32), csd_im=csd.imag.astype(np.float32),
        data_scale=np.float32(data_scale), mask=mask, n_total=n_total)


def _apply_q_grids(g: CF, q: CF, sub: str) -> CF:
    """Per-subcarrier spatial mapping out[...,i,...,k] = sum_j q[k,i,j] g[...,j,...,k].

    ``sub``: einsum pattern for the grids, e.g. "cjk" (preamble chunks) or
    "bjnk" (batched data symbols); j is the input-stream axis, k the
    subcarrier.  Four real einsums at full float32 precision: under the
    default precision the GPU runs them in TF32 (MU waveform max abs
    error vs the gold model 9.7e-6 on one H100, 9.6e-9 on the CPU).
    """
    out_sub = sub.replace("j", "i")
    ein = functools.partial(jnp.einsum, f"kij,{sub}->{out_sub}",
                            precision=jax.lax.Precision.HIGHEST)
    return CF(ein(q.re, g.re) - ein(q.im, g.im),
              ein(q.re, g.im) + ein(q.im, g.re))


def _gi80(xt: CF) -> CF:
    """(..., 64) time symbols -> (..., 80) GI-prefixed."""
    return CF(jnp.concatenate([xt.re[..., 48:], xt.re], axis=-1),
              jnp.concatenate([xt.im[..., 48:], xt.im], axis=-1))


@functools.partial(jax.jit, static_argnames=("mu",))
def tx_batch_mu(mu: MuConfig, payloads: tuple, seeds: jax.Array,
                q: CF) -> CF:
    """Device-batched MU-MIMO / beamformed VHT transmit.

    ``payloads``: per-user (B, len_u) uint8 arrays; ``seeds``: (B,) scramble
    seeds (applied to every user, like the gold model); ``q``: (64, nss,
    nss) CF per-subcarrier spatial mapping.  Returns (B, nss_total,
    n_samples) CF, float32-parity with :func:`gold.tx.tx_waveform_mu`.

    Batched mapping of the reference's streaming beamformer: the per-user bit
    pipelines (lib/encode2_impl.cc:129-216) are batched XOR-convs + one
    static gather each, and the per-subcarrier Q multiply
    (lib/modulation2_impl.cc:362-363, procNss2SymBfQ) is an einsum over the
    whole (B, nss, nsym, 64) grid tensor at once.
    """
    st = _static_parts_mu(mu)
    B = payloads[0].shape[0]
    nss = mu.nss_total

    # -- per-user encode -> QAM streams, stacked on the stream axis --------
    streams = []
    for u, ust in enumerate(st["users"]):
        ucfg: PhyConfig = ust["cfg"]
        pay = payloads[u]
        pbits = ((pay[:, :, None] >> np.arange(8)[None, None, :]) & 1
                 ).reshape(B, -1).astype(jnp.uint8)
        data_bits = jnp.concatenate(
            [jnp.tile(jnp.asarray(ust["service"]), (B, 1)), pbits,
             jnp.tile(jnp.asarray(ust["tail"]), (B, 1))], axis=1
        ).astype(jnp.uint8)
        scrambled = _scramble_batch(data_bits, seeds)
        enc_in = jnp.concatenate(
            [scrambled[:, : ucfg.n_trellis - 6],
             jnp.zeros((B, 6), jnp.uint8)], axis=1)
        coded = _bcc_encode_batch(enc_in)[:, ust["punct_idx"]]
        inter = coded[:, ust["tx_perm"]]
        chips = inter.reshape(B, ucfg.nss, ucfg.nsym, ucfg.nsd, ucfg.nbpscs)
        chips = jnp.sum(chips.astype(jnp.int32)
                        * (1 << np.arange(ucfg.nbpscs)), axis=-1)
        streams.append(CF(jnp.asarray(ust["qam_re"])[chips],
                          jnp.asarray(ust["qam_im"])[chips]))
    sym = CF(jnp.concatenate([s.re for s in streams], axis=1),
             jnp.concatenate([s.im for s in streams], axis=1))

    # -- data grids: scatter + pilots + CSD + Q + IFFT ---------------------
    grids = CF(jnp.zeros((B, nss, mu.nsym, 64)),
               jnp.zeros((B, nss, mu.nsym, 64)))
    grids = CF(grids.re.at[:, :, :, T.DATA_IDX_NL].set(sym.re),
               grids.im.at[:, :, :, T.DATA_IDX_NL].set(sym.im))
    pil = st["pilots"].transpose(1, 0, 2)           # (nss, nsym, 4)
    grids = CF(grids.re.at[:, :, :, T.PILOT_IDX].set(pil[None]), grids.im)
    csd = CF(jnp.asarray(st["csd_re"])[None, :, None, :],
             jnp.asarray(st["csd_im"])[None, :, None, :])
    grids = _apply_q_grids(grids * csd, q, "bjnk")
    xt = idft64(grids) * st["data_scale"]
    data_time = _gi80(xt).reshape(B, nss, mu.nsym * 80)

    # -- Q-dependent preamble fields (NL-STF / LTFs / SIG-B) ---------------
    nl_g = _apply_q_grids(CF(jnp.asarray(st["nl_re"]),
                             jnp.asarray(st["nl_im"])), q, "cjk")
    nl_t = idft64(nl_g) * jnp.asarray(st["nl_scales"])[:, None, None]
    nl_time = _gi80(nl_t).transpose(1, 0, 2).reshape(nss, -1)

    pre = CF(jnp.concatenate([jnp.asarray(st["leg_re"]), nl_time.re], axis=-1),
             jnp.concatenate([jnp.asarray(st["leg_im"]), nl_time.im], axis=-1))
    wave = CF(jnp.concatenate(
                  [jnp.tile(pre.re[None], (B, 1, 1)), data_time.re], axis=-1),
              jnp.concatenate(
                  [jnp.tile(pre.im[None], (B, 1, 1)), data_time.im], axis=-1))
    return wave * jnp.asarray(st["mask"])


class TxEngine:
    """Host-facing batched transmitter."""

    def tx(self, cfg: PhyConfig, payloads: list[bytes], seeds=None,
           group_id: int = 0, partial_aid: int = 0) -> np.ndarray:
        """Batch of equal-config payloads -> (B, nss, n_samples) complex64."""
        B = len(payloads)
        arr = np.zeros((B, cfg.length), np.uint8)
        for i, p in enumerate(payloads):
            assert len(p) == cfg.length
            arr[i] = np.frombuffer(p, np.uint8)
        if seeds is None:
            seeds = np.full(B, 93, np.int32)
        cf = tx_batch(cfg, jnp.asarray(arr), jnp.asarray(np.asarray(seeds, np.int32)),
                      group_id, partial_aid)
        return np.asarray(cf.re) + 1j * np.asarray(cf.im)

    def tx_mu(self, mu: MuConfig, payloads: list[list[bytes]],
              bfq: np.ndarray, seeds=None) -> np.ndarray:
        """MU batch: per-user payload lists -> (B, nss_total, n) complex64.

        ``payloads[u]`` holds user u's B equal-length byte strings; ``bfq``
        is the (64, nss, nss) per-subcarrier spatial mapping (the type-10
        wire blob's layout).
        """
        from ..ops.cplx import from_host
        B = len(payloads[0])
        arrs = []
        for u, ucfg in enumerate(mu.users):
            a = np.zeros((B, ucfg.length), np.uint8)
            for i, p in enumerate(payloads[u]):
                assert len(p) == ucfg.length
                a[i] = np.frombuffer(p, np.uint8)
            arrs.append(jnp.asarray(a))
        if seeds is None:
            seeds = np.full(B, 93, np.int32)
        cf = tx_batch_mu(mu, tuple(arrs),
                         jnp.asarray(np.asarray(seeds, np.int32)),
                         from_host(np.asarray(bfq)))
        return np.asarray(cf.re) + 1j * np.asarray(cf.im)
