"""Batched OFDM demodulation ops (jit-able, packet-batch leading axis).

All functions operate on (B, ...) :class:`CF` float-pair arrays so the whole
RX pipeline for a bucket of same-config packets is one fused XLA program:
matmul DFT over (B*nsym, 64), equalization, pilot phase tracking, LLR
demap and the deinterleave/stream-deparse gathers.  Numerics mirror the gold
receiver (``gold/rx.py``), which mirrors the reference demod blocks.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..spec import tables as T
from ..spec.params import Fmt, PhyConfig
from .cplx import CF, dft64, csum


def fft_syms(wins: CF) -> CF:
    """(..., 64) time windows -> fftshifted grids (matmul DFT)."""
    return dft64(wins)


def extract_sym_windows(xs: CF, start: int, nsym: int) -> CF:
    """xs (B, n) CFO-corrected samples -> (B, nsym, 64) FFT windows, for
    symbols whose GIs begin at start + 80*k.

    Gather-free: the 80-sample symbol stride makes the windows a reshape +
    static slice (requires n >= start + 16 + 80*nsym; callers over-fetch
    16 samples)."""
    B = xs.shape[0]
    s0 = start + T.N_GI
    if xs.shape[1] >= s0 + 80 * nsym:
        span = xs[:, s0: s0 + 80 * nsym]
        return CF(span.re.reshape(B, nsym, 80)[:, :, :64],
                  span.im.reshape(B, nsym, 80)[:, :, :64])
    idx = (s0 + 80 * np.arange(nsym)[:, None]
           + np.arange(64)[None, :]).reshape(-1)
    return CF(xs.re[:, idx].reshape(B, nsym, 64),
              xs.im[:, idx].reshape(B, nsym, 64))


# real-valued reference grids / masks as host constants
_LTF_L_REF = T.LTF_L_GRID.real.astype(np.float32)
_LTF_L_NZ = (_LTF_L_REF != 0)
_LTF_L_INV = np.where(_LTF_L_NZ, 1.0 / np.where(_LTF_L_NZ, _LTF_L_REF, 1), 0.0).astype(np.float32)
_LTF_NL_REF = T.LTF_NL_GRID.real.astype(np.float32)
_LTF_NL_NZ = (_LTF_NL_REF != 0)
_LTF_NL_INV = np.where(_LTF_NL_NZ, 1.0 / np.where(_LTF_NL_NZ, _LTF_NL_REF, 1), 0.0).astype(np.float32)


def legacy_chanest(xs: CF, ltf_start: int = 0) -> CF:
    """(B, n) -> (B, 64) legacy channel estimate from the two L-LTF repeats."""
    l1 = fft_syms(xs[:, ltf_start: ltf_start + 64])
    l2 = fft_syms(xs[:, ltf_start + 64: ltf_start + 128])
    h = (l1 + l2) * (0.5 * _LTF_L_INV)
    return CF(jnp.where(_LTF_L_NZ, h.re, 1.0), jnp.where(_LTF_L_NZ, h.im, 0.0))


def nl_chanest(xs: CF, ltf_start: int, nltf: int, nss: int,
               nrx_axis: bool = False) -> tuple[CF, CF]:
    """Non-legacy P-matrix channel estimate.

    xs: (B, n) or (B, nrx, n).  Returns (h, pilot_h):
    h (B, [nrx,] nss, 64), pilot_h (B, [nrx,] 4) summed-stream R-combined.
    """
    if not nrx_axis:
        xs = xs[:, None, :]
    grids = []
    for j in range(nltf):
        w = xs[:, :, ltf_start + 80 * j + 16: ltf_start + 80 * j + 80]
        grids.append(fft_syms(w))   # (B, nrx, 64)
    hs = []
    for s in range(nss):
        comb = grids[0] * float(T.P_LTF[s, 0])
        for j in range(1, nltf):
            comb = comb + grids[j] * float(T.P_LTF[s, j])
        h = comb * (_LTF_NL_INV / nltf)
        hs.append(CF(jnp.where(_LTF_NL_NZ, h.re, 1.0),
                     jnp.where(_LTF_NL_NZ, h.im, 0.0)))
    h = CF(jnp.stack([x.re for x in hs], axis=2),
           jnp.stack([x.im for x in hs], axis=2))     # (B, nrx, nss, 64)
    pref = _LTF_NL_REF[T.PILOT_IDX]
    pcomb = grids[0][:, :, T.PILOT_IDX] * float(T.R_LTF[0])
    for j in range(1, nltf):
        pcomb = pcomb + grids[j][:, :, T.PILOT_IDX] * float(T.R_LTF[j])
    pilot_h = pcomb * (1.0 / (pref * nltf))
    if not nrx_axis:
        return h[:, 0], pilot_h[:, 0]
    return h, pilot_h


@functools.lru_cache(maxsize=None)
def _delay_projector(legacy: bool = False):
    """(active idx, P_re, P_im): weighted LS projector onto the <=32-tap
    delay subspace over the 56 non-legacy (52 legacy) active tones.

    A single-LTF channel estimate carries one full data-tone noise
    variance COMMON to every data symbol of the packet — the dominant
    mid-SNR impairment (measured: genie-h cuts 26 dB hard errors 150x).
    Physical channels are confined to ~CP-length delay spread, so h lives
    in a <=32-dim subspace of the 56-tone space (taps [-4, 28) cover the
    1..15-early FFT window placement plus a full 16-tap CP spread);
    projecting removes 56-32 noise dimensions with zero bias.  Guard-tone
    nulls make naive IFFT-truncate biased — the weighted LS projector
    (weights 3:1 for L-combined vs NL-only tones, see refine_chanest_siso)
    handles the masked spectrum exactly."""
    act = np.flatnonzero(_LTF_L_NZ if legacy else _LTF_NL_NZ)
    ks = np.where(act > 32, act - 64, act).astype(np.float64)
    taps = np.arange(-4, 28)
    F = np.exp(-2j * np.pi * ks[:, None] * taps[None, :] / 64)
    # nominal per-tone observation counts after the L-LTF combine and the
    # decision-directed SIG passes (common L tones ~6, NL-only edge ~2);
    # legacy estimates come from the 2 L-LTF symbols only (uniform 2)
    wts = (np.full(act.shape, 2.0) if legacy
           else np.where(_LTF_L_NZ[act], 6.0, 2.0))
    P = F @ np.linalg.solve((F.conj().T * wts[None, :]) @ F,
                            F.conj().T * wts[None, :])
    # numpy (not jnp): cached values must stay host constants or they leak
    # tracers when first materialized inside another trace
    return (act.astype(np.int32), P.real.astype(np.float32),
            P.imag.astype(np.float32))


#: legacy->NL LTF tone-power ratio (52 vs 56 active tones)
_L_TO_NL_GAIN = float(np.sqrt(52.0 / 56.0))
#: rows whose legacy-portion channel does not cohere with the NL estimate
#: (beamformed SU: the L-preamble is sent without Q; or interference) keep
#: the NL-only estimate — the combine must never corrupt those
_REFINE_COH = 0.85


def refine_chanest_siso(xs: CF, h: CF, pilot_h: CF,
                        fmt: Fmt | None = None,
                        sigb_gi: int | None = None) -> tuple[CF, CF]:
    """1-stream channel-estimate refinement: L-LTF combine + delay-subspace
    projection.  ~-7 dB estimate noise vs the raw single-LTF estimate.

    The packet's OWN L-LTF (2 symbols, already inside the derotated
    window) observes the same channel as the NL LTF for non-beamformed
    1-stream transmissions: after the deterministic sqrt(52/56) tone-gain
    and a per-row constant phase (residual CFO drift over the legacy->NL
    gap, estimated from the estimates themselves), the two combine 2:1 by
    symbol count.  A per-row coherence gate keeps rows where the two
    channels genuinely differ on the raw NL estimate.  The combined
    estimate then projects onto the delay subspace (_delay_projector).
    The reference estimates from the NL LTF alone (gr-ieee80211
    lib/demod_impl.cc LTF processing); this refinement is how this
    build beats it on mid-SNR PER.

    Decision-directed SIG observations: the L-SIG / HT-SIG / VHT-SIG-A /
    VHT-SIG-B symbols are (Q)BPSK — hard-slicing the equalized tone signs
    recovers each symbol's ideal grid without any Viterbi, giving 3-4
    extra channel observations per packet (sign errors at packet-
    decodable SNR are per-tone BPSK rare).  Each observation is phase-
    aligned to the running estimate from its own data tones (no pilot
    polarity bookkeeping) and coherence-gated like the L-LTF.

    xs: (B, nrx, n) derotated windows (origin = ltf_idx); h: (B, nrx, 1,
    64); pilot_h: (B, nrx, 4).  fmt/sigb_gi: enable the SIG-symbol
    observations for the given format (sigb_gi = data_start - 80 for
    VHT; None otherwise).  Returns refined (h, pilot_h).
    """
    nrx = xs.shape[1]
    act_np, pre_np, pim_np = _delay_projector()
    act = jnp.asarray(act_np)
    p_re = jnp.asarray(pre_np)
    p_im = jnp.asarray(pim_np)
    nzl = jnp.asarray(_LTF_L_NZ.astype(np.float32))
    nznl = jnp.asarray(_LTF_NL_NZ.astype(np.float32))
    # QBPSK SIG symbols rotate only the DATA tones; their pilots stay
    # real BPSK, so imag-slicing them would inject wrong-phase values —
    # QBPSK observations cover data tones only
    dmask_np = np.zeros(64, np.float32)
    dmask_np[T.DATA_IDX_L] = 1.0
    dmask = jnp.asarray(dmask_np)

    def gated_obs(obs: CF, ref: CF, nz: jax.Array):
        """Phase-align a decision-directed observation to ``ref`` and
        coherence-gate it; returns (aligned CF, per-row weight)."""
        num = csum(ref.mul_conj(obs) * nz[None, :], axis=1)
        e_o = jnp.sum((obs.re ** 2 + obs.im ** 2) * nz[None, :], axis=1)
        e_r = jnp.sum((ref.re ** 2 + ref.im ** 2) * nz[None, :], axis=1)
        coh = num.abs() / jnp.sqrt(jnp.maximum(e_o * e_r, 1e-12))
        corr = num.unit()
        rot = obs * CF(corr.re[:, None], corr.im[:, None])
        return rot, (coh > _REFINE_COH).astype(jnp.float32)

    out_re, out_im = [], []
    for r in range(nrx):
        h_l = legacy_chanest(xs[:, r], 0) * _L_TO_NL_GAIN
        h_n = h[:, r, 0]
        h_lr, g_l = gated_obs(h_l, h_n, nzl)
        w_l = 2.0 * nzl[None, :] * g_l[:, None]
        num_re = w_l * h_lr.re + h_n.re
        num_im = w_l * h_lr.im + h_n.im
        den = w_l + 1.0
        if fmt is not None:
            # decision-directed (Q)BPSK SIG symbols on the legacy layout:
            # VHT = L-SIG(re) + SIG-A1(re) + SIG-A2(im);
            # HT = L-SIG(re) + HT-SIG1(im) + HT-SIG2(im)
            qbpsk = ((False, False, True) if fmt == Fmt.VHT
                     else (False, True, True))
            running = CF(num_re / den, num_im / den)
            for gi, qb in zip((128, 208, 288), qbpsk):
                g = fft_syms(xs[:, r, gi + 16: gi + 80])
                eq = g.mul_conj(running)          # ~ s * |h|^2 (+noise)
                if qb:                            # ideal = j*s, s = ±1
                    s = jnp.sign(eq.im) + (eq.im == 0)
                    obs = CF(g.im * s, -g.re * s)
                    m = dmask
                else:                             # ideal = s (pilots too)
                    s = jnp.sign(eq.re) + (eq.re == 0)
                    obs = CF(g.re * s, g.im * s)
                    m = nzl
                o, g_i = gated_obs(obs, running, m)
                w_i = m[None, :] * (g_l * g_i)[:, None]
                num_re = num_re + w_i * o.re
                num_im = num_im + w_i * o.im
                den = den + w_i
            if sigb_gi is not None:               # VHT-SIG-B: NL layout
                running = CF(num_re / den, num_im / den)
                g = fft_syms(xs[:, r, sigb_gi + 16: sigb_gi + 80])
                eq = g.mul_conj(running)
                s = jnp.sign(eq.re) + (eq.re == 0)
                obs = CF(g.re * s, g.im * s)
                o, g_i = gated_obs(obs, running, nznl)
                w_i = nznl[None, :] * g_i[:, None]
                num_re = num_re + w_i * o.re
                num_im = num_im + w_i * o.im
                den = den + w_i
        hc_re = num_re / den
        hc_im = num_im / den
        a_re, a_im = hc_re[:, act], hc_im[:, act]
        s_re = a_re @ p_re.T - a_im @ p_im.T
        s_im = a_re @ p_im.T + a_im @ p_re.T
        out_re.append(hc_re.at[:, act].set(s_re))
        out_im.append(hc_im.at[:, act].set(s_im))
    h_re = jnp.stack(out_re, axis=1)[:, :, None, :]
    h_im = jnp.stack(out_im, axis=1)[:, :, None, :]
    hr = CF(h_re, h_im)
    return hr, CF(h_re[:, :, 0, T.PILOT_IDX], h_im[:, :, 0, T.PILOT_IDX])


@functools.lru_cache(maxsize=None)
def _pilot_matrix(fmt: Fmt, nss: int, nsym: int) -> np.ndarray:
    from ..gold.tx import data_pilots
    return data_pilots(fmt, nss, nsym).astype(np.float32)  # (nsym, nss, 4)


#: data-aided pass coherence gate — decisions are made against the prior
#: estimate, so the data-derived channel is phase-aligned by construction
#: and decoherence only appears when the slicer output is garbage
_DD_COH = 0.80


def refine_chanest_data(grids: CF, h: CF, pilot_h: CF,
                        cfg: PhyConfig) -> tuple[CF, CF]:
    """Decision-directed DATA-symbol second-pass channel refinement (1 SS).

    The preamble-only estimate (even after :func:`refine_chanest_siso`)
    carries ~6 observations per tone; the payload itself carries ``nsym``
    more.  Hard-slicing each equalized data tone to the nearest QAM point
    recovers the transmitted grid without any decoding (at packet-decodable
    SNR per-tone symbol errors are rare, and an error lands on an adjacent
    point so its bias is bounded), and the per-symbol pilot polarities are
    known exactly — so one extra ZF pass turns every payload symbol into a
    channel observation.  Observations are LS-weighted by decided-symbol
    energy, combined with the prior estimate under its nominal observation
    count, coherence-gated per (row, rx) and re-projected onto the delay
    subspace (:func:`_delay_projector`).  Unlike the L-LTF combine this is
    safe under SU beamforming: the data symbols see exactly the effective
    channel the NL-LTF measured.  The reference never re-estimates after
    the preamble (gr-ieee80211 lib/demod_impl.cc); this pass is the
    round-5 mid-SNR lever on top of refine_chanest_siso.

    grids: (B, nrx, nsym, 64) FFT'd symbol grids (pre phase-correction);
    h: (B, nrx, 1, 64); pilot_h: (B, nrx, 4).  Returns refined (h, pilot_h).
    """
    assert cfg.nss == 1
    legacy = cfg.fmt == Fmt.L
    B, nrx, nsym, _ = grids.shape
    didx = T.DATA_IDX_L if legacy else T.DATA_IDX_NL
    act_np, pre_np, pim_np = _delay_projector(legacy)
    act = jnp.asarray(act_np)
    p_re = jnp.asarray(pre_np)
    p_im = jnp.asarray(pim_np)
    pilots = _pilot_matrix(cfg.fmt, 1, nsym)[:, 0]        # (nsym, 4) real

    # per-symbol common-phase correction, same convention as the equalizer
    exp_p = CF(pilot_h.re[:, :, None, :] * pilots[None, None],
               pilot_h.im[:, :, None, :] * pilots[None, None])
    rx_p = grids[:, :, :, T.PILOT_IDX]                    # (B,nrx,nsym,4)
    ph = csum(rx_p.mul_conj(exp_p), axis=(1, 3)).unit()   # (B, nsym)

    # ZF combine across nrx, slice to the nearest constellation point
    # (f32 throughout: a bf16 interior was built and measured — no
    # wall-clock change at either bench point, the pass is not
    # bandwidth-bound at these tensor sizes, and it cost 840 -> 822
    # decoded packets at 18 dB from decision-boundary quantization)
    phc = CF(ph.re[:, None, :, None], -ph.im[:, None, :, None])
    y = CF(grids.re[:, :, :, didx], grids.im[:, :, :, didx]) * phc
    hd = CF(h.re[:, :, 0][:, :, didx], h.im[:, :, 0][:, :, didx])
    g00 = jnp.sum(hd.abs2(), axis=1)                      # (B, nsd)
    r0 = csum(hd.conj().reshape(B, nrx, 1, -1) * y, axis=1)
    eq = r0 * (1.0 / jnp.maximum(g00, 1e-20))[:, None, :]  # (B,nsym,nsd)
    k = float(T.KMOD[cfg.nbpscs])
    if cfg.nbpscs == 1:
        s = CF(jnp.sign(eq.re) + (eq.re == 0), jnp.zeros_like(eq.re))
    else:
        lev = 1 << (cfg.nbpscs // 2)                      # points per axis

        def _slice_axis(v):
            q = jnp.clip(jnp.round((v * k - 1.0) * 0.5),
                         -(lev // 2), lev // 2 - 1)
            return (2.0 * q + 1.0) * (1.0 / k)

        s = CF(_slice_axis(eq.re), _slice_axis(eq.im))
    es = jnp.sum(s.abs2(), axis=1)                        # (B, nsd)
    prod = y * CF(s.re[:, None], -s.im[:, None])
    num = CF(jnp.sum(prod.re, axis=2), jnp.sum(prod.im, axis=2))
    # pilot tones: transmitted values known exactly (polarity sequence)
    num_p = csum(rx_p * CF(ph.re[:, None, :, None] * pilots[None, None],
                           -ph.im[:, None, :, None] * pilots[None, None]),
                 axis=2)                                  # (B, nrx, 4)

    # coherence gate per (row, rx): data-derived vs prior over data tones
    hd_dd = num * (1.0 / jnp.maximum(es, 1e-12))[:, None, :]
    cg = csum(hd_dd.mul_conj(hd), axis=2)                 # (B, nrx)
    e_p = jnp.sum(hd.abs2(), axis=2)
    e_d = jnp.sum(hd_dd.abs2(), axis=2)
    gate = (cg.abs() / jnp.sqrt(jnp.maximum(e_p * e_d, 1e-20))
            > _DD_COH).astype(jnp.float32)                # (B, nrx)

    # weighted combine on the 64-tone grid (prior nominal counts: 6/2
    # after refine_chanest_siso, uniform 2 for the legacy 2-symbol LTF,
    # matching _delay_projector's weighting assumptions; inactive tones
    # get weight 1 with zero observations so they pass the prior through)
    if legacy:
        w0 = jnp.asarray(np.where(_LTF_L_NZ, 2.0, 1.0).astype(np.float32))
    else:
        w0 = jnp.asarray(np.where(_LTF_NL_NZ,
                                  np.where(_LTF_L_NZ, 6.0, 2.0),
                                  1.0).astype(np.float32))
    den64 = (jnp.zeros((B, 1, 64), jnp.float32)
             .at[:, :, didx].add(es[:, None])
             .at[:, :, T.PILOT_IDX].add(jnp.float32(nsym)))
    num64 = CF(jnp.zeros((B, nrx, 64), jnp.float32)
               .at[:, :, didx].add(num.re).at[:, :, T.PILOT_IDX].add(num_p.re),
               jnp.zeros((B, nrx, 64), jnp.float32)
               .at[:, :, didx].add(num.im).at[:, :, T.PILOT_IDX].add(num_p.im))
    g = gate[:, :, None]
    hc_re = (w0 * h[:, :, 0].re + g * num64.re) / (w0 + g * den64)
    hc_im = (w0 * h[:, :, 0].im + g * num64.im) / (w0 + g * den64)
    a_re, a_im = hc_re[..., act], hc_im[..., act]
    s_re = a_re @ p_re.T - a_im @ p_im.T
    s_im = a_re @ p_im.T + a_im @ p_re.T
    hc_re = hc_re.at[..., act].set(s_re)
    hc_im = hc_im.at[..., act].set(s_im)
    hr = CF(hc_re[:, :, None, :], hc_im[:, :, None, :])
    return hr, CF(hc_re[..., T.PILOT_IDX], hc_im[..., T.PILOT_IDX])


def equalize_and_demap(grids: CF, h: CF, pilot_h: CF,
                       cfg: PhyConfig, nrx_axis: bool = False) -> jax.Array:
    """Per-symbol pilot phase correction + (ZF) equalization + LLR demap.

    grids: (B, [nrx,] nsym, 64); h: (B, [nrx,] nss, 64); pilot_h (B, [nrx,] 4).
    Returns interleaved LLRs (B, nss, nsym*ncbpss) float32.
    """
    legacy = cfg.fmt == Fmt.L
    didx = T.DATA_IDX_L if legacy else T.DATA_IDX_NL
    pilots = _pilot_matrix(cfg.fmt, cfg.nss, cfg.nsym)      # (nsym, nss, 4) real
    if not nrx_axis:
        grids, h, pilot_h = grids[:, None], h[:, None], pilot_h[:, None]
    B, nrx, nsym, _ = grids.shape

    # expected pilot per (sym, rx): HT 2SS uses per-stream pilot channel
    if cfg.fmt == Fmt.HT and cfg.nss == 2:
        hp = h[:, :, :, T.PILOT_IDX]                         # (B,nrx,nss,4)
        exp_re = jnp.einsum("brsk,nsk->brnk", hp.re, pilots)
        exp_im = jnp.einsum("brsk,nsk->brnk", hp.im, pilots)
        exp_p = CF(exp_re, exp_im)
    else:
        p0 = pilots[:, 0]                                    # (nsym, 4) real
        exp_p = CF(pilot_h.re[:, :, None, :] * p0[None, None],
                   pilot_h.im[:, :, None, :] * p0[None, None])
    rx_p = grids[:, :, :, T.PILOT_IDX]                       # (B,nrx,nsym,4)
    corr = csum(rx_p.mul_conj(exp_p), axis=(1, 3))           # (B, nsym)
    ph = corr.unit()
    grids = grids * CF(ph.re[:, None, :, None], -ph.im[:, None, :, None])

    y = grids[:, :, :, didx]                                 # (B,nrx,nsym,nsd)
    hd = h[:, :, :, didx]                                    # (B,nrx,nss,nsd)
    if cfg.nss == 1 and nrx == 1:
        eq = (y[:, 0] / hd[:, 0, 0][:, None, :])[:, None]    # (B,1,nsym,nsd)
    else:
        # ZF via normal equations; for nss<=2 the Gram diagonal is real
        g00 = jnp.sum(hd[:, :, 0].abs2(), axis=1)            # (B, nsd)
        r0 = csum(hd[:, :, 0].conj().reshape(B, nrx, 1, -1) * y, axis=1)
        if cfg.nss == 1:
            eq = (r0 * (1.0 / jnp.maximum(g00, 1e-20))[:, None, :])[:, None]
        else:
            g11 = jnp.sum(hd[:, :, 1].abs2(), axis=1)
            g01 = csum(hd[:, :, 0].conj().reshape(B, nrx, -1)
                       * hd[:, :, 1], axis=1)                # (B, nsd)
            r1 = csum(hd[:, :, 1].conj().reshape(B, nrx, 1, -1) * y, axis=1)
            det = g00 * g11 - g01.abs2()                     # real (B, nsd)
            inv = (1.0 / jnp.where(jnp.abs(det) > 1e-20, det, 1e-20))
            e0 = r0 * g11[:, None, :] - r1 * CF(g01.re[:, None, :], g01.im[:, None, :])
            e1 = r1 * g00[:, None, :] - r0 * CF(g01.re[:, None, :], -g01.im[:, None, :])
            eq = CF(jnp.stack([e0.re, e1.re], axis=1) * inv[:, None, None, :],
                    jnp.stack([e0.im, e1.im], axis=1) * inv[:, None, None, :])
    # eq: (B, nss, nsym, nsd)
    llr = llr_demap(eq, cfg.nbpscs)                          # (B,nss,nsym,ncbpss)
    return llr.reshape(B, cfg.nss, -1)


def llr_demap(eq: CF, nbpscs: int) -> jax.Array:
    """(..., nsd) equalized QAM -> (..., nsd*nbpscs) piecewise-linear LLRs."""
    k = float(T.KMOD[nbpscs])
    zr, zi = eq.re * k, eq.im * k
    if nbpscs == 1:
        return zr.astype(jnp.float32)
    half = nbpscs // 2
    outs = []
    for v in (zr, zi):
        cur = v
        axis_llrs = [cur]
        for b in range(1, half):
            cur = (1 << (half - b)) - jnp.abs(cur)
            axis_llrs.append(cur)
        outs.append(jnp.stack(axis_llrs, axis=-1))
    out = jnp.concatenate(outs, axis=-1)   # (..., nsd, nbpscs)
    return out.reshape(*zr.shape[:-1], -1).astype(jnp.float32)


@functools.lru_cache(maxsize=None)
def _deint_deparse_perm(fmt: Fmt, nbpscs: int, nss: int, nsym: int) -> np.ndarray:
    """Combined gather: interleaved per-stream LLR array (nss, nsym*ncbpss)
    flattened -> coded-stream order (nsym*ncbps,)."""
    legacy = fmt == Fmt.L
    nsd = 48 if legacy else 52
    ncbpss = nsd * nbpscs
    ncbps = ncbpss * nss
    perms = [T.interleave_perm_legacy(nbpscs) if legacy
             else T.interleave_perm_nl(nbpscs, iss, nss) for iss in range(nss)]
    out = np.empty(nsym * ncbps, dtype=np.int64)
    sp = T.stream_parser_perm(nbpscs, nss, 1, ncbpss)  # (nss, ncbpss)
    for sym in range(nsym):
        base = sym * ncbps
        for iss in range(nss):
            coded_pos = base + sp[iss]
            flat = iss * (nsym * ncbpss) + sym * ncbpss + perms[iss]
            out[coded_pos] = flat
    return out


def deinterleave_deparse(llr: jax.Array, cfg: PhyConfig) -> jax.Array:
    """(B, nss, nsym*ncbpss) interleaved LLRs -> (B, nsym*ncbps) coded order."""
    perm = _deint_deparse_perm(cfg.fmt, cfg.nbpscs, cfg.nss, cfg.nsym)
    B = llr.shape[0]
    return llr.reshape(B, -1)[:, perm]


@functools.lru_cache(maxsize=None)
def _descramble_tables():
    seq127 = T.scramble_seq(0x7F, 127)
    off = np.zeros(128, dtype=np.int32)
    ext = np.concatenate([seq127, seq127[:7]])
    for o in range(127):
        w = 0
        for i in range(7):
            w |= int(ext[o + i]) << i
        off[w] = o
    return seq127, off


@functools.lru_cache(maxsize=None)
def _descramble_matrix(n: int) -> np.ndarray:
    """(127, n) float32: row o = the 127-periodic scramble sequence shifted
    by offset o.  A packet's row is selected by a one-hot matmul (exact on
    0/1 values) instead of a (B, n) dynamic gather."""
    seq127, _ = _descramble_tables()
    idx = (np.arange(127)[:, None] + np.arange(n)[None, :]) % 127
    return seq127[idx].astype(np.float32)


def descramble_bits(bits: jax.Array) -> jax.Array:
    """(B, n) scrambled bits -> descrambled (first 7 bits zeroed)."""
    _, off_tab = _descramble_tables()
    B, n = bits.shape
    w = jnp.sum(bits[:, :7].astype(jnp.int32) * (1 << np.arange(7)), axis=1)
    off = jnp.asarray(off_tab)[w]                           # (B,)
    onehot = (off[:, None] == np.arange(127)[None, :]).astype(jnp.float32)
    seq = jnp.dot(onehot, _descramble_matrix(n),
                  preferred_element_type=jnp.float32)       # exact 0/1
    out = bits ^ seq.astype(bits.dtype)
    return out.at[:, :7].set(0)


def bits_to_bytes_batch(bits: jax.Array) -> jax.Array:
    """(B, 8*n) bits -> (B, n) uint8, LSB-first per byte."""
    B, nb = bits.shape
    return jnp.sum(bits.reshape(B, nb // 8, 8).astype(jnp.int32)
                   * (1 << np.arange(8)), axis=-1).astype(jnp.uint8)
