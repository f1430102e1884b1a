"""Batched receive engine.

Two-phase design (SURVEY.md section 7): a streaming *detection* pass over the
raw IQ timeline (fused correlator metrics on device, candidate indices pulled
to host), then *bucketed fixed-shape decoding* — packets grouped by
(format, mcs, nss, nsym) and demodulated/decoded as one XLA program per
bucket: batched FFT -> equalize -> LLR -> gather deinterleave -> adaptive
BCC decode (ops.fastdecode) -> descramble -> matmul CRC32.

This replaces the reference's per-sample GNU Radio state machines
(lib/{trigger,sync,signal,demod,decode}_impl.cc) with packet-batch data
parallelism — the "packet parallelism" axis the reference lacks entirely.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..spec import tables as T
from ..spec.params import Fmt, PhyConfig
from ..gold import sig as S
from ..gold import mac as MAC
from ..ops import frontend as FE
from ..ops.cplx import CF, cstack, from_host, from_host_bf16
from ..ops import ofdm as OF
from ..ops import crc as CRC
from ..ops.fastdecode import adaptive_decode
from ..ops import viterbi as VXLA


# offsets relative to ltf_idx (nominal L-LTF window start)
LSIG_GI = 128
NLSIG_GI = 208

#: min spacing between distinct packet triggers: the VHT/HT-STF at +560 into
#: a packet re-fires the lag-16 detector, so fragments within this span are
#: one packet (preamble clusters span <700; packets are >=720 samples)
TRIG_DEDUP_SPACING = 700

#: decision-directed second-pass chanest gate: batches whose L-LTF
#: repeat-difference SNR proxy falls below this use the data-aided
#: estimate (ops.ofdm.refine_chanest_data).  23.5 dB is where the
#: first-pass mean syndrome crosses ~32 hard errors/row (the fastdecode
#: big-windowed-tier boundary at B=4096): below it the full Viterbi
#: sweep (or the largest tier) runs anyway and dd buys PER (+44%
#: decoded at 18 dB, measured) plus fewer dirty windows; above it the
#: windowed tiers are already cheap and the extra pass would cost
#: more than it saves.
DD_GATE_SNR_DB = 23.5

#: per-(nbpscs, coding rate) LOWER dd gate bound (dB): ~1.5 dB under the
#: modulation's AWGN PER waterfall.  Below it every packet in the batch
#: is lost regardless of estimate quality, so the dd pass would be pure
#: cost on batches that already pay the full-Viterbi floor.  Values are
#: coarse (waterfall midpoints measured with the CPU harness, minus
#: margin) — only the decade matters.
_DD_GATE_LO = {(1, "1/2"): 0.0, (1, "3/4"): 1.5,
               (2, "1/2"): 2.5, (2, "3/4"): 4.5,
               (4, "1/2"): 7.5, (4, "3/4"): 11.5,
               (6, "2/3"): 14.5, (6, "3/4"): 15.5, (6, "5/6"): 17.0,
               (8, "3/4"): 20.0, (8, "5/6"): 21.5}

#: bucket-shape canonicalization ladder (~1.25x geometric): live traffic maps
#: a long tail of payload lengths onto a handful of compiled programs instead
#: of one XLA program per (fmt, mcs, len, nsym).  The reference has no analog
#: (its per-sample state machines are shape-free); this is the accelerator-
#: side cost model: each new shape is a fresh multi-second compile.
_NSYM_LADDER = (1, 2, 3, 4, 5, 6, 8, 10, 13, 16, 20, 26, 32, 40, 52, 64,
                80, 104, 128, 160, 208, 256, 320, 416, 512, 640, 832, 1024,
                1366)

#: min extra trellis steps between the real tail and a canonically padded
#: trellis end: survivor paths merge within ~16 constraint lengths, so >=96
#: garbage steps leave the real payload bits identical to an exact-shape
#: decode (same bound as viterbi_gpu.SEG_OVERLAP)
_CANON_MERGE_STEPS = 96


@functools.lru_cache(maxsize=4096)
def canonical_cfg(cfg: PhyConfig) -> PhyConfig:
    """Round a data config's nsym up the ladder (padding the decode with
    garbage symbols) so many payload lengths share one compiled program.

    Returns ``cfg`` unchanged on an exact ladder hit, for MU/NDP configs,
    or when no rung gives both >= _CANON_MERGE_STEPS of trellis margin and
    a consistent max-length config (e.g. near the 4095 B cap)."""
    if cfg.mu_nsym or cfg.is_ndp:
        return cfg
    nsym = cfg.nsym

    def rung_cfg(rung):
        max_len = min((rung * cfg.ndbps - 16 - 6) // 8, 4095)
        cand = PhyConfig(cfg.fmt, cfg.mcs, cfg.nss, max_len, ampdu=cfg.ampdu)
        return cand if cand.nsym == rung and max_len >= cfg.length else None

    for rung in _NSYM_LADDER:
        if rung == nsym:
            if cfg.fmt == Fmt.VHT:
                # VHT psdu_len is nsym-determined, so the max-length config
                # has IDENTICAL decode shapes — normalizing the length field
                # unifies the jit key across lengths sharing this rung
                cand = rung_cfg(rung)
                if cand is not None:
                    return cand
            # HT/L exact hits keep the exact shape: their canon trellis end
            # would sit mid-pad-stream, inside survivor-merge range of the
            # real tail when the length is near the rung max
            return cfg
        if rung > nsym and (rung - nsym) * cfg.ndbps >= _CANON_MERGE_STEPS:
            cand = rung_cfg(rung)
            return cfg if cand is None else cand
    return cfg


#: batch-size rungs for bucket decodes (~1.3x geometric): live blocks
#: detect a different packet count every time, and an exact-size bucket
#: would compile a fresh program per count.  Rows are padded with
#: duplicates of row 0 and the tail results ignored.
_BATCH_LADDER = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192,
                 256, 384, 512, 768, 1024, 1536, 2048, 3072, 4096)


def _pad_batch(n: int) -> int:
    for r in _BATCH_LADDER:
        if r >= n:
            return r
    return -(-n // 4096) * 4096


def dedup_triggers(cand: np.ndarray) -> np.ndarray:
    """Keep the first candidate of each <TRIG_DEDUP_SPACING cluster."""
    if len(cand) == 0:
        return cand.astype(np.int32)
    keep = np.concatenate([[True], np.diff(cand) > TRIG_DEDUP_SPACING])
    return cand[keep].astype(np.int32)


@dataclasses.dataclass
class RxResult:
    ok: bool
    fmt: Fmt | None = None
    mcs: int = 0
    nss: int = 1
    start: int = 0
    cfo_hz: float = 0.0
    psdu: bytes = b""
    mpdus: list = dataclasses.field(default_factory=list)
    is_ndp: bool = False
    ndp_chan: np.ndarray | None = None
    trig: int = 0        #: trigger (packet-start) sample index
    #: sync-time SNR estimate 10log10(ac/(1-ac)) and mean windowed power —
    #: the reference's rad/snr/rssi tag metadata (lib/sync_impl.cc:124-136)
    snr_db: float = 0.0
    rssi: float = 0.0
    #: VHT SIG-B re-encode SNR estimate (lib/demod_impl.cc:449-505 sssnr0)
    sssnr0: float | None = None


# ---------------------------------------------------------------------------
# Jitted cores
# ---------------------------------------------------------------------------

@jax.jit
def _sync_core(stream: CF, trigs: jax.Array):
    """Candidate triggers -> (ltf_idx abs, peak, cfo, rssi).

    ONE stream gather of (B, 464) at the trigger covers the STF window
    [0:80) and the LTF search span [80:448); the fine CFO reads the
    already-computed lag-64 autocorrelation lane at the chosen offset
    (ltf_fine_sync_cfo), so no second per-row window is fetched.  The
    gather is bf16-staged: ~49 dB SQNR is far below channel noise at any
    decodable SNR, and the timing metric / CFO averages are 64-sample
    reductions.  The window fetch is the BLOCKED row gather (detection
    triggers are 16-aligned; arbitrary trigs are rounded down to 16 and
    offsets measured from the rounded base, so the returned absolute
    ltf_idx stays consistent)."""
    trigs16 = (trigs // 16) * 16
    wins = FE.gather_windows_blocked_bf16(stream, trigs16, 464)
    cfo0 = FE.coarse_cfo_batch(wins[:, :80])
    off, peak, cfo, rssi = FE.ltf_fine_sync_cfo(wins[:, 80: 448], cfo0)
    ltf_off = 80 + off                         # ltf_idx - trig16, [80, 208]
    return trigs16 + ltf_off, peak, cfo, rssi


@jax.jit
def _sig_core(stream: CF, ltf_idx: jax.Array, cfo: jax.Array):
    """Decode L-SIG + both non-legacy SIG hypotheses for a sync batch.

    Returns (lsig_bits (B,24), ht_bits (B,48), vht_bits (B,48))."""
    xs = FE.derotate_batch(stream, ltf_idx, cfo, 368 + 128)
    h = OF.legacy_chanest(xs, 0)

    def eq_sym(gi_start):
        g = OF.fft_syms(xs[:, gi_start + 16: gi_start + 80])
        return g / h

    perm = T.interleave_perm_legacy(1)
    e_lsig = eq_sym(LSIG_GI)[:, T.DATA_IDX_L][:, perm]
    lsig_bits = VXLA.viterbi_decode(
        VXLA.depuncture(e_lsig.re.astype(jnp.float32), "1/2", 24))
    e1 = eq_sym(NLSIG_GI)[:, T.DATA_IDX_L][:, perm]
    e2 = eq_sym(NLSIG_GI + 80)[:, T.DATA_IDX_L][:, perm]
    vht_llr = jnp.concatenate([e1.re, e2.im], axis=1).astype(jnp.float32)
    ht_llr = jnp.concatenate([e1.im, e2.im], axis=1).astype(jnp.float32)
    vht_bits = VXLA.viterbi_decode(VXLA.depuncture(vht_llr, "1/2", 48))
    ht_bits = VXLA.viterbi_decode(VXLA.depuncture(ht_llr, "1/2", 48))
    return lsig_bits, ht_bits, vht_bits


def _data_start(cfg: PhyConfig) -> int:
    if cfg.fmt == Fmt.L:
        return 208
    if cfg.fmt == Fmt.HT:
        return 208 + 160 + 80 + 80 * cfg.nltf
    return 208 + 160 + 80 + 80 * cfg.nltf + 80


@functools.partial(jax.jit, static_argnames=("n_total", "own"))
def _mu_sigb_core(stream: CF, ltf_idx: jax.Array, cfo: jax.Array,
                  n_total: int, own: int):
    """Batched MU VHT-SIG-B decode for one (nsts-tuple, mu_pos) group.

    Estimates the FULL n_total-stream channel from the VHT-LTFs, selects the
    user's own column, equalizes the SIG-B symbol and Viterbi-decodes its 26
    bits.  Mirrors demod's MU-STA role (lib/demod_impl.cc:344-505) and the
    gold model (gold/rx._rx_vht_mu)."""
    nltf = int(T.N_LTF_OF_NSTS[n_total])
    ltf_start = 208 + 160 + 80
    sigb_start = ltf_start + 80 * nltf
    xs = FE.derotate_batch(stream, ltf_idx, cfo, sigb_start + 80)
    h, pilot_h = OF.nl_chanest(xs[:, None], ltf_start, nltf, n_total,
                               nrx_axis=True)
    h_own = h[:, 0, own]                                 # (B, 64)
    g = OF.fft_syms(xs[:, sigb_start + 16: sigb_start + 80])
    exp_p = pilot_h[:, 0] * jnp.asarray(T.PILOT_VHT, jnp.float32)[None, :]
    from ..ops.cplx import csum
    ph = csum(g[:, T.PILOT_IDX].mul_conj(exp_p), axis=1).unit()
    g = g * CF(ph.re[:, None], -ph.im[:, None])
    eq = g[:, T.DATA_IDX_NL] / h_own[:, T.DATA_IDX_NL]
    perm = T.interleave_perm_nl(1)
    llr = eq.re[:, perm].astype(jnp.float32)
    bits = VXLA.viterbi_decode(VXLA.depuncture(llr, "1/2", 26))
    return bits


@functools.partial(jax.jit, static_argnames=("cfg", "n_total", "own", "nrx",
                                              "mpdu_len"))
def _payload_core_mu(cfg: PhyConfig, stream: CF, ltf_idx: jax.Array,
                     cfo: jax.Array, n_total: int, own: int,
                     nrx: int = 1, mpdu_len: int = 0):
    """MU-STA payload decode: like _payload_core but the channel estimate
    covers all n_total space-time streams and only the user's own column(s)
    equalize the data (cfg describes the user's own modulation)."""
    nltf = int(T.N_LTF_OF_NSTS[n_total])
    ltf_start = 208 + 160 + 80
    data_start = ltf_start + 80 * nltf + 80
    n_need = data_start + 80 * cfg.nsym + 16
    xs = cstack([FE.derotate_batch(stream[r], ltf_idx, cfo, n_need,
                                   low_prec=True)
                 for r in range(nrx)], axis=1)
    h_all, pilot_h = OF.nl_chanest(xs, ltf_start, nltf, n_total,
                                   nrx_axis=True)
    h = h_all[:, :, own: own + cfg.nss]
    grids = cstack([OF.extract_sym_windows(xs[:, r], data_start, cfg.nsym)
                    for r in range(nrx)], axis=1)
    grids = OF.fft_syms(grids)
    llr = OF.equalize_and_demap(grids, h, pilot_h, cfg, nrx_axis=True)
    coded = OF.deinterleave_deparse(llr, cfg)
    bits = adaptive_decode(coded, cfg.cr, cfg.n_trellis)
    data = OF.descramble_bits(bits)
    psdu_bits = data[:, 16: 16 + 8 * cfg.psdu_len]
    out = {"psdu": OF.bits_to_bytes_batch(psdu_bits),
           "service": data[:, :16]}
    if mpdu_len > 4:
        mpdu_bits = psdu_bits[:, 32: 32 + 8 * mpdu_len]
        out["mpdu_fcs_ok"] = CRC.fcs_ok_batch(mpdu_bits, 8 * mpdu_len)
    return out


@functools.lru_cache(maxsize=None)
def _crc8_affine():
    """CRC8 over n bits as an affine GF(2) map: crc(b) = M @ b xor c0.

    M columns from unit-vector probes of the bit-serial oracle
    (spec.tables.crc8_bits); lets a jitted chain validate SIG-B against the
    SERVICE field on device (the reference's re-encode comparison,
    lib/demod_impl.cc:449-505) without a host round trip."""
    n = 20
    c0 = T.crc8_bits(np.zeros(n, np.uint8)).astype(np.float32)
    cols = []
    for i in range(n):
        e = np.zeros(n, np.uint8)
        e[i] = 1
        cols.append((T.crc8_bits(e).astype(np.float32) + c0) % 2)
    return np.stack(cols, axis=1), c0     # (8, 20), (8,)


def _sigb_crc_ok(sigb_bits: jax.Array, service: jax.Array) -> jax.Array:
    """Device SIG-B validation for a (B, 26) bit batch vs (B, 16) SERVICE."""
    M, c0 = _crc8_affine()
    body = sigb_bits[:, :20].astype(jnp.float32)
    crc = jnp.mod(body @ jnp.asarray(M.T) + jnp.asarray(c0)[None, :], 2.0)
    tail_zero = jnp.sum(sigb_bits[:, 20:26].astype(jnp.int32), axis=1) == 0
    match = jnp.sum(jnp.abs(crc - service[:, 8:16].astype(jnp.float32)),
                    axis=1) == 0
    return match & tail_zero


@functools.lru_cache(maxsize=None)
def _sigb_reencode_matrix() -> np.ndarray:
    """(52, 26) GF(2) map: decoded VHT-SIG-B bits -> interleaved coded bits.

    Unit-vector probes of the gold BCC+interleave pipeline; lets the jitted
    chain reproduce the reference's SIG-B re-encode SNR estimate
    (lib/demod_impl.cc:488-505) as one tiny matmul."""
    from ..gold import bits as B
    cols = []
    for i in range(26):
        e = np.zeros(26, np.uint8)
        e[i] = 1
        cols.append(B.interleave(B.bcc_encode_punct(e, "1/2"), 1, False)
                    .astype(np.float32))
    return np.stack(cols, axis=1)


def _sigb_snr(xs: CF, h: CF, data_start: int):
    """VHT SIG-B re-encode SNR (sssnr0) for a SISO batch.

    xs: (B, nrx, n) derotated windows; h: (B, nrx, nss, 64).  Equalizes the
    SIG-B symbol with the NL channel, pilot-phase-corrects, decodes the 26
    bits, re-encodes+interleaves them via a GF(2) matmul and converts the
    residual constellation error to 10log10(52/noise) — the reference's
    ``sssnr0`` tag (lib/demod_impl.cc:449-505)."""
    from ..ops.cplx import csum
    sigb_start = data_start - 80
    g = OF.fft_syms(xs[:, 0, sigb_start + 16: sigb_start + 80])
    eq_all = g / h[:, 0, 0]
    pilv = jnp.asarray(T.PILOT_VHT, jnp.float32)
    ph = csum(eq_all[:, T.PILOT_IDX] * pilv[None, :], axis=1).unit()
    eq = eq_all[:, T.DATA_IDX_NL].mul_conj(CF(ph.re[:, None], ph.im[:, None]))
    perm = T.interleave_perm_nl(1)
    llr = eq.re[:, perm].astype(jnp.float32)
    sigb_bits = VXLA.viterbi_decode(VXLA.depuncture(llr, "1/2", 26))
    M = jnp.asarray(_sigb_reencode_matrix())
    inted = jnp.mod(sigb_bits.astype(jnp.float32) @ M.T, 2.0)
    ideal = 2.0 * inted - 1.0
    noise = jnp.sum((eq.re - ideal) ** 2 + eq.im ** 2, axis=1)
    return 10.0 * jnp.log10(52.0 / jnp.maximum(noise, 1e-9))


@functools.partial(jax.jit, static_argnames=("cfg", "nrx", "mpdu_len",
                                             "want_sssnr", "refine"))
def _payload_core(cfg: PhyConfig, stream: CF, ltf_idx: jax.Array,
                  cfo: jax.Array, nrx: int = 1, mpdu_len: int = 0,
                  n_real: jax.Array | None = None,
                  want_sssnr: bool = False, refine: bool = True):
    """Full payload demod+decode for one config bucket.

    stream: (nrx, N); returns dict with psdu bytes (B, psdu_len), fcs_ok
    (B,) (whole-PSDU check for non-aggregated; first-MPDU check for VHT
    single-MPDU A-MPDUs is done by the host on the returned bytes).
    n_real: optional per-row true trellis length for canonicalized
    buckets — keeps the adaptive fast path live (ops.fastdecode).
    """
    data_start = _data_start(cfg)
    # +16 over-fetch lets extract_sym_windows run gather-free (reshape);
    # bf16-staged gather halves the dominant window-fetch bytes
    n_need = data_start + 80 * cfg.nsym + 16
    xs = cstack([FE.derotate_batch(stream[r], ltf_idx, cfo, n_need,
                                   low_prec=True)
                 for r in range(nrx)], axis=1)      # (B, nrx, n)
    if cfg.fmt == Fmt.L:
        h0 = OF.legacy_chanest(xs[:, 0], 0)
        h = h0[:, None, None, :]
        pilot_h = h0[:, T.PILOT_IDX][:, None, :]
    else:
        h, pilot_h = OF.nl_chanest(xs, 208 + 160 + 80, cfg.nltf, cfg.nss,
                                   nrx_axis=True)
        if refine and cfg.nss == 1:
            # L-LTF combine + decision-directed SIG observations +
            # delay-subspace projection (near-genie estimate noise,
            # coherence-gated per row) — the reference uses the raw
            # single-LTF estimate only (lib/demod_impl.cc)
            sigb_gi = data_start - 80 if cfg.fmt == Fmt.VHT else None
            h, pilot_h = OF.refine_chanest_siso(xs, h, pilot_h,
                                                fmt=cfg.fmt,
                                                sigb_gi=sigb_gi)
        if cfg.fmt == Fmt.HT:
            from ..ops.cplx import csum as _csum
            pilot_h = _csum(h[:, :, :, T.PILOT_IDX], axis=2)
    grids = cstack([OF.extract_sym_windows(xs[:, r], data_start, cfg.nsym)
                    for r in range(nrx)], axis=1)
    grids = OF.fft_syms(grids)                       # (B, nrx, nsym, 64)
    if refine and cfg.nss == 1:
        # decision-directed second-pass chanest, gated on a nearly-free
        # SNR proxy: every payload symbol becomes a channel observation
        # (hard-sliced QAM decisions + known pilot polarities,
        # ops.ofdm.refine_chanest_data) — worth ~10-35% fewer channel
        # hard errors and +44% decoded packets at the 18 dB floor
        # (measured), but the pass is not free, so clean high-SNR
        # batches must skip it.  The gate must NOT need the demod: a
        # first-pass-syndrome gate would double the demap and the GF(2)
        # inverse.  The two L-LTF repeats give noise (their difference)
        # and signal (their sum) directly — two 64-pt DFTs per row — so
        # the equalize/demap/decode run exactly once on both paths.
        l1 = OF.fft_syms(xs[:, 0, 0:64])
        l2 = OF.fft_syms(xs[:, 0, 64:128])
        nz = jnp.asarray(OF._LTF_L_NZ.astype(np.float32))
        d2 = jnp.sum((l1 - l2).abs2() * nz, axis=1)      # 2*noise var
        s2 = jnp.sum((l1 + l2).abs2() * nz, axis=1)      # 4*sig + 2*noise
        # energy-weighted batch SNR (padded zero rows contribute nothing):
        # snr = (S - D) / (2 D);  dd when inside [mcs lower bound, 23.5]
        # — batches >1.5 dB below this mcs's waterfall are lost whatever
        # the estimate does, so dd must not tax them either
        sd = jnp.sum(s2) - jnp.sum(d2)
        dsum = jnp.sum(d2)
        lo = _DD_GATE_LO.get((cfg.nbpscs, cfg.cr), 0.0)
        pred = ((sd < 2.0 * 10.0 ** (DD_GATE_SNR_DB / 10.0) * dsum)
                & (sd > 2.0 * 10.0 ** (lo / 10.0) * dsum))

        # the cond selects only (h, pilot_h); equalize/demap/decode run
        # once, outside (the smaller trace: moving the equalizer into
        # both branches bought nothing on the accelerator it was first
        # measured on)
        def _dd(_):
            return OF.refine_chanest_data(grids, h, pilot_h, cfg)

        h, pilot_h = jax.lax.cond(pred, _dd, lambda _: (h, pilot_h), None)
    llr = OF.equalize_and_demap(grids, h, pilot_h, cfg, nrx_axis=True)
    coded = OF.deinterleave_deparse(llr, cfg)        # (B, nsym*ncbps)
    bits = adaptive_decode(coded, cfg.cr, cfg.n_trellis,
                           n_real=n_real)            # (B, n_trellis)
    data = OF.descramble_bits(bits)
    psdu_bits = data[:, 16: 16 + 8 * cfg.psdu_len]
    psdu = OF.bits_to_bytes_batch(psdu_bits)
    out = {"psdu": psdu, "service": data[:, :16]}
    if want_sssnr and cfg.fmt == Fmt.VHT and cfg.nss == 1:
        out["sssnr0"] = _sigb_snr(xs, h, data_start)
    if cfg.fmt == Fmt.VHT and mpdu_len > 4:
        # single-MPDU A-MPDU fast path: the MPDU sits at bytes [4, 4+mpdu_len)
        # (the delimiter-walk general path runs on the host)
        mpdu_bits = psdu_bits[:, 32: 32 + 8 * mpdu_len]
        out["mpdu_fcs_ok"] = CRC.fcs_ok_batch(mpdu_bits, 8 * mpdu_len)
    elif cfg.fmt != Fmt.VHT and not cfg.ampdu and cfg.psdu_len > 4:
        out["fcs_ok"] = CRC.fcs_ok_batch(psdu_bits, 8 * cfg.psdu_len)
    return out


@functools.partial(jax.jit,
                   static_argnames=("cfg", "nrx", "mpdu_len", "max_pkts",
                                    "chunk"))
def rx_chain_count(cfg: PhyConfig, stream: CF, nrx: int = 1,
                   mpdu_len: int = 0, max_pkts: int = 4096,
                   chunk: int | None = None):
    """Single-dispatch known-config chain: detect -> dedup -> sync -> decode.

    Fuses the entire RX into ONE device program returning two scalars
    (n_fcs_ok, n_detected), so the bench/PER harness hot loop crosses the
    host boundary exactly once per batch.

    ``chunk``: decode the synced packets in lax.scan chunks of this size
    INSIDE the one program — device memory stays at chunk-level (the Viterbi decision
    planes are per-chunk temporaries) while the dispatch/readback overhead
    amortizes over max_pkts packets.  Requires max_pkts % chunk == 0.
    """
    m4 = FE.stf_metric_strided(stream[0])
    cand = FE.detect_plateaus_strided(m4, max_out=3 * max_pkts)
    trigs = FE.dedup_triggers_device(cand, max_pkts,
                                     spacing=TRIG_DEDUP_SPACING)
    valid = trigs >= 0
    trigs = jnp.maximum(trigs, 0)
    ltf_idx, peak, cfo, rssi = _sync_core(stream[0], trigs)
    n_need = _data_start(cfg) + 80 * cfg.nsym + 16
    valid &= (peak > 0.5) & (ltf_idx + n_need < stream.shape[-1])
    ltf_idx = jnp.clip(ltf_idx, 0, stream.shape[-1] - n_need - 1)

    def count(li, cf, va):
        out = _payload_core(cfg, stream[:nrx], li, cf, nrx=nrx,
                            mpdu_len=mpdu_len)
        ok = out.get("mpdu_fcs_ok", out.get("fcs_ok"))
        return (jnp.sum((ok & va).astype(jnp.int32)),
                jnp.sum(va.astype(jnp.int32)))

    if chunk is None or max_pkts <= chunk:
        return count(ltf_idx, cfo, valid)
    assert max_pkts % chunk == 0
    K = max_pkts // chunk

    def body(carry, xs):
        n_ok, n_det = count(*xs)
        return (carry[0] + n_ok, carry[1] + n_det), None

    (n_ok, n_det), _ = jax.lax.scan(
        body, (jnp.int32(0), jnp.int32(0)),
        (ltf_idx.reshape(K, chunk), cfo.reshape(K, chunk),
         valid.reshape(K, chunk)))
    return n_ok, n_det


@functools.partial(jax.jit,
                   static_argnames=("cfg", "nrx", "mpdu_len", "max_pkts"))
def rx_chain_ok(cfg: PhyConfig, stream: CF, nrx: int = 1,
                mpdu_len: int = 0, max_pkts: int = 4096):
    """Like :func:`rx_chain_count` but per-packet: returns
    (ok (max_pkts,) bool, ltf_idx (max_pkts,) int32, valid (max_pkts,) bool)
    so a host harness can map each detected packet back to its transmit slot
    (the PER-vs-SNR sweep decodes all SNR points in one dispatch)."""
    m4 = FE.stf_metric_strided(stream[0])
    cand = FE.detect_plateaus_strided(m4, max_out=3 * max_pkts)
    trigs = FE.dedup_triggers_device(cand, max_pkts,
                                     spacing=TRIG_DEDUP_SPACING)
    valid = trigs >= 0
    trigs = jnp.maximum(trigs, 0)
    ltf_idx, peak, cfo, rssi = _sync_core(stream[0], trigs)
    n_need = _data_start(cfg) + 80 * cfg.nsym + 16
    valid &= (peak > 0.5) & (ltf_idx + n_need < stream.shape[-1])
    ltf_idx_c = jnp.clip(ltf_idx, 0, stream.shape[-1] - n_need - 1)
    out = _payload_core(cfg, stream[:nrx], ltf_idx_c, cfo, nrx=nrx,
                        mpdu_len=mpdu_len)
    ok = out.get("mpdu_fcs_ok", out.get("fcs_ok"))
    return ok & valid, ltf_idx, valid


@functools.partial(jax.jit,
                   static_argnames=("cfg", "n_total", "own", "nrx",
                                    "mpdu_len", "max_pkts"))
def rx_chain_count_mu(cfg: PhyConfig, stream: CF, n_total: int, own: int,
                      nrx: int = 1, mpdu_len: int = 0, max_pkts: int = 4096):
    """Single-dispatch MU-STA chain: detect -> sync -> SIG-B -> payload.

    The MU twin of :func:`rx_chain_count` (the STA knows its group config,
    as in the cmu_v3 closed loop): ONE device program decodes the user's
    VHT-SIG-B, validates it against the SERVICE-field CRC on device
    (lib/demod_impl.cc:449-505), decodes the payload and returns
    (n_fcs_ok, n_detected) scalars — one host crossing per batch."""
    m4 = FE.stf_metric_strided(stream[0])
    cand = FE.detect_plateaus_strided(m4, max_out=3 * max_pkts)
    trigs = FE.dedup_triggers_device(cand, max_pkts,
                                     spacing=TRIG_DEDUP_SPACING)
    valid = trigs >= 0
    trigs = jnp.maximum(trigs, 0)
    ltf_idx, peak, cfo, rssi = _sync_core(stream[0], trigs)
    nltf = int(T.N_LTF_OF_NSTS[n_total])
    n_need = 208 + 160 + 80 + 80 * nltf + 80 + 80 * cfg.nsym + 16
    valid &= (peak > 0.5) & (ltf_idx + n_need < stream.shape[-1])
    ltf_idx = jnp.clip(ltf_idx, 0, stream.shape[-1] - n_need - 1)
    sigb_bits = _mu_sigb_core(stream[0], ltf_idx, cfo, n_total, own)
    mcs_bits = sigb_bits[:, 16:20].astype(jnp.int32)
    sigb_mcs = (mcs_bits[:, 0] + 2 * mcs_bits[:, 1] + 4 * mcs_bits[:, 2]
                + 8 * mcs_bits[:, 3])
    out = _payload_core_mu(cfg, stream[:nrx], ltf_idx, cfo, n_total, own,
                           nrx=nrx, mpdu_len=mpdu_len)
    ok = out["mpdu_fcs_ok"] & _sigb_crc_ok(sigb_bits, out["service"]) \
        & (sigb_mcs == cfg.mcs) & valid
    return jnp.sum(ok.astype(jnp.int32)), jnp.sum(valid.astype(jnp.int32))


@functools.partial(jax.jit,
                   static_argnames=("cfg", "n_total", "own", "nrx",
                                    "mpdu_len", "max_pkts"))
def rx_chain_ok_mu(cfg: PhyConfig, stream: CF, n_total: int, own: int,
                   nrx: int = 1, mpdu_len: int = 0, max_pkts: int = 4096):
    """Per-packet MU-STA chain: like :func:`rx_chain_count_mu` but returns
    (ok (max_pkts,), ltf_idx (max_pkts,), valid (max_pkts,)) so the PER
    harness can map each detection back to its transmit slot (the MU twin
    of :func:`rx_chain_ok`)."""
    m4 = FE.stf_metric_strided(stream[0])
    cand = FE.detect_plateaus_strided(m4, max_out=3 * max_pkts)
    trigs = FE.dedup_triggers_device(cand, max_pkts,
                                     spacing=TRIG_DEDUP_SPACING)
    valid = trigs >= 0
    trigs = jnp.maximum(trigs, 0)
    ltf_idx, peak, cfo, rssi = _sync_core(stream[0], trigs)
    nltf = int(T.N_LTF_OF_NSTS[n_total])
    n_need = 208 + 160 + 80 + 80 * nltf + 80 + 80 * cfg.nsym + 16
    valid &= (peak > 0.5) & (ltf_idx + n_need < stream.shape[-1])
    ltf_idx_c = jnp.clip(ltf_idx, 0, stream.shape[-1] - n_need - 1)
    sigb_bits = _mu_sigb_core(stream[0], ltf_idx_c, cfo, n_total, own)
    mcs_bits = sigb_bits[:, 16:20].astype(jnp.int32)
    sigb_mcs = (mcs_bits[:, 0] + 2 * mcs_bits[:, 1] + 4 * mcs_bits[:, 2]
                + 8 * mcs_bits[:, 3])
    out = _payload_core_mu(cfg, stream[:nrx], ltf_idx_c, cfo, n_total, own,
                           nrx=nrx, mpdu_len=mpdu_len)
    ok = out["mpdu_fcs_ok"] & _sigb_crc_ok(sigb_bits, out["service"]) \
        & (sigb_mcs == cfg.mcs) & valid
    return ok, ltf_idx, valid


@functools.partial(jax.jit, static_argnames=("max_pkts",))
def _front_core(stream: CF, max_pkts: int):
    """Fused detect -> dedup -> sync -> SIG front end, ONE dispatch.

    Returns (meta (max_pkts, 6) float32 [trig, ltf_idx, peak, cfo, rssi,
    valid], bits (max_pkts, 120) uint8 [lsig(24), ht(48), vht(48)]) so the
    host pays exactly ONE device->host readback (one device_get) for the
    whole front end instead of one per detect / sync / SIG stage, and the
    SIG bits ride as uint8 (4x fewer bytes than f32)."""
    m4 = FE.stf_metric_strided(stream)
    cand = FE.detect_plateaus_strided(m4, max_out=3 * max_pkts)
    trigs = FE.dedup_triggers_device(cand, max_pkts,
                                     spacing=TRIG_DEDUP_SPACING)
    n = stream.shape[-1]
    ltf_idx, peak, cfo, rssi = _sync_core(stream, jnp.maximum(trigs, 0))
    valid = (trigs >= 0) & (peak > 0.5) & (ltf_idx + 600 < n)
    li_c = jnp.clip(ltf_idx, 0, max(n - 600, 0))
    lsig, ht, vht = _sig_core(stream, li_c, cfo)
    meta = jnp.concatenate(
        [trigs.astype(jnp.float32)[:, None],
         ltf_idx.astype(jnp.float32)[:, None],
         peak[:, None], cfo[:, None], rssi[:, None],
         valid.astype(jnp.float32)[:, None]], axis=1)
    bits = jnp.concatenate(
        [lsig.astype(jnp.uint8), ht.astype(jnp.uint8),
         vht.astype(jnp.uint8)], axis=1)
    return meta, bits


#: speculative-path psdu readback cap: compacted valid rows beyond this
#: fall back to the bucket path (and dense blocks disarm speculation —
#: the classic batched path already amortizes its crossings there)
SPEC_ROWS = 512


@functools.partial(jax.jit, static_argnames=("cfg", "nrx", "max_pkts"))
def _spec_core(cfg: PhyConfig, stream: CF, max_pkts: int, nrx: int = 1,
               n_real: jax.Array | None = None):
    """Speculative ONE-CROSSING chain: front end + payload decode for a
    PRESUMED config, fused into a single program with a single readback.

    The steady-state daemon case is homogeneous traffic: every block
    decodes the same (fmt, mcs, len) as the last.  This program decodes
    ALL detected packets under the speculated canonical config and also
    returns the SIG bits; the host then verifies each row's actual
    classification against the speculation and re-decodes only
    mismatching rows through the general bucket path.  Collapses the
    general path's 2-3 host crossings to ONE for cache-hit traffic (the
    reference's block-latency study is Measurement_Report §2).

    Returns (meta (max_pkts, 7) [trig, ltf_idx, peak, cfo, rssi, valid,
    fits], bits (max_pkts, 120) uint8, psdu (SPEC_ROWS, psdu_len) uint8
    COMPACTED to the first SPEC_ROWS valid rows in device order (the
    readback must not scale with max_pkts: an 8192-row plane at 549 B
    is ~4.5 MB of transfer; kept-row i < SPEC_ROWS maps to
    compacted row i), sssnr0 (SPEC_ROWS,))."""
    m4 = FE.stf_metric_strided(stream[0])
    cand = FE.detect_plateaus_strided(m4, max_out=3 * max_pkts)
    trigs = FE.dedup_triggers_device(cand, max_pkts,
                                     spacing=TRIG_DEDUP_SPACING)
    n = stream.shape[-1]
    ltf_idx, peak, cfo, rssi = _sync_core(stream[0], jnp.maximum(trigs, 0))
    valid = (trigs >= 0) & (peak > 0.5) & (ltf_idx + 600 < n)
    li_c = jnp.clip(ltf_idx, 0, max(n - 600, 0))
    lsig, ht, vht = _sig_core(stream[0], li_c, cfo)
    n_need = _data_start(cfg) + 80 * cfg.nsym + 16
    fits = ltf_idx + n_need < n
    li2 = jnp.clip(ltf_idx, 0, max(n - n_need - 1, 0))
    want_sssnr = cfg.fmt == Fmt.VHT and cfg.nss == 1
    out = _payload_core(cfg, stream[:nrx], li2, cfo, nrx=nrx,
                        n_real=n_real, want_sssnr=want_sssnr)
    meta = jnp.concatenate(
        [trigs.astype(jnp.float32)[:, None],
         ltf_idx.astype(jnp.float32)[:, None],
         peak[:, None], cfo[:, None], rssi[:, None],
         valid.astype(jnp.float32)[:, None],
         fits.astype(jnp.float32)[:, None]], axis=1)
    bits = jnp.concatenate(
        [lsig.astype(jnp.uint8), ht.astype(jnp.uint8),
         vht.astype(jnp.uint8)], axis=1)
    sssnr = out.get("sssnr0", jnp.zeros(meta.shape[0], jnp.float32))
    k = min(SPEC_ROWS, max_pkts)
    vsel = jnp.nonzero(valid, size=k, fill_value=max_pkts - 1)[0]
    psdu_c = jnp.take(out["psdu"], vsel, axis=0)
    sssnr_c = jnp.take(sssnr, vsel, axis=0)
    return meta, bits, psdu_c, sssnr_c


@functools.partial(jax.jit, static_argnames=("nsts", "nrx"))
def _ndp_chan_core(stream: CF, ltf_idx: jax.Array, cfo: jax.Array,
                   nsts: int, nrx: int):
    """Batched NDP channel estimate: (B,) sync positions -> (B, nrx, nsts,
    64) channel (one dispatch for ALL same-nsts NDPs in a block)."""
    nltf = int(T.N_LTF_OF_NSTS[nsts])
    n_need = 208 + 160 + 80 + 80 * nltf
    xs = cstack([FE.derotate_batch(stream[r], ltf_idx, cfo, n_need)
                 for r in range(nrx)], axis=1)
    h, _ = OF.nl_chanest(xs, 208 + 160 + 80, nltf, nsts, nrx_axis=True)
    return h


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

class RxEngine:
    """Streaming receiver over a (nrx, N) IQ timeline."""

    def __init__(self, nrx: int = 1, mu_pos: int | None = None,
                 mu_gid: int | None = None, ingest_bf16: bool = False,
                 ingest: str | None = None, speculate: bool = True):
        self.nrx = nrx
        self.mu_pos = mu_pos          # MU-MIMO STA position (demod mupos)
        self.mu_gid = mu_gid          # group id filter (demod mugid), opt.
        #: upload staging: "f32" (exact), "bf16" (half bytes, ~49 dB
        #: SQNR) or "i8" (quarter bytes, ~48 dB block-AGC quantization —
        #: the 8-bit-ADC ingest for the transport-bound streaming path)
        self.ingest = ingest or ("bf16" if ingest_bf16 else "f32")
        self.ingest_bf16 = self.ingest == "bf16"
        #: one-crossing speculation: when the previous block's data
        #: traffic was homogeneous, the next block dispatches the fused
        #: front+decode program for that config (_spec_core) and the
        #: host verifies per row — steady-state daemon blocks cost ONE
        #: readback instead of 2-3
        self.speculate = speculate
        self._spec_canon: PhyConfig | None = None
        #: SIG-bits -> classification cache (pure parse; see process_device)
        self._cls_cache: dict = {}

    # -- detection ---------------------------------------------------------
    def detect(self, stream0: jax.Array, max_out: int = 4096) -> np.ndarray:
        """Candidate trigger indices; only (max_out,) ints leave the device."""
        m4 = FE.stf_metric_strided(stream0)
        cand = np.asarray(FE.detect_plateaus_strided(m4, max_out=max_out))
        cand = cand[cand >= 0]
        return dedup_triggers(cand)

    # -- full pipeline -----------------------------------------------------
    def process(self, stream: np.ndarray) -> list[RxResult]:
        stream = np.atleast_2d(stream)
        return self.process_device(self._upload(stream), stream.shape[1])

    def _upload(self, stream: np.ndarray):
        # reduced-precision ingest cuts the host->device bytes; opt-in
        # since golden-parity tests compare float32 paths
        from ..ops.cplx import from_host_i8
        fh = {"f32": from_host, "bf16": from_host_bf16,
              "i8": from_host_i8}[self.ingest]
        return fh(stream)

    def begin_process(self, stream: np.ndarray):
        """Dispatch the upload + fused front end WITHOUT blocking.

        Returns an opaque handle for :meth:`finish_process`.  jax's async
        dispatch queues the host->device transfer and the front-end
        program immediately, so a streaming caller can overlap block
        k+1's upload/front compute with block k's readbacks + bucket
        decodes (the RxStreamer double-buffering path)."""
        stream = np.atleast_2d(stream)
        dev = self._upload(stream)
        n_stream = stream.shape[1]
        spec = self._spec_canon if self.speculate else None
        if spec is not None:
            canon, nreal = spec
            min_sp = (TRIG_DEDUP_SPACING // 16) * 16
            cap = max(16, min(4096, n_stream // min_sp + 1))
            max_pkts = 1 << (cap - 1).bit_length()
            # the armed traffic's exact trellis length rides as a TRACED
            # per-row n_real (no recompile across lengths sharing a
            # canon; identical decode semantics to the bucket path)
            nr = jnp.full((max_pkts,), nreal, jnp.int32)
            outs = _spec_core(canon, dev, max_pkts, nrx=self.nrx,
                              n_real=nr)
            return (dev, n_stream, ("spec", spec) + outs)
        meta_d, bits_d = self._front_dispatch(dev, n_stream)
        return (dev, n_stream, ("front", meta_d, bits_d))

    def finish_process(self, handle) -> list[RxResult]:
        """Block on a :meth:`begin_process` handle's front-end readback and
        run classification + bucket decodes to completion."""
        dev, n_stream, rest = handle
        if rest[0] == "spec":
            _, spec, meta_d, bits_d, psdu_d, sssnr_d = rest
            got = jax.device_get((meta_d, bits_d, psdu_d, sssnr_d))
            return self._finish(dev, n_stream, got[0], got[1],
                                spec=(spec, got[2], got[3]))
        return self._finish(dev, n_stream, rest[1], rest[2])

    def _front_dispatch(self, dev, n_stream: int):
        # ONE fused dispatch + ONE readback for the whole front end
        # (detect/dedup/sync/SIG); max_pkts is padded to a power of two so
        # variable per-block packet counts share a compiled program
        # capacity from the real minimum trigger spacing: dedup keeps
        # triggers > TRIG_DEDUP_SPACING apart, but 16-sample detection
        # quantization can place them at the next multiple of 16 below
        # (704 for spacing 700) — deriving from 720 could silently drop
        # excess triggers in a dense minimum-spacing block (ADVICE r4)
        min_sp = (TRIG_DEDUP_SPACING // 16) * 16
        cap = max(16, min(4096, n_stream // min_sp + 1))
        max_pkts = 1 << (cap - 1).bit_length()
        return _front_core(dev[0], max_pkts)

    def process_device(self, dev, n_stream: int) -> list[RxResult]:
        """Run the full engine on an already-device-resident (nrx, N) CF
        stream (the block-processing path of :meth:`process`)."""
        meta_d, bits_d = self._front_dispatch(dev, n_stream)
        return self._finish(dev, n_stream, meta_d, bits_d)

    def _finish(self, dev, n_stream: int, meta_d, bits_d,
                spec=None) -> list[RxResult]:
        got = jax.device_get((meta_d, bits_d))
        meta, sig_bits = got
        keep = meta[:, 5] > 0.5
        orig = np.flatnonzero(keep)       # row index into the spec outputs
        fits = meta[keep, 6] > 0.5 if spec is not None else None
        meta, sig_bits = meta[keep], sig_bits[keep]
        if meta.shape[0] == 0:
            # idle block: KEEP the speculation armed (steady-state radio
            # traffic has silence gaps between bursts)
            return []
        trigs = meta[:, 0].astype(np.int64)
        ltf_idx = meta[:, 1].astype(np.int64)
        peak = meta[:, 2]
        cfo = meta[:, 3]
        # per-packet SNR/RSSI metadata (reference sync tags): snr from the
        # LTF autocorrelation peak, rssi from the windowed power at the peak
        snr_db = 10.0 * np.log10(peak / np.maximum(1.0 - peak, 1e-6))
        rssi = meta[:, 4]
        lsig_b = sig_bits[:, 0:24]
        ht_b = sig_bits[:, 24:72]
        vht_b = sig_bits[:, 72:120]

        # host-side classification into buckets.  The parse is pure in the
        # 120 SIG bits, so identical packets (the common case inside a
        # block: same config/length) hit a per-engine cache instead of
        # re-walking the python parsers — the classify loop dominated the
        # daemon's host time at ~1600 pkts/block
        buckets: dict[PhyConfig, list[int]] = {}
        meta: list[tuple] = []
        results: list[RxResult] = [None] * len(ltf_idx)
        seen_canons: set = set()
        spec_canon, spec_psdu, spec_sssnr = spec if spec else (None,) * 3
        for i in range(len(ltf_idx)):
            key = sig_bits[i].tobytes()
            ent = self._cls_cache.get(key)
            if ent is None:
                lsig = S.parse_lsig(lsig_b[i])
                if not lsig.ok:
                    ent = (None, None)
                else:
                    ent = self._classify(lsig, ht_b[i], vht_b[i])
                if len(self._cls_cache) > 65536:
                    self._cls_cache.clear()
                self._cls_cache[key] = ent
            cfg, ndp = ent
            if ndp is not None:
                meta.append(("ndp", ndp))
                continue
            if cfg is None:
                meta.append(None)
                continue
            if isinstance(cfg, tuple) and cfg[0] == "mu":
                meta.append(cfg)
                continue
            canon = canonical_cfg(cfg)
            if ltf_idx[i] + _data_start(canon) + 80 * canon.nsym + 16 \
                    > n_stream:
                # padded window overruns the block: fall back to exact shape
                canon = cfg
            if ltf_idx[i] + _data_start(cfg) + 80 * cfg.nsym + 16 \
                    > n_stream:
                meta.append(None)
                continue
            seen_canons.add((canon, cfg.n_trellis))
            if (spec_canon is not None
                    and (canon, cfg.n_trellis) == spec_canon and fits[i]
                    and i < len(spec_psdu)):
                # speculation hit: the fused program already decoded this
                # row (kept-row i == compacted psdu row i) — no further
                # device work or readback for it
                pb = spec_psdu[i][: cfg.psdu_len].tobytes()
                ss = (float(spec_sssnr[i])
                      if cfg.fmt == Fmt.VHT and cfg.nss == 1 else None)
                results[i] = self._mk_data_result(
                    cfg, pb, int(ltf_idx[i]), float(cfo[i]), int(trigs[i]),
                    float(snr_db[i]), float(rssi[i]), ss)
                meta.append(("data", cfg))
                continue
            buckets.setdefault(canon, []).append((i, cfg))
            meta.append(("data", cfg))
        for canon, all_items in buckets.items():
            # cap the bucket batch so the Viterbi decision planes
            # (n_trellis x 64 x B bytes for the XLA scan) stay within
            # ~2 GB of device memory (an MCS0 4095 B packet has a
            # 32k-step trellis)
            max_b = max(128,
                        -(-(1 << 31) // (canon.n_trellis * 64)) // 128 * 128)
            for c0 in range(0, len(all_items), max_b):
                items = all_items[c0: c0 + max_b]
                self._decode_bucket(dev, canon, items, ltf_idx, cfo, trigs,
                                    results, snr_db, rssi)
        # NDPs: ONE channel-estimate dispatch per nsts value (not per packet)
        ndp_groups: dict[int, list[int]] = {}
        for i, mi in enumerate(meta):
            if mi is not None and mi[0] == "ndp":
                ndp_groups.setdefault(mi[1], []).append(i)
        for nsts, idxs in ndp_groups.items():
            sel = np.zeros(_pad_batch(len(idxs)), np.int32)
            sel[: len(idxs)] = idxs
            h = _ndp_chan_core(dev[: self.nrx], jnp.asarray(ltf_idx[sel]),
                               jnp.asarray(cfo[sel]), nsts, self.nrx)
            hc = np.asarray(h.re) + 1j * np.asarray(h.im)
            for j, i in enumerate(idxs):
                r = RxResult(True, Fmt.VHT, 0, nsts, int(ltf_idx[i]),
                             float(cfo[i]), is_ndp=True, trig=int(trigs[i]),
                             snr_db=float(snr_db[i]), rssi=float(rssi[i]))
                r.ndp_chan = hc[j]
                results[i] = r
        self._process_mu(dev, ltf_idx, cfo, trigs, meta, results,
                         n_stream, snr_db, rssi)
        # next-block speculation: homogeneous SPARSE data traffic arms
        # it, mixed data traffic or dense blocks (beyond the compacted
        # psdu readback) disarm, data-free blocks (NDP/MU/idle) leave it
        if len(seen_canons) == 1 and len(ltf_idx) <= SPEC_ROWS:
            self._spec_canon = next(iter(seen_canons))
        elif seen_canons:
            self._spec_canon = None
        return [r for r in results if r is not None]

    def _mk_data_result(self, cfg: PhyConfig, pb: bytes, ltf_idx: int,
                        cfo: float, trig: int, snr_db: float, rssi: float,
                        sssnr) -> RxResult:
        """Shared per-packet assembly: MPDU walk + FCS by format."""
        r = RxResult(False, cfg.fmt, cfg.mcs, cfg.nss, ltf_idx, cfo,
                     trig=trig, snr_db=snr_db, rssi=rssi)
        if sssnr is not None:
            r.sssnr0 = sssnr
        r.psdu = pb
        if cfg.fmt == Fmt.VHT:
            # native C++ delimiter walk + FCS (runtime/native.py falls
            # back to the python gold walk when the .so is absent)
            from ..runtime.native import deagg_vht
            r.mpdus = deagg_vht(pb)
            r.ok = len(r.mpdus) > 0
        elif cfg.fmt == Fmt.HT and cfg.ampdu:
            r.mpdus = MAC.ampdu_deaggregate(pb, ht=True)
            r.ok = len(r.mpdus) > 0
        else:
            from ..gold.bits import fcs_ok
            r.ok = fcs_ok(pb)
            r.mpdus = [pb] if r.ok else []
        return r

    def _decode_bucket(self, dev, canon: PhyConfig, items, ltf_idx, cfo,
                       trigs, results, snr_db, rssi):
        """items: [(packet index, exact PhyConfig)]; decoded with the shared
        canonical config, each packet's real psdu sliced from the padded
        decode (bit-identical: >= _CANON_MERGE_STEPS of trellis margin)."""
        nb = len(items)
        pad = _pad_batch(nb)
        sel = np.zeros(pad, np.int32)
        sel[:nb] = [i for i, _ in items]
        n_real = np.full(pad, canon.n_trellis, np.int32)
        n_real[:nb] = [c.n_trellis for _, c in items]
        want_sssnr = canon.fmt == Fmt.VHT and canon.nss == 1
        out = _payload_core(canon, dev[: self.nrx], jnp.asarray(ltf_idx[sel]),
                            jnp.asarray(cfo[sel]), nrx=self.nrx,
                            n_real=jnp.asarray(n_real),
                            want_sssnr=want_sssnr)
        # one device_get for every consumed output
        got = jax.device_get({k: out[k] for k in ("psdu", "sssnr0")
                              if k in out})
        psdu = got["psdu"]
        sssnr = got.get("sssnr0")
        for j, (i, cfg) in enumerate(items):
            pb = psdu[j][: cfg.psdu_len].tobytes()
            ss = float(sssnr[j]) if sssnr is not None else None
            results[i] = self._mk_data_result(
                cfg, pb, int(ltf_idx[i]), float(cfo[i]), int(trigs[i]),
                float(snr_db[i]), float(rssi[i]), ss)

    def _process_mu(self, dev, ltf_idx, cfo, trigs, meta, results, n_stream,
                    snr_db, rssi):
        """Batched MU-STA decode: SIG-B pass per nsts-group, then payload
        buckets per (mcs, len, nsym)."""
        groups: dict[tuple, list[int]] = {}
        for i, mi in enumerate(meta):
            if mi is not None and mi[0] == "mu":
                groups.setdefault(mi[1].nsts, []).append(i)
        for nsts, idxs in groups.items():
            n_total = sum(nsts)
            own = sum(nsts[: self.mu_pos])
            sel = np.zeros(_pad_batch(len(idxs)), np.int32)
            sel[: len(idxs)] = idxs
            sigb_b = np.asarray(_mu_sigb_core(
                dev[0], jnp.asarray(ltf_idx[sel]), jnp.asarray(cfo[sel]),
                n_total, own))
            nltf = int(T.N_LTF_OF_NSTS[n_total])
            data_start = 208 + 160 + 80 + 80 * nltf + 80
            buckets: dict[PhyConfig, list[tuple[int, np.ndarray]]] = {}
            for j, i in enumerate(idxs):
                sigb = S.parse_vhtsigb(sigb_b[j], mu=True)
                lsig = meta[i][2]
                n_data = lsig.nsym * 80 - (160 + 80 + 80 * nltf + 80)
                nsym = max(n_data // 80, 0)
                if (nsym == 0 or not sigb.ok or sigb.mcs > 8
                        or not (1 <= sigb.length <= 4095)):
                    continue
                if ltf_idx[i] + data_start + 80 * nsym + 16 > n_stream:
                    continue
                cfg = PhyConfig(Fmt.VHT, sigb.mcs, nsts[self.mu_pos],
                                sigb.length, ampdu=True, mu_nsym=nsym)
                if cfg.mcs > 8 or cfg.nsym != nsym:
                    continue
                buckets.setdefault(cfg, []).append((i, sigb.crc))
            for cfg, items in buckets.items():
                sel = np.zeros(_pad_batch(len(items)), np.int32)
                sel[: len(items)] = [i for i, _ in items]
                out = _payload_core_mu(cfg, dev[: self.nrx],
                                       jnp.asarray(ltf_idx[sel]),
                                       jnp.asarray(cfo[sel]),
                                       sum(nsts), sum(nsts[: self.mu_pos]),
                                       nrx=self.nrx)
                psdu, service = jax.device_get((out["psdu"], out["service"]))
                for j, (i, crc) in enumerate(items):
                    if not np.array_equal(service[j, 8:16], crc):
                        continue
                    r = RxResult(False, Fmt.VHT, cfg.mcs, cfg.nss,
                                 int(ltf_idx[i]), float(cfo[i]),
                                 trig=int(trigs[i]), snr_db=float(snr_db[i]),
                                 rssi=float(rssi[i]))
                    r.psdu = psdu[j].tobytes()
                    r.mpdus = MAC.ampdu_deaggregate(r.psdu)
                    r.ok = len(r.mpdus) > 0
                    results[i] = r

    def _classify(self, lsig, ht_bits, vht_bits):
        """-> (PhyConfig | None, ndp_nss | None)."""
        if lsig.mcs != 0:
            return PhyConfig(Fmt.L, lsig.mcs, 1, lsig.length), None
        siga = S.parse_vhtsiga(vht_bits)
        if siga.ok and siga.mu and self.mu_pos is not None:
            if self.mu_gid is not None and siga.group_id != self.mu_gid:
                return None, None
            if siga.nsts[self.mu_pos] == 0:
                return None, None
            return ("mu", siga, lsig), None
        if siga.ok and not siga.mu:
            nltf = int(T.N_LTF_OF_NSTS[siga.nss])
            n_data = lsig.nsym * 80 - (160 + 80 + 80 * nltf + 80)
            nsym = max(n_data // 80, 0)
            if nsym == 0:
                return None, siga.nss
            probe = PhyConfig(Fmt.VHT, siga.mcs, siga.nss, 1, ampdu=True)
            max_len = (nsym * probe.ndbps - 22) // 8
            if not (1 <= max_len <= 4095):
                return None, None
            cfg = PhyConfig(Fmt.VHT, siga.mcs, siga.nss, max_len, ampdu=True)
            return (cfg if cfg.nsym == nsym else None), None
        htsig = S.parse_htsig(ht_bits)
        if htsig.ok:
            nss = htsig.mcs // 8 + 1
            if nss <= self.nrx:
                cfg = PhyConfig(Fmt.HT, htsig.mcs, nss, htsig.length,
                                ampdu=htsig.ampdu)
                # L-SIG TXTIME plausibility bound: HT-SIG-implied air time
                # must fit the L-SIG sample budget (demod_impl.cc:185-199)
                if lsig.nsym * 80 < cfg.nsym * 80 + 160 + 80 + 80 * cfg.nltf:
                    return None, None
                return cfg, None
            return None, None
        if lsig.ok:
            return PhyConfig(Fmt.L, 0, 1, lsig.length), None
        return None, None

    def _ndp_chan(self, dev, ltf_idx: int, cfo: float, nsts: int) -> np.ndarray:
        nltf = int(T.N_LTF_OF_NSTS[nsts])
        xs = cstack([FE.derotate_batch(dev[r], jnp.asarray([ltf_idx]),
                                       jnp.asarray([cfo]),
                                       208 + 160 + 80 + 80 * nltf)[0]
                     for r in range(self.nrx)], axis=0)
        h, _ = OF.nl_chanest(xs[None], 208 + 160 + 80, nltf, nsts,
                             nrx_axis=True)
        return np.asarray(h.re[0]) + 1j * np.asarray(h.im[0])

    # -- known-config fast path (bench / PER harness) ----------------------
    def decode_aligned(self, cfg: PhyConfig, stream: np.ndarray,
                       ltf_idx: np.ndarray, cfo: np.ndarray,
                       mpdu_len: int = 0) -> dict:
        """Decode a batch of same-config packets at known sync positions."""
        dev = from_host(np.atleast_2d(stream))
        return _payload_core(cfg, dev[: self.nrx], jnp.asarray(ltf_idx),
                             jnp.asarray(cfo), nrx=self.nrx,
                             mpdu_len=mpdu_len)
