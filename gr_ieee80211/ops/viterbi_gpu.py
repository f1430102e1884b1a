"""Viterbi decode on the GPU, and the one place that picks a decoder.

:func:`viterbi_decode` is the production entry point.  It selects the
implementation from the JAX platform (:func:`decoder`):

* ``gpu``: :func:`viterbi_decode_gpu`, two Pallas kernels on the Triton
  route (ACS sweep, then traceback);
* ``cpu``: the plain XLA scan in :mod:`ops.viterbi`, the reference;
* anything else raises.  Interpret mode is only ever asked for by tests.

ACS kernel.  The grid covers packet tiles only; the loop over the trellis
runs inside the kernel, so a tile's 64 path metrics stay in registers
from the first step to the last.  The metrics are held as a (bt, 64) tile
in bit-reversed state order: position k holds state bitrev6(k).  In that
order the radix-2 butterfly needs no shuffle that Triton cannot express:

    ev, od = split(pm, 2, axis=1)      # states 2j and 2j+1, j = bitrev5(k)
    lo = max(ev + bm(ev, 0), od + bm(od, 0))      # new state j
    hi = max(ev + bm(ev, 1), od + bm(od, 1))      # new state 32 + j
    pm = join(lo, hi).reshape(bt, 64)  # position 2k + b = bitrev6(32b + j)

One step's 64 decisions leave the kernel as two int32 words per packet
(bit j of the low word: the odd predecessor won for state j), so the
decision planes are 8 bytes per packet-step instead of the reference's 64.
The LLR planes and the decision words are (T, B): one step's loads and
stores are coalesced across the packets of a tile.

Traceback kernel: one scalar state walk per packet, from state 0 or from
a given start state, reading the two decision words of each step.

Every candidate metric is formed as ``(p + c_a*l0) + c_b*l1`` with 0/1
branch masks, and the metrics are renormalised after every ``CHUNK`` steps,
exactly as the reference does, so the decoded bits equal the reference's
bit for bit.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from . import viterbi as VXLA

#: renormalisation period, shared with the reference (bit-exact metrics)
CHUNK = VXLA.CHUNK
#: ACS packets per program and warps per program (the fastest of six
#: measured tiles on the H100, PERF.md)
ACS_BT = 16
ACS_WARPS = 2
#: traceback packets per program (one thread each) and warps per program
TB_BT = 32
TB_WARPS = 1

#: position k of the kernel's metric tile holds state _BR6[k] (involution)
_BR6 = np.array([int(f"{k:06b}"[::-1], 2) for k in range(64)], np.int32)


def _bitrev5(k):
    """Reverse the low five bits of an int32 array."""
    r = jnp.zeros_like(k)
    for i in range(5):
        r = r | (((k >> i) & 1) << (4 - i))
    return r


def _acs_kernel(l0_ref, l1_ref, pm0_ref, dlo_ref, dhi_ref, pm_ref, *,
                n_chunks: int, bt: int):
    k = jax.lax.broadcasted_iota(jnp.int32, (1, 32), 1)
    j = _bitrev5(k)
    ev_s = 2 * j                          # even predecessor state, b = 0

    def bit(s, i):
        return (s >> i) & 1

    # coded bits of the transitions out of 2j / 2j+1 on input bit 0
    # (133o/171o taps; input bit 1 flips both), as 0/1 float masks
    def masks(p):
        o0 = bit(p, 4) ^ bit(p, 3) ^ bit(p, 1) ^ bit(p, 0)
        o1 = bit(p, 5) ^ bit(p, 4) ^ bit(p, 3) ^ bit(p, 0)
        return o0.astype(jnp.float32), o1.astype(jnp.float32)

    ae, be = masks(ev_s)
    ao, bo = masks(ev_s + 1)
    weight = jnp.left_shift(jnp.ones_like(j), j)     # bit j of the word

    def pack(take):
        return jnp.sum(jnp.where(take, weight, 0), axis=1)

    def step(t, pm):
        l0 = l0_ref[t, :][:, None]
        l1 = l1_ref[t, :][:, None]
        ev, od = jax.lax.split(pm, (32, 32), axis=1)
        lo_e = (ev + ae * l0) + be * l1
        lo_o = (od + ao * l0) + bo * l1
        hi_e = (ev + (1.0 - ae) * l0) + (1.0 - be) * l1
        hi_o = (od + (1.0 - ao) * l0) + (1.0 - bo) * l1
        take_lo = lo_o > lo_e
        take_hi = hi_o > hi_e
        dlo_ref[t, :] = pack(take_lo)
        dhi_ref[t, :] = pack(take_hi)
        lo = jnp.maximum(lo_e, lo_o)
        hi = jnp.maximum(hi_e, hi_o)
        return jax.lax.concatenate([lo[:, :, None], hi[:, :, None]],
                                   2).reshape(bt, 64)

    def chunk(c, pm):
        pm = jax.lax.fori_loop(c * CHUNK, (c + 1) * CHUNK, step, pm)
        return pm - jnp.max(pm, axis=1, keepdims=True)

    pm_ref[...] = jax.lax.fori_loop(0, n_chunks, chunk, pm0_ref[...])


@functools.partial(jax.jit, static_argnames=("interpret",))
def acs_sweep(llr0: jax.Array, llr1: jax.Array, pm0: jax.Array,
              interpret: bool = False):
    """Forward ACS over whole trellises.

    llr0, llr1: (T, B) float32, T a CHUNK multiple, B an ACS_BT multiple;
    pm0: (B, 64) initial metrics in the kernel's bit-reversed order.
    Returns the (T, B) int32 decision words for states 0-31 and 32-63 and
    the final (B, 64) metrics, bit-reversed."""
    n_steps, B = llr0.shape
    assert n_steps % CHUNK == 0 and B % ACS_BT == 0, (n_steps, B)
    plane = pl.BlockSpec((n_steps, ACS_BT), lambda i: (0, i))
    metrics = pl.BlockSpec((ACS_BT, 64), lambda i: (i, 0))
    return pl.pallas_call(
        functools.partial(_acs_kernel, n_chunks=n_steps // CHUNK, bt=ACS_BT),
        grid=(B // ACS_BT,),
        in_specs=[plane, plane, metrics],
        out_specs=(plane, plane, metrics),
        out_shape=(jax.ShapeDtypeStruct((n_steps, B), jnp.int32),
                   jax.ShapeDtypeStruct((n_steps, B), jnp.int32),
                   jax.ShapeDtypeStruct((B, 64), jnp.float32)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=ACS_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="viterbi_acs",
    )(llr0, llr1, pm0)


def _traceback_kernel(dlo_ref, dhi_ref, s0_ref, bits_ref, *, n_steps: int):
    def step(u, s):
        t = n_steps - 1 - u
        bits_ref[t, :] = (s >> 5).astype(jnp.int8)
        word = jnp.where(s >= 32, dhi_ref[t, :], dlo_ref[t, :])
        d = jax.lax.shift_right_logical(word, s & 31) & 1
        return ((s << 1) & 63) | d

    jax.lax.fori_loop(0, n_steps, step, s0_ref[...])


@functools.partial(jax.jit, static_argnames=("interpret",))
def traceback_sweep(dec_lo: jax.Array, dec_hi: jax.Array, s0: jax.Array,
                    interpret: bool = False) -> jax.Array:
    """(T, B) decision words and (B,) int32 start states -> (T, B) int8 bits."""
    n_steps, B = dec_lo.shape
    assert B % TB_BT == 0, B
    plane = pl.BlockSpec((n_steps, TB_BT), lambda i: (0, i))
    return pl.pallas_call(
        functools.partial(_traceback_kernel, n_steps=n_steps),
        grid=(B // TB_BT,),
        in_specs=[plane, plane, pl.BlockSpec((TB_BT,), lambda i: (i,))],
        out_specs=plane,
        out_shape=jax.ShapeDtypeStruct((n_steps, B), jnp.int8),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=TB_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="viterbi_traceback",
    )(dec_lo, dec_hi, s0)


@functools.partial(jax.jit, static_argnames=("traceback_from_zero",
                                             "interpret"))
def viterbi_decode_gpu(llr_pairs: jax.Array, traceback_from_zero: bool = True,
                       pm0: jax.Array | None = None,
                       interpret: bool = False) -> jax.Array:
    """Same contract as :func:`ops.viterbi.viterbi_decode`, on the kernels.

    llr_pairs (B, T, 2) float32 -> (B, T) uint8.  T pads with zero LLRs to
    a CHUNK multiple (as the reference pads), B to a whole tile."""
    B, n_steps, _ = llr_pairs.shape
    Tp = VXLA._pad_steps(n_steps)
    tile = int(np.lcm(ACS_BT, TB_BT))
    Bp = -(-B // tile) * tile
    if pm0 is None:
        pm0 = VXLA.state0_metrics(B)
    x = jnp.pad(llr_pairs, ((0, Bp - B), (0, Tp - n_steps), (0, 0)))
    pm0 = jnp.pad(pm0, ((0, Bp - B), (0, 0)))
    llr0 = x[:, :, 0].T
    llr1 = x[:, :, 1].T
    dec_lo, dec_hi, pm = acs_sweep(llr0, llr1, pm0[:, _BR6],
                                   interpret=interpret)
    if traceback_from_zero:
        s0 = jnp.zeros((Bp,), jnp.int32)
    else:
        s0 = jnp.argmax(pm[:, _BR6], axis=1).astype(jnp.int32)
    bits = traceback_sweep(dec_lo, dec_hi, s0, interpret=interpret)
    return bits.T[:B, :n_steps].astype(jnp.uint8)


def decoder(platform: str | None = None):
    """The Viterbi implementation for a JAX platform (default: the default
    backend's).  Both take (llr_pairs, traceback_from_zero, pm0)."""
    platform = platform or jax.default_backend()
    if platform == "gpu":
        return viterbi_decode_gpu
    if platform == "cpu":
        return VXLA.viterbi_decode
    raise ValueError(f"no Viterbi decoder for platform {platform!r}")


def _seg_geometry(B: int, T: int):
    """(S, K) segment count and kept steps per segment for (B, T).

    K is a multiple of SEG_W * 2 = 256 steps so every segment window is
    whole 512-float rows of the flat depunctured view (a row take; see
    _viterbi_decode_segmented)."""
    S = max(2, -(-T // SEG_TARGET_K))
    K = 2 * SEG_W * -(-T // (2 * SEG_W * S))
    S = -(-T // K)
    return S, K


def segmented_pays(B: int, T: int) -> bool:
    """True when the segmented decode beats the monolithic sweep.

    Measured on one H100 (tools/bench_viterbi.py, PERF.md): segmentation
    pays at every batch from 128 to 4096 rows once the trellis spans at
    least two target segments (T=2288: 2.2 -> 1.2 ms at 128 rows;
    T=4420: 3.9 -> 1.5 ms at 128 rows, 6.4 -> 3.7 ms at 4096; T=33000:
    37 -> 2.1 ms at 128 rows), and not below that (T=1040: a tie at 128
    rows, a loss at 4096), where a segment is as long as the trellis."""
    del B                          # no batch dependence in the measurements
    return T >= 2 * SEG_TARGET_K


def viterbi_decode(llr_pairs: jax.Array, traceback_from_zero: bool = True,
                   pm0: jax.Array | None = None,
                   segmented: bool | str = False) -> jax.Array:
    """Production Viterbi: (B, T, 2) float32 LLR pairs -> (B, T) uint8.

    The implementation follows the platform (:func:`decoder`).

    segmented=True splits each trellis into overlapped ~1k-step segments
    decoded as extra batch rows (see _viterbi_decode_segmented): bit-
    identical at working SNR and a T/K-fold shorter sequential span, for
    about 25% more total work.  segmented="auto" picks by
    :func:`segmented_pays`.  Segmented decodes start from state 0 only.
    """
    B, n_steps, _ = llr_pairs.shape
    if segmented == "auto":
        segmented = segmented_pays(B, n_steps)
    if segmented:
        assert traceback_from_zero and pm0 is None
        return _viterbi_decode_segmented(llr_pairs)
    return decoder()(llr_pairs, traceback_from_zero, pm0)


#: segmented decoding: overlap-save over the TRELLIS.  Each packet's trellis
#: splits into S segments decoded as extra batch rows — the sequential loop
#: shrinks from T to K + 2*SEG_W steps.  A 128-step (>= the ~96-step
#: survivor-merge depth) warmup from uniform metrics converges the survivor
#: tree, so segment interiors decode identically to the monolithic sweep;
#: traceback seeds from the argmax state at the segment tail.  This is the
#: "standard windowed" decoding the reference's own measurement report
#: recommends over its full-packet traceback (Measurement_Report.pdf
#: section 1).
SEG_OVERLAP = 96          # survivor-merge depth bound (docs/canon ladder)
SEG_W = 128               # actual window overlap (>= the bound)
SEG_TARGET_K = 1024
#: front-pad LLR strongly favoring coded bit 0: segment 0 decodes its
#: SEG_W-step pre-history as forced zero bits, reproducing the state-0
#: start pin under the shared uniform initial metrics
PIN_LLR = -1e5


def _viterbi_decode_segmented(llr_pairs: jax.Array) -> jax.Array:
    """The trellis is depunctured-flat (B, 2T), front-padded with SEG_W
    steps of PIN_LLR (state-0 pin for segment 0 under uniform pm0) and
    viewed as 512-float rows; every segment window is a whole-row take."""
    B, n_steps, _ = llr_pairs.shape
    W = SEG_W
    S, K = _seg_geometry(B, n_steps)
    seg_t = K + 2 * W
    P = W + S * K + W                     # 2P = 512 * (S*K/256 + 1)
    flat = llr_pairs.reshape(B, 2 * n_steps)
    flat = jnp.pad(flat, ((0, 0), (2 * W, 2 * (P - W - n_steps))))
    pin = (jnp.arange(2 * P, dtype=jnp.int32) < 2 * W)[None, :]
    flat = jnp.where(pin, PIN_LLR, flat)
    rows_per_b = 2 * P // 512
    v = flat.reshape(B * rows_per_b, 512)
    # window (b, s) = rows [b*rows_per_b + s*(2K/512), +2*seg_t/512)
    b = jnp.arange(B * S, dtype=jnp.int32) // S
    s = jnp.arange(B * S, dtype=jnp.int32) % S
    base = b * rows_per_b + s * (2 * K // 512)
    span = 2 * seg_t // 512
    bidx = base[:, None] + jnp.arange(span, dtype=jnp.int32)[None, :]
    N = B * S
    win = jnp.take(v, bidx, axis=0).reshape(N, seg_t, 2)
    # uniform start metrics (the pin rides in the LLRs); traceback from
    # the ML end state of each window (for the last, tail segment this is
    # state 0 via the zero tail bits at working SNR)
    bits = decoder()(win, False, jnp.zeros((N, 64), jnp.float32))
    kept = bits[:, W: W + K]                          # (B*S, K)
    return kept.reshape(B, S * K)[:, :n_steps]
