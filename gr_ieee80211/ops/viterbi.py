"""Batched soft Viterbi decoder for the 802.11 BCC (K=7, 64 states), plain XLA.

The reference's decoder is the profiled bottleneck of its RX chain (93-250
CPU ticks per LLR item, ``BASELINE.md``).  This is the repository's plain
reference implementation (``ops.viterbi_gpu`` selects it on the CPU):

* one add-compare-select step is a handful of (B, 64) elementwise ops with
  **no gathers**: the predecessor permutation for this trellis
  (pred0(s) = 2s mod 64, pred1 = 2s+1 mod 64) is exactly "split even/odd and
  tile", a reshape;
* the trellis scan is sequential (inherent), so throughput comes from the
  packet batch; decisions are stored as (T, B, 64) int8 and traced back with
  a second scan of batched 1-element gathers;
* path metrics are renormalized by their per-packet max each step to keep
  f32 exact over 32k-step trellises.

Trellis semantics match ``spec.tables.viterbi_tables`` (validated against the
reference decoders in tests/test_spec.py).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..spec import tables as T

NEG = -1e9


@functools.lru_cache(maxsize=None)
def _acs_consts():
    # plain numpy: embedded as compile-time constants (jnp arrays created
    # here would leak tracers through the cache when called inside a trace)
    return T.viterbi_acs_tables()


def _acs_step(pm, llr_t, c):
    """pm (B, 64), llr_t (B, 2) -> (new pm, decision bits)."""
    c0a, c0b, c1a, c1b = c
    l0 = llr_t[:, 0:1]
    l1 = llr_t[:, 1:2]
    pme = pm.reshape(pm.shape[0], 32, 2)
    p0 = jnp.tile(pme[:, :, 0], (1, 2))     # predecessor 2s mod 64
    p1 = jnp.tile(pme[:, :, 1], (1, 2))     # predecessor 2s+1 mod 64
    cand0 = p0 + c0a * l0 + c0b * l1
    cand1 = p1 + c1a * l0 + c1b * l1
    take1 = cand1 > cand0
    pm_new = jnp.maximum(cand0, cand1)
    return pm_new, take1


#: trellis steps fused per scan iteration; path-metric renormalization happens
#: once per chunk (f32 headroom: |LLR| <= ~16, drift 16*CHUNK << 2^24).
CHUNK = 54


def _pad_steps(n_steps: int) -> int:
    return -(-n_steps // CHUNK) * CHUNK


@functools.partial(jax.jit, static_argnames=("traceback_from_zero",))
def viterbi_decode(llr_pairs: jax.Array, traceback_from_zero: bool = True,
                   pm0: jax.Array | None = None):
    """Decode a batch of equal-length trellises.

    llr_pairs: (B, T, 2) float32, already depunctured (zeros at punctured
    positions).  Positive LLR means coded bit 1.  Returns (B, T) uint8.
    pm0: optional (B, 64) initial path metrics (default: pinned to state
    0); windowed callers pass uniform metrics and trace back from the
    argmax state (``traceback_from_zero=False``).

    Zero-LLR padding steps are appended up to a CHUNK multiple; they leave
    the surviving path through state 0 intact so traceback from state 0 of
    the padded trellis yields the same bits (padded tail bits are dropped).
    """
    B, n_steps, _ = llr_pairs.shape
    c = _acs_consts()
    n_pad = _pad_steps(n_steps)
    if n_pad != n_steps:
        llr_pairs = jnp.pad(llr_pairs, ((0, 0), (0, n_pad - n_steps), (0, 0)))
    if pm0 is None:
        pm0 = state0_metrics(B)
    # tie the carry to the input so its sharding/varying axes match under
    # shard_map (a constant carry would be unvarying and fail scan typing)
    pm0 = pm0 + 0.0 * llr_pairs[:, 0, 0:1]
    chunks = llr_pairs.transpose(1, 0, 2).reshape(n_pad // CHUNK, CHUNK, B, 2)

    def fwd(pm, llr_chunk):
        decs = []
        for t in range(CHUNK):
            pm, take1 = _acs_step(pm, llr_chunk[t], c)
            decs.append(take1)
        pm = pm - jnp.max(pm, axis=1, keepdims=True)
        return pm, jnp.stack(decs).astype(jnp.int8)

    pm, decisions = jax.lax.scan(fwd, pm0, chunks)
    decisions = decisions.reshape(n_pad, B, 64)

    if traceback_from_zero:
        s0 = jnp.zeros((B,), dtype=jnp.int32) + 0 * decisions[0, :, 0].astype(jnp.int32)
    else:
        s0 = jnp.argmax(pm, axis=1).astype(jnp.int32)

    def back(state, dec_t):
        bit = (state >> 5).astype(jnp.uint8)
        d = jnp.take_along_axis(dec_t, state[:, None], axis=1)[:, 0]
        pred = (2 * state) % 64 + d.astype(jnp.int32)
        return pred, bit

    _, bits_rev = jax.lax.scan(back, s0, decisions[::-1], unroll=16)
    return bits_rev[::-1].transpose(1, 0)[:, :n_steps]


def state0_metrics(B: int) -> jax.Array:
    """(B, 64) initial path metrics pinned to state 0 (packet start)."""
    return jnp.full((B, 64), NEG, dtype=jnp.float32).at[:, 0].set(0.0)


@functools.lru_cache(maxsize=None)
def depuncture_indices(cr: str, n_steps: int):
    """(keep positions, n_kept) for scattering LLRs into the 2*T stream."""
    pat = T.PUNCTURE[cr]
    keep = np.tile(pat, -(-2 * n_steps // len(pat)))[: 2 * n_steps].astype(bool)
    # numpy (not jnp): cached values must stay host constants or they leak
    # tracers when first materialized inside another trace
    return np.nonzero(keep)[0].astype(np.int32), int(keep.sum())


@functools.partial(jax.jit, static_argnames=("cr", "n_steps"))
def depuncture(llr: jax.Array, cr: str, n_steps: int) -> jax.Array:
    """(B, n_coded) punctured LLRs -> (B, n_steps, 2) with zeros inserted."""
    idx, nk = depuncture_indices(cr, n_steps)
    B = llr.shape[0]
    full = jnp.zeros((B, 2 * n_steps), dtype=llr.dtype)
    full = full.at[:, idx].set(llr[:, :nk])
    return full.reshape(B, n_steps, 2)


def decode_coded_llrs(llr: jax.Array, cr: str, n_steps: int) -> jax.Array:
    """Convenience: depuncture + decode.  llr (B, n_coded) -> (B, n_steps)."""
    return viterbi_decode(depuncture(llr, cr, n_steps))
