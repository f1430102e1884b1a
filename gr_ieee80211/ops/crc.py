"""Batched CRC32 (FCS) checking on device via GF(2) matrix products.

CRC32 is linear over GF(2): for a fixed frame length L,
``crc(frame) = M_L @ bits + c_L (mod 2)`` where M_L is an (L x 32) 0/1
matrix.  A batch of frames is checked with one (B, L) x (L, 32) matmul on
a matmul followed by ``mod 2`` (exact in f32 for L < 2^24), replacing the
reference's per-byte boost::crc loop (lib/decode_impl.cc:374,453).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import zlib


@functools.lru_cache(maxsize=None)
def _crc_matrix(nbits: int):
    """(M, c): crc32(bits) == M^T b + c over GF(2).

    Column j of M = crc32 of the frame with only bit j set, xor c;
    c = crc32 of the all-zero frame.  Uses zlib on basis frames of
    byte-aligned length (nbits % 8 == 0), bit order LSB-first per byte.
    Cost O(L^2/64) via byte-level incremental construction.
    """
    assert nbits % 8 == 0
    nbytes = nbits // 8
    zero = bytes(nbytes)
    c = zlib.crc32(zero) & 0xFFFFFFFF
    # crc of single-bit frames: crc32 state is linear; use the identity
    # crc(e_j) = crc(zero) ^ D_j where D_j depends only on (bit pos in byte,
    # bytes remaining).  Build the 8 x nbytes kernel table by computing
    # crc(single byte b at position p) for the 8 one-hot bytes at each of
    # the "remaining length" classes.
    M = np.zeros((nbits, 32), dtype=np.float32)
    # incremental: crc(e at byte p) = crc32(one-hot byte || zeros(nbytes-1-p))
    # computed efficiently with zlib.crc32 over a reused zero tail via
    # combination: crc32(a || zeros(n)) = crc32_combine... zlib lacks
    # combine; instead compute per distinct tail length with one pass.
    for bit_in_byte in range(8):
        onehot = bytes([1 << bit_in_byte])
        # crc of onehot byte followed by k zero bytes, for all k, in O(L):
        # iterate from k = nbytes-1 down: maintain crc while appending zeros
        crc_k = np.zeros(nbytes, dtype=np.uint64)
        cur = zlib.crc32(onehot) & 0xFFFFFFFF
        # appending one zero byte: crc_new = crc32(zero_byte, prev_state)?
        # zlib.crc32(data, start) continues the crc; so:
        crc_k[nbytes - 1] = cur  # onehot at last byte, 0 zeros after
        for k in range(1, nbytes):
            cur = zlib.crc32(b"\x00", cur) & 0xFFFFFFFF
            crc_k[nbytes - 1 - k] = cur
        base = zlib.crc32(zero) & 0xFFFFFFFF
        for p in range(nbytes):
            # frame with byte p = onehot, rest zero:
            # crc = crc_k[p] ^ base ^ crc(all-zero up to p pre-xor terms)
            # Since crc is affine: crc(x) = A x + c; crc(e) ^ crc(0) = A e.
            zp = zlib.crc32(bytes(nbytes - p)) & 0xFFFFFFFF  # crc of zeros len n-p
            # careful: crc(onehot||zeros) uses init 0xFFFFFFFF; A e = crc(e)^crc(0)
            ae = crc_k[p] ^ zp
            bitpos = 8 * p + bit_in_byte
            for ob in range(32):
                M[bitpos, ob] = (ae >> ob) & 1
    cbits = np.array([(c >> ob) & 1 for ob in range(32)], dtype=np.float32)
    return M, cbits


@functools.partial(jax.jit, static_argnames=("nbits",))
def crc32_bits(bits: jax.Array, nbits: int) -> jax.Array:
    """(B, nbits) bits -> (B, 32) crc32 bits (LSB first)."""
    M, c = _crc_matrix(nbits)
    acc = jnp.dot(bits.astype(jnp.float32), M,
                  preferred_element_type=jnp.float32)
    return (acc + c) % 2.0


RESIDUE_BITS = np.array([(558161692 >> i) & 1 for i in range(32)],
                        dtype=np.float32)


@functools.partial(jax.jit, static_argnames=("nbits",))
def fcs_ok_batch(frame_bits: jax.Array, nbits: int) -> jax.Array:
    """(B, nbits) frame(+FCS) bits -> (B,) bool residue check."""
    crc = crc32_bits(frame_bits, nbits)
    return jnp.all(crc == RESIDUE_BITS, axis=1)
