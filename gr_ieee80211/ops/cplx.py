"""Complex arithmetic as float32 pairs for the device compute path.

The device pipeline carries (re, im) float32 pairs in a :class:`CF` pytree
instead of complex dtypes: the accelerator the system was first built for
had no complex support.  The 64-point (I)DFT is four real 64x64 matmuls.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class CF(NamedTuple):
    """Complex array as a (re, im) float32 pytree."""
    re: jax.Array
    im: jax.Array

    # -- structure ---------------------------------------------------------
    @property
    def shape(self):
        return self.re.shape

    @property
    def ndim(self):
        return self.re.ndim

    def __getitem__(self, idx):
        return CF(self.re[idx], self.im[idx])

    def reshape(self, *s):
        return CF(self.re.reshape(*s), self.im.reshape(*s))

    def transpose(self, *axes):
        return CF(self.re.transpose(*axes), self.im.transpose(*axes))

    # -- arithmetic --------------------------------------------------------
    def __add__(self, o):
        if isinstance(o, CF):
            return CF(self.re + o.re, self.im + o.im)
        return CF(self.re + o, self.im)

    def __sub__(self, o):
        if isinstance(o, CF):
            return CF(self.re - o.re, self.im - o.im)
        return CF(self.re - o, self.im)

    def __mul__(self, o):
        if isinstance(o, CF):
            return CF(self.re * o.re - self.im * o.im,
                      self.re * o.im + self.im * o.re)
        return CF(self.re * o, self.im * o)  # real scalar/array

    __rmul__ = __mul__

    def conj(self):
        return CF(self.re, -self.im)

    def mul_conj(self, o: "CF") -> "CF":
        """self * conj(o)."""
        return CF(self.re * o.re + self.im * o.im,
                  self.im * o.re - self.re * o.im)

    def abs2(self) -> jax.Array:
        return self.re * self.re + self.im * self.im

    def abs(self) -> jax.Array:
        return jnp.sqrt(self.abs2())

    def angle(self) -> jax.Array:
        return jnp.arctan2(self.im, self.re)

    def __truediv__(self, o):
        if isinstance(o, CF):
            d = o.abs2()
            d = jnp.where(d > 1e-24, d, 1e-24)
            return CF((self.re * o.re + self.im * o.im) / d,
                      (self.im * o.re - self.re * o.im) / d)
        return CF(self.re / o, self.im / o)

    def unit(self) -> "CF":
        """self / |self| (safe)."""
        a = jnp.maximum(self.abs(), 1e-12)
        return CF(self.re / a, self.im / a)


def cf_zeros(shape, dtype=jnp.float32) -> CF:
    return CF(jnp.zeros(shape, dtype), jnp.zeros(shape, dtype))


def from_host(x: np.ndarray) -> CF:
    """Host complex ndarray -> device CF (two float32 arrays)."""
    x = np.asarray(x)
    return CF(jnp.asarray(x.real.astype(np.float32)),
              jnp.asarray(x.imag.astype(np.float32)))


def from_host_bf16(x: np.ndarray) -> CF:
    """Host complex ndarray -> device CF staged as bfloat16 (half the
    upload bytes; ~49 dB SQNR, far below channel noise at any decodable
    SNR), for a transport-bound raw-IQ ingest.  Downstream ops promote to f32 where they accumulate
    (frontend._chunk4_rows, the factored derotation phasors)."""
    import ml_dtypes
    x = np.asarray(x)
    return CF(jnp.asarray(x.real.astype(ml_dtypes.bfloat16)),
              jnp.asarray(x.imag.astype(ml_dtypes.bfloat16)))


def from_host_i8(x: np.ndarray) -> CF:
    """Host complex ndarray -> device CF staged as int8 (quarter of the
    f32 upload bytes; ~48 dB SQNR at full scale — an 8-bit ADC front
    end, the dynamic range real 802.11 radios digitize with anyway).

    Host-side: one shared scale per call (block-level AGC) quantizes
    re/im to [-127, 127].  Device-side: one multiply dequantizes to f32
    before the chain.  Half of bf16's bytes again, for a transport-bound
    raw-IQ ingest (tools/bench_daemon.py)."""
    x = np.asarray(x)
    m = float(max(np.abs(x.real).max(initial=0.0),
                  np.abs(x.imag).max(initial=0.0), 1e-9))
    s = 127.0 / m
    re8 = jnp.asarray(np.clip(np.rint(x.real * s), -127, 127
                              ).astype(np.int8))
    im8 = jnp.asarray(np.clip(np.rint(x.imag * s), -127, 127
                              ).astype(np.int8))
    # scale as a device array, NOT a python scalar: eager ops cache by
    # shape, but a fresh scalar constant would re-trace (and re-compile)
    # on every distinct block gain
    inv = jnp.asarray(np.float32(m / 127.0))
    return CF(re8.astype(jnp.float32) * inv, im8.astype(jnp.float32) * inv)


def to_host(cf: CF) -> np.ndarray:
    return np.asarray(cf.re) + 1j * np.asarray(cf.im)


def expj(theta: jax.Array) -> CF:
    """exp(j*theta)."""
    return CF(jnp.cos(theta), jnp.sin(theta))


def csum(cf: CF, axis=None, keepdims=False) -> CF:
    return CF(jnp.sum(cf.re, axis=axis, keepdims=keepdims),
              jnp.sum(cf.im, axis=axis, keepdims=keepdims))


def cmean(cf: CF, axis=None) -> CF:
    return CF(jnp.mean(cf.re, axis=axis), jnp.mean(cf.im, axis=axis))


def cstack(cfs: list[CF], axis=0) -> CF:
    return CF(jnp.stack([c.re for c in cfs], axis=axis),
              jnp.stack([c.im for c in cfs], axis=axis))


def cconcat(cfs: list[CF], axis=0) -> CF:
    return CF(jnp.concatenate([c.re for c in cfs], axis=axis),
              jnp.concatenate([c.im for c in cfs], axis=axis))


def cwhere(mask, a: CF, b: CF) -> CF:
    return CF(jnp.where(mask, a.re, b.re), jnp.where(mask, a.im, b.im))


# ---------------------------------------------------------------------------
# 64-point DFT / IDFT as matmuls (fftshifted grid convention)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _dft64_mats():
    """Real/imag DFT matrices mapping 64 time samples -> fftshifted grid.

    grid[i] = sum_n x[n] * exp(-2j*pi*n*(i-32)/64)  (fftshift built in).
    """
    n = np.arange(64)[:, None]
    k = (np.arange(64) - 32)[None, :]
    ang = -2 * np.pi * n * k / 64.0
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _idft64_mats():
    """Fftshifted grid -> 64 time samples (numpy ifft normalization 1/64)."""
    k = (np.arange(64) - 32)[:, None]
    n = np.arange(64)[None, :]
    ang = 2 * np.pi * k * n / 64.0
    return (np.cos(ang) / 64).astype(np.float32), (np.sin(ang) / 64).astype(np.float32)


# Default-precision f32 matmuls may run in reduced precision (bf16 passes or
# TF32, ~1e-3 rel err), which flips QAM decisions near boundaries and costs
# FCS failures at MCS7.  The (I)DFT is a tiny fraction of chain FLOPs, so
# force full f32 here.
_PREC = jax.lax.Precision.HIGHEST


def dft64(x: CF) -> CF:
    """(..., 64) time windows -> fftshifted grids via matmuls."""
    C, S = _dft64_mats()
    re = jnp.dot(x.re, C, precision=_PREC, preferred_element_type=jnp.float32) \
        - jnp.dot(x.im, S, precision=_PREC, preferred_element_type=jnp.float32)
    im = jnp.dot(x.re, S, precision=_PREC, preferred_element_type=jnp.float32) \
        + jnp.dot(x.im, C, precision=_PREC, preferred_element_type=jnp.float32)
    return CF(re, im)


def idft64(g: CF) -> CF:
    """(..., 64) fftshifted grids -> time samples (1/64 normalized)."""
    C, S = _idft64_mats()
    re = jnp.dot(g.re, C, precision=_PREC, preferred_element_type=jnp.float32) \
        - jnp.dot(g.im, S, precision=_PREC, preferred_element_type=jnp.float32)
    im = jnp.dot(g.re, S, precision=_PREC, preferred_element_type=jnp.float32) \
        + jnp.dot(g.im, C, precision=_PREC, preferred_element_type=jnp.float32)
    return CF(re, im)
