"""Matmuls pinned to full float32 precision (the GPU would otherwise run
them in TF32) agree with float64 numpy, and stay pinned."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gr_ieee80211.models.tx import _apply_q_grids
from gr_ieee80211.ops import cplx
from gr_ieee80211.ops.cplx import CF

#: float32 rounding of a 64-term (DFT) or 2-term (Q) sum of O(1) values
TOL = 1e-5


def _cf(rng, shape):
    x = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    return x, CF(jnp.asarray(x.real, jnp.float32),
                 jnp.asarray(x.imag, jnp.float32))


def _dft(x):
    return np.fft.fftshift(np.fft.fft(x, axis=-1), axes=-1)


def _idft(g):
    return np.fft.ifft(np.fft.ifftshift(g, axes=-1), axis=-1)


def _apply_q(x, q):
    return np.einsum("kij,bjnk->bink", q, x)


SITES = {
    "dft64": (lambda rng: (_cf(rng, (5, 3, 64)),), cplx.dft64, _dft),
    "idft64": (lambda rng: (_cf(rng, (5, 3, 64)),), cplx.idft64, _idft),
    "apply_q": (lambda rng: (_cf(rng, (4, 2, 3, 64)), _cf(rng, (64, 2, 2))),
                lambda g, q: _apply_q_grids(g, q, "bjnk"), _apply_q),
}


@pytest.mark.parametrize("site", sorted(SITES))
def test_pinned_site_matches_float64(site):
    make, dev_fn, ref_fn = SITES[site]
    args = make(np.random.default_rng(3))
    got = dev_fn(*(cf for _, cf in args))
    ref = ref_fn(*(x for x, _ in args))
    err = np.abs(np.asarray(got.re) + 1j * np.asarray(got.im) - ref).max()
    assert err < TOL * max(1.0, np.abs(ref).max()), err
    jaxpr = jax.make_jaxpr(lambda *a: dev_fn(*a))(*(cf for _, cf in args))
    dots = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "dot_general"]
    assert dots and all(
        e.params["precision"] == (jax.lax.Precision.HIGHEST,) * 2
        for e in dots), [e.params["precision"] for e in dots]
