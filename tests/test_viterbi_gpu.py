"""GPU Viterbi kernels (ops.viterbi_gpu) and the decoder selection.

On the CPU the Pallas kernels run in interpret mode against the XLA
reference (ops.viterbi); ``gpu``-marked tests run them compiled on the card.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gr_ieee80211.gold import bits as GB
from gr_ieee80211.ops import viterbi as VX
from gr_ieee80211.ops import viterbi_gpu as VG


def _noisy_pairs(rng, B, T, sigma):
    """(B, T, 2) LLR pairs of random tail-terminated data plus noise."""
    msg = rng.integers(0, 2, (B, T)).astype(np.uint8)
    msg[:, -6:] = 0
    llr = np.stack([(2.0 * GB.bcc_encode(m).astype(np.float32) - 1.0)
                    .reshape(T, 2) for m in msg])
    llr += sigma * rng.normal(size=llr.shape).astype(np.float32)
    return jnp.asarray(llr)


@pytest.mark.parametrize("B, T, from_zero", [
    (5, 100, True),          # B below one tile, T below one CHUNK multiple
    (33, 130, False),        # B just over a tile, argmax start
    (17, 61, True),
    (48, 216, False),        # T an exact CHUNK multiple
])
def test_kernel_interpret_matches_reference(B, T, from_zero):
    """The interpreted ACS + traceback kernels decode exactly the bits of
    the XLA reference, from state 0 and from uniform metrics with an argmax
    start (the windowed and segmented callers)."""
    rng = np.random.default_rng(B * 1000 + T)
    llr = _noisy_pairs(rng, B, T, 0.9)
    pm0 = None if from_zero else jnp.zeros((B, 64), jnp.float32)
    got = VG.viterbi_decode_gpu(llr, from_zero, pm0, interpret=True)
    ref = VX.viterbi_decode(llr, from_zero, pm0)
    assert got.shape == (B, T) and got.dtype == jnp.uint8
    assert np.array_equal(np.asarray(got), np.asarray(ref))


@pytest.mark.parametrize("platform, expect", [
    ("cpu", VX.viterbi_decode),
    ("gpu", VG.viterbi_decode_gpu),
])
def test_decoder_selection(platform, expect):
    assert VG.decoder(platform) is expect


def test_decoder_selection_rejects_unknown_platform():
    with pytest.raises(ValueError, match="no Viterbi decoder"):
        VG.decoder("rocm")


def test_production_decode_on_cpu_is_the_reference():
    """The production entry point on the CPU backend is the reference."""
    rng = np.random.default_rng(2)
    llr = _noisy_pairs(rng, 6, 90, 0.7)
    assert jax.default_backend() == "cpu"
    assert np.array_equal(np.asarray(VG.viterbi_decode(llr)),
                          np.asarray(VX.viterbi_decode(llr)))


@pytest.mark.gpu
def test_kernel_on_card_matches_reference(gpu):
    """The compiled kernels on the card against the reference on the card."""
    rng = np.random.default_rng(3)
    for B, T, from_zero in ((256, 4420, True), (300, 512, False)):
        llr = _noisy_pairs(rng, B, T, 0.8)
        pm0 = None if from_zero else jnp.zeros((B, 64), jnp.float32)
        got = VG.viterbi_decode_gpu(llr, from_zero, pm0)
        ref = VX.viterbi_decode(llr, from_zero, pm0)
        assert np.array_equal(np.asarray(got), np.asarray(ref)), (B, T)
