"""Seeded test streams shared by the benchmark, the chip smoke test and tools.

The headline stream mirrors the reference PER harness packet shape
(tools/performance/perf_siso.py: ~500 B payloads, VHT): B copies of one
VHT MCS7 1SS A-MPDU packet with a 900 Hz CFO, 240 idle samples apart,
in complex AWGN at a stated SNR.
"""
from __future__ import annotations

import numpy as np

from ..gold import channel, mac, tx
from ..spec.params import Fmt, PhyConfig

LEAD = 1024
GAP = 240


def vht_packet(payload_len: int = 500, mcs: int = 7, nss: int = 1,
               seed: int = 1):
    """(cfg, mpdu, wave (nss, n)) for one single-MPDU VHT A-MPDU."""
    rng = np.random.default_rng(seed)
    payload = bytes(rng.integers(0, 256, payload_len, dtype=np.uint8))
    mpdu = mac.qos_data_frame(payload, "f4:69:d5:80:0f:a0",
                              "00:c0:ca:b1:5b:e1", "f4:69:d5:80:0f:a0", 7)
    am = mac.ampdu_aggregate_vht([mpdu])
    cfg = PhyConfig(Fmt.VHT, mcs, nss, len(am), ampdu=True)
    wave = tx.tx_waveform(cfg, am, group_id=0, partial_aid=0)
    return cfg, mpdu, wave


def noisy_llr_pairs(B: int, T: int, sigma: float, seed: int = 0):
    """(B, T, 2) float32 LLR pairs on the device: random tail-terminated
    data, BCC-encoded, BPSK +-1 plus Gaussian noise of std ``sigma``."""
    import jax
    import jax.numpy as jnp
    from ..models.tx import _bcc_encode_batch
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    bits = jax.random.bernoulli(k1, 0.5, (B, T)).astype(jnp.uint8)
    bits = bits.at[:, -6:].set(0)
    coded = _bcc_encode_batch(bits).astype(jnp.float32)
    llr = (2.0 * coded - 1.0) + sigma * jax.random.normal(k2, coded.shape)
    return llr.reshape(B, T, 2)


def packet_train(wave: np.ndarray, n_pkts: int, snr_db: float,
                 cfo_hz: float = 900.0, h: np.ndarray | None = None,
                 seed: int = 1) -> np.ndarray:
    """(nrx, N) complex64 stream of ``n_pkts`` copies of ``wave`` (nss, n),
    each through the optional (nrx, nss) channel ``h``, in AWGN at
    ``snr_db`` relative to the mean received packet power."""
    rng = np.random.default_rng(seed)
    w = np.atleast_2d(wave)
    if h is not None:
        w = np.asarray(h) @ w
    w = np.stack([channel.apply_cfo(r, cfo_hz) for r in w])
    spacing = w.shape[1] + GAP
    stream = np.zeros((w.shape[0], n_pkts * spacing + 2 * LEAD),
                      np.complex64)
    for i in range(n_pkts):
        stream[:, LEAD + i * spacing: LEAD + i * spacing + w.shape[1]] = w
    rms = float(np.sqrt(np.mean(np.abs(w) ** 2)))
    sigma = rms / 10 ** (snr_db / 20) / np.sqrt(2)
    stream += (rng.normal(size=stream.shape)
               + 1j * rng.normal(size=stream.shape)
               ).astype(np.complex64) * np.float32(sigma)
    return stream
