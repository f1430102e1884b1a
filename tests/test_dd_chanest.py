"""Decision-directed DATA-symbol second-pass channel refinement.

The reference estimates the channel once from the preamble LTF and never
re-estimates (gr-ieee80211 lib/demod_impl.cc); ops.ofdm.refine_chanest_data
turns every payload symbol into a channel observation (hard-sliced QAM
decisions + known pilot polarities) and is gated in models/rx._payload_core
on the first-pass syndrome total so clean high-SNR batches never pay for it.
"""
import numpy as np
import pytest

from gr_ieee80211.spec import tables as T
from gr_ieee80211.spec.params import PhyConfig, Fmt
from gr_ieee80211.gold import tx as gtx, mac, channel
from gr_ieee80211.ops import ofdm as OF
from gr_ieee80211.ops.cplx import CF


def _delay_channel(rng, ntaps=6):
    """Random delay-limited channel frequency response on 64 tones."""
    taps = (rng.normal(size=ntaps) + 1j * rng.normal(size=ntaps)) / np.sqrt(2 * ntaps)
    k = np.fft.fftshift(np.fft.fftfreq(64, 1 / 64)).astype(int)
    return np.sum(taps[None, :] * np.exp(-2j * np.pi * k[:, None]
                                         * np.arange(ntaps)[None, :] / 64), axis=1)


@pytest.mark.parametrize("fmt,mcs", [(Fmt.VHT, 4), (Fmt.L, 5)])
def test_dd_pass_cuts_estimate_error(fmt, mcs):
    """Synthetic grids through a known channel: the refined estimate must be
    substantially closer to truth than the noisy prior on the data tones."""
    rng = np.random.default_rng(7)
    if fmt == Fmt.VHT:
        cfg = PhyConfig(fmt, mcs, 1, 300, ampdu=True)
    else:
        cfg = PhyConfig(fmt, mcs, 1, 300)
    nsym, B = cfg.nsym, 16
    didx = T.DATA_IDX_L if fmt == Fmt.L else T.DATA_IDX_NL
    coded = rng.integers(0, 2, (B, nsym * cfg.ncbps))
    pilots = gtx.data_pilots(fmt, 1, nsym)[:, 0]            # (nsym, 4)

    h_true = np.stack([_delay_channel(rng) for _ in range(B)])  # (B, 64)
    grids = np.zeros((B, 1, nsym, 64), complex)
    for b in range(B):
        syms = gtx.modulate_data_symbols(cfg, coded[b])[0]  # (nsym, nsd)
        grids[b, 0, :, didx] = (h_true[b, didx, None] * syms.T)
        grids[b, 0, :, T.PILOT_IDX] = (h_true[b, T.PILOT_IDX, None]
                                       * pilots.T)
    snr = 22.0
    sig = np.sqrt(np.mean(np.abs(h_true[:, didx]) ** 2))
    namp = sig / 10 ** (snr / 20)
    grids += (rng.normal(size=grids.shape) + 1j * rng.normal(size=grids.shape)
              ) * (namp / np.sqrt(2))
    # noisy prior: truth + LTF-estimate-level noise on the active tones
    est_namp = namp  # single-LTF estimate noise ~ per-tone noise level
    h0 = h_true + (rng.normal(size=h_true.shape)
                   + 1j * rng.normal(size=h_true.shape)) * (est_namp / np.sqrt(2))

    g = CF(grids.real.astype(np.float32), grids.imag.astype(np.float32))
    h_in = CF(h0.real.astype(np.float32)[:, None, None, :],
              h0.imag.astype(np.float32)[:, None, None, :])
    p_in = CF(h0.real.astype(np.float32)[:, None, T.PILOT_IDX],
              h0.imag.astype(np.float32)[:, None, T.PILOT_IDX])
    h2, p2 = OF.refine_chanest_data(g, h_in, p_in, cfg)
    h2c = np.asarray(h2.re)[:, 0, 0] + 1j * np.asarray(h2.im)[:, 0, 0]
    err0 = np.mean(np.abs(h0[:, didx] - h_true[:, didx]) ** 2)
    err2 = np.mean(np.abs(h2c[:, didx] - h_true[:, didx]) ** 2)
    assert np.isfinite(err2)
    # nsym extra observations + delay projection: expect >~4x error cut
    assert err2 < 0.4 * err0, (err0, err2)
    # pilot_h output must track the refined grid
    p2c = np.asarray(p2.re)[:, 0] + 1j * np.asarray(p2.im)[:, 0]
    assert np.allclose(p2c, h2c[:, T.PILOT_IDX], atol=1e-5)


def test_dd_gate_both_branches_decode():
    """Gated chain smoke: clean batch (gate off) decodes everything; heavy
    -noise batch (gate on -> dd branch executes) returns sane counts."""
    from gr_ieee80211.models import rx as RXM
    from gr_ieee80211.ops.cplx import from_host

    rng = np.random.default_rng(11)
    payload = bytes(rng.integers(0, 256, 120, dtype=np.uint8))
    mpdu = mac.qos_data_frame(payload, "02:00:00:00:00:01",
                              "02:00:00:00:00:02", "02:00:00:00:00:01", 1)
    psdu = mac.ampdu_aggregate_vht([mpdu])
    cfg = PhyConfig(Fmt.VHT, 4, 1, len(psdu), ampdu=True)
    wave = gtx.tx_waveform(cfg, psdu, group_id=0, partial_aid=0)[0]
    rms = float(np.sqrt(np.mean(np.abs(wave) ** 2)))
    n, spacing = 8, len(wave) + 400
    base = np.zeros(n * spacing + 2048, np.complex64)
    w = channel.apply_cfo(wave, 700.0).astype(np.complex64)
    for i in range(n):
        base[512 + i * spacing: 512 + i * spacing + len(wave)] = w
    for snr, min_ok in ((35.0, n), (11.0, 0)):
        stream = base + (rng.normal(size=len(base))
                         + 1j * rng.normal(size=len(base))
                         ).astype(np.complex64) * (rms / 10 ** (snr / 20)
                                                   / np.sqrt(2))
        n_ok, n_det = (int(x) for x in RXM.rx_chain_count(
            cfg, from_host(stream[None]), nrx=1, mpdu_len=len(mpdu),
            max_pkts=128))
        assert n_det >= n
        assert n_ok >= min_ok
        if snr > 30:
            assert n_ok == n
