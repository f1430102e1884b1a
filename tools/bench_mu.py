"""MU-STA and 2x2 SU-MIMO RX throughput on one GPU.

The MU/MIMO companion of bench.py: the reference measures 2x2 decode at
84-237 CPU ticks/LLR-item (Gr_WiFi_Time_Complexity_Report Table 1, SU-MIMO
section); here both paths run as ONE fused device program per batch
(models.rx.rx_chain_count{_mu}).

  python tools/bench_mu.py [B]

Each batch is timed with block_until_ready; exits 1 without a GPU.
Prints one JSON line to stdout.
"""
import json
import os
import statistics
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def build_stream(bursts, B, gap, rng, snr_db=32.0):
    one = bursts  # (nrx, n)
    nrx, n = one.shape
    spacing = n + gap
    stream = np.zeros((nrx, B * spacing + 2048), np.complex64)
    for i in range(B):
        stream[:, 1024 + i * spacing: 1024 + i * spacing + n] = one
    rms = float(np.sqrt(np.mean(np.abs(one) ** 2)))
    noise = (rng.normal(size=stream.shape) + 1j * rng.normal(size=stream.shape)
             ).astype(np.complex64) * (rms / 10 ** (snr_db / 20) / np.sqrt(2))
    return stream + noise


def main():
    from gr_ieee80211.utils import device as D
    D.setup_compile_cache()
    summary = D.require_gpu()
    from gr_ieee80211.spec.params import PhyConfig, Fmt, MuConfig
    from gr_ieee80211.gold import tx, mac, channel, sounding
    from gr_ieee80211.models import rx as RXM
    from gr_ieee80211.ops.cplx import from_host

    rng = np.random.default_rng(3)
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 2048
    out = {}

    # ---- 2x2 SU-MIMO: VHT MCS7 2SS, 500 B, 2 RX antennas ------------------
    payload = bytes(rng.integers(0, 256, 500, dtype=np.uint8))
    mpdu = mac.qos_data_frame(payload, "f4:69:d5:80:0f:a0",
                              "00:c0:ca:b1:5b:e1", "f4:69:d5:80:0f:a0", 7)
    am = mac.ampdu_aggregate_vht([mpdu])
    cfg = PhyConfig(Fmt.VHT, 7, 2, len(am), ampdu=True)
    wave = tx.tx_waveform(cfg, am, group_id=0, partial_aid=0)
    h = np.array([[1.0, 0.25 + 0.1j], [0.2 - 0.15j, 0.9]], complex)
    burst = channel.apply_cfo(
        channel.mimo_channel(wave, h), 700.0).astype(np.complex64)
    stream = build_stream(np.atleast_2d(burst), B, 240, rng)
    dev = from_host(stream)

    def su2(d):
        return RXM.rx_chain_count(cfg, d, nrx=2, mpdu_len=len(mpdu),
                                  max_pkts=B)

    n_ok, n_det = (int(x) for x in su2(dev))
    log(f"2x2 SU warmup: det {n_det}, ok {n_ok}/{B}")
    n_rep = 20
    dt = statistics.median(D.time_ms(lambda: su2(dev), n_rep)) / 1e3
    out["su_2x2_vht_mcs7_500B_pkts_per_s"] = B / dt
    out["su_2x2_ok"] = n_ok
    log(f"2x2 SU: {B/dt:,.0f} pkt/s ({dt*1e3:.1f} ms/batch)")

    # ---- MU-STA: 2-user VHT MU, user0 MCS3, ~120 B, ZF precoded -----------
    h_sta = [(rng.normal(size=(1, 2)) + 1j * rng.normal(size=(1, 2)))
             / np.sqrt(2) for _ in range(2)]
    m0 = mac.qos_data_frame(b"user zero data " * 8, "02:00:00:00:00:10",
                            "02:00:00:00:00:01", "02:00:00:00:00:10", 5)
    m1 = mac.qos_data_frame(b"USER ONE DATA " * 6, "02:00:00:00:00:11",
                            "02:00:00:00:00:01", "02:00:00:00:00:11", 6)
    a0, a1 = mac.ampdu_aggregate_vht([m0]), mac.ampdu_aggregate_vht([m1])
    mu = MuConfig((PhyConfig(Fmt.VHT, 3, 1, len(a0), ampdu=True),
                   PhyConfig(Fmt.VHT, 2, 1, len(a1), ampdu=True)), group_id=2)
    # frequency-flat per-user rows -> per-subcarrier (nsts, ntx, 56) stack
    h_rows = np.stack([np.repeat(h[0][:, None], 56, axis=1) for h in h_sta])
    q56 = sounding.zf_q(h_rows)
    muw = tx.tx_waveform_mu(mu, [a0, a1], sounding.q_to_grid(q56))
    mburst = channel.apply_cfo(
        channel.mimo_channel(muw, h_sta[0])[0], 300.0).astype(np.complex64)
    mstream = build_stream(mburst[None], B, 240, rng)
    mdev = from_host(mstream)
    u0 = mu.users[0]
    mcfg = PhyConfig(Fmt.VHT, u0.mcs, 1, u0.psdu_len, ampdu=True,
                     mu_nsym=mu.nsym)

    def mu0(d):
        return RXM.rx_chain_count_mu(mcfg, d, n_total=2, own=0, nrx=1,
                                     mpdu_len=len(m0), max_pkts=B)

    n_ok, n_det = (int(x) for x in mu0(mdev))
    log(f"MU-STA warmup: det {n_det}, ok {n_ok}/{B}")
    dt = statistics.median(D.time_ms(lambda: mu0(mdev), n_rep)) / 1e3
    out["mu_sta_vht_mcs3_pkts_per_s"] = B / dt
    out["mu_sta_ok"] = n_ok
    out["batch"] = B
    log(f"MU-STA: {B/dt:,.0f} pkt/s ({dt*1e3:.1f} ms/batch)")

    out["device"] = summary
    out["card"] = D.card_name_and_power()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
