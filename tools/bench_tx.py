"""TX throughput: batched device waveform synthesis, VHT MCS7 500 B.

The reference TX chain (pktgen -> encode -> modulation -> IFFT/CP -> pad)
runs one packet at a time through GR blocks; here a whole batch synthesizes
as one XLA program (scramble/BCC/interleave as XOR-matmuls and gathers,
QAM map, pilots, matmul IDFT, GI/preamble assembly).

  python tools/bench_tx.py [B] [--mu]

Each batch is timed with block_until_ready; exits 1 without a GPU.
Prints one JSON line (packets/s and samples/s, device) to stdout.
"""
import json
import os
import statistics
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    from gr_ieee80211.utils import device as D
    D.setup_compile_cache()
    summary = D.require_gpu()
    import jax
    import jax.numpy as jnp
    from gr_ieee80211.spec.params import PhyConfig, Fmt
    from gr_ieee80211.gold import mac
    from gr_ieee80211.models.tx import tx_batch

    args = [a for a in sys.argv[1:] if a != "--mu"]
    mu_mode = "--mu" in sys.argv[1:]
    B = int(args[0]) if args else 4096
    rng = np.random.default_rng(3)
    payload = bytes(rng.integers(0, 256, 500, dtype=np.uint8))
    mpdu = mac.qos_data_frame(payload, "f4:69:d5:80:0f:a0",
                              "00:c0:ca:b1:5b:e1", "f4:69:d5:80:0f:a0", 7)
    am = mac.ampdu_aggregate_vht([mpdu])
    seeds = jnp.asarray((np.arange(B) % 127 + 1).astype(np.int32))

    if mu_mode:
        # device-batched 2-user MU beamformed TX (tx_batch_mu)
        from gr_ieee80211.spec.params import MuConfig
        from gr_ieee80211.models.tx import tx_batch_mu
        from gr_ieee80211.ops.cplx import from_host
        mpdu1 = mac.qos_data_frame(payload[:300], "02:00:00:00:00:11",
                                   "00:c0:ca:b1:5b:e1",
                                   "02:00:00:00:00:11", 8)
        am1 = mac.ampdu_aggregate_vht([mpdu1])
        mu = MuConfig((PhyConfig(Fmt.VHT, 7, 1, len(am), ampdu=True),
                       PhyConfig(Fmt.VHT, 7, 1, len(am1), ampdu=True)),
                      group_id=2)
        q = from_host((rng.normal(size=(64, 2, 2))
                       + 1j * rng.normal(size=(64, 2, 2))) / np.sqrt(2))
        pays = (jnp.asarray(np.tile(np.frombuffer(am, np.uint8), (B, 1))),
                jnp.asarray(np.tile(np.frombuffer(am1, np.uint8), (B, 1))))
        f = jax.jit(lambda p, s: jnp.sum(
            tx_batch_mu(mu, p, s, q).re[..., :1]))
        one = tx_batch_mu(mu, (pays[0][:1], pays[1][:1]), seeds[:1], q)
        n_samp = one.re.shape[-1]
        metric = "tx_mu_2user_ppdus_per_s_vht_mcs7"
        call = lambda: f(pays, seeds)
    else:
        cfg = PhyConfig(Fmt.VHT, 7, 1, len(am), ampdu=True)
        arr = jnp.asarray(np.tile(np.frombuffer(am, np.uint8), (B, 1)))
        f = jax.jit(lambda a, s: jnp.sum(
            tx_batch(cfg, a, s, 0, 0).re[..., :1]))
        one = tx_batch(cfg, arr[:1], seeds[:1], 0, 0)
        n_samp = one.re.shape[-1]
        metric = "tx_synthesis_packets_per_s_vht_mcs7_500B"
        call = lambda: f(arr, seeds)

    ts = D.time_ms(call, 30)
    dt = statistics.median(ts) / 1e3
    print(f"{dt*1e3:.3f} ms/batch of {B} (median of {len(ts)}, "
          f"min {min(ts):.3f}, max {max(ts):.3f}); wave {n_samp} "
          f"samples/pkt", file=sys.stderr)
    print(json.dumps({"metric": metric, "value": B / dt,
                      "unit": "packets/s",
                      "samples_per_s": B * n_samp / dt,
                      "device": summary, "card": D.card_name_and_power()}))


if __name__ == "__main__":
    main()
