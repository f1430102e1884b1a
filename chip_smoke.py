"""Smoke test of the RX/TX main path on one NVIDIA GPU, against the references.

  python chip_smoke.py          # phases (a)-(g) on one card
  python chip_smoke.py --four   # the four-card mesh paths only

Every phase runs in this one process (a JAX process reserves most of the
card's memory, so a second one could not start).  A phase that fails
raises, and the script exits non-zero without printing a result.

(a) device    JAX must report GPU devices; prints the card's name and
              power limit.
(b) decoder   the GPU Viterbi (ops.viterbi_gpu) against the XLA reference
              (ops.viterbi) on the card at (4096, 4420), (128, 4420),
              (512, 33000) and the windowed tier's (2048, 512) with uniform
              start metrics and an argmax traceback: decoded bits equal.
              Prints memory_analysis() of the B=4096 VHT MCS7 500 B bucket.
(c) main path RxEngine(nrx=1).process on 4096 VHT MCS7 500 B packets with
              900 Hz CFO: all 4096 MPDUs at 32 dB; FCS-ok counts at 24 and
              18 dB under default and "highest" matmul precision.
(d) 2x2       RxEngine(nrx=2) on 512 VHT MCS7 2SS packets through a fixed
              2x2 channel at 30 dB: all decode.
(e) TX        models.tx.tx_batch / tx_batch_mu against the gold waveforms.
(f) streaming a generated 200-packet capture replayed through native rings
              and RxStreamer (tools/rx_daemon.py --file): 200/200 ok.
(g) MU loop   the tools/cmu_demo.py closed loop in-process: SUCCESS.

--four runs the mesh paths of parallel.mesh on four cards at the phase (c)
stream size (dp payload decode, sp full chain, dp 2x2, dp MU-STA) and
compares each ok count with the same path on one card.

Informational lines give ms per call, timed with block_until_ready.  The
last line of standard output is one JSON object with the device as JAX
reports it.
"""
import argparse
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: (B, T, traceback from state 0): the full sweep of the bench bucket, a
#: fallback row tile, the longest trellis (MCS0 4095 B) and the windowed tier
DECODER_SHAPES = ((4096, 4420, True), (128, 4420, True), (512, 33000, True),
                  (2048, 512, False))
B_MAIN = 4096            # packets per main-path batch (the bench stream)
B_MIMO = 512
N_STREAM = 200
#: TX tolerances: |device - gold| over float32 synthesis (the CPU tests
#: hold the same bounds, tests/test_engines.py)
TX_TOL_SU = 2e-6
TX_TOL_MU = 2e-5


def log(*a):
    print(*a, flush=True)


def phase_a(min_count):
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < min_count:
        log(f"(a) FAILED: JAX reports {len(devs)} {devs[0].platform} "
            f"device(s), need {min_count} gpu")
        sys.exit(1)
    from gr_ieee80211.utils import device as D
    D.setup_compile_cache()
    log(f"(a) device {D.device_summary()}")
    log(f"(a) card {D.card_name_and_power()}")


def phase_b():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from gr_ieee80211.ops import viterbi as VX
    from gr_ieee80211.ops import viterbi_gpu as VG
    from gr_ieee80211.models import rx as RXM
    from gr_ieee80211.ops.cplx import CF
    from gr_ieee80211.utils import device as D
    from gr_ieee80211.utils import workload as W

    def ms(fn, *args):
        return statistics.median(D.time_ms(lambda: fn(*args), 3))

    for i, (B, T, from_zero) in enumerate(DECODER_SHAPES):
        llr = W.noisy_llr_pairs(B, T, 0.8, seed=i)
        pm0 = None if from_zero else jnp.zeros((B, 64), jnp.float32)
        gpu = jax.jit(lambda x, p: VG.viterbi_decode_gpu(x, from_zero, p))
        ref = jax.jit(lambda x, p: VX.viterbi_decode(x, from_zero, p))
        a, b = np.asarray(gpu(llr, pm0)), np.asarray(ref(llr, pm0))
        bad = int((a != b).any(axis=1).sum())
        log(f"(b) ({B}, {T}) start={'state0' if from_zero else 'argmax'}: "
            f"{bad} rows differ from the reference; kernel "
            f"{ms(gpu, llr, pm0):.2f} ms, XLA scan {ms(ref, llr, pm0):.2f} ms")
        assert bad == 0, (B, T, bad)
    cfg, mpdu, wave = W.vht_packet()
    n = RXM._data_start(cfg) + 80 * cfg.nsym + 16
    stream = CF(jnp.zeros((1, B_MAIN * n), jnp.float32),
                jnp.zeros((1, B_MAIN * n), jnp.float32))
    li = jnp.arange(B_MAIN, dtype=jnp.int32) * n
    cfo = jnp.zeros((B_MAIN,), jnp.float32)
    compiled = RXM._payload_core.lower(
        cfg, stream, li, cfo, nrx=1, mpdu_len=len(mpdu)).compile()
    log(f"(b) _payload_core B={B_MAIN} VHT MCS7 500 B memory_analysis: "
        f"{compiled.memory_analysis()}")


def mpdu_matches(results, mpdu):
    return sum(1 for r in results if r.ok and r.mpdus and r.mpdus[0] == mpdu)


def phase_c():
    import jax
    from gr_ieee80211.models.rx import RxEngine
    from gr_ieee80211.utils import workload as W
    cfg, mpdu, wave = W.vht_packet()
    eng = RxEngine(nrx=1)
    s32 = W.packet_train(wave, B_MAIN, 32.0, seed=32)
    t0 = time.perf_counter()
    res = eng.process(s32)
    t_first = time.perf_counter() - t0
    n = mpdu_matches(res, mpdu)
    log(f"(c) 32 dB: {n}/{B_MAIN} MPDUs equal the transmitted one "
        f"({len(res)} packets reported; first call {t_first:.1f} s "
        f"incl. compile)")
    assert n == B_MAIN and len(res) == B_MAIN, (n, len(res))
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        eng.process(s32)
        ts.append(time.perf_counter() - t0)
    log(f"(c) RxEngine.process 32 dB: {statistics.median(ts) * 1e3:.1f} ms "
        f"per {B_MAIN}-packet stream (host included)")
    for snr in (24.0, 18.0):
        s = W.packet_train(wave, B_MAIN, snr, seed=int(snr))
        n_def = mpdu_matches(eng.process(s), mpdu)
        with jax.default_matmul_precision("highest"):
            n_hi = mpdu_matches(RxEngine(nrx=1).process(s), mpdu)
        log(f"(c) {snr:.0f} dB FCS ok: {n_def}/{B_MAIN} default precision, "
            f"{n_hi}/{B_MAIN} highest")
        if snr == 18.0:
            t0 = time.perf_counter()
            eng.process(s)
            log(f"(c) RxEngine.process 18 dB: "
                f"{(time.perf_counter() - t0) * 1e3:.1f} ms per stream")
        assert n_def > 0 and n_hi > 0, (snr, n_def, n_hi)


def phase_d():
    import numpy as np
    from gr_ieee80211.models.rx import RxEngine
    from gr_ieee80211.utils import workload as W
    cfg, mpdu, wave = W.vht_packet(nss=2)
    rng = np.random.default_rng(22)
    h = np.eye(2) + 0.25 * (rng.normal(size=(2, 2))
                            + 1j * rng.normal(size=(2, 2)))
    s = W.packet_train(wave, B_MIMO, 30.0, h=h, seed=30)
    n = mpdu_matches(RxEngine(nrx=2).process(s), mpdu)
    log(f"(d) 2x2 SU-MIMO VHT MCS7 2SS at 30 dB: {n}/{B_MIMO} decoded")
    assert n == B_MIMO, n


def phase_e():
    import numpy as np
    from gr_ieee80211.gold import mac, sounding, tx as gtx
    from gr_ieee80211.models.tx import TxEngine
    from gr_ieee80211.spec.params import Fmt, MuConfig, PhyConfig
    rng = np.random.default_rng(5)
    worst = 0.0
    for fmt, mcs, nss, ln in ((Fmt.L, 0, 1, 100), (Fmt.L, 7, 1, 1500),
                              (Fmt.HT, 4, 1, 400), (Fmt.HT, 12, 2, 800),
                              (Fmt.VHT, 0, 1, 60), (Fmt.VHT, 8, 1, 900),
                              (Fmt.VHT, 7, 2, 700)):
        cfg = PhyConfig(fmt, mcs, nss, ln, ampdu=fmt == Fmt.VHT)
        pays = [bytes(rng.integers(0, 256, ln, dtype=np.uint8))
                for _ in range(4)]
        seeds = rng.integers(1, 128, 4)
        dev = TxEngine().tx(cfg, pays, seeds=seeds)
        for p, sd, d in zip(pays, seeds, dev):
            kw = dict(group_id=0, partial_aid=0) if fmt == Fmt.VHT else {}
            gold = gtx.tx_waveform(cfg, p, seed=int(sd), **kw)
            worst = max(worst, float(np.abs(d - gold).max()))
    log(f"(e) tx_batch vs gold: max abs error {worst:.3g} "
        f"(tolerance {TX_TOL_SU:g})")
    assert worst < TX_TOL_SU, worst
    h = [(rng.normal(size=(1, 2)) + 1j * rng.normal(size=(1, 2)))
         / np.sqrt(2) for _ in range(2)]
    q = sounding.q_to_grid(sounding.zf_q(
        np.repeat(np.stack(h)[:, 0][:, :, None], 56, axis=2)))
    a0 = mac.ampdu_aggregate_vht([mac.qos_data_frame(
        b"mu user0 " * 20, "02:00:00:00:00:10", "02:00:00:00:00:01",
        "02:00:00:00:00:10", 1)])
    a1 = mac.ampdu_aggregate_vht([mac.qos_data_frame(
        b"mu user1 " * 9, "02:00:00:00:00:11", "02:00:00:00:00:01",
        "02:00:00:00:00:11", 2)])
    mu = MuConfig((PhyConfig(Fmt.VHT, 5, 1, len(a0), ampdu=True),
                   PhyConfig(Fmt.VHT, 2, 1, len(a1), ampdu=True)),
                  group_id=2)
    dev = TxEngine().tx_mu(mu, [[a0] * 4, [a1] * 4], q)
    gold = gtx.tx_waveform_mu(mu, [a0, a1], q)
    err = float(np.abs(dev - gold[None]).max())
    log(f"(e) tx_batch_mu vs gold: max abs error {err:.3g} "
        f"(tolerance {TX_TOL_MU:g})")
    assert err < TX_TOL_MU, err


def phase_f():
    import numpy as np
    from gr_ieee80211.gold import channel
    from gr_ieee80211.models.rx import RxEngine
    from gr_ieee80211.runtime import native as NAT
    from gr_ieee80211.runtime.streaming import replay
    from gr_ieee80211.utils import workload as W
    assert NAT.available(), "native runtime did not build"
    cfg, mpdu, wave = W.vht_packet(payload_len=300, mcs=4, seed=3)
    rng = np.random.default_rng(6)
    s = channel.frame_stream(wave, 0.3, 500.0, num=N_STREAM, gap=1500)[0]
    s = channel.awgn(s, 0.3 * float(np.sqrt(np.mean(np.abs(wave) ** 2)))
                     / 10 ** (28 / 20), rng).astype(np.complex64)
    path = os.path.join(HERE, ".smoke", "capture.bin")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    s.tofile(path)
    try:
        st = replay([np.fromfile(path, np.complex64)], RxEngine(nrx=1),
                    block_len=1 << 18, halo=16384)
    finally:
        os.remove(path)
    log(f"(f) streaming replay: {st.n_ok}/{st.n_packets} packets ok in "
        f"{st.n_blocks} blocks")
    assert st.n_ok == st.n_packets == N_STREAM, (st.n_ok, st.n_packets)


def phase_g():
    sys.path.insert(0, os.path.join(HERE, "tools"))
    import cmu_demo
    assert cmu_demo.run(), "MU closed loop failed"
    log("(g) MU closed loop: SUCCESS")


def sharded(mesh, spec, *arrays):
    """device_put each array with ``spec`` on ``mesh``; print its shards."""
    import jax
    from jax.sharding import NamedSharding
    out = [jax.device_put(a, NamedSharding(mesh, spec)) for a in arrays]
    log(f"    input {arrays[0].shape} shards on "
        f"{[str(s.device) for s in out[0].addressable_shards]}")
    return out


def run_four():
    import numpy as np
    from jax.sharding import PartitionSpec as P
    from gr_ieee80211.gold import channel, mac, sounding, tx as gtx
    from gr_ieee80211.ops.cplx import CF
    from gr_ieee80211.parallel import mesh as M
    from gr_ieee80211.spec.params import Fmt, MuConfig, PhyConfig
    from gr_ieee80211.utils import workload as W
    m4 = M.make_mesh(4, axes=("dp",))
    m1 = M.make_mesh(1, axes=("dp",))
    s4 = M.make_mesh(4, axes=("sp",))
    s1 = M.make_mesh(1, axes=("sp",))
    cfg, mpdu, wave = W.vht_packet()
    counts = {}

    def compare(name, n4, n1, expect):
        counts[name] = (n4, n1)
        log(f"(four) {name}: 4 cards {n4}, 1 card {n1}, of {expect}")

    def windows(w, snr, h=None):
        s = W.packet_train(w, B_MAIN, snr, cfo_hz=0.0, h=h, seed=int(snr))
        spacing = np.atleast_2d(w).shape[1] + W.GAP
        starts = W.LEAD + np.arange(B_MAIN) * spacing + 188
        return s, starts

    # dp payload decode: aligned windows at the packet positions
    rng = np.random.default_rng(22)
    h2 = np.eye(2) + 0.25 * (rng.normal(size=(2, 2))
                             + 1j * rng.normal(size=(2, 2)))
    for name, w, nrx, snr, h in (
            ("dp payload decode", wave, 1, 32.0, None),
            ("dp 2x2", W.vht_packet(nss=2)[2], 2, 30.0, h2)):
        c = PhyConfig(Fmt.VHT, 7, nrx, cfg.length, ampdu=True)
        s, starts = windows(w, snr, h)
        res = {}
        for mesh, tag in ((m4, 4), (m1, 1)):
            step, n_samp = M.payload_decode_dp(c, mesh, mpdu_len=len(mpdu),
                                               nrx=nrx)
            idx = starts[:, None] + np.arange(n_samp)[None, :]
            wins = np.stack([s[r][idx] for r in range(nrx)], axis=1)
            spec = P("dp", None, None)
            re, im = sharded(mesh, spec, wins.real.astype(np.float32),
                             wins.imag.astype(np.float32))
            with mesh:
                _, _, total = step(CF(re, im))
            res[tag] = int(total)
        compare(name, res[4], res[1], B_MAIN)

    # sp full chain over the phase (c) stream (time-sharded, ppermute halos)
    s = W.packet_train(wave, B_MAIN, 32.0, seed=32)[0]
    s = np.pad(s, (0, (-len(s)) % 4))
    res = {}
    for mesh, tag, per in ((s4, 4, 2048), (s1, 1, B_MAIN)):
        chain, _ = M.rx_chain_sp(cfg, mesh, mpdu_len=len(mpdu),
                                 max_pkts_per_shard=per)
        re, im = sharded(mesh, P("sp"), s.real.astype(np.float32),
                         s.imag.astype(np.float32))
        with mesh:
            n_ok, n_det = chain(CF(re, im))
        res[tag] = int(n_ok)
    compare("sp full chain", res[4], res[1], B_MAIN)

    # dp MU-STA: four captures of B_MAIN/4 MU bursts, one per card
    rng = np.random.default_rng(9)
    h_sta = [(rng.normal(size=(1, 2)) + 1j * rng.normal(size=(1, 2)))
             / np.sqrt(2) for _ in range(2)]
    m0 = mac.qos_data_frame(b"u0" * 100, "02:00:00:00:00:10",
                            "02:00:00:00:00:01", "02:00:00:00:00:10", 1)
    a0 = mac.ampdu_aggregate_vht([m0])
    a1 = mac.ampdu_aggregate_vht([mac.qos_data_frame(
        b"u1" * 40, "02:00:00:00:00:11", "02:00:00:00:00:01",
        "02:00:00:00:00:11", 2)])
    mu = MuConfig((PhyConfig(Fmt.VHT, 4, 1, len(a0), ampdu=True),
                   PhyConfig(Fmt.VHT, 2, 1, len(a1), ampdu=True)),
                  group_id=2)
    q = sounding.q_to_grid(sounding.zf_q(
        np.repeat(np.stack(h_sta)[:, 0][:, :, None], 56, axis=2)))
    burst = channel.mimo_channel(gtx.tx_waveform_mu(mu, [a0, a1], q),
                                 h_sta[0])
    per_cap = B_MAIN // 4
    caps = np.stack([W.packet_train(burst, per_cap, 30.0, cfo_hz=300.0,
                                    seed=40 + k)[0] for k in range(4)])
    u0 = mu.users[0]
    cfg_mu = PhyConfig(Fmt.VHT, u0.mcs, 1, u0.psdu_len, ampdu=True,
                       mu_nsym=mu.nsym)
    chain4 = M.mu_chain_dp(cfg_mu, m4, n_total=2, own=0, mpdu_len=len(m0),
                           max_pkts_per_shard=per_cap)
    re, im = sharded(m4, P("dp", None), caps.real.astype(np.float32),
                     caps.imag.astype(np.float32))
    with m4:
        n4 = int(chain4(CF(re, im))[0])
    chain1 = M.mu_chain_dp(cfg_mu, m1, n_total=2, own=0, mpdu_len=len(m0),
                           max_pkts_per_shard=per_cap)
    n1 = 0
    for k in range(4):
        re, im = sharded(m1, P("dp", None), caps[k: k + 1].real.astype(
            np.float32), caps[k: k + 1].imag.astype(np.float32))
        with m1:
            n1 += int(chain1(CF(re, im))[0])
    compare("dp MU-STA", n4, n1, B_MAIN)

    for name, (n4, n1) in counts.items():
        assert n4 == n1 and n4 > 0, (name, n4, n1)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh paths")
    args = ap.parse_args()
    count = 4 if args.four else 1
    phase_a(count)
    sys.path.insert(0, HERE)
    from gr_ieee80211.utils import device as D
    summary = D.device_summary()
    card = D.card_name_and_power()
    if args.four:
        run_four()
    else:
        for phase in (phase_b, phase_c, phase_d, phase_f, phase_g, phase_e):
            t0 = time.perf_counter()
            phase()
            log(f"    {phase.__name__} done in {time.perf_counter() - t0:.1f} s")
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": summary["platform"], "kind": summary["kind"],
        "count": count if args.four else summary["count"]}}), flush=True)


if __name__ == "__main__":
    main()
