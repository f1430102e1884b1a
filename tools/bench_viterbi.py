"""GPU Viterbi kernels against the XLA scan, on the card.

  python tools/bench_viterbi.py                        # all sections
  python tools/bench_viterbi.py --sections decoder segmented

Sections (all in one process on one card, times with block_until_ready,
median of --reps after a warm-up call):

1. decoder: ops.viterbi_gpu.viterbi_decode_gpu vs ops.viterbi.viterbi_decode
   at (4096, 4420), (128, 4420), (512, 33000) from state 0 and the windowed
   tier's (2048, 512) from uniform metrics with an argmax start — decoded
   bits compared bit for bit, both times printed;
2. segmented: monolithic vs segmented GPU decode at fallback-tile shapes
   (the data behind ops.viterbi_gpu.segmented_pays);
3. engine: RxEngine.process on the 4096-packet VHT MCS7 500 B stream at
   32 and 18 dB with each decoder, FCS-ok counts under default and
   "highest" matmul precision at 24 and 18 dB.

Prints the whole record as one JSON line at the end.
"""
import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


#: (B, T, traceback from state 0) per decoder comparison
DECODER_SHAPES = ((4096, 4420, True), (128, 4420, True), (512, 33000, True),
                  (2048, 512, False))
SEG_SHAPES = ((128, 1040), (128, 2288), (128, 4420), (512, 4420),
              (1024, 4420), (2048, 4420), (4096, 4420), (4096, 1040),
              (128, 33000), (256, 33000), (512, 33000))
SECTIONS = ("decoder", "segmented", "engine", "precision")
ENGINE_B = 4096


def timed(fn, *args, reps=5):
    from gr_ieee80211.utils.device import time_ms
    return statistics.median(time_ms(lambda: fn(*args), reps))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sections", nargs="+", choices=SECTIONS,
                    default=SECTIONS)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    from gr_ieee80211.utils import device as D
    D.setup_compile_cache()
    summary = D.require_gpu()
    card = D.card_name_and_power()
    print(f"card: {card}", flush=True)
    import jax
    import jax.numpy as jnp
    import numpy as np
    from gr_ieee80211.ops import viterbi as VX
    from gr_ieee80211.ops import viterbi_gpu as VG
    from gr_ieee80211.utils import workload as W
    rec = {"device": summary, "card": card}
    decoder = VG.decoder

    # 1. decoder
    rows = []
    for B, T, from_zero in (DECODER_SHAPES if "decoder" in args.sections
                            else ()):
        llr = W.noisy_llr_pairs(B, T, 0.8)
        pm0 = None if from_zero else jnp.zeros((B, 64), jnp.float32)
        gpu = jax.jit(lambda x, p: VG.viterbi_decode_gpu(x, from_zero, p))
        xla = jax.jit(lambda x, p: VX.viterbi_decode(x, from_zero, p))
        a = np.asarray(gpu(llr, pm0))
        b = np.asarray(xla(llr, pm0))
        r = {"B": B, "T": T, "from_zero": from_zero,
             "bit_mismatch": int((a != b).sum()),
             "rows_mismatch": int((a != b).any(axis=1).sum()),
             "kernel_ms": timed(gpu, llr, pm0, reps=args.reps),
             "xla_ms": timed(xla, llr, pm0, reps=args.reps)}
        print("decoder", r, flush=True)
        rows.append(r)
    rec["decoder"] = rows

    # 2. segmented vs monolithic (GPU decoder)
    segs = []
    for B, T in (SEG_SHAPES if "segmented" in args.sections else ()):
        llr = W.noisy_llr_pairs(B, T, 0.6)
        mono = jax.jit(lambda x: VG.viterbi_decode(x))
        seg = jax.jit(lambda x: VG.viterbi_decode(x, segmented=True))
        same = bool((np.asarray(mono(llr)) == np.asarray(seg(llr))).all())
        r = {"B": B, "T": T, "mono_ms": timed(mono, llr, reps=args.reps),
             "seg_ms": timed(seg, llr, reps=args.reps), "identical": same}
        print("segmented", r, flush=True)
        segs.append(r)
    rec["segmented"] = segs

    # 3. engine
    if not {"engine", "precision"} & set(args.sections):
        return dump(rec)
    from gr_ieee80211.models.rx import RxEngine
    cfg, mpdu, wave = W.vht_packet()
    B = ENGINE_B
    streams = {snr: W.packet_train(wave, B, snr, seed=snr)
               for snr in (32, 24, 18)}

    def ok_count(stream):
        res = RxEngine(nrx=1).process(stream)
        return sum(1 for r in res if r.ok and r.mpdus and r.mpdus[0] == mpdu)

    eng = {}
    for name, dec in ((("kernel", VG.viterbi_decode_gpu),
                       ("xla", VX.viterbi_decode))
                      if "engine" in args.sections else ()):
        VG.decoder = (lambda d: lambda platform=None: d)(dec)
        jax.clear_caches()
        for snr in (32, 18):
            n_ok = ok_count(streams[snr])
            ts = []
            for _ in range(args.reps):
                t0 = time.perf_counter()
                ok_count(streams[snr])
                ts.append(time.perf_counter() - t0)
            eng[f"{name}_{snr}dB"] = {"ok": n_ok,
                                      "ms": statistics.median(ts) * 1e3}
            print("engine", name, snr, eng[f"{name}_{snr}dB"], flush=True)
    rec["engine"] = eng
    VG.decoder = decoder
    jax.clear_caches()
    prec = {}
    for snr in ((24, 18) if "precision" in args.sections else ()):
        prec[f"{snr}dB_default"] = ok_count(streams[snr])
        with jax.default_matmul_precision("highest"):
            prec[f"{snr}dB_highest"] = ok_count(streams[snr])
        print("precision", snr, prec, flush=True)
    rec["precision"] = prec
    dump(rec)


def dump(rec):
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
