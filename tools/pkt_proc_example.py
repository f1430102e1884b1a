"""Offline RX of a recorded cf32 file (pktProcExample.py equivalent).

Usage: python tools/pkt_proc_example.py file0.bin [file1.bin] [--engine]
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
from gr_ieee80211.utils.io import read_cf32


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    use_engine = "--engine" in sys.argv
    streams = np.stack([read_cf32(p) for p in args])
    if use_engine:
        from gr_ieee80211.models.rx import RxEngine
        results = RxEngine(nrx=streams.shape[0]).process(streams)
    else:
        from gr_ieee80211.gold import rx
        results = rx.receive(streams)
    n_ok = 0
    for r in results:
        if r.is_ndp:
            print(f"@{r.start}: NDP sounding, chan shape "
                  f"{None if r.ndp_chan is None else r.ndp_chan.shape}")
            continue
        status = "ok" if r.ok else "FCS FAIL"
        print(f"@{r.start}: fmt={getattr(r.fmt, 'name', r.fmt)} mcs={r.mcs} "
              f"nss={r.nss} cfo={r.cfo_hz:.0f}Hz {status} "
              f"mpdus={[len(m) for m in r.mpdus]}")
        n_ok += r.ok
    print(f"{n_ok}/{len(results)} packets decoded")


if __name__ == "__main__":
    from gr_ieee80211.utils.device import setup_compile_cache
    setup_compile_cache()
    main()
