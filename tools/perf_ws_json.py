"""Wireshark-JSON -> PER-vs-SNR analysis (external-capture interop harness).

Parses a Wireshark "export packet dissections as JSON" file of a monitor-mode
capture (e.g. Intel AX210) of our TX output, recovers per-packet (mcs, snr)
— the SNR rides in the payload's last two bytes, offset by 30 and split
tens/ones exactly like the reference's OTA sweep — and tallies receptions
per (snr, mcs) cell.  Behavioral parity: the counting loop of
``/root/reference/tools/performance/perf_wsJsonProc.py:18-24``; output is a
machine-readable JSON artifact + markdown table instead of a pyplot window.

Usage: python tools/perf_ws_json.py capture.json [--sent N] [--out F]
"""
from __future__ import annotations

import argparse
import json
import sys

N_SNR = 30
N_MCS = 9


def parse_ws_json(data) -> list[list[int]]:
    """[{_source: {layers: ...}}, ...] -> counts[snr][mcs].

    Packets without a radiotap VHT user block or a data payload are skipped
    (beacons, control frames, other traffic on the channel).
    """
    counts = [[0] * N_MCS for _ in range(N_SNR)]
    for each in data:
        try:
            layers = each["_source"]["layers"]
            mcs = int(layers["radiotap"]["radiotap.vht"]["radiotap.vht.user"]
                      ["radiotap.vht.mcs.0"])
            items = layers["data"]["data.data"].split(":")
            # last two payload bytes are ASCII digits of the SNR (0x30..0x39,
            # i.e. hex text "30".."39"); reading the hex text as DECIMAL and
            # subtracting 30 recovers the digit — the reference's exact trick
            # (perf_sisotx.py:131 appends str(snr).zfill(2))
            snr = (int(items[-2]) - 30) * 10 + (int(items[-1]) - 30)
        except (KeyError, ValueError, IndexError):
            continue
        if 0 <= snr < N_SNR and 0 <= mcs < N_MCS:
            counts[snr][mcs] += 1
    return counts


def per_table(counts, sent: int) -> list[list[float]]:
    """Counts -> PER per (snr, mcs) given ``sent`` packets per cell."""
    return [[1.0 - min(c, sent) / sent for c in row] for row in counts]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("json_file")
    ap.add_argument("--sent", type=int, default=100,
                    help="packets transmitted per (snr, mcs) cell")
    ap.add_argument("--out", default=None, help="write JSON artifact here")
    args = ap.parse_args(argv)

    with open(args.json_file) as f:
        data = json.load(f)
    counts = parse_ws_json(data)
    pers = per_table(counts, args.sent)

    print("| SNR dB |" + "".join(f" MCS{m} |" for m in range(N_MCS)))
    print("|---" * (N_MCS + 1) + "|")
    for snr in range(N_SNR):
        if any(counts[snr]):
            print(f"| {snr} |" + "".join(f" {p:.2f} |" for p in pers[snr]))

    if args.out:
        with open(args.out, "w") as f:
            json.dump({"sent_per_cell": args.sent, "counts": counts,
                       "per": pers}, f, indent=1)
        print(f"wrote {args.out}", file=sys.stderr)
    return counts


if __name__ == "__main__":
    main()
