"""Generate golden multi-format signal files (pktGenExample.py equivalent).

Writes GR-compatible interleaved-cf32 files: 8 L + 8 HT + 9 VHT SISO packets
in one 1x1 stream file, and 8 HT + 9 VHT 2SS packets in a 2x2 pair, matching
the reference's tmp/sig80211GenMultipleSiso naming.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
from gr_ieee80211.spec.params import PhyConfig, Fmt
from gr_ieee80211.gold import tx, mac, channel
from gr_ieee80211.utils.io import write_streams


def main(outdir="tmp"):
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(0)
    payload = mac.llc_ip_udp(b"123456789012345678901234567890",
                             "192.168.13.1", "192.168.13.2", 52001, 52002)
    mpdu = mac.qos_data_frame(payload, "f4:69:d5:80:0f:a0",
                              "00:c0:ca:b1:5b:e1", "f4:69:d5:80:0f:a0", 100)
    ampdu = mac.ampdu_aggregate_vht([mpdu])

    siso = []
    for mcs in range(8):
        siso.append(channel.frame_stream(
            tx.tx_waveform(PhyConfig(Fmt.L, mcs, 1, len(mpdu)), mpdu),
            0.26, gap=5000))
    for mcs in range(8):
        siso.append(channel.frame_stream(
            tx.tx_waveform(PhyConfig(Fmt.HT, mcs, 1, len(mpdu)), mpdu),
            0.26, gap=5000))
    for mcs in range(9):
        siso.append(channel.frame_stream(
            tx.tx_waveform(PhyConfig(Fmt.VHT, mcs, 1, len(ampdu), ampdu=True),
                           ampdu, group_id=0, partial_aid=0),
            0.26, gap=5000))
    sig = np.concatenate(siso, axis=-1)
    print("siso:", write_streams(os.path.join(outdir, "sig80211GenMultipleSiso"), sig))

    mimo = []
    for mcs in range(8, 16):
        mimo.append(channel.frame_stream(
            tx.tx_waveform(PhyConfig(Fmt.HT, mcs, 2, len(mpdu)), mpdu),
            0.26, gap=5000))
    for mcs in range(9):
        mimo.append(channel.frame_stream(
            tx.tx_waveform(PhyConfig(Fmt.VHT, mcs, 2, len(ampdu), ampdu=True),
                           ampdu, group_id=0, partial_aid=0),
            0.26, gap=5000))
    sig2 = np.concatenate(mimo, axis=-1)
    print("mimo:", write_streams(os.path.join(outdir, "sig80211GenMultipleMimo"), sig2))


if __name__ == "__main__":
    main(*sys.argv[1:])
