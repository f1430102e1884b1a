"""openwifi FPGA signal generation — pktGenOwExample.py parity.

Builds the same VHT MCS0 single-MPDU A-MPDU the reference example writes
(/root/reference/tools/pktGenOwExample.py:158-181): UDP/IPv4/LLC/QoS-data
MPDU, VHT waveform, x236298 DAC scaling, 200-sample gap framing, integer
text output for the openwifi FPGA TX path.
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from gr_ieee80211.spec.params import PhyConfig, Fmt
from gr_ieee80211.gold import mac, tx, channel
from gr_ieee80211.utils.io import write_streams_ow


def main(out_prefix: str = "/tmp/sig80211GenOwVht"):
    payload = mac.llc_ip_udp(b"123456789012345678901234567890",
                             "10.10.0.6", "10.10.0.1", 39379, 8889,
                             ip_id=43778)
    mpdu = mac.data_frame(payload, "f4:69:d5:80:0f:a0",
                          "00:c0:ca:b1:5b:e1", "f4:69:d5:80:0f:a0", 2704)
    ampdu = mac.ampdu_aggregate_vht([mpdu])
    cfg = PhyConfig(Fmt.VHT, 0, 1, len(ampdu), ampdu=True)
    wave = tx.tx_waveform(cfg, ampdu, group_id=0, partial_aid=0)
    final = channel.frame_stream(wave[0], 236298.0, 0.0, num=1, gap=200)
    paths = write_streams_ow(out_prefix, final)
    for p in paths:
        print("written", p, f"({final.shape[-1]} samples)")


if __name__ == "__main__":
    main(*sys.argv[1:])
