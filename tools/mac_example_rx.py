"""MAC monitor on UDP :9527 (macExampleGrRx.py equivalent).

Prints decoded packets ([fmt, len] + payload + mcs) and type-20 NDP channel
reports published by the PHY RX reporter.
"""
import os
import socket
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from gr_ieee80211.runtime.udp_phy import parse_phy_to_mac, F_NDP_CHAN


def main():
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.bind(("127.0.0.1", 9527))
    print("listening on 127.0.0.1:9527 ...")
    n = 0
    while True:
        data, _ = sock.recvfrom(65536)
        parsed = parse_phy_to_mac(data)
        if parsed is None:
            continue
        fmt, payload, mcs = parsed
        n += 1
        if fmt == F_NDP_CHAN:
            print(f"[{n}] NDP channel report, {payload.shape} complex bins")
        else:
            print(f"[{n}] fmt={fmt} mcs={mcs} len={len(payload)} "
                  f"head={payload[:16].hex()}")


if __name__ == "__main__":
    main()
