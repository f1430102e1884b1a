"""Daemon-level 2-antenna streaming: MAC UDP -> PhyTxServer -> TxStreamer
framing BOTH antenna streams -> 2x cf32 UDP -> 2x native ingest rings ->
RxStreamer(nrx=2) -> PHY report UDP.  The tx2.grc/rx2.grc loopback
(reference lib/pad2_impl.cc:154-201, examples/rx2.grc)."""
import socket
import time

import numpy as np
import pytest

from gr_ieee80211.runtime import native as NAT
from gr_ieee80211.runtime.udp_phy import (
    PhyTxServer, PhyRxReporter, parse_phy_to_mac)
from gr_ieee80211.runtime.streaming import RxStreamer, TxStreamer
from gr_ieee80211.models.rx import RxEngine
from gr_ieee80211.gold import mac


pytestmark = pytest.mark.skipif(not NAT.available(),
                                reason="native runtime unavailable")


def test_full_2x2_stream_loopback_mac_to_mac():
    mac_rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    mac_rx.bind(("127.0.0.1", 0))
    mac_rx.settimeout(5.0)
    report_port = mac_rx.getsockname()[1]

    rings = [NAT.IqRing(1 << 21), NAT.IqRing(1 << 21)]
    ings = [NAT.UdpIngest(r, port=0) for r in rings]
    streamer = RxStreamer(rings, RxEngine(nrx=2), block_len=1 << 16,
                          halo=16384,
                          reporter=PhyRxReporter(port=report_port))
    streamer.start()

    tx_sink = TxStreamer(udp_addr=[("127.0.0.1", i.port) for i in ings],
                         gap=1500, amp=0.2)
    phy_tx = PhyTxServer(sink=tx_sink, port=0)
    phy_tx.start()

    payload = mac.llc_ip_udp(b"two antennas!", "192.168.13.1",
                             "192.168.13.2", 9000, 9001)
    mac_tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sent = []
    # one 2SS VHT burst (both antennas carry data) and one 1SS VHT burst
    # (antenna 1 must be zero-filled, pad2-style, keeping streams aligned)
    for mcs, nss, seq in ((4, 2, 11), (5, 1, 12)):
        mpdu = mac.qos_data_frame(payload, "f4:69:d5:80:0f:a0",
                                  "00:c0:ca:b1:5b:e1",
                                  "f4:69:d5:80:0f:a0", seq)
        psdu = mac.ampdu_aggregate_vht([mpdu])
        hdr = bytes([2, mcs, nss, len(psdu) & 0xFF, len(psdu) >> 8])
        mac_tx.sendto(hdr + psdu, ("127.0.0.1", phy_tx.port))
        sent.append((2, mcs, mpdu))

    got = {}
    try:
        deadline = time.time() + 10
        while (min(i.stats["samples"] for i in ings) < 5000
               and time.time() < deadline):
            time.sleep(0.02)
        # both antennas saw the same number of samples (zero-fill parity)
        s0, s1 = (i.stats["samples"] for i in ings)
        assert s0 == s1, (s0, s1)
        for r in rings:
            r.write(np.zeros((1 << 16) + 16384 + 64, np.complex64))
        deadline = time.time() + 300
        while len(got) < 2 and time.time() < deadline:
            assert streamer.error is None, streamer.error
            try:
                data, _ = mac_rx.recvfrom(65536)
            except socket.timeout:
                continue
            fmt, pl, mcs = parse_phy_to_mac(data)
            got[(fmt, mcs)] = pl
    finally:
        phy_tx.stop()
        streamer.stop()
        for i in ings:
            i.stop()

    assert all(i.stats["dropped"] == 0 for i in ings)
    for fmt, mcs, mpdu in sent:
        assert got.get((fmt, mcs)) == mpdu, (fmt, mcs, streamer.n_packets,
                                             streamer.counters)
    for r in rings:
        r.close()
