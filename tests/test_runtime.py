"""UDP MAC<->PHY runtime: wire protocol parity and loopback."""
import socket
import time
import numpy as np

from gr_ieee80211.spec.params import Fmt
from gr_ieee80211.gold import mac, rx as grx, channel, sounding
from gr_ieee80211.runtime import udp_phy as U


def _send(port, data):
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.sendto(data, ("127.0.0.1", port))
    s.close()


def _wait(cond, timeout=5.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if cond():
            return True
        time.sleep(0.02)
    return False


def test_udp_tx_data_and_rx_report_loopback():
    srv = U.PhyTxServer(port=0)  # ephemeral port
    srv.start()
    try:
        mpdu = mac.qos_data_frame(b"runtime loopback " * 6, "f4:69:d5:80:0f:a0",
                                  "00:c0:ca:b1:5b:e1", "f4:69:d5:80:0f:a0", 3)
        am = mac.ampdu_aggregate_vht([mpdu])
        # 5-byte header datagram, exactly the reference's genPktGrData format
        hdr = bytes([2, 4, 1, len(am) & 0xFF, len(am) >> 8])
        _send(srv.port, hdr + am)
        assert _wait(lambda: len(srv.waves) == 1)
        wave = srv.waves[0]
        # decode the synthesized waveform and report to a MAC listener
        stream = channel.frame_stream(wave, 1.0, 200.0, gap=1200)
        pkts = grx.receive(stream)
        assert pkts and pkts[0].ok and pkts[0].mpdus[0] == mpdu

        lsock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        lsock.bind(("127.0.0.1", 0))
        lsock.settimeout(5.0)
        rep = U.PhyRxReporter(port=lsock.getsockname()[1])
        rep.report(pkts[0])
        data, _ = lsock.recvfrom(65536)
        fmt, payload, mcs = U.parse_phy_to_mac(data)
        assert fmt == 2 and payload == mpdu and mcs == 4
        lsock.close()
    finally:
        srv.stop()
        srv.join(timeout=3)


def test_udp_ndp_and_bfq_and_mu():
    srv = U.PhyTxServer(port=0)
    srv.start()
    try:
        # NDP request (reference genPktGrNdp bytes)
        _send(srv.port, b"\x02\x00\x02\x00\x00")
        assert _wait(lambda: len(srv.waves) == 1)
        assert srv.waves[0].shape[0] == 2  # 2 streams

        # BFQ update then MU data
        rng = np.random.default_rng(0)
        q = np.tile(np.eye(2, dtype=np.complex64), (64, 1, 1))
        buf = np.empty((64, 2, 2, 2), np.float32)
        buf[..., 0], buf[..., 1] = q.real, q.imag
        _send(srv.port, bytes([10]) + buf.tobytes())
        m0 = mac.qos_data_frame(b"mu user zero " * 4, "02:00:00:00:00:10",
                                "02:00:00:00:00:01", "02:00:00:00:00:10", 5)
        m1 = mac.qos_data_frame(b"mu user one " * 3, "02:00:00:00:00:11",
                                "02:00:00:00:00:01", "02:00:00:00:00:11", 6)
        a0, a1 = mac.ampdu_aggregate_vht([m0]), mac.ampdu_aggregate_vht([m1])
        hdr = bytes([3, 2, 1, len(a0) & 0xFF, len(a0) >> 8,
                     1, 1, len(a1) & 0xFF, len(a1) >> 8, 2])
        _send(srv.port, hdr + a0 + a1)
        assert _wait(lambda: len(srv.waves) == 2)
        wave = srv.waves[1]
        assert wave.shape[0] == 2
        # identity Q + identity channel: each user decodes its own stream
        for u, m in ((0, m0), (1, m1)):
            stream = channel.frame_stream(wave[u: u + 1], 1.0, 100.0, gap=1200)
            pkts = grx.receive(stream, mu_pos=u)
            assert pkts and pkts[0].ok and pkts[0].mpdus[0] == m
    finally:
        srv.stop()
        srv.join(timeout=3)


def test_udp_server_device_tx_matches_gold():
    """device_tx=True synthesizes the same waveforms over the wire protocol
    (SU data + BFQ'd MU) as the gold server, to float32 tolerance."""
    gold_srv = U.PhyTxServer(port=0)
    dev_srv = U.PhyTxServer(port=0, device_tx=True)
    gold_srv.start(), dev_srv.start()
    try:
        rng = np.random.default_rng(7)
        q = (rng.normal(size=(64, 2, 2)) + 1j * rng.normal(size=(64, 2, 2))
             ).astype(np.complex64) / np.sqrt(2)
        buf = np.empty((64, 2, 2, 2), np.float32)
        buf[..., 0], buf[..., 1] = q.real, q.imag
        m0 = mac.qos_data_frame(b"dev tx user0 " * 4, "02:00:00:00:00:10",
                                "02:00:00:00:00:01", "02:00:00:00:00:10", 5)
        m1 = mac.qos_data_frame(b"dev tx user1 " * 3, "02:00:00:00:00:11",
                                "02:00:00:00:00:01", "02:00:00:00:00:11", 6)
        a0, a1 = mac.ampdu_aggregate_vht([m0]), mac.ampdu_aggregate_vht([m1])
        mu_hdr = bytes([3, 2, 1, len(a0) & 0xFF, len(a0) >> 8,
                        1, 1, len(a1) & 0xFF, len(a1) >> 8, 2])
        su_hdr = bytes([2, 4, 1, len(a0) & 0xFF, len(a0) >> 8])
        for srv in (gold_srv, dev_srv):
            _send(srv.port, bytes([10]) + buf.tobytes())
            _send(srv.port, su_hdr + a0)
            _send(srv.port, mu_hdr + a0 + a1)
        assert _wait(lambda: len(gold_srv.waves) == 2
                     and len(dev_srv.waves) == 2, timeout=60)
        for g, d in zip(gold_srv.waves, dev_srv.waves):
            assert np.abs(np.atleast_2d(g) - np.atleast_2d(d)).max() < 2e-5
    finally:
        gold_srv.stop(), dev_srv.stop()
        gold_srv.join(timeout=3), dev_srv.join(timeout=3)


def test_chan_report_roundtrip():
    rng = np.random.default_rng(1)
    chan = (rng.normal(size=(2, 64)) + 1j * rng.normal(size=(2, 64))).astype(np.complex64)
    blob = U.pack_chan_report(chan)
    assert len(blob) == 1027
    fmt, parsed, _ = U.parse_phy_to_mac(blob)
    assert fmt == 20
    assert np.allclose(parsed, chan)
