"""End-to-end streaming runtime: MAC UDP -> TX -> cf32 UDP -> native ingest
-> ring -> RxStreamer -> PHY report UDP -> MAC.  The full rx.grc/tx.grc
loopback with the reference wire protocol at both ends."""
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


def test_udp_ingest_into_ring():
    ring = NAT.IqRing(1 << 16)
    ing = NAT.UdpIngest(ring, port=0)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    data = (np.arange(1024) + 1j * np.arange(1024)).astype(np.complex64)
    tx.sendto(data.tobytes(), ("127.0.0.1", ing.port))
    deadline = time.time() + 3
    while ring.fill < 1024 and time.time() < deadline:
        time.sleep(0.01)
    assert ring.fill == 1024
    blk = ring.read_block(1000, 24)
    assert blk is not None and np.array_equal(blk, data)
    assert ing.stats["datagrams"] == 1 and ing.stats["dropped"] == 0
    ing.stop()
    ring.close()


def test_full_stream_loopback_mac_to_mac():
    # MAC listener for PHY reports
    mac_rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    mac_rx.bind(("127.0.0.1", 0))
    mac_rx.settimeout(5.0)
    report_port = mac_rx.getsockname()[1]

    ring = NAT.IqRing(1 << 21)
    ing = NAT.UdpIngest(ring, port=0)
    streamer = RxStreamer(ring, RxEngine(nrx=1), block_len=1 << 16,
                          halo=16384,
                          reporter=PhyRxReporter(port=report_port))
    streamer.start()

    tx_sink = TxStreamer(udp_addr=("127.0.0.1", ing.port), gap=1500,
                         amp=0.2)
    phy_tx = PhyTxServer(sink=tx_sink, port=0)
    phy_tx.start()

    # the reference MAC side: 5-byte header + PSDU over UDP
    payload = mac.llc_ip_udp(b"streaming loopback!", "192.168.13.1",
                             "192.168.13.2", 9000, 9001)
    mpdus = []
    mac_tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    for fmt, mcs in ((0, 3), (2, 5)):
        mpdu = mac.qos_data_frame(payload, "f4:69:d5:80:0f:a0",
                                  "00:c0:ca:b1:5b:e1",
                                  "f4:69:d5:80:0f:a0", 11 + fmt)
        psdu = mac.ampdu_aggregate_vht([mpdu]) if fmt == 2 else mpdu
        hdr = bytes([fmt, mcs, 1, len(psdu) & 0xFF, len(psdu) >> 8])
        mac_tx.sendto(hdr + psdu, ("127.0.0.1", phy_tx.port))
        mpdus.append((fmt, mcs, mpdu))

    got = {}
    try:
        # wait for both bursts to land in the ring, then pad with silence so
        # a full overlap-save block (block_len + halo) flushes through
        deadline = time.time() + 10
        while ing.stats["samples"] < 5000 and time.time() < deadline:
            time.sleep(0.02)
        ring.write(np.zeros((1 << 16) + 16384 + 64, np.complex64))
        # first block includes the engine's jit compiles (~1-3 min on CPU)
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
        ing.stop()

    assert ing.stats["dropped"] == 0
    for fmt, mcs, mpdu in mpdus:
        assert got.get((fmt, mcs)) == mpdu, (fmt, mcs, streamer.n_packets)
    ring.close()


def test_block_boundary_packet_owned_by_trigger():
    """A packet triggering just before the block edge (LTF past it) must be
    decoded exactly once — ownership follows the trigger, not the LTF."""
    from gr_ieee80211.gold import tx, channel
    from gr_ieee80211.spec.params import PhyConfig, Fmt

    rng = np.random.default_rng(3)
    mpdu = mac.qos_data_frame(b"edge case " * 6, "02:00:00:00:00:01",
                              "02:00:00:00:00:02", "02:00:00:00:00:01", 9)
    am = mac.ampdu_aggregate_vht([mpdu])
    cfg = PhyConfig(Fmt.VHT, 4, 1, len(am), ampdu=True)
    wave = tx.tx_waveform(cfg, am, group_id=0, partial_aid=0)[0]
    block = 8192
    stream = np.zeros(3 * block, np.complex64)
    # trigger fires ~40 samples before the waveform start; place the start
    # 50 samples before the boundary so trig < block <= ltf_idx
    stream[block - 50: block - 50 + len(wave)] = wave
    stream[300: 300 + len(wave)] = wave          # control packet, block 0
    rms = np.sqrt(np.mean(np.abs(wave) ** 2))
    stream = channel.awgn(stream[None], rms / 10 ** (32 / 20), rng)[0]

    ring = NAT.IqRing(1 << 16)
    got = []
    streamer = RxStreamer(ring, RxEngine(nrx=1), block_len=block, halo=4096,
                          on_result=lambda r: got.append(r))
    streamer.start()
    ring.write(stream)
    streamer.stop(drain=True, timeout=300)
    streamer.join(timeout=300)
    assert streamer.error is None, streamer.error
    ok = [r for r in got if r.ok and r.mpdus and r.mpdus[0] == mpdu]
    assert len(ok) == 2, [(r.trig, r.start, r.ok) for r in got]
    edge = [r for r in ok if r.trig > block - 200]
    assert len(edge) == 1 and edge[0].trig < block <= edge[0].start
    ring.close()


def test_tx_streamer_timed_burst_placement(tmp_path):
    """pad2 tx_time contract: timed bursts land at sample-accurate
    scheduled positions (stream position + lead) with explicit
    inter-burst silence (lib/pad2_impl.cc:154-160)."""
    from gr_ieee80211.utils.io import read_cf32
    rng = np.random.default_rng(5)
    p = str(tmp_path / "timed.bin")
    sink = TxStreamer(path=p, timed=True, lead=1200)
    w0 = (rng.normal(size=300) + 1j * rng.normal(size=300)).astype(np.complex64)
    w1 = (rng.normal(size=500) + 1j * rng.normal(size=500)).astype(np.complex64)
    sink(w0)
    sink(w1)
    sink.close()
    out = read_cf32(p)
    s0, s1 = sink.burst_starts
    assert s0 == 1200 and s1 == 1200 + 300 + 1200
    assert np.array_equal(out[s0: s0 + 300], w0)
    assert np.array_equal(out[s1: s1 + 500], w1)
    assert not out[:s0].any() and not out[s0 + 300: s1].any()
