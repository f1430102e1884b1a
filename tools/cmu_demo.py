"""MU-MIMO closed loop over the UDP wire protocol (cmu_v3 equivalent).

Runs the AP control loop of tools/cmu_v3/cmu_ap.py against in-process PHY
servers and a simulated air channel:

  AP: NDP request -> PHY TX -> air -> STA RX -> type-20 chan reports ->
  AP: ZF Q -> BFQ datagram -> MU data datagram -> PHY TX applies Q ->
  air -> each STA decodes its own stream -> reports on :9527 format.

Everything crosses real UDP sockets in the reference wire format.
The PHY server synthesizes on the accelerator (device_tx=True: the
batched models.tx engines incl. the MU tx_batch_mu Q-einsum path) and
the STAs receive with the batched device engine (models.rx.RxEngine,
NDP channel export + demod(mupos) MU role); pass --gold-tx / --gold-rx
for the numpy gold models instead.
"""
import os
import socket
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
from gr_ieee80211.gold import mac, rx as grx, channel, sounding
from gr_ieee80211.runtime import udp_phy as U


def _pop_wave(srv, timeout=180.0):
    # the TX server synthesizes on its own thread; with device_tx the first
    # request also pays a jit compile, so wait rather than racing .pop()
    t0 = time.time()
    while not srv.waves and time.time() - t0 < timeout:
        time.sleep(0.02)
    return srv.waves.pop()


def run(gold_tx: bool = False, gold_rx: bool = False) -> bool:
    """One NDP -> feedback -> ZF Q -> MU burst cycle; True when both STAs
    decode their own MPDU."""
    rng = np.random.default_rng(7)
    h_sta = [(rng.normal(size=(1, 2)) + 1j * rng.normal(size=(1, 2))) / np.sqrt(2)
             for _ in range(2)]
    srv = U.PhyTxServer(port=0, device_tx=not gold_tx)
    srv.start()
    ap = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    phy_addr = ("127.0.0.1", srv.port)

    # 1) sound: NDP
    ap.sendto(b"\x02\x00\x02\x00\x00", phy_addr)
    t0 = time.time()
    while not srv.waves and time.time() - t0 < 5:
        time.sleep(0.02)
    ndp = _pop_wave(srv)

    # 2) each STA receives the NDP and reports its channel row (type 20)
    fb_rows = []
    for u in range(2):
        stream = channel.awgn(channel.frame_stream(
            channel.mimo_channel(ndp, h_sta[u]), 1.0, 150.0 + 80 * u, gap=1200),
            0.0008, rng)
        if gold_rx:
            pkt = grx.receive(stream)[0]
        else:
            from gr_ieee80211.models.rx import RxEngine
            pkt = [r for r in RxEngine(nrx=1).process(stream) if r.is_ndp][0]
        assert pkt.is_ndp
        blob = U.pack_chan_report(np.asarray(pkt.ndp_chan)[0])
        _, chan, _ = U.parse_phy_to_mac(blob)          # over-the-wire roundtrip
        fb = sounding.feedback_from_ndp(chan[None])     # (1, 2, 56)
        fb_rows.append(fb[0])
        print(f"STA{u}: NDP sounded, |h| mean {np.abs(fb[0]).mean():.3f}")

    # 3) AP computes ZF Q, pushes BFQ over the wire
    q56 = sounding.zf_q(np.stack(fb_rows))
    bfq = sounding.q_to_grid(q56)
    buf = np.empty((64, 2, 2, 2), np.float32)
    buf[..., 0], buf[..., 1] = bfq.real, bfq.imag
    ap.sendto(bytes([U.F_BFQ]) + buf.tobytes(), phy_addr)
    time.sleep(0.2)

    # 4) MU data downlink
    m0 = mac.qos_data_frame(b"MU user0 payload " * 6, "02:00:00:00:00:10",
                            "02:00:00:00:00:01", "02:00:00:00:00:10", 5)
    m1 = mac.qos_data_frame(b"MU user1 payload " * 4, "02:00:00:00:00:11",
                            "02:00:00:00:00:01", "02:00:00:00:00:11", 6)
    a0, a1 = mac.ampdu_aggregate_vht([m0]), mac.ampdu_aggregate_vht([m1])
    hdr = bytes([U.F_MU, 3, 1, len(a0) & 0xFF, len(a0) >> 8,
                 2, 1, len(a1) & 0xFF, len(a1) >> 8, 2])
    ap.sendto(hdr + a0 + a1, phy_addr)
    t0 = time.time()
    while not srv.waves and time.time() - t0 < 5:
        time.sleep(0.02)
    mu_wave = _pop_wave(srv)

    # 5) each STA decodes only its own stream
    ok = True
    for u, m in ((0, m0), (1, m1)):
        stream = channel.awgn(channel.frame_stream(
            channel.mimo_channel(mu_wave, h_sta[u]), 1.0, 120.0, gap=1200),
            0.0008, rng)
        if gold_rx:
            pkt = grx.receive(stream, mu_pos=u)[0]
        else:
            from gr_ieee80211.models.rx import RxEngine
            pkt = RxEngine(nrx=1, mu_pos=u).process(stream)[0]
        match = bool(pkt.ok and pkt.mpdus and pkt.mpdus[0] == m)
        ok &= match
        print(f"STA{u}: mu decode ok={pkt.ok} payload match={match}")
    srv.stop()
    print("closed loop:", "SUCCESS" if ok else "FAILED")
    return ok


if __name__ == "__main__":
    from gr_ieee80211.utils.device import setup_compile_cache
    setup_compile_cache()
    sys.exit(0 if run("--gold-tx" in sys.argv, "--gold-rx" in sys.argv)
             else 1)
