"""MU-MIMO closed loop: NDP sounding -> feedback -> ZF Q -> per-user decode.

Replicates the reference cmu_v3 control loop (tools/cmu_v3/cmu_ap.py) offline.
"""
import numpy as np

from gr_ieee80211.spec.params import PhyConfig, Fmt, MuConfig
from gr_ieee80211.gold import tx, rx, mac, channel, sounding


def test_mu_closed_loop():
    rng = np.random.default_rng(42)
    h_sta = [(rng.normal(size=(1, 2)) + 1j * rng.normal(size=(1, 2))) / np.sqrt(2)
             for _ in range(2)]

    # 1) AP sounds with an NDP; each STA estimates and feeds back its row
    ndp = tx.tx_waveform(PhyConfig(Fmt.VHT, 0, 2, 0, ampdu=True), b"",
                         group_id=0, partial_aid=0)
    fb = []
    for u in range(2):
        stream = channel.frame_stream(channel.mimo_channel(ndp, h_sta[u]),
                                      1.0, 200.0 + 100 * u, gap=1200)
        stream = channel.awgn(stream, 0.015 / 10 ** (35 / 20), rng)
        p = rx.receive(stream)[0]
        assert p.is_ndp
        fb.append(sounding.feedback_from_ndp(p.ndp_chan)[0])

    # 2) AP computes per-subcarrier ZF Q
    q56 = sounding.zf_q(np.stack(fb))
    bfq = sounding.q_to_grid(q56)

    # 3) MU downlink data; 4) each STA decodes only its own stream
    mpdu0 = mac.qos_data_frame(b"user zero data " * 8, "02:00:00:00:00:10",
                               "02:00:00:00:00:01", "02:00:00:00:00:10", 5)
    mpdu1 = mac.qos_data_frame(b"USER ONE DATA " * 6, "02:00:00:00:00:11",
                               "02:00:00:00:00:01", "02:00:00:00:00:11", 6)
    a0 = mac.ampdu_aggregate_vht([mpdu0])
    a1 = mac.ampdu_aggregate_vht([mpdu1])
    mu = MuConfig((PhyConfig(Fmt.VHT, 3, 1, len(a0), ampdu=True),
                   PhyConfig(Fmt.VHT, 2, 1, len(a1), ampdu=True)), group_id=2)
    wave = tx.tx_waveform_mu(mu, [a0, a1], bfq)
    for u, mpdu in enumerate([mpdu0, mpdu1]):
        stream = channel.frame_stream(channel.mimo_channel(wave, h_sta[u]),
                                      1.0, 150.0, gap=1200)
        stream = channel.awgn(stream, 0.012 / 10 ** (30 / 20), rng)
        p = rx.receive(stream, mu_pos=u)[0]
        assert p.ok and p.mu
        assert p.mpdus[0] == mpdu


def test_givens_compress_roundtrip():
    rng = np.random.default_rng(3)
    for (m, n) in ((2, 1), (2, 2), (3, 2), (4, 2)):
        a = rng.normal(size=(m, n)) + 1j * rng.normal(size=(m, n))
        u, _, _ = np.linalg.svd(a, full_matrices=False)
        v = u[:, :n]
        vals, types = sounding.givens_compress(v, codebook=1)
        assert types == sounding.angle_order(m, n)
        vt = sounding.givens_decompress(vals, types, m, n, codebook=1)
        # recovered V~ equals V up to per-column phase (the D~ convention)
        dt = np.exp(1j * np.angle(v[m - 1, :]))
        v_ref = v * np.conj(dt)[None, :]
        assert np.abs(vt - v_ref).max() < 0.05, (m, n)


def test_bf_report_pack_roundtrip():
    rng = np.random.default_rng(4)
    a = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
    u, _, _ = np.linalg.svd(a)
    vals, types = sounding.givens_compress(u, codebook=0)
    blob = sounding.pack_bf_report(vals, types, codebook=0)
    back = sounding.unpack_bf_report(blob, sounding.angle_order(2, 2), codebook=0)
    assert back == vals


def test_zf_q_separates_users():
    rng = np.random.default_rng(5)
    h = (rng.normal(size=(2, 2, 56)) + 1j * rng.normal(size=(2, 2, 56)))
    q = sounding.zf_q(h)
    # H(k) Q(k) must be diagonal for every subcarrier
    hq = np.einsum("utk,ktj->kuj", h, q)
    off = np.abs(hq[:, 0, 1]) + np.abs(hq[:, 1, 0])
    on = np.abs(hq[:, 0, 0]) + np.abs(hq[:, 1, 1])
    assert off.max() < 1e-9 * max(1.0, on.max())
    # normalization: ||Q||_F = sqrt(nSTS)
    assert np.allclose(np.linalg.norm(q, axis=(1, 2)), np.sqrt(2))


def test_mu_engine_batched_rx():
    """The batched device engine decodes MU downlink per STA position
    (demod(mupos,mugid) parity, lib/demod_impl.cc:28-40,344-505)."""
    from gr_ieee80211.models.rx import RxEngine
    rng = np.random.default_rng(77)
    h_sta = [(rng.normal(size=(1, 2)) + 1j * rng.normal(size=(1, 2))) / np.sqrt(2)
             for _ in range(2)]
    ndp = tx.tx_waveform(PhyConfig(Fmt.VHT, 0, 2, 0, ampdu=True), b"",
                         group_id=0, partial_aid=0)
    fb = []
    for u in range(2):
        stream = channel.frame_stream(channel.mimo_channel(ndp, h_sta[u]),
                                      1.0, 150.0, gap=1200)
        stream = channel.awgn(stream, 0.015 / 10 ** (35 / 20), rng)
        p = rx.receive(stream)[0]
        fb.append(sounding.feedback_from_ndp(p.ndp_chan)[0])
    bfq = sounding.q_to_grid(sounding.zf_q(np.stack(fb)))
    mpdu0 = mac.qos_data_frame(b"engine user zero " * 7, "02:00:00:00:00:10",
                               "02:00:00:00:00:01", "02:00:00:00:00:10", 5)
    mpdu1 = mac.qos_data_frame(b"ENGINE USER ONE " * 5, "02:00:00:00:00:11",
                               "02:00:00:00:00:01", "02:00:00:00:00:11", 6)
    a0 = mac.ampdu_aggregate_vht([mpdu0])
    a1 = mac.ampdu_aggregate_vht([mpdu1])
    mu = MuConfig((PhyConfig(Fmt.VHT, 3, 1, len(a0), ampdu=True),
                   PhyConfig(Fmt.VHT, 2, 1, len(a1), ampdu=True)), group_id=2)
    wave = tx.tx_waveform_mu(mu, [a0, a1], bfq)
    for u, mpdu in enumerate([mpdu0, mpdu1]):
        stream = channel.frame_stream(channel.mimo_channel(wave, h_sta[u]),
                                      1.0, 150.0, num=3, gap=1200)
        stream = channel.awgn(stream, 0.012 / 10 ** (30 / 20), rng)
        eng = RxEngine(nrx=1, mu_pos=u, mu_gid=2)
        res = [r for r in eng.process(stream) if r.ok]
        assert len(res) == 3
        assert all(r.mpdus[0] == mpdu for r in res)
        # wrong group id -> packets ignored
        eng_other = RxEngine(nrx=1, mu_pos=u, mu_gid=5)
        assert not [r for r in eng_other.process(stream) if r.ok]


def test_mu_closed_loop_compressed_feedback():
    """Standard-compliant closed loop: STAs feed back Givens-COMPRESSED V
    inside VHT action-no-ack frames (not raw H rows); the AP parses the
    mgmt body, reconstructs V~, computes ZF Q from the V rows and sends MU
    data.  Matches tools/phy80211.py:1193-1326 + mac80211header.py:568-730.
    Gate: user separation within ~1 dB of the raw-H loop at the 30 dB
    operating point, and both users decode end-to-end."""
    rng = np.random.default_rng(46)
    h_sta = [(rng.normal(size=(1, 2)) + 1j * rng.normal(size=(1, 2)))
             / np.sqrt(2) for _ in range(2)]

    ndp = tx.tx_waveform(PhyConfig(Fmt.VHT, 0, 2, 0, ampdu=True), b"",
                         group_id=0, partial_aid=0)
    frames, fb_raw = [], []
    for u in range(2):
        stream = channel.frame_stream(channel.mimo_channel(ndp, h_sta[u]),
                                      1.0, 200.0 + 100 * u, gap=1200)
        stream = channel.awgn(stream, 0.015 / 10 ** (35 / 20), rng)
        p = rx.receive(stream)[0]
        assert p.is_ndp
        row = sounding.feedback_from_ndp(p.ndp_chan)[0]    # (2, 56)
        fb_raw.append(row)
        # STA: V = right-singular vector of its 1x2 row, per tone
        v56 = (row.conj() / np.linalg.norm(row, axis=0, keepdims=True)
               ).T[:, :, None]                              # (56, 2, 1)
        body = sounding.mgmt_vht_bf_body(v56, [p.snr_db], group=1,
                                         codebook=1, token=u + 1)
        frames.append(mac.action_no_ack("02:00:00:00:00:01",
                                        f"02:00:00:00:00:1{u}",
                                        "02:00:00:00:00:01", 10 + u,
                                        21, body))   # category 21 = VHT

    # AP side: parse the action frames, recover V~, ZF on the V rows
    v_rows = []
    for u, fr in enumerate(frames):
        info = mac.parse_frame(fr)
        assert "beamforming" in mac.describe_frame(fr)
        rep = sounding.parse_mgmt_vht_bf(fr[24:-4][1:])  # strip hdr+FCS+cat
        assert rep["nc"] == 1 and rep["nr"] == 2 and rep["token"] == u + 1
        v_rows.append(rep["v56"][:, :, 0].conj().T)        # (2, 56) eff row
    q_c = sounding.zf_q(np.stack(v_rows))
    q_r = sounding.zf_q(np.stack(fb_raw))

    # separation: post-ZF signal-to-leakage+noise per user at 30 dB, the
    # compressed loop must sit within 1 dB of the raw-H loop
    h_true = np.stack(fb_raw)                              # (2, 2, 56)
    snr_lin = 10 ** (30 / 10)
    for q, out in ((q_c, []), (q_r, [])):
        hq = np.einsum("utk,ktj->kuj", h_true, q)
        for u in range(2):
            sig = np.mean(np.abs(hq[:, u, u]) ** 2)
            leak = np.mean(np.abs(hq[:, u, 1 - u]) ** 2)
            out.append(10 * np.log10(sig / (leak + sig / snr_lin)))
        if q is q_c:
            sinr_c = out
        else:
            sinr_r = out
    for u in range(2):
        assert sinr_r[u] - sinr_c[u] < 1.0, (sinr_c, sinr_r)

    # full end-to-end decode through the compressed-feedback Q
    bfq = sounding.q_to_grid(q_c)
    mpdu0 = mac.qos_data_frame(b"compressed fb u0 " * 7, "02:00:00:00:00:10",
                               "02:00:00:00:00:01", "02:00:00:00:00:10", 7)
    mpdu1 = mac.qos_data_frame(b"compressed fb u1 " * 5, "02:00:00:00:00:11",
                               "02:00:00:00:00:01", "02:00:00:00:00:11", 8)
    a0 = mac.ampdu_aggregate_vht([mpdu0])
    a1 = mac.ampdu_aggregate_vht([mpdu1])
    mu = MuConfig((PhyConfig(Fmt.VHT, 3, 1, len(a0), ampdu=True),
                   PhyConfig(Fmt.VHT, 2, 1, len(a1), ampdu=True)), group_id=2)
    wave = tx.tx_waveform_mu(mu, [a0, a1], bfq)
    for u, mpdu in enumerate([mpdu0, mpdu1]):
        stream = channel.frame_stream(channel.mimo_channel(wave, h_sta[u]),
                                      1.0, 150.0, gap=1200)
        stream = channel.awgn(stream, 0.012 / 10 ** (30 / 20), rng)
        p = rx.receive(stream, mu_pos=u)[0]
        assert p.ok and p.mu and p.mpdus[0] == mpdu


def test_cmu_offline_tool_loop(tmp_path):
    """cmu_v4 offline-analysis parity (tools/cmu_offline.py): saved
    LTF captures -> compressed feedback wire round trip -> ZF Q -> MU
    waveform, and each STA decodes its own stream from the artifact
    (reference: tools/cmu_v4/cmu_ap_offline.py)."""
    import subprocess, sys as _sys, os as _os
    import numpy as np
    from gr_ieee80211.utils.io import read_cf32
    from gr_ieee80211.gold import channel, mac
    from gr_ieee80211.models.rx import RxEngine
    c0, c1 = str(tmp_path / "c0.bin"), str(tmp_path / "c1.bin")
    out = str(tmp_path / "mu")
    env = dict(_os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([_sys.executable, "tools/cmu_offline.py",
                        "--demo", "--chan0", c0, "--chan1", c1,
                        "--out", out, "--mcs", "2"],
                       capture_output=True, text=True, env=env,
                       cwd=_os.path.dirname(_os.path.dirname(__file__)))
    assert r.returncode == 0, r.stderr[-2000:]
    wave = np.stack([read_cf32(f"{out}_2x2_{i}.bin") for i in range(2)])
    # reproduce the demo channels (same seed path as the tool)
    rng = np.random.default_rng(7)
    h_sta = [(rng.normal(size=(1, 2)) + 1j * rng.normal(size=(1, 2)))
             / np.sqrt(2) for _ in range(2)]
    texts = [b"1234567 packet for station 000",
             b"7654321 packet for station 111"]
    for u in range(2):
        stream = channel.awgn(channel.frame_stream(
            channel.mimo_channel(wave, h_sta[u]), 1.0, 300.0, gap=1200),
            0.0008, np.random.default_rng(u))
        pkts = [p for p in RxEngine(nrx=1, mu_pos=u).process(stream)
                if p.ok and p.mpdus]
        assert pkts, f"STA{u} decoded nothing"
        assert texts[u] in pkts[0].mpdus[0]
