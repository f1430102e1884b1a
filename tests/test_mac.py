"""MAC layer parity with reference mac80211 golden vectors."""
import numpy as np

from gr_ieee80211.gold import mac as M
from gr_ieee80211.gold.bits import fcs_ok


def test_qos_data_frame(golden):
    wire = golden["mac_wire"].tobytes()
    ref = golden["mac_mpdu"].tobytes()
    mine = M.qos_data_frame(wire, "f4:69:d5:80:0f:a0", "00:c0:ca:b1:5b:e1",
                            "f4:69:d5:80:0f:a0", 2704)
    assert mine == ref
    assert fcs_ok(mine)


def test_llc_ip_udp(golden):
    inner = golden["mac_inner"].tobytes()
    ref = golden["mac_wire"].tobytes()
    mine = M.llc_ip_udp(inner, "192.168.13.1", "192.168.13.2", 52001, 52002,
                        ip_id=0x01AB, ttl=64)
    assert mine == ref


def test_ampdu_vht_single(golden):
    mpdu = golden["mac_mpdu"].tobytes()
    ref = golden["mac_ampdu_vht1"].tobytes()
    assert M.ampdu_aggregate_vht([mpdu]) == ref
    out = M.ampdu_deaggregate(ref)
    assert out == [mpdu]


def test_ampdu_vht_two(golden):
    mpdu = golden["mac_mpdu"].tobytes()
    ref = golden["mac_ampdu_vht2"].tobytes()
    assert M.ampdu_aggregate_vht([mpdu, mpdu[:60]]) == ref
    out = M.ampdu_deaggregate(ref)
    # second sub-mpdu is a truncated frame: FCS fails, only first survives
    assert out == [mpdu]


def test_ampdu_ht_two(golden):
    mpdu = golden["mac_mpdu"].tobytes()
    ref = golden["mac_ampdu_ht2"].tobytes()
    assert M.ampdu_aggregate_ht([mpdu, mpdu[:60]]) == ref


def test_ndp_announcement(golden):
    ref = golden["mac_ndpa"].tobytes()
    mine = M.ndp_announcement("6e:1b:72:2a:1c:b8", "00:27:e3:9d:e8:9c", 23, [100], [0])
    assert mine == ref


def test_deaggregate_with_eof_padding():
    from gr_ieee80211.spec import tables as T
    mpdu = M.qos_data_frame(b"payload-bytes" * 5, "02:00:00:00:00:01",
                            "02:00:00:00:00:02", "02:00:00:00:00:01", 7)
    psdu = M.ampdu_aggregate_vht([mpdu])
    psdu += T.bits_to_bytes(T.VHT_EOF_BITS) * 3  # PHY EOF pad subframes
    assert M.ampdu_deaggregate(psdu) == [mpdu]


def test_parse_frame_roundtrips():
    from gr_ieee80211.gold import mac
    payload = b"parser test payload"
    q = mac.qos_data_frame(payload, "f4:69:d5:80:0f:a0", "00:c0:ca:b1:5b:e1",
                           "f4:69:d5:80:0f:a0", 42)
    f = mac.parse_frame(q)
    assert f.ok and f.ftype == 2 and f.subtype == 8 and f.seq == 42
    assert f.addr1 == "f4:69:d5:80:0f:a0" and f.addr2 == "00:c0:ca:b1:5b:e1"
    assert f.body == payload and f.qos == 0
    assert "QoS Data" in mac.describe_frame(q) and "ok" in mac.describe_frame(q)

    d = mac.data_frame(payload, "f4:69:d5:80:0f:a0", "00:c0:ca:b1:5b:e1",
                       "f4:69:d5:80:0f:a0", 7)
    f = mac.parse_frame(d)
    assert f.ok and f.subtype == 0 and f.qos is None and f.body == payload

    ndp = mac.ndp_announcement("02:00:00:00:00:01", "02:00:00:00:00:02",
                               5, [1, 2], [0, 0])
    f = mac.parse_frame(ndp)
    assert f.ok and f.ftype == 1 and f.subtype == 5
    assert "NDP Announcement" in mac.describe_frame(ndp)

    bad = q[:-1] + bytes([q[-1] ^ 1])
    assert not mac.parse_frame(bad).ok


def test_vht_bf_mgmt_frame_roundtrip():
    """Full compressed-BF action frame: V56 -> body -> frame -> parse -> V56
    (mac80211header genMgmtActVhtCompressBf/mgmtVhtActCompressBfParser)."""
    import numpy as np
    from gr_ieee80211.gold import mac, sounding
    rng = np.random.default_rng(9)
    v56 = np.empty((56, 2, 2), complex)
    for k in range(56):
        a = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
        u, _, _ = np.linalg.svd(a)
        v56[k] = u
    for group, codebook in ((1, 0), (2, 1), (4, 0)):
        body = sounding.mgmt_vht_bf_body(v56, [20.0, 17.5], group=group,
                                         codebook=codebook, token=11)
        frame = mac.action_no_ack("02:00:00:00:00:01", "02:00:00:00:00:02",
                                  "02:00:00:00:00:01", 3, 21, body)
        f = mac.parse_frame(frame)
        assert f.ok and f.subtype == 14 and f.body[0] == 21
        r = sounding.parse_mgmt_vht_bf(f.body[1:])
        assert (r["nc"], r["nr"], r["group"], r["codebook"], r["token"]) == \
            (2, 2, group, codebook, 11)
        assert abs(r["snr_db"][0] - 20.0) < 0.25
        # fed tones recover V up to the per-column phase convention
        for t in sounding.BFFB_SCIDX_20[group][:8]:
            k = sounding._TONE_POS[t]
            dt = np.exp(1j * np.angle(v56[k][1, :]))
            v_ref = v56[k] * np.conj(dt)[None, :]
            assert np.abs(r["v56"][k] - v_ref).max() < (0.05 if codebook else 0.1)


def test_beacon_capture_tx_rx_and_element_parse():
    """The reference's captured beacon (examples/beacon) transmits at
    L MCS0, decodes, and its elements parse (SSID, rates, DS param)."""
    import numpy as np
    from gr_ieee80211.gold import mac, tx, channel
    from gr_ieee80211.spec.params import PhyConfig, Fmt
    from gr_ieee80211.models.rx import RxEngine
    blob = bytes.fromhex(
        "80000000ffffffffffff244bfe6125ac244bfe6125acc0293e00f6ed6a0100006400"
        "1111000e636c6f75645f61633836755f354701088c129824b048606c050402030000"
        "074255532024011e28011e2c011e30011e34011e38011e3c011e40011e64011e6801"
        "1e6c011e70011e74011e84011e88011e8c011e95011e99011e9d011ea1011ea5011e"
        "2001002302110030140100000fac040100000fac040100000fac020c000b0500000c"
        "000042020000460530000000002d1aef0117ffffffff0000000000000000000000000"
        "00000000000003d16640500000000000000000000000000000000000000007f08040"
        "0080000000040bf0cb269830faaff0000aaff0000c005016a000000c30402020202d"
        "d31f832e4010101020100031444867f67c0f5fefe59231d42f65a24b75aed3b88070"
        "45aed3b881204a8ac0000130101150100dd0500904c0417dd090010180200009c000"
        "0dd180050f2020101840003a4000027a4000042435e0062322f00d13fd44d")
    f = mac.parse_frame(blob)
    assert f.ok and f.ftype == 0 and f.subtype == 8        # beacon, FCS ok
    els = dict((name, data) for _, name, data in
               mac.parse_mgmt_elements(f.body))
    assert els["SSID"] == "cloud_ac86u_5G"
    assert "Supported Rates" in els and "VHT Capabilities" in els
    # through the PHY at legacy MCS0 (the reference txBeaconBin.grc config)
    cfg = PhyConfig(Fmt.L, 0, 1, len(blob))
    wave = tx.tx_waveform(cfg, blob)[0]
    rng = np.random.default_rng(71)
    rms = np.sqrt(np.mean(np.abs(wave) ** 2))
    stream = channel.awgn(channel.frame_stream(wave, 1.0, 300.0, gap=1200),
                          rms / 10 ** (25 / 20), rng)
    res = [r for r in RxEngine(nrx=1).process(stream) if r.ok]
    assert len(res) == 1 and res[0].mpdus[0] == blob
    assert mac.parse_frame(res[0].mpdus[0]).subtype == 8
