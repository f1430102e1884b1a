"""Wireshark-JSON PER parser on a synthetic monitor-mode capture export."""
import json
import sys

sys.path.insert(0, "tools")

from perf_ws_json import parse_ws_json, per_table


def _pkt(mcs: int, snr: int, extra=None):
    """One Wireshark JSON dissection entry: VHT radiotap + data payload whose
    last two bytes are the ASCII digits of the SNR (perf_sisotx.py:131)."""
    tens, ones = divmod(snr, 10)
    payload = ["41", "42", "43", f"{0x30 + tens:02x}", f"{0x30 + ones:02x}"]
    layers = {
        "radiotap": {"radiotap.vht": {"radiotap.vht.user": {
            "radiotap.vht.mcs.0": str(mcs)}}},
        "data": {"data.data": ":".join(payload)},
    }
    if extra:
        layers.update(extra)
    return {"_source": {"layers": layers}}


def test_parse_counts_and_per():
    data = ([_pkt(7, 23)] * 99 + [_pkt(7, 5)] * 40 + [_pkt(0, 23)] * 100
            + [{"_source": {"layers": {"wlan": {}}}}]       # beacon: skipped
            + [_pkt(3, 12)])
    counts = parse_ws_json(data)
    assert counts[23][7] == 99
    assert counts[5][7] == 40
    assert counts[23][0] == 100
    assert counts[12][3] == 1
    assert sum(map(sum, counts)) == 240

    per = per_table(counts, sent=100)
    assert abs(per[23][7] - 0.01) < 1e-9
    assert abs(per[5][7] - 0.60) < 1e-9
    assert per[23][0] == 0.0
    assert per[0][0] == 1.0


def test_parser_roundtrips_through_json(tmp_path):
    data = [_pkt(2, 17)] * 5
    p = tmp_path / "cap.json"
    p.write_text(json.dumps(data))
    with open(p) as f:
        counts = parse_ws_json(json.load(f))
    assert counts[17][2] == 5
