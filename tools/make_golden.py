"""Generate hermetic golden vectors by running the reference PY-TB oracle.

Run once (requires the reference checkout):  python tools/make_golden.py
Outputs small .npz fixtures under tests/golden/ that the test suite consumes
without needing the reference tree.
"""
import sys
import os
import numpy as np

sys.path.insert(0, "/root/reference/tools")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import phy80211header as p8h  # noqa: E402
import phy80211 as p8  # noqa: E402
import mac80211  # noqa: E402

OUT = os.path.join(os.path.dirname(__file__), "..", "tests", "golden")
os.makedirs(OUT, exist_ok=True)

rng = np.random.default_rng(20260817)
phy = p8.phy80211(ifDebug=False)

entries = {}

def add(name, ss_sig, payload, fmt, mcs, nss, ampdu):
    entries[f"{name}_sig"] = np.asarray(ss_sig, dtype=np.complex64)
    entries[f"{name}_payload"] = np.frombuffer(payload, dtype=np.uint8)
    entries[f"{name}_meta"] = np.array([fmt, mcs, nss, int(ampdu)], dtype=np.int32)

names = []

# Legacy
for mcs in (0, 3, 7):
    payload = bytes(rng.integers(0, 256, 100, dtype=np.uint8))
    phy.genFromMpdu(payload, p8h.modulation(p8h.F.L, mcs, p8h.BW.BW20, 1, False))
    name = f"l_mcs{mcs}"
    add(name, phy.ssPhySig, payload, 0, mcs, 1, False)
    names.append(name)

# HT 1SS + 2SS
for mcs in (0, 5, 7, 8, 13, 15):
    nss = mcs // 8 + 1
    payload = bytes(rng.integers(0, 256, 160, dtype=np.uint8))
    phy.genFromMpdu(payload, p8h.modulation(p8h.F.HT, mcs, p8h.BW.BW20, nss, False))
    name = f"ht_mcs{mcs}"
    add(name, phy.ssPhySig, payload, 1, mcs, nss, False)
    names.append(name)

# VHT 1SS + 2SS (A-MPDU)
for nss in (1, 2):
    for mcs in (0, 4, 7, 8):
        mpdu = bytes(rng.integers(0, 256, 180, dtype=np.uint8))
        ampdu = mac80211.genAmpduVHT([mpdu])
        phy.genFromAmpdu(ampdu, p8h.modulation(p8h.F.VHT, mcs, p8h.BW.BW20, nss, False),
                         vhtPartialAid=0, vhtGroupId=0)
        name = f"vht_mcs{mcs}_{nss}ss"
        add(name, phy.ssPhySig, ampdu, 2, mcs, nss, True)
        names.append(name)

# VHT NDP
phy.genFromAmpdu(b"", p8h.modulation(p8h.F.VHT, 0, p8h.BW.BW20, 2, False),
                 vhtPartialAid=0, vhtGroupId=0)
add("vht_ndp", phy.ssPhySig, b"", 2, 0, 2, True)
names.append("vht_ndp")

# MU-MIMO with a random (well-conditioned) Q
q = np.eye(2, dtype=complex)[None].repeat(64, axis=0)
q += 0.3 * (rng.normal(size=(64, 2, 2)) + 1j * rng.normal(size=(64, 2, 2)))
amp0 = mac80211.genAmpduVHT([bytes(rng.integers(0, 256, 140, dtype=np.uint8))])
amp1 = mac80211.genAmpduVHT([bytes(rng.integers(0, 256, 90, dtype=np.uint8))])
phy.genAmpduMu(2, [q[k] for k in range(64)], 2,
               amp0, p8h.modulation(p8h.F.VHT, 3, p8h.BW.BW20, 1, False),
               amp1, p8h.modulation(p8h.F.VHT, 2, p8h.BW.BW20, 1, False))
entries["mu_sig"] = np.asarray(phy.ssPhySig, dtype=np.complex64)
entries["mu_q"] = q.astype(np.complex64)
entries["mu_payload0"] = np.frombuffer(amp0, dtype=np.uint8)
entries["mu_payload1"] = np.frombuffer(amp1, dtype=np.uint8)
entries["mu_meta"] = np.array([3, 2, 2, 3, 2], dtype=np.int32)  # mcs0=3, mcs1=2, gid=2

# MAC vectors
m = mac80211.mac80211(2, 8, 1, 0, 0, 0, "f4:69:d5:80:0f:a0", "00:c0:ca:b1:5b:e1",
                      "f4:69:d5:80:0f:a0", 2704)
udp_ins = mac80211.udp("192.168.13.1", "192.168.13.2", 52001, 52002)
ip_ins = mac80211.ipv4(0x01AB, 64, "192.168.13.1", "192.168.13.2")
llc_ins = mac80211.llc()
inner = bytes(rng.integers(0, 256, 64, dtype=np.uint8))
wire = llc_ins.genPacket(ip_ins.genPacket(udp_ins.genPacket(inner)))
mpdu = m.genPacket(wire)
entries["mac_inner"] = np.frombuffer(inner, dtype=np.uint8)
entries["mac_wire"] = np.frombuffer(wire, dtype=np.uint8)
entries["mac_mpdu"] = np.frombuffer(mpdu, dtype=np.uint8)
entries["mac_ampdu_vht1"] = np.frombuffer(mac80211.genAmpduVHT([mpdu]), dtype=np.uint8)
entries["mac_ampdu_vht2"] = np.frombuffer(mac80211.genAmpduVHT([mpdu, mpdu[:60]]), dtype=np.uint8)
entries["mac_ampdu_ht2"] = np.frombuffer(mac80211.genAmpduHT([mpdu, mpdu[:60]]), dtype=np.uint8)
entries["mac_ndpa"] = np.frombuffer(
    m.genCtrlVhtNdpAnnouncement("6e:1b:72:2a:1c:b8", "00:27:e3:9d:e8:9c", 23, [100], [0], [0]),
    dtype=np.uint8)

# pilot polarity / scramble / eof reference tables
entries["pilot_ps"] = np.array(p8h.C_PILOT_PS, dtype=np.int32)
entries["vht_eof"] = np.array(p8h.C_VHT_EOF, dtype=np.uint8)
entries["names"] = np.array(names)

np.savez_compressed(os.path.join(OUT, "golden.npz"), **entries)
print("wrote", os.path.join(OUT, "golden.npz"),
      os.path.getsize(os.path.join(OUT, "golden.npz")) / 1024, "KiB")
