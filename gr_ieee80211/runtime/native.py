"""ctypes bindings for the native host runtime (native/phyrt.cpp).

``libphyrt.so`` is built from the source on first use, on the machine that
runs it (:func:`build`; also ``python -m gr_ieee80211.runtime.native``).
All entry points have pure-python fallbacks so the framework works without
a toolchain.
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.normpath(
    os.path.join(os.path.dirname(__file__), "..", "..", "native"))
#: host-tuned build: the library is compiled where it runs
CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-Wall", "-std=c++17",
            "-pthread", "-shared"]


def build(native_dir: str = _NATIVE_DIR) -> str:
    """Compile ``<native_dir>/phyrt.cpp`` into ``<native_dir>/libphyrt.so``
    unless it is already up to date; returns the library's path.

    Concurrent callers (pytest-xdist workers) serialize on a file lock;
    the compiler writes a private temporary name that is renamed into
    place, so no process ever loads a half-written library."""
    src = os.path.join(native_dir, "phyrt.cpp")
    so = os.path.join(native_dir, "libphyrt.so")

    def fresh():
        return (os.path.exists(so)
                and os.path.getmtime(so) >= os.path.getmtime(src))

    if fresh():
        return so
    build_dir = os.path.join(native_dir, ".build")
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not fresh():
            tmp = os.path.join(build_dir,
                               f"libphyrt.{os.getpid()}.{id(lock)}.so")
            subprocess.run([os.environ.get("CXX", "g++"), *CXXFLAGS, "-o",
                            tmp, src], check=True, capture_output=True)
            os.replace(tmp, so)
    return so


@functools.lru_cache(maxsize=1)
def _lib():
    try:
        lib = ctypes.CDLL(build())
    except (OSError, subprocess.SubprocessError):
        return None
    lib.phyrt_crc32.restype = ctypes.c_uint32
    lib.phyrt_crc32.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.phyrt_fcs_ok.restype = ctypes.c_int
    lib.phyrt_fcs_ok.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.phyrt_fcs_ok_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p]
    lib.phyrt_deagg_vht.restype = ctypes.c_int
    lib.phyrt_deagg_vht.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int]
    lib.phyrt_stf_detect.restype = ctypes.c_int
    lib.phyrt_stf_detect.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int32]
    lib.phyrt_rb_create.restype = ctypes.c_void_p
    lib.phyrt_rb_create.argtypes = [ctypes.c_int64]
    lib.phyrt_rb_destroy.argtypes = [ctypes.c_void_p]
    lib.phyrt_rb_write.restype = ctypes.c_int64
    lib.phyrt_rb_write.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_int64]
    lib.phyrt_rb_read_block.restype = ctypes.c_int
    lib.phyrt_rb_read_block.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_int64, ctypes.c_int64]
    lib.phyrt_rb_fill.restype = ctypes.c_int64
    lib.phyrt_rb_fill.argtypes = [ctypes.c_void_p]
    lib.phyrt_rb_writable.restype = ctypes.c_int64
    lib.phyrt_rb_writable.argtypes = [ctypes.c_void_p]
    lib.phyrt_udp_ingest_start.restype = ctypes.c_void_p
    lib.phyrt_udp_ingest_start.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.phyrt_udp_ingest_port.restype = ctypes.c_int
    lib.phyrt_udp_ingest_port.argtypes = [ctypes.c_void_p]
    lib.phyrt_udp_ingest_stats.argtypes = [ctypes.c_void_p] + \
        [ctypes.POINTER(ctypes.c_int64)] * 3
    lib.phyrt_udp_ingest_stop.argtypes = [ctypes.c_void_p]
    return lib


def available() -> bool:
    return _lib() is not None


def fcs_ok(frame: bytes) -> bool:
    lib = _lib()
    if lib is None:
        from ..gold.bits import fcs_ok as py_fcs
        return py_fcs(frame)
    return bool(lib.phyrt_fcs_ok(frame, len(frame)))


def deagg_vht(psdu: bytes, max_out: int = 64) -> list[bytes]:
    """FCS-valid MPDUs from a VHT A-MPDU (native delimiter walk)."""
    lib = _lib()
    if lib is None:
        from ..gold.mac import ampdu_deaggregate
        return ampdu_deaggregate(psdu)
    offs = np.zeros(max_out, np.int32)
    lens = np.zeros(max_out, np.int32)
    n = lib.phyrt_deagg_vht(psdu, len(psdu),
                            offs.ctypes.data_as(ctypes.c_void_p),
                            lens.ctypes.data_as(ctypes.c_void_p), max_out)
    return [psdu[offs[i]: offs[i] + lens[i]] for i in range(n)]


def stf_detect(iq: np.ndarray, thresh: float = 0.3, run: int = 20,
               max_out: int = 4096, min_spacing: int = 700) -> np.ndarray:
    """Host-side plateau detector over complex64 samples."""
    lib = _lib()
    iq = np.ascontiguousarray(iq, dtype=np.complex64)
    if lib is None:
        from ..gold.rx import stf_metric, find_triggers
        m, _ = stf_metric(iq)
        return np.asarray(find_triggers(m, thresh, run), np.int32)
    out = np.zeros(max_out, np.int32)
    n = lib.phyrt_stf_detect(iq.ctypes.data_as(ctypes.c_void_p), len(iq),
                             thresh, run, out.ctypes.data_as(ctypes.c_void_p),
                             max_out, min_spacing)
    return out[:n]


class IqRing:
    """SPSC IQ ring buffer with overlap-save block reads (native)."""

    def __init__(self, capacity: int):
        lib = _lib()
        if lib is None:
            raise RuntimeError("native runtime unavailable")
        self._lib = lib
        self._h = lib.phyrt_rb_create(capacity)
        self.capacity = capacity

    def write(self, samples: np.ndarray) -> int:
        s = np.ascontiguousarray(samples, dtype=np.complex64)
        return int(self._lib.phyrt_rb_write(
            self._h, s.ctypes.data_as(ctypes.c_void_p), len(s)))

    def read_block(self, n: int, halo: int = 0) -> np.ndarray | None:
        out = np.empty(n + halo, np.complex64)
        ok = self._lib.phyrt_rb_read_block(
            self._h, out.ctypes.data_as(ctypes.c_void_p), n, halo)
        return out if ok else None

    @property
    def fill(self) -> int:
        return int(self._lib.phyrt_rb_fill(self._h))

    def close(self):
        if self._h:
            self._lib.phyrt_rb_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class UdpIngest:
    """Native UDP IQ source: a C++ thread receives interleaved-cf32
    datagrams on localhost and writes them straight into an :class:`IqRing`
    — Python is out of the per-datagram hot path (the GR udp-source /
    UHD-source equivalent)."""

    def __init__(self, ring: IqRing, port: int = 0):
        lib = _lib()
        if lib is None:
            raise RuntimeError("native runtime unavailable")
        self._lib = lib
        self._h = lib.phyrt_udp_ingest_start(ring._h, port)
        if not self._h:
            raise OSError(f"cannot bind UDP ingest port {port}")
        self.port = int(lib.phyrt_udp_ingest_port(self._h))
        self._last_stats = {"datagrams": 0, "samples": 0, "dropped": 0}

    @property
    def stats(self) -> dict:
        if not self._h:
            return dict(self._last_stats)
        d = ctypes.c_int64()
        s = ctypes.c_int64()
        x = ctypes.c_int64()
        self._lib.phyrt_udp_ingest_stats(self._h, ctypes.byref(d),
                                         ctypes.byref(s), ctypes.byref(x))
        self._last_stats = {"datagrams": d.value, "samples": s.value,
                            "dropped": x.value}
        return dict(self._last_stats)

    def stop(self):
        if self._h:
            _ = self.stats          # snapshot final counters
            self._lib.phyrt_udp_ingest_stop(self._h)
            self._h = None

    def __del__(self):
        try:
            self.stop()
        except Exception:
            pass


if __name__ == "__main__":
    print(build())
