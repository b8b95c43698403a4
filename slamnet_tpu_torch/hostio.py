"""The host's IO runtime: ctypes bindings over ``native/slamnet_host.cpp``.

Port of ``slamnet_tpu/hostio/__init__.py`` (the host side of the pipeline:
ingest -> de-skew/pack -> device, the role BaseSLAM/ParallelWorker.cs and
SignalConcurrentQueue.cs play in the reference):

* ``ScanQueue``: a bounded blocking ring buffer of fixed-size scan slots;
* ``SlogWriter`` / ``SlogReader``: the binary scan log (.slog, CRC32-checked
  records);
* ``pack_polar_deskew``: polar rays of S segments -> one de-skewed cloud
  (the ``core.scan.segments_to_cloud`` contract, CoreSLAMProcessor.cs:187-207);
* ``read_carmen_native``: the C++ CARMEN parser, bit-identical to
  ``io.datasets.read_carmen`` (its plain twin) on FLASER logs.

``library()`` compiles the C++ source with ``g++`` (the flags of
``native/Makefile``, ``-march=native`` included) into
``build/slamnet_tpu_torch/host/<hash of source, flags and host CPU>/
libslamnet_host.so`` at the repository root at first use, and loads it; it
never writes into ``native/``.  Without a compiler, or when the build
fails, it raises RuntimeError: nothing here falls back to numpy.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .io.datasets import SICK_MAX_RANGE, LidarLog, flaser_angles

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "native" / "slamnet_host.cpp"
BUILD_ROOT = ROOT / "build" / "slamnet_tpu_torch" / "host"
LIB_NAME = "libslamnet_host.so"
# native/Makefile's CXXFLAGS and link line, plus <string>: the source uses
# std::string without including it, which a newer libstdc++'s headers no
# longer bring in through <vector> and <mutex> (g++ then stops with
# "incomplete type std::string")
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared",
             "-include", "string")
LIBS = ("-lpthread",)


def _cpu_fingerprint() -> bytes:
    """The host CPU's model and feature flags: ``-march=native`` builds for
    this CPU, so a build from another machine is not reused."""
    try:
        with open("/proc/cpuinfo") as f:
            return "".join(sorted({ln for ln in f if ln.startswith(
                ("model name", "flags", "Features"))})).encode()
    except OSError:
        return platform.processor().encode()


def build() -> Path:
    """Compile the host library unless this exact build exists; returns its
    path."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("slamnet_tpu_torch.hostio needs g++ (or $CXX) to "
                           f"build {SOURCE}")
    h = hashlib.sha256(" ".join((cxx, *CXX_FLAGS, *LIBS)).encode())
    h.update(SOURCE.read_bytes())
    h.update(_cpu_fingerprint())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        tmp.replace(lib)    # atomic: a concurrent loader never sees half a file
    finally:
        tmp.unlink(missing_ok=True)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded host library (built once per process) with its
    signatures declared."""
    lib = ctypes.CDLL(str(build()))
    vp, c_i64, c_u32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32
    sigs = {
        "sq_create": (vp, [ctypes.c_size_t, ctypes.c_size_t]),
        "sq_destroy": (None, [vp]),
        "sq_close": (None, [vp]),
        "sq_push": (ctypes.c_int, [vp, ctypes.c_char_p, c_i64]),
        "sq_pop": (ctypes.c_int, [vp, ctypes.c_char_p, c_i64]),
        "sq_size": (ctypes.c_size_t, [vp]),
        "sq_dropped": (ctypes.c_uint64, [vp]),
        "slog_open_write": (vp, [ctypes.c_char_p, c_u32]),
        "slog_append": (ctypes.c_int, [vp, ctypes.c_uint64, vp, vp, vp]),
        "slog_close_write": (None, [vp]),
        "slog_open_read": (vp, [ctypes.c_char_p, ctypes.POINTER(c_u32)]),
        "slog_read": (ctypes.c_int, [vp, ctypes.POINTER(ctypes.c_uint64), vp,
                                     vp, vp]),
        "slog_close_read": (None, [vp]),
        "pack_polar_deskew": (None, [vp] * 4 + [ctypes.c_int, ctypes.c_int,
                                                vp, vp]),
        "slam_crc32": (c_u32, [ctypes.c_char_p, ctypes.c_size_t]),
        "carmen_scan_count": (c_i64, [
            ctypes.c_char_p, ctypes.POINTER(c_i64),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
            c_i64]),
        "carmen_read": (c_i64, [ctypes.c_char_p, c_i64, c_i64, vp, vp, vp,
                                vp]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


class ScanQueue:
    """Bounded blocking ring buffer of fixed-size scan slots."""

    def __init__(self, capacity: int, slot_bytes: int):
        self._lib = library()
        self._slot = slot_bytes
        self._q = self._lib.sq_create(capacity, slot_bytes)

    def push(self, data: bytes, timeout_ms: int = -1) -> int:
        """1 pushed, 0 timed out, -1 closed (native/slamnet_host.cpp)."""
        if len(data) != self._slot:
            raise ValueError(f"slot is {self._slot} bytes, got {len(data)}")
        return self._lib.sq_push(self._q, data, timeout_ms)

    def pop(self, timeout_ms: int = -1) -> Optional[bytes]:
        buf = ctypes.create_string_buffer(self._slot)
        r = self._lib.sq_pop(self._q, buf, timeout_ms)
        return buf.raw if r == 1 else None

    def __len__(self) -> int:
        return self._lib.sq_size(self._q)

    @property
    def dropped(self) -> int:
        return self._lib.sq_dropped(self._q)

    def close(self) -> None:
        self._lib.sq_close(self._q)

    def __del__(self):
        if getattr(self, "_q", None):
            self._lib.sq_destroy(self._q)
            self._q = None


class SlogWriter:
    """Binary scan-log writer (.slog, CRC32-checked records)."""

    def __init__(self, path: str, num_beams: int):
        self._lib = library()
        self.num_beams = num_beams
        self._w = self._lib.slog_open_write(path.encode(), num_beams)
        if not self._w:
            raise IOError(f"cannot open {path}")

    def append(self, ts_ns: int, odom, radii, valid) -> None:
        odom = np.ascontiguousarray(odom, np.float32)
        radii = np.ascontiguousarray(radii, np.float32)
        bits = np.packbits(np.asarray(valid, bool), bitorder="little")
        if self._lib.slog_append(self._w, ts_ns, odom.ctypes.data,
                                 radii.ctypes.data, bits.ctypes.data) != 0:
            raise IOError("slog append failed")

    def close(self) -> None:
        if self._w:
            self._lib.slog_close_write(self._w)
            self._w = None


class SlogReader:
    """Binary scan-log reader; iterates (ts_ns, odom[3], radii[N], valid[N])."""

    def __init__(self, path: str):
        self._lib = library()
        nb = ctypes.c_uint32()
        self._r = self._lib.slog_open_read(path.encode(), ctypes.byref(nb))
        if not self._r:
            raise IOError(f"cannot open {path}")
        self.num_beams = nb.value

    def __iter__(self):
        return self

    def __next__(self):
        ts = ctypes.c_uint64()
        odom = np.empty(3, np.float32)
        radii = np.empty(self.num_beams, np.float32)
        bits = np.empty((self.num_beams + 7) // 8, np.uint8)
        r = self._lib.slog_read(self._r, ctypes.byref(ts), odom.ctypes.data,
                                radii.ctypes.data, bits.ctypes.data)
        if r == 0:
            raise StopIteration
        if r == -1:
            raise IOError("corrupt slog record (CRC mismatch)")
        valid = np.unpackbits(bits, bitorder="little")[: self.num_beams] \
            .astype(bool)
        return ts.value, odom, radii, valid

    def close(self) -> None:
        if self._r:
            self._lib.slog_close_read(self._r)
            self._r = None


def pack_polar_deskew(angles, radii, valid, seg_poses
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """De-skew pack: [S, N] polar rays -> ([S*N, 2] points, [S*N] valid),
    each segment moved by its pose relative to the last segment's."""
    lib = library()
    angles = np.ascontiguousarray(angles, np.float32)
    radii = np.ascontiguousarray(radii, np.float32)
    seg_poses = np.ascontiguousarray(seg_poses, np.float32)
    s, n = angles.shape
    vu8 = np.ascontiguousarray(np.asarray(valid, bool), np.uint8)
    out_p = np.empty((s * n, 2), np.float32)
    out_v = np.empty(s * n, np.uint8)
    lib.pack_polar_deskew(angles.ctypes.data, radii.ctypes.data,
                          vu8.ctypes.data, seg_poses.ctypes.data, s, n,
                          out_p.ctypes.data, out_v.ctypes.data)
    return out_p, out_v.astype(bool)


def read_carmen_native(path: str,
                       max_scans: int | None = None) -> LidarLog | None:
    """The C++ twin of ``io.datasets.read_carmen`` for FLASER logs: the same
    LidarLog bit for bit, ``# TRUTH`` lines and the PARAM max range
    included.  Returns None when the log has no FLASER line (a ROBOTLASER1
    log is the Python reader's); raises ValueError on a malformed or
    mixed-beam log, as the twin does."""
    lib = library()
    beams = ctypes.c_int64(0)
    maxr = ctypes.c_double(0.0)
    has_truth = ctypes.c_int32(0)
    cap = -1 if max_scans is None else int(max_scans)
    t = lib.carmen_scan_count(path.encode(), ctypes.byref(beams),
                              ctypes.byref(maxr), ctypes.byref(has_truth),
                              cap)
    if t == 0:
        return None
    if t < 0:
        raise ValueError(f"carmen_scan_count({path}) failed: {t}")
    n = int(beams.value)
    ranges = np.empty((t, n), np.float32)
    odom = np.empty((t, 3), np.float32)
    truth = np.zeros((t, 3), np.float32)
    stamps = np.empty(t, np.float64)
    got = lib.carmen_read(path.encode(), t, n,
                          ranges.ctypes.data_as(ctypes.c_void_p),
                          odom.ctypes.data_as(ctypes.c_void_p),
                          truth.ctypes.data_as(ctypes.c_void_p),
                          stamps.ctypes.data_as(ctypes.c_void_p))
    if got != t:
        raise ValueError(f"carmen_read({path}) failed: {got} != {t}")
    max_range = float(maxr.value) if maxr.value > 0 else SICK_MAX_RANGE
    return LidarLog(ranges=ranges,
                    valid=(ranges > 0.0) & (ranges < 0.99 * max_range),
                    odometry=odom, angles=flaser_angles(n),
                    max_range=max_range, timestamps=stamps,
                    truth=truth if has_truth.value else None)
