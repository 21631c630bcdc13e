"""ctypes loader for the native host runtime (native/smarcnav_native.cc).

Builds the shared library on first use (g++ -O3, cached next to the
source), exposes:

* ``jv_assign`` / ``jv_assign_batch`` — exact Jonker-Volgenant assignment,
  the production host path for SLAM data association (the role of the
  reference's vendored C++ Munkres solver). Identical algorithm to the
  in-JAX device solver, so host and device paths agree.
* ``latest_index`` / ``bin_events`` — timeline binning of recorded sensor
  logs (the only O(events) python loop in mission preprocessing).

Falls back cleanly (``available() == False``) if no compiler is present.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import subprocess
import tempfile
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_HERE, "native", "smarcnav_native.cc")
_LIB = os.path.join(_HERE, "native", "libsmarcnav.so")
_STAMP = _LIB + ".srchash"  # sha256 of the source the cached lib was built from
_LOCK = _LIB + ".lock"

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _src_hash() -> str:
    with open(_SRC, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@contextlib.contextmanager
def _build_lock():
    """Exclusive lock around build + load: several processes (test workers)
    may reach ``_load`` at once, and only one may write the library. A
    checkout where no lock file can be created proceeds unlocked."""
    try:
        fd = os.open(_LOCK, os.O_CREAT | os.O_RDWR, 0o644)
    except OSError:
        yield
        return
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        os.close(fd)  # closing releases the flock


def _replace_atomically(path: str, write) -> None:
    """Write via ``write(tmp_path)`` to a temporary file in the target's
    directory, then ``os.replace`` it over ``path``: a reader sees the old
    file or the whole new one, never a partial write."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                               prefix=os.path.basename(path) + ".")
    os.close(fd)
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _build(src_hash: str) -> bool:
    def compile_to(tmp):
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
                       check=True, capture_output=True)

    def write_stamp(tmp):
        with open(tmp, "w") as f:
            f.write(src_hash)

    try:
        _replace_atomically(_LIB, compile_to)
        _replace_atomically(_STAMP, write_stamp)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError, OSError):
        return False


def _cached_lib_current(src_hash: str) -> bool:
    """A cached .so is only trusted if its recorded source hash matches the
    committed source — never on mtime (a checkout gives every file the same
    mtime, which would load an unverifiable stale/foreign binary)."""
    try:
        with open(_STAMP) as f:
            return f.read().strip() == src_hash
    except OSError:
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    src_hash = _src_hash()
    with _build_lock():
        if not os.path.exists(_LIB) or not _cached_lib_current(src_hash):
            if not _build(src_hash):
                return None
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError:
            return None
    c_dp = ctypes.POINTER(ctypes.c_double)
    c_ip = ctypes.POINTER(ctypes.c_int)
    c_lp = ctypes.POINTER(ctypes.c_int64)
    c_up = ctypes.POINTER(ctypes.c_uint8)
    lib.jv_assign.argtypes = [c_dp, ctypes.c_int, ctypes.c_int, c_ip]
    lib.jv_assign.restype = ctypes.c_int
    lib.jv_assign_batch.argtypes = [c_dp, ctypes.c_int, ctypes.c_int, ctypes.c_int, c_ip]
    lib.jv_assign_batch.restype = ctypes.c_int
    lib.latest_index.argtypes = [c_dp, ctypes.c_int64, c_dp, ctypes.c_int64, c_lp]
    lib.latest_index.restype = None
    lib.bin_events.argtypes = [
        c_dp, c_dp, c_lp, ctypes.c_int64, ctypes.c_int,
        c_dp, ctypes.c_int64, ctypes.c_int, c_dp, c_up,
    ]
    lib.bin_events.restype = ctypes.c_int64
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def jv_assign(cost: np.ndarray) -> np.ndarray:
    """(R, C) float cost -> (C,) int32 col_to_row (exact minimum)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable (no g++?)")
    cost = np.ascontiguousarray(cost, np.float64)
    R, C = cost.shape
    out = np.empty(C, np.int32)
    rc = lib.jv_assign(_ptr(cost, ctypes.c_double), R, C, _ptr(out, ctypes.c_int))
    if rc != 0:
        raise ValueError(f"jv_assign failed rc={rc} (C<=R required)")
    return out


def jv_assign_batch(costs: np.ndarray) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable (no g++?)")
    costs = np.ascontiguousarray(costs, np.float64)
    B, R, C = costs.shape
    out = np.empty((B, C), np.int32)
    rc = lib.jv_assign_batch(_ptr(costs, ctypes.c_double), B, R, C,
                             _ptr(out, ctypes.c_int))
    if rc != 0:
        raise ValueError(f"jv_assign_batch failed rc={rc}")
    return out


def latest_index(stamps: np.ndarray, ticks: np.ndarray) -> np.ndarray:
    lib = _load()
    if lib is None:
        return np.searchsorted(stamps, ticks, side="right") - 1
    stamps = np.ascontiguousarray(stamps, np.float64)
    ticks = np.ascontiguousarray(ticks, np.float64)
    out = np.empty(len(ticks), np.int64)
    lib.latest_index(_ptr(stamps, ctypes.c_double), len(stamps),
                     _ptr(ticks, ctypes.c_double), len(ticks),
                     _ptr(out, ctypes.c_int64))
    return out


def bin_events(
    stamps: np.ndarray, values: np.ndarray, burst: np.ndarray,
    ticks: np.ndarray, max_per_tick: int,
):
    """-> (values (T,K,D) f64, mask (T,K) bool, dropped count)."""
    lib = _load()
    if lib is None:
        return None  # caller falls back to the python binner
    stamps = np.ascontiguousarray(stamps, np.float64)
    values = np.ascontiguousarray(values, np.float64)
    burst = np.ascontiguousarray(burst, np.int64)
    ticks = np.ascontiguousarray(ticks, np.float64)
    T, K, D = len(ticks), max_per_tick, values.shape[1] if values.size else 3
    out_v = np.zeros((T, K, D), np.float64)
    out_m = np.zeros((T, K), np.uint8)
    dropped = lib.bin_events(
        _ptr(stamps, ctypes.c_double), _ptr(values, ctypes.c_double),
        _ptr(burst, ctypes.c_int64), len(stamps), D,
        _ptr(ticks, ctypes.c_double), T, K,
        _ptr(out_v, ctypes.c_double), _ptr(out_m, ctypes.c_uint8),
    )
    return out_v, out_m.astype(bool), int(dropped)
