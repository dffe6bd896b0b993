"""ctypes bindings to the native data-loading library (native/fastload.cpp).

The reference's scene-build chain is C++ (collada.cpp parsing, bvh.cpp
construction); this module is its runtime counterpart here: text→array
parsing, Morton ordering, cluster bboxes, and vertex normals in C++, with
transparent NumPy fallbacks when the library cannot be built.

The library is built from source on first use into native/build/ (listed
in .gitignore), or ahead of time with `python -m rrt_tpu.utils.native`.
The build writes a private temporary file and renames it into place, so
concurrent first uses (parallel test workers) never load a partial file.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "native", "fastload.cpp")
_SO = os.path.join(_ROOT, "native", "build", "libfastload.so")


def build() -> str:
    """Compile native/fastload.cpp into native/build/libfastload.so."""
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".libfastload.", suffix=".so",
                               dir=os.path.dirname(_SO))
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                        _SRC, "-o", tmp], check=True, capture_output=True,
                       timeout=300)
        os.replace(tmp, _SO)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return _SO


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if not os.path.exists(_SO):
        try:
            build()
        except (OSError, subprocess.SubprocessError):
            return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None
    c_dp = ctypes.POINTER(ctypes.c_double)
    c_ip = ctypes.POINTER(ctypes.c_int64)
    c_u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.parse_floats.restype = ctypes.c_int64
    lib.parse_floats.argtypes = [ctypes.c_char_p, ctypes.c_int64, c_dp,
                                 ctypes.c_int64]
    lib.parse_ints.restype = ctypes.c_int64
    lib.parse_ints.argtypes = [ctypes.c_char_p, ctypes.c_int64, c_ip,
                               ctypes.c_int64]
    lib.morton_order.argtypes = [c_dp, c_dp, c_dp, ctypes.c_int64, c_ip]
    lib.cluster_bboxes.argtypes = [c_dp, c_dp, c_dp, c_u8p,
                                   ctypes.c_int64, ctypes.c_int64,
                                   c_dp, c_dp]
    lib.vertex_normals.argtypes = [c_dp, ctypes.c_int64, c_ip,
                                   ctypes.c_int64, c_dp]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def _dp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _ip(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def parse_floats(text: str, expected: Optional[int] = None) -> np.ndarray:
    lib = _load()
    raw = text.encode()
    cap = expected if expected is not None else len(raw) // 2 + 2
    if lib is None:
        v = np.array([float(t) for t in text.split()])
        return v[:expected] if expected is not None else v
    out = np.empty(cap, np.float64)
    n = lib.parse_floats(raw, len(raw), _dp(out), cap)
    return out[:n if expected is None else min(n, expected)]


def parse_ints(text: str, expected: Optional[int] = None) -> np.ndarray:
    lib = _load()
    raw = text.encode()
    cap = expected if expected is not None else len(raw) // 2 + 2
    if lib is None:
        v = np.array([int(t) for t in text.split()], np.int64)
        return v[:expected] if expected is not None else v
    out = np.empty(cap, np.int64)
    n = lib.parse_ints(raw, len(raw), _ip(out), cap)
    return out[:n if expected is None else min(n, expected)]


def morton_order(v0, v1, v2) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    v0 = np.ascontiguousarray(v0, np.float64)
    v1 = np.ascontiguousarray(v1, np.float64)
    v2 = np.ascontiguousarray(v2, np.float64)
    n = len(v0)
    order = np.empty(n, np.int64)
    lib.morton_order(_dp(v0), _dp(v1), _dp(v2), n, _ip(order))
    return order


def cluster_bboxes(v0, v1, v2, valid, cluster_size):
    lib = _load()
    if lib is None:
        return None
    v0 = np.ascontiguousarray(v0, np.float64)
    v1 = np.ascontiguousarray(v1, np.float64)
    v2 = np.ascontiguousarray(v2, np.float64)
    valid = np.ascontiguousarray(valid, np.uint8)
    n = len(v0)
    k = n // cluster_size
    lo = np.empty((k, 3), np.float64)
    hi = np.empty((k, 3), np.float64)
    lib.cluster_bboxes(
        _dp(v0), _dp(v1), _dp(v2),
        valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n, cluster_size, _dp(lo), _dp(hi))
    return lo, hi


def vertex_normals(verts, tris) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    verts = np.ascontiguousarray(verts, np.float64)
    tris = np.ascontiguousarray(tris, np.int64)
    out = np.empty_like(verts)
    lib.vertex_normals(_dp(verts), len(verts), _ip(tris), len(tris),
                       _dp(out))
    return out


if __name__ == "__main__":
    print(build())
    sys.exit(0 if available() else 1)
