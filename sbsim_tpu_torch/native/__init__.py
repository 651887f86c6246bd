"""Host C++ ops of the port: floor-plan raster ops and the record scanner.

Port of sbsim_tpu/native on the port's own copies of its C++ sources
(floorplan_ops.cc: 4-connected labeling, the exact Euclidean distance
transform, dilation with the cross element; record_io.cc: the
length-prefixed record scanner and batched appender). Each library is built
with g++ at its first use into sbsim_tpu_torch/_build/, under a name keyed
by the digest of its source and flags, and loaded through ctypes.

The build goes through the port's build cache (buildcache.py), which is
atomic: processes that build at once each load a whole library. There is
no fallback: a failed build raises RuntimeError with the compiler's
output, and a truncated shard raises IOError.
"""

from __future__ import annotations

import ctypes
import os
import threading
import time
from typing import Dict, List

import numpy as np

from sbsim_tpu_torch import buildcache

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = buildcache.BUILD_DIR
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")
# Seconds each library's build took in this process (0.0: found built).
build_seconds: Dict[str, float] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def source_path(name: str) -> str:
    return os.path.join(_DIR, f"{name}.cc")


def library_path(name: str) -> str:
    """Where lib<name> is built: BUILD_DIR, keyed by the digest of the
    source, the compiler and its flags."""
    return buildcache.library_path(source_path(name), f"lib{name}", CXX, CXX_FLAGS, BUILD_DIR)


def build(name: str) -> str:
    """Compiles <name>.cc unless its library is built already; returns the
    library's path. Raises RuntimeError if the compiler fails or is absent."""
    t0 = time.perf_counter()
    path, log = buildcache.build(source_path(name), f"lib{name}", CXX, CXX_FLAGS, BUILD_DIR)
    if log is None:
        build_seconds.setdefault(name, 0.0)
    else:
        build_seconds[name] = time.perf_counter() - t0
    return path


def load(name: str) -> ctypes.CDLL:
    """lib<name>, built at first use and bound; raises if it cannot be
    built."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _bind(name, ctypes.CDLL(build(name)))
            _LIBS[name] = lib
        return lib


def _bind(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p, i32p, i64p = (ctypes.POINTER(t) for t in (ctypes.c_uint8, ctypes.c_int32,
                                                  ctypes.c_int64))
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    if name == "floorplan_ops":
        lib.connected_components_4.argtypes = [u8p, i32, i32, i32p]
        lib.connected_components_4.restype = i32
        lib.distance_transform_edt.argtypes = [u8p, i32, i32, ctypes.POINTER(ctypes.c_float)]
        lib.distance_transform_edt.restype = None
        lib.binary_dilation_cross.argtypes = [u8p, i32, i32, i32, u8p]
        lib.binary_dilation_cross.restype = None
    elif name == "record_io":
        lib.scan_records.argtypes = [ctypes.c_char_p, i64p, i64]
        lib.scan_records.restype = i64
        lib.read_all_records.argtypes = [ctypes.c_char_p, u8p, i64]
        lib.read_all_records.restype = i64
        lib.append_records.argtypes = [ctypes.c_char_p, u8p, i64p, i64]
        lib.append_records.restype = i32
    return lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _mask(image: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(image) != 0, dtype=np.uint8)


# ---------------------------------------------------------------------------
# floorplan_ops
# ---------------------------------------------------------------------------


def connected_components_4(image: np.ndarray) -> np.ndarray:
    """4-connected labels of nonzero pixels (0 background, 1..n in raster
    order of first encounter), int32."""
    img = _mask(image)
    labels = np.zeros(img.shape, dtype=np.int32)
    load("floorplan_ops").connected_components_4(
        _ptr(img, ctypes.c_uint8), img.shape[0], img.shape[1], _ptr(labels, ctypes.c_int32))
    return labels


def distance_transform_edt(image: np.ndarray) -> np.ndarray:
    """Exact Euclidean distance of each nonzero pixel to the nearest zero
    pixel, float32 (zero pixels 0)."""
    img = _mask(image)
    out = np.zeros(img.shape, dtype=np.float32)
    load("floorplan_ops").distance_transform_edt(
        _ptr(img, ctypes.c_uint8), img.shape[0], img.shape[1], _ptr(out, ctypes.c_float))
    return out


def binary_dilation_cross(image: np.ndarray, iterations: int = 1) -> np.ndarray:
    """Binary dilation with the 4-connected cross element, `iterations`
    times; bool."""
    img = _mask(image)
    out = np.zeros(img.shape, dtype=np.uint8)
    load("floorplan_ops").binary_dilation_cross(
        _ptr(img, ctypes.c_uint8), img.shape[0], img.shape[1], iterations,
        _ptr(out, ctypes.c_uint8))
    return out.astype(bool)


# ---------------------------------------------------------------------------
# record_io
# ---------------------------------------------------------------------------


def read_record_payloads(path: str) -> List[bytes]:
    """Every length-prefixed payload of a shard file, in order. Raises
    IOError for an unreadable file or a truncated trailing record."""
    lib = load("record_io")
    encoded = os.fsencode(path)
    n = lib.scan_records(encoded, None, 0)
    if n == -2:
        raise IOError(f"truncated trailing record in shard: {path}")
    if n < 0:
        raise IOError(f"unreadable shard: {path}")
    lengths = np.zeros(int(n), dtype=np.int64)
    lib.scan_records(encoded, _ptr(lengths, ctypes.c_int64), int(n))
    total = int(lengths.sum())
    buffer = np.zeros(total, dtype=np.uint8)
    got = lib.read_all_records(encoded, _ptr(buffer, ctypes.c_uint8), total)
    if got != total:
        raise IOError(f"short read on shard: {path}")
    raw = buffer.tobytes()
    ends = np.cumsum(lengths)
    return [raw[int(e - length):int(e)] for e, length in zip(ends, lengths)]


def append_record_payloads(path: str, payloads: List[bytes]) -> None:
    """Appends payloads as length-prefixed records with one buffered write.
    Raises IOError if the file cannot be written."""
    data = b"".join(payloads)
    arr = np.frombuffer(data, dtype=np.uint8) if data else np.zeros(1, np.uint8)
    lengths = np.asarray([len(p) for p in payloads] or [0], dtype=np.int64)
    rc = load("record_io").append_records(
        os.fsencode(path), _ptr(arr, ctypes.c_uint8), _ptr(lengths, ctypes.c_int64),
        len(payloads))
    if rc != 0:
        raise IOError(f"failed to append records to {path}")
