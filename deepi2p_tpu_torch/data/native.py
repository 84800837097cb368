"""The port's native host core (``deepi2p_tpu_torch/native/``) through
ctypes.

One library from three C++ sources of the port's own:

* ``deepi2p_data.cpp``, the port's copy of the JAX package's data core
  (``native/deepi2p_data.cpp``): farthest-point sampling, voxel
  downsampling and brute-force kNN in threaded C++;
* ``jpeg.cpp``, the baseline JPEG decoder and the PNG row unfilter, and
  ``jpeg_encode.cpp``, the baseline JPEG encoder, which ``data/jpeg.py``
  binds.

It is built at first use: ``g++`` with the flags of ``native/Makefile``
compiles both sources into ``deepi2p_tpu_torch/build/`` (never into
``native/``, where the JAX package looks for its own build), under a name
that carries a hash of the sources, the flags and the host's CPU
(``-march=native`` code runs only on the CPU it was built for).  A failed
build raises; callers that want the numpy path ask for it
(``native=False`` in the loaders).
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
from typing import Optional

import numpy as np

from .._build import BUILD_DIR, PKG_DIR

SOURCES = (PKG_DIR / "native" / "deepi2p_data.cpp",
           PKG_DIR / "native" / "jpeg.cpp",
           PKG_DIR / "native" / "jpeg_encode.cpp")
# native/Makefile's CXXFLAGS, and -shared
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-pthread", "-shared"]
BUILD_TIMEOUT_S = 120
N_THREADS = 4   # the JAX package's default for fps and knn


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "flags")):
                    return line
    except OSError:
        pass
    return platform.processor() or platform.machine()


def library_path() -> Path:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(_cpu_model().encode())
    return BUILD_DIR / f"libdeepi2p_data_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the core if this hash of the sources has no library yet;
    raise if ``g++`` is missing or fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found on PATH (nor $CXX): the native "
                           "data core cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    try:
        res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp),
                              *map(str, SOURCES)],
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True,
                             timeout=BUILD_TIMEOUT_S)
        if res.returncode != 0:
            names = " ".join(src.name for src in SOURCES)
            raise RuntimeError(f"building {names} failed "
                               f"({res.returncode}):\n{res.stdout}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def _typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    fp, ip = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64)
    i64 = ctypes.c_int64
    lib.fps.argtypes = [fp, i64, i64, ctypes.c_uint64, ctypes.c_int, ip]
    lib.fps.restype = None
    lib.voxel_downsample.argtypes = [fp, fp, i64, i64, ctypes.c_float,
                                     fp, fp]
    lib.voxel_downsample.restype = i64
    lib.knn.argtypes = [fp, i64, fp, i64, i64, ctypes.c_int, ip]
    lib.knn.restype = None
    u8p, cp = ctypes.POINTER(ctypes.c_uint8), ctypes.c_char_p
    lib.jpeg_dims.argtypes = [u8p, i64, ctypes.c_int, ip, ip, cp,
                              ctypes.c_int]
    lib.jpeg_dims.restype = ctypes.c_int
    lib.jpeg_decode.argtypes = [u8p, i64, ctypes.c_int, u8p, i64, i64, cp,
                                ctypes.c_int]
    lib.jpeg_decode.restype = ctypes.c_int
    lib.png_unfilter.argtypes = [u8p, i64, i64, ctypes.c_int, u8p, cp,
                                 ctypes.c_int]
    lib.png_unfilter.restype = ctypes.c_int
    lib.jpeg_encode_bound.argtypes = [i64, i64]
    lib.jpeg_encode_bound.restype = i64
    lib.jpeg_encode.argtypes = [u8p, i64, i64, u8p, i64, cp, ctypes.c_int]
    lib.jpeg_encode.restype = i64
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (on first use) and load the core, typed."""
    return _typed(ctypes.CDLL(str(build())))


def available() -> bool:
    """Whether the core builds and loads here."""
    try:
        load_library()
    except (RuntimeError, OSError, subprocess.TimeoutExpired):
        return False
    return True


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _points(pts: np.ndarray, name: str) -> np.ndarray:
    pts = np.ascontiguousarray(pts, np.float32)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"{name}: expected (N, 3) points, got {pts.shape}")
    return pts


def fps(pts: np.ndarray, k: int, seed: int = 0,
        n_threads: int = N_THREADS) -> np.ndarray:
    """(k,) int64 FPS indices over (N, 3) points; the first point is drawn
    by ``std::mt19937_64(seed)``."""
    pts = _points(pts, "fps")
    if not 0 < k <= pts.shape[0]:
        raise ValueError(f"fps: k={k} for {pts.shape[0]} points")
    out = np.empty(k, np.int64)
    load_library().fps(_fptr(pts), pts.shape[0], k, seed, n_threads,
                       _iptr(out))
    return out


def voxel_downsample(pts: np.ndarray, voxel: float,
                     extras: Optional[np.ndarray] = None):
    """Voxel-grid average of (N, 3) points (and (N, E) ``extras``), in the
    core's hash order (not :func:`~..ops.sampling.voxel_downsample_np`'s
    sorted order)."""
    pts = _points(pts, "voxel_downsample")
    n = pts.shape[0]
    e = 0 if extras is None else extras.shape[1]
    if extras is not None and extras.shape[0] != n:
        raise ValueError("voxel_downsample: extras and points differ in N")
    ex = (np.ascontiguousarray(extras, np.float32) if extras is not None
          else np.zeros((n, 0), np.float32))
    out_p = np.empty((n, 3), np.float32)
    out_e = np.empty((n, max(e, 1)), np.float32)
    m = load_library().voxel_downsample(_fptr(pts), _fptr(ex), n, e, voxel,
                                        _fptr(out_p), _fptr(out_e))
    if extras is None:
        return out_p[:m].copy()
    return out_p[:m].copy(), out_e[:m, :e].copy()


def knn(query: np.ndarray, database: np.ndarray, k: int,
        n_threads: int = N_THREADS) -> np.ndarray:
    """(Nq, k) int64 indices of the nearest database points, nearest
    first."""
    query = _points(query, "knn query")
    database = _points(database, "knn database")
    if not 0 < k <= database.shape[0]:
        raise ValueError(f"knn: k={k} for {database.shape[0]} points")
    out = np.empty((query.shape[0], k), np.int64)
    load_library().knn(_fptr(query), query.shape[0], _fptr(database),
                       database.shape[0], k, n_threads, _iptr(out))
    return out
