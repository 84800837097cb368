"""Build and load the port's CUDA kernels.

All of ``csrc/*.cu`` goes through ONE ``nvcc`` call into a shared library
with a plain C interface, bound with :mod:`ctypes`.  No source includes
PyTorch's headers, so the build takes seconds, not minutes.

* The library lands in ``deepi2p_tpu_torch/build/`` (ignored by git's
  ``build/`` rule) and its file name carries a hash of the sources, so a
  stale library is never loaded.
* It is compiled under a temporary name and renamed into place, so a
  build cut off half way leaves nothing that looks finished, and there
  is no lock file for a later run to wait on.
* ``nvcc`` is looked up on ``PATH``, then under ``$CUDA_HOME/bin`` (or
  ``$CUDA_PATH/bin``, else ``/usr/local/cuda/bin``); without it the build
  raises.

Each C entry point takes raw pointers, sizes and the CUDA stream, launches
on that stream, allocates nothing and returns ``cudaGetLastError()``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import List

PKG_DIR = Path(__file__).resolve().parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    # no multiply-add contraction: the kernels then round every product
    # and sum as the plain PyTorch versions do, which is what lets the
    # chip check hold them to those versions tightly
    "-fmad=false",
]
BUILD_TIMEOUT_S = 300

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argument types (restype is int, the CUDA error)
SIGNATURES = {
    # q, db, d2, idx, B, N, M, D, k, stream
    "knn_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # pts, labels, valid, kparams, theta0, theta_out, cost_out,
    # B, N, I, max_iter, H1, W1, lb0, lb1, lb2, ub0, ub1, ub2, stream
    "lm_solve_p4_f32": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                        _F, _F, _F, _F, _F, _F, _F, _F, _P],
}


def sources() -> List[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def library_path(srcs=None) -> Path:
    """``build/libdeepi2p_kernels_<hash>.so`` for the given sources."""
    h = hashlib.sha256()
    for p in (srcs if srcs is not None else sources()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libdeepi2p_kernels_{h.hexdigest()[:16]}.so"


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = (os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
            or "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file() and os.access(cand, os.X_OK):
        return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin; the CUDA toolkit "
        "is needed to build the port's kernels")


def nvcc_command(nvcc: str, srcs, out: Path) -> List[str]:
    """The single compile-and-link command for all kernel sources."""
    return [nvcc, *NVCC_FLAGS, "-o", str(out), *(str(p) for p in srcs)]


def build(verbose: bool = False) -> Path:
    """Compile the kernels if this source hash has no library yet."""
    srcs = sources()
    out = library_path(srcs)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    cmd = nvcc_command(find_nvcc(), srcs, tmp)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=BUILD_TIMEOUT_S)
    if verbose or proc.returncode != 0:
        print(" ".join(cmd), flush=True)
        print(proc.stdout + proc.stderr, flush=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with code {proc.returncode}")
    os.replace(tmp, out)
    if verbose:
        print(f"built {out.name} in {time.perf_counter() - t0:.1f} s",
              flush=True)
    return out


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (on first use) and load the kernel library, typed."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.deepi2p_error_string.argtypes = [ctypes.c_int]
    lib.deepi2p_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = load_library().deepi2p_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg}) at launch")
