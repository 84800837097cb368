"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by its own ``nvcc -c``, all started
together, and one ``nvcc -shared`` links the objects into a shared library
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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List

PKG_DIR = Path(__file__).resolve().parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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
    # the same for the 6-DoF mode (theta0 and theta_out (B, I, 6))
    "lm_solve_p6_f32": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                        _F, _F, _F, _F, _F, _F, _F, _F, _P],
    # q, db, d2, idx, S (query sets), N, M, D, Q (sets per database), stream
    "nn1_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
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


def nvcc_commands(nvcc: str, srcs, out: Path):
    """One compile command per source (to an object beside ``out``) and
    the command that links the objects into ``out``."""
    objs = [out.with_name(f"{out.name}.{p.stem}.o") for p in srcs]
    compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)]
                for p, o in zip(srcs, objs)]
    link = [nvcc, "-shared", "-o", str(out), *(str(o) for o in objs)]
    return compiles, link


def _run_all(cmds, verbose: bool) -> None:
    """Run the commands at once and wait for all; raise if one failed (a
    command past :data:`BUILD_TIMEOUT_S` is killed and raises)."""
    def run(cmd):
        return subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              timeout=BUILD_TIMEOUT_S)

    with ThreadPoolExecutor(len(cmds)) as pool:
        done = list(pool.map(run, cmds))
    for cmd, res in zip(cmds, done):
        if verbose or res.returncode != 0:
            print(" ".join(cmd), flush=True)
            print(res.stdout, flush=True)
    failed = [(c[-1], r.returncode) for c, r in zip(cmds, done)
              if r.returncode != 0]
    if failed:
        raise RuntimeError(f"nvcc failed: {failed}")


def build(verbose: bool = False) -> Path:
    """Compile the kernels if this source hash has no library yet."""
    srcs = sources()
    out = library_path(srcs)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    compiles, link = nvcc_commands(find_nvcc(), srcs, tmp)
    t0 = time.perf_counter()
    try:
        _run_all(compiles, verbose)
        _run_all([link], verbose)
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise
    finally:
        for cmd in compiles:
            Path(cmd[cmd.index("-o") + 1]).unlink(missing_ok=True)
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
