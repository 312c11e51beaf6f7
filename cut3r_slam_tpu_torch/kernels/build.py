"""Build the CUDA sources under ``cut3r_slam_tpu_torch/csrc`` with ``nvcc``
and load them with ``ctypes``.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/torch_kernels/lib<name>-<hash>.so <name>.cu

The file name carries a hash of the source and the headers it includes, so
a stale library is never loaded. Libraries go to ``build/torch_kernels/``
at the repository root. Nothing is built at import: ``load`` builds on
first use, and ``build_all`` builds every source in parallel (one ``nvcc``
process per source, all started together).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List

__all__ = ["SOURCES", "build", "build_all", "load", "nvcc_path"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of each library's entry point: (symbol, argtypes)
SOURCES: Dict[str, tuple] = {
    # A, extent, R, K, nC, O, dsum, mdep, tleft, tchk, stream
    "gs_blend_fwd": ("gs_blend_fwd",
                     [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P]),
    # A, extent, R, K, nC, tchk, tleft, gO, gd, gmd, gT, dA, stream
    "gs_blend_bwd": ("gs_blend_bwd",
                     [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P]),
    # dG, entry_gauss, entry_mask, E, n_rows, cap, work, dRaw, stream
    "gs_pack_bwd": ("gs_pack_bwd",
                    [_P, _P, _P, _I, ctypes.c_longlong, _I, _P, _P, _P]),
    # poses_in, poses_out, disps_in, disps_out, intr, target, weight, ev,
    # eta, ii, jj, cells, E, P0, fixedp, ht, wd, ep, lm, plan, with_cov,
    # HB, VB, EB, CW, H, v, Ed, nzE, Q, w, S, rhs, Lp, dx, status, dzcov,
    # stream
    "droid_ba": ("droid_ba_step",
                 [_P] * 12 + [_I] * 5 + [_F, _F, _I, _I] + [_P] * 16 + [_P]),
}

_LOADED: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}    # nvcc's -Xptxas -v report per source


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "CUDA kernels cannot be built")


def _source_hash(name: str) -> str:
    h = hashlib.sha256()
    for f in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_source_hash(name)}.so"


def build(name: str) -> Path:
    """Compile one source (no-op when its hashed library exists). nvcc's
    report is kept beside the library, so ``BUILD_LOG`` holds it either
    way."""
    out = _lib_path(name)
    report = out.with_suffix(".log")
    if out.exists():
        if report.exists():
            BUILD_LOG[name] = report.read_text()
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [nvcc_path()] + ARCH_FLAGS + NVCC_FLAGS + [
        "-o", str(tmp), str(CSRC / f"{name}.cu")]
    p = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOG[name] = p.stdout + p.stderr
    if p.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} (rc {p.returncode}):\n"
                           f"{' '.join(cmd)}\n{p.stdout}\n{p.stderr}")
    report.write_text(BUILD_LOG[name])
    os.replace(tmp, out)
    return out


def build_all(names: List[str] = None) -> float:
    """Build every source in parallel; returns the wall seconds."""
    names = list(SOURCES) if names is None else names
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(names)) as ex:
        list(ex.map(build, names))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name`` (built on first use)."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        sym, argtypes = SOURCES[name]
        fn = getattr(lib, sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LOADED[name] = lib
    return lib
