"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into its own shared library
with a plain C interface, loaded with ``ctypes``.  The build runs at first
use, one ``nvcc`` process per source, all started together, into
``build/cuda/`` at the root of the checkout (listed in ``.gitignore``).
Each library's file name carries a hash of its source and flags, so an
edited source is rebuilt and a stale library is never loaded.

Nothing here runs when the package is imported: the CPU tests import every
module on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Optional

__all__ = ["SOURCES", "build_all", "library"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "cuda")

SOURCES = ("hist_single", "hist_leaves", "hist_leaves_u16", "row_update")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
# name -> (seconds, ptxas report) of the builds this process ran
BUILD_LOG: Dict[str, tuple] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "lightgbm_tpu_torch are built at first use on a "
                       "machine with the CUDA toolkit")


def _lib_path(name: str) -> str:
    with open(os.path.join(_CSRC, name + ".cu"), "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:12]}.so")


def build_all(names=SOURCES) -> Dict[str, float]:
    """Build every missing library, one ``nvcc`` per source in parallel.
    Returns {name: build seconds} for the sources built by this call."""
    todo = [n for n in names if not os.path.exists(_lib_path(n))]
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = f"{_lib_path(n)}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, n + ".cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    out: Dict[str, float] = {}
    errors = []
    for n, (p, tmp) in procs.items():
        report, _ = p.communicate()
        dt = time.perf_counter() - t0
        if p.returncode != 0:
            errors.append(f"nvcc failed for csrc/{n}.cu "
                          f"(exit {p.returncode}):\n{report}")
            continue
        os.replace(tmp, _lib_path(n))
        out[n] = dt
        BUILD_LOG[n] = (dt, report)
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building every source
    first if this one is missing."""
    lib: Optional[ctypes.CDLL] = _LIBS.get(name)
    if lib is None:
        if not os.path.exists(_lib_path(name)):
            build_all()
        lib = ctypes.CDLL(_lib_path(name))
        _LIBS[name] = lib
    return lib
