"""Native host-runtime builds of the port: the ``LGBM_*`` ABI shim.

Port of ``build_capi_shim`` of ``lightgbm_tpu/utils/native.py``.
``csrc/capi_shim.cc`` is compiled with ``g++`` (not ``nvcc``: it is host
code over the embedded CPython interpreter) at first use, into
``build/capi/`` at the root of the checkout (listed in ``.gitignore``),
next to ``build/cuda/``.  The library's file name carries the Python
version it links against and a hash of its source and flags, so a shim
built for another interpreter or from an edited source is never loaded.
The reference's threaded binning helper (``native/binning.cc``) is not
ported (ROADMAP queue 1): the port bins with numpy.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sysconfig
from typing import Optional

__all__ = ["build_capi_shim", "CAPI_BUILD_DIR"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAPI_BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "capi")
_SRC = os.path.join(_PKG_DIR, "csrc", "capi_shim.cc")
_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")


def build_capi_shim() -> Optional[str]:
    """Compile the native ``LGBM_*`` ABI shim (``csrc/capi_shim.cc``) and
    return the shared library's path, or None when the toolchain or the
    Python headers are missing.  The shim exports LightGBM's out-pointer
    calling convention (c_api.h) as real C symbols backed by the embedded
    interpreter and ``lightgbm_tpu_torch.capi``: dlopen it from C, C++ or
    ctypes and call ``LGBM_*`` directly."""
    gxx = shutil.which("g++")
    inc = sysconfig.get_path("include")
    if gxx is None or not os.path.exists(os.path.join(inc, "Python.h")):
        return None
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    ver = sysconfig.get_config_var("LDVERSION") or \
        sysconfig.get_config_var("VERSION")
    with open(_SRC, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(_FLAGS).encode() +
                                ver.encode()).hexdigest()[:12]
    lib_path = os.path.join(CAPI_BUILD_DIR,
                            f"liblightgbm_tpu_torch_capi-py{ver}_{digest}.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(CAPI_BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"   # per-pid: no build races
    cmd = [gxx, *_FLAGS, _SRC, f"-I{inc}", "-o", tmp]
    if libdir:
        cmd += [f"-L{libdir}", f"-Wl,-rpath,{libdir}"]
    cmd += [f"-lpython{ver}"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        os.replace(tmp, lib_path)
    except (OSError, subprocess.SubprocessError):
        return None
    return lib_path
