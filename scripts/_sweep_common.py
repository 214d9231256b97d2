"""Helpers shared by the kernel sweeps (``torch_single_lanes_sweep.py``,
``torch_leaf_lanes_sweep.py``): the card's name, CUDA-event timing, nvcc
builds of several sources started together, pointing a package library at
another build, SASS reports, and the parent / change / change / parent
runs of a sweep's worker processes.

Nothing here runs on import; the functions that need the package import
it from ``sys.path``, where a worker has put its own tree first.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

# the atomic and reduction opcodes a SASS report counts
SASS_OPS = (r"\b(ATOMS\.[A-Z0-9.]+|ATOM\.[A-Z0-9.]+|REDG?\.[A-Z0-9.]+|"
            r"ATOMG\.[A-Z0-9.]+)")


def card_name() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown card"


def time_ms(torch, fn, reps: int) -> float:
    """Median device ms of ``fn`` (CUDA events behind a spinning kernel,
    after one warm-up run), as ``chip_smoke.py`` times."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    out.sort()
    return float(out[len(out) // 2])


def build(jobs: dict) -> dict:
    """{name: (shared library, ptxas report)} of ``jobs``, {name: (source,
    extra nvcc flags, library path)}: one ``nvcc`` each, all started
    together, with the package's flags."""
    from lightgbm_tpu_torch.ops import cuda_lib
    procs = {}
    for name, (source, flags, path) in jobs.items():
        os.makedirs(os.path.dirname(path), exist_ok=True)
        cmd = [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, *flags, "-o", path,
               source]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), path)
    built = {}
    for name, (p, path) in procs.items():
        report, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{report}")
        built[name] = (path, report)
    return built


def use_library(lib: str, path: str) -> None:
    """Point the package's wrappers of library ``lib`` (a
    ``cuda_lib._LIBS`` key) at the build at ``path``."""
    from lightgbm_tpu_torch.ops import cuda_lib
    from lightgbm_tpu_torch.ops import histogram_cuda as hc
    cuda_lib._LIBS[lib] = ctypes.CDLL(path)
    hc._SIGS_SET.clear()


def sass(path: str) -> list:
    """The SASS of a shared library (``cuobjdump -sass``), by line."""
    from lightgbm_tpu_torch.ops import cuda_lib
    cuobjdump = os.path.join(os.path.dirname(cuda_lib._nvcc()), "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", path], capture_output=True,
                          text=True, timeout=300).stdout.splitlines()


def kernel_body(lines: list, kernel: str):
    """The SASS lines of the first function whose name holds ``kernel``
    (None if there is none)."""
    starts = [i for i, x in enumerate(lines) if "Function :" in x]
    at = next((i for i in starts if kernel in lines[i]), None)
    if at is None:
        return None
    end = next((i for i in starts if i > at), len(lines))
    return lines[at:end]


def op_counts(lines: list) -> dict:
    """Atomic and reduction instructions in SASS ``lines``, by opcode."""
    counts = {}
    for op in re.findall(SASS_OPS, "\n".join(lines)):
        counts[op] = counts.get(op, 0) + 1
    return counts


def excerpt(lines: list, pattern: str, before: int = 4,
            after: int = 4) -> str:
    """The instructions around the first line of ``lines`` that matches
    ``pattern``, their addresses and encodings dropped ('' if none)."""
    hit = next((i for i, x in enumerate(lines) if re.search(pattern, x)),
               None)
    if hit is None:
        return ""
    out = []
    for x in lines[max(0, hit - before):hit + after + 1]:
        parts = x.split("/*")
        code = parts[1].split("*/")[1] if len(parts) >= 3 else x
        if code.strip():
            out.append(code.strip())
    return "\n".join(out)


def run_trees(script: str, trees: list, argv: list, timeout: int = 3000):
    """Run ``script``'s worker (``--tree NAME --root DIR`` and ``argv``) for
    each (name, root) of ``trees`` in turn, in the root's directory;
    echo each worker's lines and return the rows every worker printed as
    JSON on its last line, or None when one failed."""
    every = []
    for tree, root in trees:
        cmd = [sys.executable, os.path.abspath(script), "--tree", tree,
               "--root", root, *argv]
        p = subprocess.run(cmd, stdout=subprocess.PIPE, text=True, cwd=root,
                           timeout=timeout)
        lines = p.stdout.strip().splitlines()
        for line in lines[:-1]:
            print(line, flush=True)
        if p.returncode != 0:
            print(f"{tree} worker failed (exit {p.returncode})", flush=True)
            if lines:
                print(lines[-1], flush=True)
            return None
        every.extend(json.loads(lines[-1]))
    return every
