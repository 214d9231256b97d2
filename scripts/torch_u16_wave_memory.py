#!/usr/bin/env python3
"""Peak device memory of the wave grower at ``max_bin=1023`` on one CUDA
card: ``chip_smoke.py`` phase 15b's explicit wave runs, exact and
quantized (the headline settings), on its rows.

    python3 scripts/torch_u16_wave_memory.py [--rows 10500000] [--seed 0]

For each run it resets PyTorch's peak counter, trains ``U16_ROUNDS``
rounds and prints ``torch.cuda.max_memory_allocated`` and
``max_memory_reserved`` beside what was allocated before, with the
leaf-histogram launches; the package is the one beside this script, so
a copy of the script in another checkout measures that checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=10_500_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import histogram_cuda as hc
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), flush=True)
    X, y, _ = cs.higgs_like(args.rows, args.seed)
    ds = lt.Dataset(X, y, params={"max_bin": cs.U16_MAX_BIN})
    ds.construct()
    del X
    for mode in ("exact", "headline"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        hc.reset_launches()
        bst = lt.train(cs.mode_params(mode, cs.U16_MAX_BIN), ds,
                       cs.U16_ROUNDS)
        torch.cuda.synchronize()
        print(json.dumps(dict(
            mode=mode, rows=args.rows, rounds=cs.U16_ROUNDS,
            bin_matrix_bytes=int(ds.X_binned.nbytes), before_bytes=base,
            peak_allocated_bytes=torch.cuda.max_memory_allocated(),
            peak_reserved_bytes=torch.cuda.max_memory_reserved(),
            launches={k: v for k, v in hc.LAUNCHES.items()
                      if v and k.startswith(("hist_leaves", "leaf_"))})),
            flush=True)
        del bst
    return 0


if __name__ == "__main__":
    sys.exit(main())
