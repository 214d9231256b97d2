"""The port's distributed training in its production layout: one card a
rank over NCCL.

``chip_smoke.py``'s phase 19 (data-parallel quantized headline and exact,
voting at top_k 14 and 5, feature-parallel, ``pre_partition``) on
``--world`` ranks, rank r on card r, ``distributed.init(...,
local_device_ids=[r])`` with its default backend (NCCL), against the
single-process run of each job on card 0: the same checks (every rank's
text identical; data-parallel text byte-identical to one process; voting
at 2k = F the data-parallel trees, at top_k=5 AUC within 0.01;
feature-parallel predictions within 1e-5 of the masked grower's) and the
same readings (iterations/s beside one process's, collective calls and
bytes a tree per site).  Needs ``--world`` cards.

    python scripts/torch_dp_world.py --world 4 [--rows 10500000]
                                     [--rounds 6] [--out-dir build/dp_world]
"""

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--rows", type=int, default=10_500_000)
    ap.add_argument("--test-rows", type=int, default=500_000)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out-dir", default=os.path.join("build", "dp_world"))
    args = ap.parse_args()
    import torch
    if torch.cuda.device_count() < args.world:
        print(f"torch_dp_world: {args.world} ranks need {args.world} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import cuda_lib
    cuda_lib.build_all()           # once, before the ranks start
    card = cs.card_line()
    import subprocess
    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60, check=True).stdout
    cs.log(f"cards: {'; '.join(cards.strip().splitlines())}; torch "
           f"{torch.__version__}")
    X, y, _ = cs.higgs_like(args.rows + args.test_rows, args.seed)
    out = os.path.join(REPO, args.out_dir)
    os.makedirs(out, exist_ok=True)
    t0 = time.perf_counter()
    cs.distributed_phase(lt, torch, card, X[:args.rows], y[:args.rows],
                         X[args.rows:], y[args.rows:], args.rounds, out,
                         world=args.world, nccl=True)
    cs.log(f"{args.world} ranks over NCCL: every check held in "
           f"{time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
