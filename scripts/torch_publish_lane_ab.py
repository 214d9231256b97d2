"""What the publish lane costs a training run on the card.

Trains ``chip_smoke.py`` phase 17a's configuration (the headline mode on
2,097,152 rows, 8 rounds) in the order P B B P P B B P, where P is a
plain run and B one with ``publish_dir`` (a publish every 2 rounds) and
``flight_dir``, all in one process so that every run sees the same host.
Prints one JSON line a run: each round's milliseconds after the first
(the card synchronized at each round's end), 1 / the median round, each
publish's milliseconds, and the count and milliseconds of Python's
garbage collections by generation.

    python3 scripts/torch_publish_lane_ab.py [--out build/publish_ab]
"""

import argparse
import gc
import json
import os
import shutil
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(HERE, "build",
                                                  "publish_ab"))
    ap.add_argument("--order", default="PBBPPBBP")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import chip_smoke as cs
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import cuda_lib
    from lightgbm_tpu_torch.publish import publisher as pubmod

    os.makedirs(args.out, exist_ok=True)
    print(cs.card_line(), flush=True)
    cuda_lib.build_all()
    # the first PUBLISH_ROWS of 2,621,440 generated rows (the generator's
    # draw depends on the count)
    X, y, _ = cs.higgs_like(2_621_440, 0)
    n = cs.PUBLISH_ROWS
    ds = lt.Dataset(X[:n], y[:n], params={"max_bin": cs.MAX_BIN})
    ds.construct()
    head = cs.mode_params("headline")

    publishes, collections, gc_start = [], [], [0.0]
    publish = pubmod.DeltaPublisher.publish

    def timed_publish(self, gbdt):
        t0 = time.perf_counter()
        out = publish(self, gbdt)
        publishes.append(time.perf_counter() - t0)
        return out
    pubmod.DeltaPublisher.publish = timed_publish

    def on_gc(phase, info):
        if phase == "start":
            gc_start[0] = time.perf_counter()
        else:
            collections.append((info["generation"],
                                time.perf_counter() - gc_start[0]))
    gc.callbacks.append(on_gc)

    for i, lane in enumerate(args.order):
        extra = {}
        if lane == "B":
            jdir = os.path.join(args.out, "journal")
            fdir = os.path.join(args.out, "flight")
            for d in (jdir, fdir):
                shutil.rmtree(d, ignore_errors=True)
            extra = {"publish_dir": jdir, "publish_every": cs.PUBLISH_EVERY,
                     "flight_dir": fdir}
        publishes.clear()
        collections.clear()
        bst, rounds, first = cs._intervals(torch, lambda cbs: lt.train(
            {**head, **extra}, ds, cs.PUBLISH_ROUNDS, callbacks=cbs))
        by_gen = {g: [sum(1 for gg, _ in collections if gg == g),
                      round(sum(t for gg, t in collections if gg == g) * 1e3,
                            1)]
                  for g in (0, 1, 2)}
        print(json.dumps({
            "run": i, "lane": lane,
            "median_rate": round(1.0 / float(np.median(rounds)), 4),
            "rounds_ms": [round(v * 1e3, 1) for v in rounds],
            "first_s": round(first, 3),
            "publish_ms": [round(v * 1e3, 2) for v in publishes],
            "gc": by_gen}), flush=True)
        del bst
    return 0


if __name__ == "__main__":
    sys.exit(main())
