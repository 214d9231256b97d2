"""Multi-process smoke of the port: 2 ``lightgbm_tpu_torch`` processes
over gloo on the CPU train the quantized data-parallel wave path on
pre-partitioned row shards, and the model text must be byte-identical to
the JAX package's single-process 2-device run of the same job: the
port's counterpart of ``scripts/multihost_smoke.py``.

Why byte-identity holds: both layouts are a world of 2 with each rank
holding one contiguous half of the rows, quantized histograms sum as
int32 (order-free), stochastic rounding is off, and distributed bin
finding merges the ranks' sketches, which cover every row
(``bin_construct_sample_cnt`` >> N), into the summaries an in-core
construct sees.  The job is ``scripts/multihost_smoke.py``'s without leaf
renewal: renewal refits leaves from exact sums, which the port carries
in fixed point and the JAX package in f32, so their renewed leaf values
agree only to about 1e-4 (tests/test_torch_slice.py).

A second phase repeats the run through the streamed ingest path (each
rank feeds ONLY its shard through a ChunkSource; binning rides the
sketch merge) and must match the same text.

Usage: python scripts/port_multihost_smoke.py [--out FILE]
(--worker / --baseline are internal re-invocation modes).  The port's
workers import no JAX; the baseline process runs the JAX package.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N, F, ROUNDS = 600, 6, 4

# pre_partition is set in BOTH layouts (inert in one process) so the
# model text's parameters block is the same byte for byte
PARAMS = {
    "objective": "binary", "num_leaves": 7, "min_data_in_leaf": 5,
    "verbosity": -1, "tree_learner": "data", "tree_grow_mode": "wave",
    "use_quantized_grad": True, "stochastic_rounding": False,
    "pre_partition": True,
}


def _make_data():
    import numpy as np
    rng = np.random.RandomState(31)
    X = rng.randn(N, F)
    y = ((X[:, 0] + 0.5 * X[:, 1] - 0.2 * X[:, 2] ** 2) > 0).astype(float)
    return X, y


def _run_worker(rank: int, port: str, outdir: str) -> int:
    import torch
    torch.set_num_threads(1)
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ingest.source import ArraySource
    lt.distributed.init(coordinator_address="127.0.0.1:" + port,
                        num_processes=2, process_id=rank)
    X, y = _make_data()
    lo, hi = (0, N // 2) if rank == 0 else (N // 2, N)
    bst = lt.train(dict(PARAMS), lt.Dataset(X[lo:hi], y[lo:hi]), ROUNDS,
                   device="cpu")
    with open(os.path.join(outdir, f"model_dist_{rank}.txt"), "w") as fh:
        fh.write(bst.model_to_string())
    sd = lt.StreamedDataset(ArraySource(X[lo:hi], y[lo:hi], chunk_rows=256),
                            params=dict(PARAMS))
    bst2 = lt.train(dict(PARAMS), sd, ROUNDS, device="cpu")
    with open(os.path.join(outdir, f"model_stream_{rank}.txt"), "w") as fh:
        fh.write(bst2.model_to_string())
    lt.distributed.shutdown()
    return 0


def _run_baseline(outdir: str) -> int:
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 2)   # 1 process x 2 devices
    import lightgbm_tpu as lgb
    X, y = _make_data()
    bst = lgb.train(dict(PARAMS), lgb.Dataset(X, y), ROUNDS)
    with open(os.path.join(outdir, "model_single.txt"), "w") as fh:
        fh.write(bst.model_to_string())
    return 0


def _free_port() -> str:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return str(port)


def _launch(outdir: str, timeout: float) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="")
    me = os.path.abspath(__file__)
    port = _free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, me, "--worker", str(r), "--port", port,
         "--dir", outdir],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)]
    procs.append(subprocess.Popen(
        [sys.executable, me, "--baseline", "--dir", outdir],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs, rcs = [], []
    for p in procs:
        try:
            out = p.communicate(timeout=timeout)[0].decode()
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out = p.communicate()[0].decode() + "\n<timeout>"
        outs.append(out)
        rcs.append(p.returncode)
    rec = {"schema": "port-multihost-smoke-v1", "ok": False,
           "world": {"processes": 2, "backend": "gloo"},
           "launch_seconds": round(time.perf_counter() - t0, 2),
           "returncodes": rcs}
    if any(rc != 0 for rc in rcs):
        rec["error"] = "\n===\n".join(o[-2500:] for o in outs)
        return rec

    def read(name):
        with open(os.path.join(outdir, name), "rb") as fh:
            return fh.read()

    single = read("model_single.txt")
    checks = {}
    for tag in ("dist", "stream"):
        m0, m1 = read(f"model_{tag}_0.txt"), read(f"model_{tag}_1.txt")
        checks[f"{tag}_ranks_identical"] = m0 == m1
        checks[f"{tag}_matches_single_process"] = m0 == single
    rec["model_text_bytes"] = len(single)
    rec["bit_identical"] = checks
    rec["ok"] = all(checks.values())
    if not rec["ok"]:
        import difflib
        rec["first_divergence"] = {
            tag: list(difflib.unified_diff(
                read(f"model_{tag}_0.txt").decode().splitlines(),
                single.decode().splitlines(), "port", "reference",
                lineterm="", n=0))[:12]
            for tag in ("dist", "stream")
            if not checks[f"{tag}_matches_single_process"]}
    return rec


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="port-multihost-smoke.json")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds each process may take")
    ap.add_argument("--worker", type=int, default=None)
    ap.add_argument("--baseline", action="store_true")
    ap.add_argument("--port", default=None)
    ap.add_argument("--dir", default=None)
    ns = ap.parse_args()
    if ns.worker is not None:
        return _run_worker(ns.worker, ns.port, ns.dir)
    if ns.baseline:
        return _run_baseline(ns.dir)

    import tempfile
    with tempfile.TemporaryDirectory() as td:
        rec = _launch(td, ns.timeout)
    with open(ns.out, "w") as fh:
        json.dump(rec, fh, indent=2, default=str)
    print(json.dumps({k: rec.get(k) for k in
                      ("ok", "launch_seconds", "bit_identical")}))
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
