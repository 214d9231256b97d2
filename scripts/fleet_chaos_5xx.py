#!/usr/bin/env python3
"""Where the serving fleet's 5xx come from under a worker SIGKILL.

    JAX_PLATFORMS=cpu python3 scripts/fleet_chaos_5xx.py \
        --package lightgbm_tpu_torch [--runs 3] [--heavy] [--out FILE]

Runs ``test_fleet_chaos_under_load``'s scenario (``tests/test_fleet.py``
and ``tests/test_torch_fleet.py``: 4 CPU workers, 6 s of loadgen traffic
at 40 requests/s of 8 rows, workers 0 and 2 SIGKILLed 1.5 s and 3 s in)
against one package's ``serve/fleet.py`` (``lightgbm_tpu`` or
``lightgbm_tpu_torch``), ``--runs`` times.  ``--heavy`` sends
chip_smoke.py phase 18's load instead: 8 closed-loop clients of 1 / 64 /
4,096-row requests at 0.5 / 0.4 / 0.1, so that a kill more often lands
while a worker is writing a reply.  The in-process dispatcher's
``dispatch_predict`` is wrapped so that every answer of 500 or more is
logged with its source:

* ``worker``: a worker's own 5xx, forwarded unchanged (its error text);
* ``dispatcher 502`` / ``503`` / ``504``: the dispatcher's own answers
  (retry budget spent, nothing routable, deadline or forward timeout);
* ``dispatcher 500``: ``dispatch_predict`` raised (the exception's type
  and text), which the front end answers with 500.

Prints one line per 5xx and per run (the client's codes, the fleet's
``serve_predict_responses_total`` by code) and writes them as JSON to
``--out`` (default ``build/fleet_chaos_5xx_<package>.json``).  Nothing
here needs a card.
"""

from __future__ import annotations

import argparse
import http.client
import importlib
import json
import os
import sys
import tempfile
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SMALL = {"num_leaves": 7, "min_data_in_leaf": 5, "verbosity": -1}
DISPATCHER_TEXT = {"no serving worker available": 503,
                   "deadline exhausted": 504, "in the forward hop": 504,
                   "retry budget": 502}


def _booster(pkg, port: bool):
    """The tests' ``fleet_booster``: ``binary_data`` (600 x 6, seed 42),
    6 rounds of the small configuration."""
    rng = np.random.RandomState(42)
    X = rng.randn(600, 6)
    logit = X[:, 0] * 2 + X[:, 1] - 0.5 * X[:, 2]
    y = (logit + 0.5 * rng.randn(600) > 0).astype(np.float64)
    kw = {"device": "cpu"} if port else {}
    return pkg.train({**SMALL, "objective": "binary"}, pkg.Dataset(X, y), 6,
                     **kw)


def _source(status: int, data: bytes) -> str:
    try:
        err = str(json.loads(data).get("error", ""))
    except (ValueError, AttributeError):
        err = data[:120].decode(errors="replace")
    for text, code in DISPATCHER_TEXT.items():
        if text in err and code == status:
            return f"dispatcher {status}: {err}"
    return f"worker {status}: {err}"


def one_run(name: str, run: int, tmp: str, heavy: bool) -> dict:
    pkg = importlib.import_module(name)
    fleet_mod = importlib.import_module(name + ".serve.fleet")
    loadgen = importlib.import_module(name + ".serve.loadgen")
    port = name.endswith("_torch")
    model_file = os.path.join(tmp, f"model_{run}.txt")
    _booster(pkg, port).save_model(model_file)
    env = ({"PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"} if port
           else {"JAX_PLATFORMS": "cpu", "PYTHONPATH": ROOT})
    args = {"warmup": "0", "max_wait_ms": "0.5"}
    if port:
        args["device_type"] = "cpu"
    events = []
    cls = fleet_mod.FleetSupervisor
    real = cls.dispatch_predict

    def traced(self, body, rid):
        t = time.monotonic()
        try:
            status, data, headers = real(self, body, rid)
        except Exception as exc:
            events.append(dict(t=t, source=f"dispatcher 500: "
                               f"{type(exc).__name__}: {exc}"))
            raise
        if status >= 500:
            events.append(dict(t=t, source=_source(status, data)))
        return status, data, headers

    cls.dispatch_predict = traced
    fleet = cls([model_file], workers=4, worker_env=env, worker_args=args,
                probe_interval_s=0.25, probe_timeout_s=5.0,
                breaker_failures=3, breaker_window_s=20.0,
                breaker_halfopen_s=1.0, backoff_base_s=0.2,
                backoff_max_s=1.0, startup_timeout_s=180.0,
                drain_timeout_s=30.0, forward_timeout_s=60.0,
                run_dir=os.path.join(tmp, f"fleet-run-{run}")).start()
    try:
        spec = (loadgen.LoadSpec(duration_s=6.0, target_qps=0.0, workers=8,
                                 features=6,
                                 bucket_mix={1: 0.5, 64: 0.4, 4096: 0.1},
                                 seed=3 + run, timeout_s=30.0) if heavy
                else loadgen.LoadSpec(duration_s=6.0, target_qps=40.0,
                                      workers=2, features=6,
                                      bucket_mix={8: 1.0}, seed=3,
                                      timeout_s=30.0))
        gen = loadgen.LoadGenerator(fleet.host, fleet.port, spec)
        kills = []

        def killer():
            for i in (0, 2):
                time.sleep(1.5)
                w = fleet.workers()[i]
                if w.proc is not None and w.proc.poll() is None:
                    w.proc.kill()
                    kills.append((time.monotonic(), w.name))

        kt = threading.Thread(target=killer, daemon=True)
        t0 = time.monotonic()
        kt.start()
        client = gen.run()
        kt.join(20)
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline and not all(
                w.state == "alive" for w in fleet.workers()):
            time.sleep(0.05)
        conn = http.client.HTTPConnection(fleet.host, fleet.port, timeout=30)
        conn.request("GET", "/metrics")
        parsed = loadgen.parse_prometheus(conn.getresponse().read().decode())
        conn.close()
        codes = {c: loadgen.metric_sum(
            parsed, "lgbm_tpu_serve_predict_responses_total", code=c)
            for c in ("200", "500", "502", "503", "504")}
    finally:
        fleet.shutdown()
        cls.dispatch_predict = real
    return dict(package=name, run=run, heavy=heavy,
                sent=client.requests_sent,
                client_codes={str(k): v for k, v in client.by_code.items()},
                connect_errors=client.connect_errors, fleet_codes=codes,
                kills=[(round(t - t0, 3), n) for t, n in kills],
                fives=[dict(at_s=round(e["t"] - t0, 3), source=e["source"])
                       for e in events])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", required=True,
                    choices=("lightgbm_tpu", "lightgbm_tpu_torch"))
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--heavy", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    out = args.out or os.path.join(ROOT, "build",
                                   f"fleet_chaos_5xx_{args.package}.json")
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for r in range(args.runs):
            res = one_run(args.package, r, tmp, args.heavy)
            runs.append(res)
            print(f"{args.package} run {r}: {res['sent']} sent, client "
                  f"{res['client_codes']} + {res['connect_errors']} "
                  f"connection errors; fleet {res['fleet_codes']}; kills "
                  f"{res['kills']}", flush=True)
            for e in res["fives"]:
                print(f"  5xx at {e['at_s']} s: {e['source']}", flush=True)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as fh:
        json.dump(runs, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
