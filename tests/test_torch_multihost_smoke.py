"""``scripts/port_multihost_smoke.py`` run once: two gloo processes of the
port on pre-partitioned shards, in core and streamed, write the model
text of the JAX package's single-process 2-device run byte for byte."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_multihost_smoke_is_bit_identical(tmp_path):
    out = tmp_path / "smoke.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts",
                                      "port_multihost_smoke.py"),
         "--out", str(out), "--timeout", "300"],
        env=env, capture_output=True, text=True, timeout=420)
    rec = json.loads(out.read_text())
    assert proc.returncode == 0 and rec["ok"], \
        json.dumps(rec, indent=1)[-3000:]
    assert all(rec["bit_identical"].values())
