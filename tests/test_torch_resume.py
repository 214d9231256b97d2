"""Checkpoint / resume of the port held against itself and the JAX package.

The same seeded data and params go through ``lightgbm_tpu.train`` (the
wave grower with the Pallas kernels in interpret mode) and through
``lightgbm_tpu_torch.train`` on the CPU (the kernels' plain versions).

* Quantized training (stochastic rounding, bagging at
  ``bagging_freq=2``, by-node feature sampling) interrupted after round
  3 and resumed to round 8 writes model text byte-identical to the
  port's uninterrupted run and to the reference's: round 3 is not a
  multiple of the bagging period, so the resumed run redraws the mask
  of the block it stopped in.
* The bundle format is the reference's: a bundle either package writes
  resumes in the other to the same text; the snapshot files and the
  dataset fingerprints are equal.
* A SIGTERM drains the iteration, flushes a bundle and raises
  ``TrainingPreempted``; ``resume=latest`` on an empty directory starts
  fresh; the reference's refusals carry over; ``train_many`` refuses
  checkpointing and ``cv`` takes its per-fold loop; the parameters the
  port does not carry yet raise.
"""

import os
import signal
import threading

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.resilience.checkpoint import (Checkpoint,
                                                      CheckpointError,
                                                      TrainingPreempted,
                                                      load_checkpoint)

# many small tensor ops per test and several test processes: one
# intra-op thread each
torch.set_num_threads(1)

N, F, ROUNDS, CUT = 2000, 6, 8, 3
P = dict(objective="binary", num_leaves=15, max_bin=63, verbosity=-1,
         tpu_histogram_impl="pallas", tree_grow_mode="wave",
         use_quantized_grad=True, bagging_fraction=0.8, bagging_freq=2,
         feature_fraction_bynode=0.5)


def _data(seed=0, n=N):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F)
    X[rng.rand(n, F) < 0.03] = np.nan
    x0, x1 = np.nan_to_num(X[:, 0]), np.nan_to_num(X[:, 1])
    y = (x0 + x1 ** 2 + 0.3 * rng.randn(n) > 0.8).astype(float)
    return X, y


@pytest.fixture(scope="module")
def full():
    """The uninterrupted runs: (port text, reference text)."""
    X, y = _data()
    port = lt.train(P, lt.Dataset(X, y), ROUNDS, device="cpu")
    ref = lgb.train(P, lgb.Dataset(X, y), ROUNDS)
    return port.model_to_string(), ref.model_to_string()


def _interrupt(pkg, ck, params=P, **kw):
    X, y = _data()
    if pkg is lt:
        kw["device"] = "cpu"
    return pkg.train({**params, "checkpoint_dir": ck}, pkg.Dataset(X, y),
                     CUT, **kw)


def _resume(pkg, ck, params=P, rounds=ROUNDS, **kw):
    X, y = _data()
    if pkg is lt:
        kw["device"] = "cpu"
    return pkg.train({**params, "checkpoint_dir": ck, "resume": "latest"},
                     pkg.Dataset(X, y), rounds, **kw)


def test_quantized_resume_matches_uninterrupted(full, tmp_path):
    port_full, ref_full = full
    assert port_full == ref_full
    ck = str(tmp_path / "ck")
    _interrupt(lt, ck)
    assert load_checkpoint(ck).iteration == CUT
    assert _resume(lt, ck).model_to_string() == port_full


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_bundles_resume_across_packages(full, writer, tmp_path):
    """A bundle written by one package resumes in the other to the
    uninterrupted text."""
    ck = str(tmp_path / "ck")
    if writer == "reference":
        _interrupt(lgb, ck)
        got = _resume(lt, ck).model_to_string()
    else:
        _interrupt(lt, ck)
        got = _resume(lgb, ck).model_to_string()
    assert got == full[1]


def test_bundle_and_fingerprint_fields_match_reference(tmp_path):
    """The port's bundle carries the reference's fields and values: the
    iteration, the f32 scores bit for bit, the RNG seeds, the recorded
    params and the dataset fingerprint."""
    _interrupt(lt, str(tmp_path / "port"))
    _interrupt(lgb, str(tmp_path / "ref"))
    a = load_checkpoint(str(tmp_path / "port"))
    b = load_checkpoint(str(tmp_path / "ref"))
    assert a.iteration == b.iteration == CUT
    assert a.model_text == b.model_text
    np.testing.assert_array_equal(a.score, b.score)
    for k in ("rng_state", "params", "fingerprint", "valid_names",
              "prev_iter_leaves"):
        assert getattr(a, k) == getattr(b, k), k
    X, y = _data()
    assert lt.Dataset(X, y).construct().fingerprint() == \
        lgb.Dataset(X, y).construct().fingerprint()
    # and the fingerprint follows the rows
    X2 = X.copy()
    X2[0, 0] = 5.0
    assert lt.Dataset(X2, y).construct().fingerprint() != \
        lt.Dataset(X, y).construct().fingerprint()


def test_snapshots_match_reference(tmp_path):
    """``snapshot_freq`` writes ``output_model.snapshot_iter_N`` every N
    rounds, byte-identical to the reference's (one output path, so the
    params dump matches), and a bundle ring of ``checkpoint_keep``
    bundles under ``output_model.ckpt``."""
    X, y = _data()
    out = str(tmp_path / "m.txt")
    params = {**P, "snapshot_freq": 2, "output_model": out,
              "checkpoint_keep": 2}
    texts = {}
    for pkg in (lt, lgb):
        kw = {"device": "cpu"} if pkg is lt else {}
        pkg.train(params, pkg.Dataset(X, y), 5, **kw)
        names = sorted(n for n in os.listdir(tmp_path)
                       if n.startswith("m.txt.snapshot_iter_"))
        assert names == ["m.txt.snapshot_iter_2", "m.txt.snapshot_iter_4"]
        ring = sorted(n for n in os.listdir(out + ".ckpt")
                      if n.endswith(".npz"))
        assert ring == ["ckpt_iter00000002.npz", "ckpt_iter00000004.npz"]
        texts[pkg.__name__] = [open(tmp_path / n).read() for n in names]
        for n in names:
            os.unlink(tmp_path / n)
    assert texts["lightgbm_tpu_torch"] == texts["lightgbm_tpu"]


def test_checkpoint_dir_cadence_and_keep(tmp_path):
    """An explicit ``checkpoint_dir`` without ``snapshot_freq`` flushes
    every max(1, rounds // 100) rounds and keeps ``checkpoint_keep``
    bundles behind a ``LATEST`` pointer; no snapshot text is written."""
    ck = tmp_path / "ring"
    X, y = _data()
    lt.train({**P, "checkpoint_dir": str(ck), "checkpoint_keep": 2,
              "output_model": str(tmp_path / "m.txt")}, lt.Dataset(X, y),
             4, device="cpu")
    assert sorted(os.listdir(ck)) == ["LATEST", "ckpt_iter00000003.npz",
                                      "ckpt_iter00000004.npz"]
    assert open(ck / "LATEST").read().strip() == "ckpt_iter00000004.npz"
    assert not [n for n in os.listdir(tmp_path) if "snapshot" in n]


def test_sigterm_flushes_and_resumes(full, tmp_path):
    """A SIGTERM during training drains the iteration in flight, flushes
    a bundle and raises TrainingPreempted; the resumed run is the
    uninterrupted one."""
    ck = str(tmp_path / "sig")
    fired = threading.Event()

    def kill_at(env):
        if env.iteration == CUT and not fired.is_set():
            fired.set()
            os.kill(os.getpid(), signal.SIGTERM)
    kill_at.before_iteration = True

    X, y = _data()
    with pytest.raises(TrainingPreempted) as exc_info:
        lt.train({**P, "checkpoint_dir": ck}, lt.Dataset(X, y), ROUNDS,
                 callbacks=[kill_at], device="cpu")
    exc = exc_info.value
    assert exc.signum == signal.SIGTERM
    assert exc.checkpoint and os.path.exists(exc.checkpoint)
    assert load_checkpoint(ck).iteration == CUT + 1
    assert _resume(lt, ck).model_to_string() == full[0]


def test_resume_latest_cold_start(full, tmp_path):
    """``resume=latest`` on an empty directory is the job's first run."""
    ck = tmp_path / "empty"
    ck.mkdir()
    assert _resume(lt, str(ck)).model_to_string() == full[0]


def test_resume_from_missing_path_raises(tmp_path):
    """A ``resume_from`` path that does not exist raises CheckpointError,
    as the reference's load_checkpoint does, and trains nothing."""
    X, y = _data()
    missing = str(tmp_path / "nope.npz")
    with pytest.raises(CheckpointError, match="no checkpoint found"):
        lt.train(P, lt.Dataset(X, y), 2, resume_from=missing,
                 device="cpu")
    with pytest.raises(CheckpointError, match="no checkpoint found"):
        lt.train({**P, "resume": missing}, lt.Dataset(X, y), 2,
                 device="cpu")
    assert not os.path.exists(missing)


def test_resume_with_valid_set_and_early_stopping(tmp_path):
    """The valid scores, the engine's eval history and the early-stopping
    state ride the bundle: the resumed run's valid metrics, best
    iteration and text equal the uninterrupted run's."""
    X, y = _data()
    Xv, yv = _data(seed=1, n=600)
    params = {**P, "early_stopping_round": 4, "metric": "binary_logloss"}

    def run(rounds, extra, hist):
        ds = lt.Dataset(X, y)
        return lt.train({**params, **extra}, ds, rounds,
                        valid_sets=[ds.create_valid(Xv, yv)],
                        valid_names=["hold"],
                        callbacks=[lt.record_evaluation(hist)],
                        device="cpu")

    h_full, h_res = {}, {}
    full = run(ROUNDS, {}, h_full)
    ck = str(tmp_path / "es")
    run(CUT, {"checkpoint_dir": ck}, {})
    res = run(ROUNDS, {"checkpoint_dir": ck, "resume": "latest"}, h_res)
    assert res.model_to_string() == full.model_to_string()
    assert res.best_iteration == full.best_iteration
    assert h_res == h_full


@pytest.mark.parametrize("case", ["dart", "rf", "init_model", "seed",
                                  "rows", "valid_names", "early_stopping"])
def test_resume_refusals(case, tmp_path):
    """The reference's refusals: DART and RF cannot resume (their caches
    are not in the model text), ``init_model`` with a checkpoint, a
    changed seed, changed rows, other valid names and another
    early-stopping configuration raise instead of forking."""
    X, y = _data()
    ck = str(tmp_path / "ck")
    params = dict(P)
    if case in ("dart", "rf"):
        params.update(boosting=case)
        if case == "rf":
            params.update(bagging_fraction=0.6, bagging_freq=1)
    Xv, yv = _data(seed=1, n=300)
    with_valid = case in ("valid_names", "early_stopping")
    if case == "early_stopping":
        params.update(early_stopping_round=3)

    def run(extra, rounds, valid_name="hold", **kw):
        ds = lt.Dataset(X if extra.get("_rows") is None else extra["_rows"],
                        y)
        extra = {k: v for k, v in extra.items() if k != "_rows"}
        vs = dict(valid_sets=[ds.create_valid(Xv, yv)],
                  valid_names=[valid_name]) if with_valid else {}
        return lt.train({**params, **extra}, ds, rounds, device="cpu",
                        **vs, **kw)

    run({"checkpoint_dir": ck}, CUT)
    resume = {"checkpoint_dir": ck, "resume": "latest"}
    if case in ("dart", "rf"):
        with pytest.raises(ValueError, match="not supported for boosting"):
            run(resume, ROUNDS)
    elif case == "init_model":
        base = run({}, 2)
        with pytest.raises(CheckpointError, match="init_model"):
            run(resume, ROUNDS, init_model=base)
    elif case == "seed":
        with pytest.raises(CheckpointError, match="RNG seed"):
            run({**resume, "bagging_seed": 99}, ROUNDS)
    elif case == "rows":
        X2 = X.copy()
        X2[:10] = X2[:10][::-1]
        with pytest.raises(CheckpointError, match="does not match"):
            run({**resume, "_rows": X2}, ROUNDS)
    elif case == "valid_names":
        with pytest.raises(CheckpointError, match="valid sets"):
            run(resume, ROUNDS, valid_name="other")
    else:
        with pytest.raises(CheckpointError, match="stopping_rounds"):
            run({**resume, "early_stopping_round": 5}, ROUNDS)


def test_train_many_refuses_and_cv_falls_back(tmp_path, caplog):
    """``train_many`` raises the reference's CheckpointError on checkpoint
    parameters; ``cv`` catches it from its batched fast path and runs
    the per-fold loop, whose results equal the loop's own."""
    X, y = _data(n=800)
    params = {**P, "snapshot_freq": 1,
              "output_model": str(tmp_path / "m.txt")}
    with pytest.raises(CheckpointError, match="train_many"):
        lt.train_many(params, lt.Dataset(X, y), 2,
                      variants=[{"lambda_l2": 0.0}, {"lambda_l2": 1.0}],
                      device="cpu")
    got = lt.cv(params, lt.Dataset(X, y), 2, nfold=2, device="cpu")
    want = lt.cv({**params, "tpu_cv_many": False}, lt.Dataset(X, y), 2,
                 nfold=2, device="cpu")
    assert got == want


@pytest.mark.parametrize("param,value", [("publish_dir", "pub"),
                                         ("publish_every", 2),
                                         ("flight_dir", "fl")])
@pytest.mark.parametrize("entry", ["train", "cv", "train_many"])
def test_unported_run_parameters_raise(entry, param, value, tmp_path):
    """``train`` carries the publish lane and the flight recorder now:
    ``publish_dir`` writes the delta journal, ``flight_dir`` the tape,
    and ``publish_every`` alone writes nothing.  ``cv`` and
    ``train_many`` have neither lane, as the reference's do not: their
    parameters raise NotImplementedError and nothing is written."""
    X, y = _data(n=400)
    if isinstance(value, str):
        value = str(tmp_path / value)
    params = {**P, param: value}
    fn = {"train": lambda: lt.train(params, lt.Dataset(X, y), 2,
                                    device="cpu"),
          "cv": lambda: lt.cv(params, lt.Dataset(X, y), 2, nfold=2,
                              device="cpu"),
          "train_many": lambda: lt.train_many(
              params, lt.Dataset(X, y), 2,
              variants=[{"lambda_l2": 0.0}], device="cpu")}[entry]
    if entry != "train":
        with pytest.raises(NotImplementedError, match="no publish lane"):
            fn()
        assert os.listdir(tmp_path) == []
        return
    fn()
    written = {"publish_dir": ["pub"], "publish_every": [],
               "flight_dir": ["fl"]}[param]
    assert sorted(os.listdir(tmp_path)) == written
    if param == "publish_dir":
        assert sorted(os.listdir(tmp_path / "pub")) == [
            "BASE.00001.txt", "DELTA.00002", "HEAD"]
    if param == "flight_dir":
        assert os.listdir(tmp_path / "fl") == ["flight.jsonl"]


def test_multiclass_resume(tmp_path):
    """Three trees an iteration: the (N, 3) scores ride the bundle."""
    X, y = _data()
    y3 = np.digitize(np.nan_to_num(X[:, 0]), [-0.4, 0.4]).astype(float)
    params = {**P, "objective": "multiclass", "num_class": 3}
    ck = str(tmp_path / "mc")

    def run(rounds, extra):
        return lt.train({**params, **extra}, lt.Dataset(X, y3), rounds,
                        device="cpu")

    full = run(5, {})
    run(2, {"checkpoint_dir": ck})
    assert load_checkpoint(ck).score.shape == (N, 3)
    res = run(5, {"checkpoint_dir": ck, "resume": "latest"})
    assert res.model_to_string() == full.model_to_string()


def test_exact_resume(tmp_path):
    """Exact training: the resumed text is the port's uninterrupted text,
    and the trees are the reference's with predictions within 1e-5 of
    their scale (ROADMAP queue 3 item 3)."""
    X, y = _data()
    params = {k: v for k, v in P.items() if k != "use_quantized_grad"}
    ck = str(tmp_path / "ex")
    full = lt.train(params, lt.Dataset(X, y), 5, device="cpu")
    lt.train({**params, "checkpoint_dir": ck}, lt.Dataset(X, y), 2,
             device="cpu")
    res = lt.train({**params, "checkpoint_dir": ck, "resume": "latest"},
                   lt.Dataset(X, y), 5, device="cpu")
    assert res.model_to_string() == full.model_to_string()
    ref = lgb.train(params, lgb.Dataset(X, y), 5)

    def fields(text, key):
        return [ln for ln in text.splitlines() if ln.startswith(key)]
    for key in ("split_feature=", "left_child=", "right_child="):
        assert fields(res.model_to_string(), key) == \
            fields(ref.model_to_string(), key)
    want = ref.predict(X)
    np.testing.assert_allclose(res.predict(X), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_checkpoint_round_trips_bytes():
    """``to_bytes`` / ``from_bytes`` keep every field bit for bit."""
    ck = Checkpoint(iteration=4, model_text="tree\n",
                    score=np.arange(6, dtype=np.float32) / 3,
                    valid_names=["v"],
                    valid_scores=[np.ones(2, np.float32)],
                    rng_state={"seed": 1}, cegb_used=np.array([True, False]),
                    prev_iter_leaves=[3])
    back = Checkpoint.from_bytes(ck.to_bytes())
    assert back.iteration == 4 and back.model_text == "tree\n"
    np.testing.assert_array_equal(back.score, ck.score)
    np.testing.assert_array_equal(back.cegb_used, ck.cegb_used)
    assert back.prev_iter_leaves == [3] and back.rng_state == {"seed": 1}
    with pytest.raises(CheckpointError, match="not a readable"):
        Checkpoint.from_bytes(b"garbage")
