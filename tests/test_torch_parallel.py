"""The port's distributed training held against the JAX package.

One world of 2 port processes over gloo (``device="cpu"``) is started
once for the module (``distributed.init``; the pattern of
tests/test_multiprocess.py:27-70 for the reference) and every suite
trains inside it: the data-parallel learner (wave grower: quantized with
stochastic rounding off and on, exact; scatter merge on and off; the
masked grower; the wave options of tests/test_parallel.py:53-157), the
voting learner at 2k >= F and 2k < F, the feature-parallel learner,
``pre_partition`` shards (dense, streamed, sparse, linear trees) and
``tree_learner=auto``.  Each rank writes its model text, its predictions
and its collective tallies; the tests compare them here with the
reference's learners on this process's 8-device CPU mesh at
``num_devices=2`` (tests/conftest.py) and with the port's serial
learner:

* quantized data-parallel text (scatter on and off, stochastic rounding
  off and on), voting at 2k < F, and pre_partition dense and streamed
  text: byte-identical to the reference;
* exact data-parallel text: identical to the port's serial text (the
  ranks merge int64 fixed-point sums on one global scale); against the
  reference the same structure and predictions within 2e-5, the
  reference's own parallel tolerance;
* voting at 2k >= F: the data-parallel and serial trees;
* every case: the two ranks' texts and collective tallies identical.

Every wait on the world has its own timeout: a rank that hangs in a
collective fails the module, it never skips.
"""

import contextlib
import functools
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, F, ROUNDS, X_ROUNDS = 5000, 6, 4, 3
WORLD_TIMEOUT = 420

BASE = dict(objective="binary", num_leaves=15, verbosity=-1,
            tpu_histogram_impl="pallas", tree_grow_mode="wave",
            use_quantized_grad=True, stochastic_rounding=False,
            tree_learner="data", num_devices=2)
SMALL = dict(objective="binary", num_leaves=7, min_data_in_leaf=5,
             verbosity=-1, tree_grow_mode="wave", tree_learner="data",
             num_devices=2)
# scripts/multihost_smoke.py's job without leaf renewal: renewal refits
# leaves from exact sums, which the port carries in fixed point and the
# reference in f32 (tests/test_torch_slice.py: leaf values within 1e-4)
PP = dict(objective="binary", num_leaves=7, min_data_in_leaf=5,
          verbosity=-1, tree_learner="data", tree_grow_mode="wave",
          use_quantized_grad=True, stochastic_rounding=False,
          pre_partition=True, num_devices=2)
PR = dict(objective="regression", num_leaves=7, min_data_in_leaf=5,
          verbosity=-1, tree_learner="data", pre_partition=True,
          num_devices=2)

# name -> (params, data, rounds); "dense" is _data(), "multi" its
# 3-class labels
CASES = {
    "q": (BASE, "dense", ROUNDS),
    "q_psum": (dict(BASE, tpu_dp_hist_scatter=False), "dense", ROUNDS),
    "q_sr": (dict(BASE, stochastic_rounding=True), "dense", ROUNDS),
    "exact": (dict(BASE, use_quantized_grad=False), "dense", ROUNDS),
    "exact_psum": (dict(BASE, use_quantized_grad=False,
                        tpu_dp_hist_scatter=False), "dense", ROUNDS),
    "masked": (dict(BASE, use_quantized_grad=False,
                    tree_grow_mode="partition"), "dense", ROUNDS),
    "vote3": (dict(BASE, tree_learner="voting", top_k=3), "dense", ROUNDS),
    "vote2": (dict(BASE, tree_learner="voting", top_k=2), "dense", ROUNDS),
    "feature": (dict(BASE, tree_learner="feature", use_quantized_grad=False,
                     tree_grow_mode="auto"), "dense", ROUNDS),
    "auto": (dict(BASE, tree_learner="auto"), "dense", ROUNDS),
    "x_extra_trees": (dict(SMALL, extra_trees=True), "dense", X_ROUNDS),
    "x_bynode": (dict(SMALL, feature_fraction_bynode=0.5), "dense",
                 X_ROUNDS),
    "x_cegb": (dict(SMALL, cegb_tradeoff=0.5, cegb_penalty_split=0.05),
               "dense", X_ROUNDS),
    "x_interaction": (dict(SMALL, interaction_constraints="[0,3],[1,2]"),
                      "dense", X_ROUNDS),
    "x_bagging": (dict(SMALL, bagging_fraction=0.6, bagging_freq=1),
                  "dense", X_ROUNDS),
    "x_goss": (dict(SMALL, boosting="goss", top_rate=0.3, other_rate=0.2,
                    learning_rate=0.5), "dense", X_ROUNDS),
    "x_multiclass": (dict(SMALL, objective="multiclass", num_class=3,
                          bagging_fraction=0.7, bagging_freq=1), "multi",
                     X_ROUNDS),
    # the speculative ramp (31 leaves >= 3 x wave 8) on SPEC_N rows with
    # a 4,096-row subsample budget: the one-process subsample strides 5
    "q_spec": (dict(BASE, num_leaves=31, tpu_wave_size=8), "spec", ROUNDS),
    "exact_spec": (dict(BASE, num_leaves=31, tpu_wave_size=8,
                        use_quantized_grad=False), "spec", ROUNDS),
}
SPEC_N, SPEC_SUBSAMPLE = 20000, 4096
PP_CASES = ("pp_dense", "pp_stream", "pp_sparse", "pp_linear")

_WORKER = textwrap.dedent("""
    import json, sys
    rank, port, outdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    sys.path.insert(0, {repo!r}); sys.path.insert(0, {tests!r})
    import numpy as np
    import scipy.sparse as sp
    import torch
    torch.set_num_threads(1)
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ingest.source import ArraySource
    from test_torch_parallel import (CASES, PP, PR, N, ROUNDS, _case_data,
                                     _data, _reg_data, _spec_budget)
    lt.distributed.init(coordinator_address="127.0.0.1:" + port,
                        num_processes=2, process_id=rank)

    def save(name, bst, X):
        with open(f"{{outdir}}/{{name}}_{{rank}}.txt", "w") as fh:
            fh.write(bst.model_to_string())
        np.save(f"{{outdir}}/{{name}}_{{rank}}.npy", bst.predict(X))
        with open(f"{{outdir}}/{{name}}_{{rank}}.json", "w") as fh:
            json.dump(bst.train_record.snapshot()["collectives_traced"], fh)

    X, y = _data()
    for name, (params, data, rounds) in CASES.items():
        Xc, yc = _case_data(data)
        with _spec_budget(data):
            save(name, lt.train(dict(params), lt.Dataset(Xc, yc), rounds,
                                device="cpu"), Xc)
    from lightgbm_tpu_torch.parallel.voting_parallel import (
        QuantizedGradUnsupportedError)
    try:
        lt.train(dict(CASES["vote2"][0], tree_grow_mode="partition"),
                 lt.Dataset(X, y), 1, device="cpu")
        raised = "nothing"
    except QuantizedGradUnsupportedError as e:
        raised = type(e).__name__
    with open(f"{{outdir}}/masked_voting_{{rank}}.txt", "w") as fh:
        fh.write(raised)
    lo, hi = (0, N // 2) if rank == 0 else (N // 2, N)
    save("pp_dense", lt.train(dict(PP), lt.Dataset(X[lo:hi], y[lo:hi]),
                              ROUNDS, device="cpu"), X)
    sd = lt.StreamedDataset(ArraySource(X[lo:hi], y[lo:hi], chunk_rows=256),
                            params=dict(PP))
    save("pp_stream", lt.train(dict(PP), sd, ROUNDS, device="cpu"), X)
    Xr, yr = _reg_data()
    Xs = Xr.copy()
    Xs[np.abs(Xs) < 0.6] = 0.0
    save("pp_sparse", lt.train(dict(PR), lt.Dataset(
        sp.csr_matrix(Xs[lo:hi]), yr[lo:hi]), ROUNDS, device="cpu"), Xs)
    save("pp_linear", lt.train(dict(PR, linear_tree=True), lt.Dataset(
        Xr[lo:hi], yr[lo:hi]), ROUNDS, device="cpu"), Xr)
    lt.distributed.shutdown()
""")


def _data(seed=0, n=N):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F)
    X[rng.rand(n, F) < 0.05] = np.nan
    x0, x1 = np.nan_to_num(X[:, 0]), np.nan_to_num(X[:, 1])
    y = (x0 + x1 ** 2 + 0.3 * rng.randn(n) > 0.8).astype(float)
    return X, y


def _multi():
    return np.random.RandomState(5).randint(0, 3, N).astype(float)


def _case_data(kind):
    """(X, y) of a case's data kind."""
    if kind == "spec":
        return _data(seed=3, n=SPEC_N)
    X, y = _data()
    return X, (_multi() if kind == "multi" else y)


@contextlib.contextmanager
def _spec_budget(kind):
    """The speculative ramp's row-subsample budget cut to 4,096 rows for
    the ``spec`` cases (1 << 19 by default, more rows than a CPU test
    trains), so the subsample strides."""
    if kind != "spec":
        yield
        return
    from lightgbm_tpu_torch.learner import wave
    orig = wave.make_wave_grow_fn
    wave.make_wave_grow_fn = functools.partial(orig,
                                               spec_subsample=SPEC_SUBSAMPLE)
    try:
        yield
    finally:
        wave.make_wave_grow_fn = orig


def _reg_data():
    rng = np.random.RandomState(23)
    X = rng.randn(N, F)
    return X, X[:, 0] * 2 - X[:, 1] + 0.3 * rng.randn(N)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The 2-rank gloo world: launched once, every case's text,
    predictions and tallies saved under the returned directory.  Each
    rank has its own timeout; a hang kills both and fails."""
    outdir = tmp_path_factory.mktemp("torch_world")
    script = outdir / "worker.py"
    script.write_text(_WORKER.format(repo=REPO,
                                     tests=os.path.join(REPO, "tests")))
    port = str(_free_port())
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(r), port,
                               str(outdir)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=WORLD_TIMEOUT)[0].decode())
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"a rank of the port's world hung for "
                        f"{WORLD_TIMEOUT} s (a collective one rank issued "
                        f"and the other did not)")
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{out[-4000:]}"
    return outdir


def _text(world, name, rank=0):
    return (world / f"{name}_{rank}.txt").read_text()


def _pred(world, name, rank=0):
    return np.load(world / f"{name}_{rank}.npy")


def _trees(text):
    """The tree blocks of a model text (its parameters block names the
    learner)."""
    return text[text.index("Tree="):text.index("end of trees")]


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The reference's learner at num_devices=2 on this process's CPU
    mesh, trained on the case's data: (model text, predictions)."""
    import lightgbm_tpu as lgb
    params, data, rounds = CASES[name]
    X, y = _case_data(data)
    bst = lgb.train(dict(params), lgb.Dataset(X, y), rounds)
    return bst.model_to_string(), bst.predict(X)


@functools.lru_cache(maxsize=None)
def _serial(name):
    """The port's serial learner on the case: its model text."""
    params, data, rounds = CASES[name]
    X, y = _case_data(data)
    p = dict(params, tree_learner="serial", num_devices=0)
    with _spec_budget(data):
        return lt.train(p, lt.Dataset(X, y), rounds,
                        device="cpu").model_to_string()


_FIELDS = ("num_leaves", "split_feature", "threshold", "decision_type",
           "left_child", "right_child", "leaf_count", "internal_count")


def _structure(text):
    out = []
    for block in text.split("Tree=")[1:]:
        body = block.split("\n\n")[0]
        kv = dict(ln.split("=", 1) for ln in body.splitlines()[1:]
                  if "=" in ln)
        out.append({k: kv.get(k) for k in _FIELDS})
    return out


@pytest.mark.parametrize("name", list(CASES) + list(PP_CASES))
def test_ranks_agree(world, name):
    """Both ranks write the same model text and issue the same
    collectives, site by site (count and bytes)."""
    assert _text(world, name, 0) == _text(world, name, 1)
    np.testing.assert_array_equal(_pred(world, name, 0),
                                  _pred(world, name, 1))
    t0 = json.loads((world / f"{name}_0.json").read_text())
    t1 = json.loads((world / f"{name}_1.json").read_text())
    assert t0 == t1 and t0


@pytest.mark.parametrize("name", ["q", "q_psum"])
def test_quantized_data_parallel_matches_reference_and_serial(world, name):
    """Quantized data-parallel text, scatter merge on and off: byte for
    byte the reference's data-parallel learner at num_devices=2, and
    the port's serial trees (int32 sums under global scales add
    exactly)."""
    assert _text(world, name) == _reference(name)[0]
    assert _trees(_text(world, name)) == _trees(_serial(name))


def test_stochastic_rounding_data_parallel_matches_reference(world):
    """Stochastic rounding: each rank folds its rank into the tree's key
    and draws over its block of rows, the reference's shard layout, so
    the text is the reference's at the same world size."""
    assert _text(world, "q_sr") == _reference("q_sr")[0]


@pytest.mark.parametrize("name", ["exact", "exact_psum"])
def test_exact_data_parallel_is_serial(world, name):
    """Exact data-parallel text equals the port's serial text (integer
    merge); against the reference (which sums f32 hi+lo) the structure
    is the same and predictions agree within 2e-5."""
    assert _trees(_text(world, name)) == _trees(_serial(name))
    ref_text, ref_pred = _reference(name)
    assert _structure(_text(world, name)) == _structure(ref_text)
    np.testing.assert_allclose(_pred(world, name), ref_pred, atol=2e-5)


@pytest.mark.parametrize("name", ["q_spec", "exact_spec"])
def test_speculative_ramp_data_parallel_is_serial(world, name):
    """Under the speculative ramp each rank takes the one-process
    subsample's rows in its block, so the merged provisional histograms,
    and the trees, are the serial learner's (quantized and exact)."""
    assert _trees(_text(world, name)) == _trees(_serial(name))


def test_masked_data_parallel_matches_reference(world):
    """The masked sequential grower (tree_grow_mode=partition under
    tree_learner=data): the reference's masked learner's structure,
    predictions within 2e-5."""
    ref_text, ref_pred = _reference("masked")
    assert _structure(_text(world, "masked")) == _structure(ref_text)
    np.testing.assert_allclose(_pred(world, "masked"), ref_pred, atol=2e-5)


@pytest.mark.parametrize("name", [n for n in CASES if n.startswith("x_")])
def test_wave_options_match_reference(world, name):
    """extra_trees, by-node sampling, CEGB, interaction constraints,
    bagging, GOSS and multiclass under tree_learner=data: the
    reference's data-parallel predictions within tests/test_parallel.py's
    tolerances (5e-5 for multiclass with bagging, else 2e-5)."""
    atol = 5e-5 if name == "x_multiclass" else 2e-5
    np.testing.assert_allclose(_pred(world, name), _reference(name)[1],
                               atol=atol)


def test_voting_at_2k_covering_f_is_data_parallel(world):
    """Voting at top_k=3, F=6 (2k >= F): every feature is voted in, so
    the trees are the data-parallel learner's and the serial learner's
    (reference tests/test_wave_voting.py:94-121)."""
    vote = _trees(_text(world, "vote3"))
    assert vote == _trees(_text(world, "q"))
    assert vote == _trees(_serial("q"))


def test_voting_matches_reference(world):
    """Voting at top_k=2 (2k < F): the reference's voting learner's text
    byte for byte (quantized)."""
    assert _text(world, "vote2") == _reference("vote2")[0]


def test_masked_voting_refuses_quantized_gradients(world):
    """The masked voting grower cannot train quantized: asking for it
    (tree_grow_mode=partition) raises on every rank, as the reference's
    QuantizedGradUnsupportedError, before any collective."""
    for r in range(2):
        assert (world / f"masked_voting_{r}.txt").read_text() == \
            "QuantizedGradUnsupportedError"


def test_feature_parallel_matches_reference(world):
    """The feature-parallel learner (exact, masked grower): the
    reference's structure, predictions within 2e-5."""
    ref_text, ref_pred = _reference("feature")
    assert _structure(_text(world, "feature")) == _structure(ref_text)
    np.testing.assert_allclose(_pred(world, "feature"), ref_pred, atol=2e-5)


def test_auto_resolves_to_data_parallel(world):
    """tree_learner=auto in a world of 2: voting is not favored below 4
    ranks, so the data-parallel learner trains the same trees."""
    text = _text(world, "auto")
    assert "[tree_learner: data]" in text
    assert _trees(text) == _trees(_text(world, "q"))


@pytest.mark.parametrize("world_size", [2, 4, 8, 64])
@pytest.mark.parametrize("shape", [(28, 255, 20), (6, 63, 3), (2000, 255, 8)])
def test_auto_rule_matches_reference(world_size, shape):
    """``voting_favored`` and ``modeled_pass_bytes`` are the reference's
    model, number for number."""
    from lightgbm_tpu.parallel import voting_parallel as ref_vp
    from lightgbm_tpu_torch.parallel import voting_parallel as vp
    f, b, k = shape
    assert vp.voting_favored(f, b, k, world_size) == \
        ref_vp.voting_favored(f, b, k, world_size)
    assert vp.modeled_pass_bytes(f, b, k, world_size) == \
        ref_vp.modeled_pass_bytes(f, b, k, world_size)
    assert vp.AUTO_VOTING_MIN_WORLD == ref_vp.AUTO_VOTING_MIN_WORLD


@functools.lru_cache(maxsize=None)
def _reference_pp():
    import lightgbm_tpu as lgb
    X, y = _data()
    return lgb.train(dict(PP), lgb.Dataset(X, y), ROUNDS).model_to_string()


@pytest.mark.parametrize("name", ["pp_dense", "pp_stream"])
def test_pre_partition_matches_reference_single_process(world, name):
    """Each rank constructs only its half of the rows, in core or
    streamed through a ChunkSource; the merged bin-finding summaries and
    the integer merge make the text the reference's single-process
    2-device run's, byte for byte (scripts/multihost_smoke.py's
    contract)."""
    assert _text(world, name) == _reference_pp()


@pytest.mark.parametrize("name", ["pp_sparse", "pp_linear"])
def test_pre_partition_sparse_and_linear_learn(world, name):
    """Sparse shards (gathered nonzero samples, global zero fractions)
    and linear trees on shards: finite predictions that learn the target
    (tests/test_multiprocess.py:192-222's checks)."""
    X, y = _reg_data()
    p = _pred(world, name)
    assert np.isfinite(p).all()
    assert np.mean((p - y) ** 2) < np.var(y) * 0.6


def test_train_record_lists_the_reference_sites(world):
    """The data-parallel scatter run's train record names every site the
    reference's records (README "the two DP histogram-merge modes")."""
    import lightgbm_tpu as lgb
    params, _, rounds = CASES["q"]
    X, y = _data()
    ref = lgb.train(dict(params), lgb.Dataset(X, y), rounds)
    ref_sites = set(ref.train_record.snapshot()["collectives_traced"])
    got = json.loads((world / "q_0.json").read_text())
    assert ref_sites and ref_sites <= set(got)


def test_cuda_rank_without_a_card_raises(monkeypatch):
    """No fallback: a rank asked onto a card where none is usable raises
    DeviceUnavailableError before it joins any group."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(lt.DeviceUnavailableError):
        lt.distributed.init(coordinator_address="127.0.0.1:1",
                            num_processes=2, process_id=0,
                            local_device_ids=[0])
    assert not lt.distributed.is_initialized()


def test_mesh_of_one_process():
    """Without ``distributed.init`` the mesh is one rank: its collectives
    return their operands, and a mesh cut to another size raises."""
    from lightgbm_tpu_torch.parallel import mesh
    m = mesh.get_mesh(0)
    assert (m.world, m.rank) == (1, 0)
    v = torch.arange(6, dtype=torch.int64).reshape(2, 3)
    for op in (mesh.psum, mesh.pmax, mesh.pmin):
        assert torch.equal(op(v, "test/site"), v)
    assert torch.equal(mesh.psum_scatter(v, "test/site", dim=1), v)
    assert mesh.all_gather(v, "test/site").shape == (1, 2, 3)
    with pytest.raises(ValueError, match="num_devices=2"):
        mesh.get_mesh(2)
