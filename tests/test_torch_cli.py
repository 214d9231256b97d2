"""The port's command line (``python -m lightgbm_tpu_torch``) held against
the reference's (``lightgbm_tpu/cli.py``): the same conf file through both
CLIs writes the same model file, and the predict, refit and
convert_model tasks agree.  The runs take ``device_type=cpu`` (the plain
versions of the kernels); quantized training on the wave grower, whose
model text is byte-identical across the packages.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu.cli import main as ref_main
from lightgbm_tpu_torch.cli import main as port_main
from lightgbm_tpu_torch.cli import parse_cli_args
from lightgbm_tpu_torch.io_utils import load_data_file

# many small tensor ops per test and several test processes: one
# intra-op thread each (faster than a pool per process here)
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "examples", "binary_classification")
CONF = os.path.join(EXAMPLE, "train.conf")
EXTRA = ("num_trees=5", "num_leaves=15", "verbosity=-1", "device_type=cpu",
         "tpu_histogram_impl=pallas", "tree_grow_mode=wave",
         "use_quantized_grad=true", "stochastic_rounding=false")


def _train(main, tmp_path, name, extra=EXTRA):
    out = str(tmp_path / name)
    cwd = os.getcwd()
    os.chdir(EXAMPLE)
    try:
        assert main([f"config={CONF}", f"output_model={out}", *extra]) == 0
    finally:
        os.chdir(cwd)
    return out


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """The reference's and the port's model files of one conf, each
    trained to the same ``output_model`` (the params dump records it) and
    then copied apart."""
    d = tmp_path_factory.mktemp("cli")
    texts = []
    for main, name in ((ref_main, "ref.txt"), (port_main, "port.txt")):
        texts.append(open(_train(main, d, "model.txt")).read())
        with open(str(d / name), "w") as fh:
            fh.write(texts[-1])
    return str(d / "ref.txt"), str(d / "port.txt")


def test_the_same_conf_writes_the_reference_model_file(models):
    ref, port = models
    assert open(port).read() == open(ref).read()


def test_predict_task_matches_reference(models, tmp_path):
    ref, port = models
    data = os.path.join(EXAMPLE, "binary.test")
    outs = []
    for main, model, name in ((ref_main, ref, "r.txt"),
                              (port_main, port, "p.txt")):
        out = str(tmp_path / name)
        assert main(["task=predict", f"data={data}", f"input_model={model}",
                     f"output_result={out}", "verbosity=-1",
                     "device_type=cpu"]) == 0
        outs.append(np.loadtxt(out))
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-6, atol=1e-9)
    X, _, _ = load_data_file(data, {})
    bst = lt.Booster(model_file=port, params={"device_type": "cpu"})
    np.testing.assert_allclose(outs[1], bst.predict(X), rtol=1e-6)


def test_refit_and_convert_match_reference(models, tmp_path):
    ref, port = models
    data = os.path.join(EXAMPLE, "binary.train")
    refit = []
    for main, model, name in ((ref_main, ref, "r.txt"),
                              (port_main, port, "p.txt")):
        out = str(tmp_path / name)
        assert main(["task=refit", f"data={data}", f"input_model={model}",
                     f"output_model={out}", "refit_decay_rate=0.5",
                     "verbosity=-1", "device_type=cpu"]) == 0
        refit.append(out)
    X, _, _ = load_data_file(data, {})
    np.testing.assert_allclose(
        lt.Booster(model_file=refit[1],
                   params={"device_type": "cpu"}).predict(X),
        lgb.Booster(model_file=refit[0]).predict(X), rtol=1e-5, atol=1e-7)
    code = []
    for main, model, name in ((ref_main, ref, "r.cpp"),
                              (port_main, port, "p.cpp")):
        out = str(tmp_path / name)
        assert main(["task=convert_model", f"input_model={model}",
                     f"convert_model={out}", "verbosity=-1",
                     "device_type=cpu"]) == 0
        code.append(open(out).read())
    assert code[1] == code[0] and "PredictRaw" in code[1]


def test_subprocess_entry_point_writes_train_s_model(tmp_path):
    """The CLI's ``main`` in a subprocess that cannot import jax or the
    reference writes the model ``train()`` writes from the same params."""
    out = str(tmp_path / "m.txt")
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['lightgbm_tpu'] = None\n"
            "from lightgbm_tpu_torch.cli import main\n"
            f"sys.exit(main(sys.argv[1:]))\n")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    subprocess.run([sys.executable, "-c", code, f"config={CONF}",
                    f"output_model={out}", *EXTRA], cwd=EXAMPLE, env=env,
                   check=True, timeout=300)
    params = parse_cli_args([f"config={CONF}", f"output_model={out}",
                             *EXTRA])
    X, _, y = load_data_file(os.path.join(EXAMPLE, "binary.train"), params)
    ds = lt.Dataset(X, y, params=params)
    ds.set_weight(np.loadtxt(os.path.join(EXAMPLE, "binary.train.weight")))
    bst = lt.train(params, ds, 5)
    bst.save_model(str(tmp_path / "api.txt"))
    assert open(out).read() == open(str(tmp_path / "api.txt")).read()


@pytest.mark.parametrize("argv", [
    ["serve", "model.txt"], ["serve-fleet", "model.txt"],
    ["lint-trace"], ["lint-mem"], ["task=serve", "input_model=m.txt"],
    ["profile", "telemetry_out=t.json"]])
def test_unported_verbs_raise_naming_roadmap(argv):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_main(argv)


def test_profile_verb_writes_a_torch_profiler_capture(tmp_path):
    prof = tmp_path / "prof"
    out = str(tmp_path / "m.txt")
    cwd = os.getcwd()
    os.chdir(EXAMPLE)
    try:
        assert port_main(["profile", f"config={CONF}", f"output_model={out}",
                          f"profile_dir={prof}", *EXTRA[:4]]) == 0
    finally:
        os.chdir(cwd)
    assert os.path.exists(out)
    assert (prof / "trace.json").stat().st_size > 0
    assert "Self CPU" in (prof / "profile.txt").read_text()
