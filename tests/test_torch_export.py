"""The port's model export against its own eager forward and the JAX
package's artifacts, on the CPU.

- ``export/pt2.py``: the ``.pt2`` program at batch 1, 2 and 5 (a symbolic
  batch) against the eager CPU forward within 1e-6, for PointNet, PointNet++
  and DGCNN; against the JAX package's ``export_stablehlo`` artifact
  (``call``) on the same weights within 1e-4 (the repo's logit-parity
  bar); loaded and run by a process that imports no module of the port.
- ``export/cli.py`` from a torch ``best/model.pt``, every family
  (``tests/test_export.py:104,165``): exit 0, an ONNX file the interpreter
  runs within 1e-4 of the eager forward, a ``.pt2`` within 1e-6.
- The trainer: a one-epoch stage writes both artifacts from its best
  weights, in f32 and in bf16 compute; a failing export is logged and the
  stage still completes.
- FPS under ``torch.export``: one ``while_loop``, picks equal to the
  kernel's plain version.
- ``export/onnx_bridge.py``: the native writer and the JAX bridge's
  advisory; ``verify_onnx`` through the native interpreter.
- ``export/keras_compat.py``: Keras-shaped objects (the reference's
  attribute names and ``get_weights()``) through both packages give the
  same weights, which load into the port's models.

Sizes: 5 classes, 4 parts, 64 points (32 for the CLI).
"""

import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudprocessing_tpu.export import keras_compat as jax_keras
from pointcloudprocessing_tpu.export.stablehlo import export_stablehlo, load_stablehlo
from pointcloudprocessing_tpu.models import PointNet as JaxPointNet
from pointcloudprocessing_tpu.models import dgcnn as jax_dgcnn
from pointcloudprocessing_tpu.models import pointnet2 as jax_pn2
from pointcloudprocessing_tpu_torch.convert import state_dict_from_flax
from pointcloudprocessing_tpu_torch.core.config import load_config
from pointcloudprocessing_tpu_torch.core.constants import BEST_DIR, BEST_FILE
from pointcloudprocessing_tpu_torch.export import keras_compat, onnx_bridge, pt2
from pointcloudprocessing_tpu_torch.export.cli import main as export_main
from pointcloudprocessing_tpu_torch.export.onnx_native import parse_model, run_onnx
from pointcloudprocessing_tpu_torch.models import dgcnn, pointnet2
from pointcloudprocessing_tpu_torch.models.factory import model_from_config
from pointcloudprocessing_tpu_torch.models.pointnet import PointNet
from pointcloudprocessing_tpu_torch.ops.cuda.fps import fps_with_points_reference
from pointcloudprocessing_tpu_torch.ops.fps import (
    _seed_indices,
    farthest_point_sample_batch,
)
from pointcloudprocessing_tpu_torch.train.profile import TrainProfile
from test_torch_classifier import pair as classifier_pair
from test_torch_pointnet import randomize
from test_torch_train_profile import make_config

N, C, P = 64, 5, 4
EXACT = 1e-6  # the same formulation on the same CPU
ATOL = 1e-4  # the repo's logit-parity bar between implementations
FAMILIES = ("pointnet", "pointnet2", "dgcnn")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread, as the trainer tests take in the parallel suite."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _models(family):
    if family == "pointnet":
        return JaxPointNet(C, P), PointNet(C, P, device="cpu")
    if family == "pointnet2":
        return (jax_pn2.pointnet2_for_width(C, P, N, exact_knn=True),
                pointnet2.pointnet2_for_width(C, P, N, device="cpu"))
    return (jax_dgcnn.dgcnn_for_width(C, P, N, exact_knn=True),
            dgcnn.dgcnn_for_width(C, P, N, device="cpu"))


@pytest.fixture(scope="module", params=FAMILIES)
def pair(request):
    """A family's JAX model and randomized variables, and the port's twin on
    the CPU with the converted weights, in eval mode."""
    jmodel, model = _models(request.param)
    init = jax.jit(lambda r, x: jmodel.init(r, x, train=False))(
        jax.random.key(0), jnp.zeros((1, N, 3), jnp.float32))
    variables = randomize({"params": init["params"],
                           "batch_stats": init["batch_stats"]}, seed=3)
    model.load_state_dict(state_dict_from_flax(variables))
    return request.param, jmodel, variables, model.eval()


@pytest.fixture(scope="module")
def exported(pair, tmp_path_factory):
    """The pair's port model exported once, with a symbolic batch, on the
    CPU: (family, JAX model, variables, model, path)."""
    path = str(tmp_path_factory.mktemp(pair[0]) / "m.pt2")
    pt2.export_program(pair[3], N, path, device="cpu")
    return (*pair, path)


def _cloud(b, seed, n=N):
    return (np.random.default_rng(seed).normal(size=(b, n, 3)) * 2.0).astype(
        np.float32)


def _eager(model, pts):
    with torch.no_grad():
        out = model(torch.from_numpy(pts))
    return [out[k].numpy() for k in
            ("classification_output", "segmentation_output", "se3")]


def _close(got, want, atol, label):
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.shape == w.shape, (label, i)
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=f"{label} {i}")


def test_pt2_symbolic_batch_matches_eager(exported):
    family, _, _, model, path = exported
    program = pt2.load_program(path).module()
    for b in (1, 2, 5):
        pts = _cloud(b, seed=b)
        _close(program(torch.from_numpy(pts)), _eager(model, pts), EXACT,
               f"{family} b={b}")


def test_pt2_matches_jax_stablehlo(exported, tmp_path):
    """The two packages' exported artifacts on the same weights, at batch 3
    (both symbolic)."""
    family, jmodel, variables, model, path = exported
    hlo = str(tmp_path / "m.stablehlo")
    export_stablehlo(jmodel, variables, N, hlo)
    pts = _cloud(3, seed=7)
    want = [np.asarray(a) for a in load_stablehlo(hlo).call(pts)]
    _close(pt2.load_program(path).module()(torch.from_numpy(pts)), want, ATOL,
           family)


def test_fixed_batch_export(tmp_path):
    model = PointNet(C, P, vanilla=True, device="cpu").eval()
    path = str(tmp_path / "m.pt2")
    pt2.export_program(model, N, path, batch_size=4, device="cpu")
    pts = _cloud(4, seed=0)
    _close(pt2.load_program(path).module()(torch.from_numpy(pts)),
           _eager(model, pts), EXACT, "b=4")


def test_export_program_defaults_to_cuda(tmp_path):
    model = PointNet(C, P, vanilla=True, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt2.export_program(model, N, str(tmp_path / "m.pt2"))


_LOADER = """
import json, sys
import numpy as np
import torch
program = torch.export.load(sys.argv[1]).module()
pts = np.load(sys.argv[2])
with torch.no_grad():
    out = program(torch.from_numpy(pts))
np.savez(sys.argv[3], *[o.numpy() for o in out])
mods = sorted(m for m in sys.modules
              if m.split(".")[0] in ("pointcloudprocessing_tpu_torch",
                                     "pointcloudprocessing_tpu"))
print(json.dumps(mods))
"""


def test_pt2_loads_without_the_port(exported, tmp_path):
    """A process that never imports the port (run outside the repo) loads
    and runs the program at batch 2."""
    family, _, _, model, path = exported
    pts = _cloud(2, seed=11)
    np.save(tmp_path / "pts.npy", pts)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _LOADER, path, str(tmp_path / "pts.npy"),
         str(tmp_path / "out.npz")],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
    with np.load(tmp_path / "out.npz") as got:
        _close([got[f"arr_{i}"] for i in range(3)], _eager(model, pts), EXACT,
               family)


def _config(tmp_path, family, width):
    config = {
        "info": {"name": f"cli_{family}",
                 "class_labels": {"0": "a", "1": "b", "2": "c"},
                 "part_labels": {"0": "x", "1": "y"},
                 "training_profiles": {}},
        "params": {"input_width": width, "epochs": 1, "patience": 1,
                   "batch_size": 2, "model": family,
                   "vanilla": family == "pointnet"},
        "file_system": {},
    }
    path = tmp_path / f"cli_{family}_config.json"
    path.write_text(json.dumps(config))
    return str(path)


@pytest.mark.parametrize("family", FAMILIES)
def test_export_cli_from_checkpoint(tmp_path, family):
    """The CLI reads a stage's ``best/model.pt`` and the config and writes
    an ONNX file and a ``.pt2`` that match the checkpoint's eager forward."""
    width = 32
    cfg_path = _config(tmp_path, family, width)
    model = model_from_config(load_config(cfg_path), device="cpu",
                              generator=torch.Generator().manual_seed(5))
    with torch.no_grad():  # running statistics other than the init's
        for name, buf in model.named_buffers():
            buf.add_(0.05 * torch.arange(buf.numel(), dtype=buf.dtype) / buf.numel())
    os.makedirs(tmp_path / "stage" / BEST_DIR)
    torch.save(model.state_dict(), tmp_path / "stage" / BEST_DIR / BEST_FILE)
    onnx_path, pt2_path = tmp_path / "m.onnx", tmp_path / "m.pt2"
    rc = export_main([str(tmp_path / "stage"), cfg_path, str(onnx_path),
                      str(pt2_path), "--device", "cpu"])
    assert rc == 0
    pts = _cloud(2, seed=0, n=width)
    want = _eager(model.eval(), pts)
    parsed = parse_model(open(onnx_path, "rb").read())
    got = run_onnx(parsed, {"points": pts})
    _close([got[k] for k in parsed["outputs"]], want, ATOL, f"{family} onnx")
    np.testing.assert_allclose(got["classification_output"].sum(-1), 1.0, atol=1e-5)
    program = pt2.load_program(str(pt2_path)).module()
    _close(program(torch.from_numpy(pts)), want, EXACT, f"{family} pt2")


def test_export_cli_usage_and_device(tmp_path, capsys):
    assert export_main([]) == 1
    assert "export.cli" in capsys.readouterr().out
    cfg_path = _config(tmp_path, "pointnet", 32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export_main([str(tmp_path), cfg_path, str(tmp_path / "m.onnx"),
                     str(tmp_path / "m.pt2")])
    assert not (tmp_path / "m.onnx").exists()


def _stage_artifacts(tmp_path, name):
    stage_dir = tmp_path / "models" / name / "final"
    return stage_dir, stage_dir / f"{name}_final.pt2", stage_dir / f"{name}_final.onnx"


def test_trainer_stage_writes_both_artifacts(tmp_path):
    """A one-epoch stage: ``{name}_{stage}.pt2`` and ``.onnx`` from the
    best weights, each matching the eager forward of ``best/model.pt``."""
    path = make_config(tmp_path, epochs=1, stages=("final",), name="exp")
    TrainProfile(path, log_to_file=False, device="cpu").train()
    stage_dir, pt2_path, onnx_path = _stage_artifacts(tmp_path, "exp")
    cfg = load_config(path)
    model = model_from_config(cfg, device="cpu")
    model.load_state_dict(torch.load(stage_dir / BEST_DIR / BEST_FILE))
    pts = _cloud(3, seed=2, n=cfg.input_width)
    want = _eager(model.eval(), pts)
    _close(pt2.load_program(str(pt2_path)).module()(torch.from_numpy(pts)),
           want, EXACT, "trainer pt2")
    parsed = parse_model(open(onnx_path, "rb").read())
    got = run_onnx(parsed, {"points": pts})
    _close([got[k] for k in parsed["outputs"]], want, ATOL, "trainer onnx")


def test_trainer_exports_a_bf16_compute_stage(tmp_path):
    """A one-epoch stage with ``compute_dtype`` bfloat16: the ``.pt2``
    traces the bf16 forward and matches its eager run of ``best/model.pt``
    within 1e-6; the ONNX graph (f32, from the same f32 weights) matches
    the f32 eager forward within 1e-4."""
    path = make_config(tmp_path, epochs=1, stages=("final",), name="bf",
                       compute_dtype="bfloat16")
    TrainProfile(path, log_to_file=False, device="cpu").train()
    stage_dir, pt2_path, onnx_path = _stage_artifacts(tmp_path, "bf")
    cfg = load_config(path)
    weights = torch.load(stage_dir / BEST_DIR / BEST_FILE)
    pts = _cloud(3, seed=4, n=cfg.input_width)
    models = {}
    for dtype in (torch.bfloat16, None):
        models[dtype] = model_from_config(cfg, device="cpu", dtype=dtype)
        models[dtype].load_state_dict(weights)
        models[dtype].eval()
    with torch.no_grad():
        got = pt2.load_program(str(pt2_path)).module()(torch.from_numpy(pts))
        want = models[torch.bfloat16](torch.from_numpy(pts))
    for g, name in zip(got, ("classification_output", "segmentation_output", "se3")):
        assert g.dtype == want[name].dtype, name
        _close([g.float()], [want[name].float().numpy()], EXACT, f"bf16 pt2 {name}")
    parsed = parse_model(open(onnx_path, "rb").read())
    out = run_onnx(parsed, {"points": pts})
    _close([out[k] for k in parsed["outputs"]], _eager(models[None], pts), ATOL,
           "bf16 stage onnx")


class _Sampler(torch.nn.Module):
    def forward(self, points, valid):
        return farthest_point_sample_batch(points, 9, valid, start_index=2)


def test_exported_fps_is_one_loop_equal_to_the_plain_version(tmp_path):
    """Under ``torch.export`` FPS 'auto' stays one ``while_loop`` (PointNet++
    samples 512 and 128 centroids at full width; unrolled, each step would
    be a copy of the loop body in the graph) and picks exactly as the
    kernel's plain version, at a symbolic batch of 1 and 4, with invalid
    rows, an invalid seed row and a cloud of fewer valid points than
    picks."""
    n = 40
    b = torch.export.Dim("b")
    program = torch.export.export(
        _Sampler(), (torch.zeros(2, n, 3), torch.ones(2, n, dtype=torch.bool)),
        dynamic_shapes={"points": {0: b}, "valid": {0: b}})
    path = str(tmp_path / "fps.pt2")
    torch.export.save(program, path)
    loaded = torch.export.load(path)
    top = [node.target for node in loaded.graph.nodes]
    assert sum(t is torch.ops.higher_order.while_loop for t in top) == 1
    assert torch.ops.aten.minimum.default not in top  # the step: in the body
    rng = np.random.default_rng(5)
    for batch in (1, 4):
        pts = torch.from_numpy(_cloud(batch, seed=batch, n=n))
        valid = torch.from_numpy(rng.random((batch, n)) > 0.3)
        valid[0, 2] = False
        if batch > 1:
            valid[1] = False
            valid[1, 30:34] = True
        want = fps_with_points_reference(pts, 9, valid, _seed_indices(valid, 2))[0]
        got = loaded.module()(pts, valid)
        assert got.dtype == torch.int32
        assert torch.equal(got, want), batch


def test_trainer_logs_a_failed_export(tmp_path, monkeypatch):
    def refuse(*args, **kwargs):
        raise RuntimeError("no exporter here")

    monkeypatch.setattr(pt2, "export_pointnet", refuse)
    monkeypatch.setattr(onnx_bridge, "export_onnx", refuse)
    path = make_config(tmp_path, epochs=1, stages=("final",), name="nox")
    tp = TrainProfile(path, log_to_file=False, device="cpu")
    messages = []
    handler = types.SimpleNamespace(level=0, handle=lambda r: messages.append(
        r.getMessage()))
    tp._log.addHandler(handler)
    try:
        history = tp.train()["final"]
    finally:
        tp._log.removeHandler(handler)
    assert len(history["loss"]) == 1
    stage_dir, pt2_path, onnx_path = _stage_artifacts(tmp_path, "nox")
    assert (stage_dir / BEST_DIR / BEST_FILE).exists()
    assert not pt2_path.exists() and not onnx_path.exists()
    assert any(m.startswith(".pt2 export skipped: RuntimeError") for m in messages)
    assert any(m.startswith("ONNX export skipped: RuntimeError") for m in messages)


def test_onnx_bridge_native_writer(tmp_path):
    model = PointNet(3, 2, vanilla=True, device="cpu").eval()
    messages = []
    path = str(tmp_path / "m.onnx")
    assert onnx_bridge.export_onnx(model, 8, path, print_func=messages.append)
    assert messages[0] == onnx_bridge.GATING_MESSAGE
    out = run_onnx(parse_model(open(path, "rb").read()),
                   {"points": np.zeros((2, 8, 3), np.float32)})
    assert out["classification_output"].shape == (2, 3)
    outs = onnx_bridge.verify_onnx(path, np.zeros((1, 8, 3)),
                                   print_func=messages.append)
    assert outs is not None and outs[0].shape == (1, 3)
    assert onnx_bridge.verify_onnx(str(tmp_path / "missing.onnx"), np.zeros(
        (1, 8, 3)), print_func=messages.append) is None
    assert not onnx_bridge.export_onnx(torch.nn.Linear(3, 3), 8, path,
                                       print_func=messages.append)


# -- Keras weight interop ----------------------------------------------------

class _KerasLayer:
    """A Keras layer: its weights as ``get_weights()`` lists them."""

    def __init__(self, weights):
        self._weights = [np.asarray(w) for w in weights]

    def get_weights(self):
        return list(self._weights)


def _keras_block(params, stats, conv: bool):
    """A reference ConvLayer / DenseLayer holding a Flax block's weights."""
    inner = params["conv" if conv else "dense"]
    kernel = np.asarray(inner["kernel"])
    if conv:
        kernel = kernel.reshape(1, 1, *kernel.shape)
    weights = [kernel] + ([inner["bias"]] if "bias" in inner else [])
    block = types.SimpleNamespace(apply_bn="bn" in params, bn=None)
    setattr(block, "conv" if conv else "dense", _KerasLayer(weights))
    if "bn" in params:
        block.bn = _KerasLayer([params["bn"]["scale"], params["bn"]["bias"],
                                stats["bn"]["mean"], stats["bn"]["var"]])
    return block


def _keras_object(variables):
    """A Keras-shaped model over a Flax tree: every block by its reference
    attribute name (T-Nets with ``conv_layer_N``, ``dense_layer_N``, ``w``,
    ``b``)."""
    params, stats = variables["params"], variables["batch_stats"]

    def block(name, tree_p, tree_s):
        sub_p, sub_s = tree_p[name], tree_s.get(name, {})
        if "w" in sub_p:  # a T-Net
            tnet = types.SimpleNamespace(w=sub_p["w"], b=sub_p["b"])
            for child in sub_p:
                if child not in ("w", "b"):
                    setattr(tnet, child, block(child, sub_p, sub_s))
            return tnet
        return _keras_block(sub_p, sub_s, conv="conv" in sub_p)

    return types.SimpleNamespace(**{name: block(name, params, stats)
                                    for name in params})


def _same_state(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("vanilla", [False, True])
def test_keras_pointnet_through_both_packages(vanilla):
    jmodel = JaxPointNet(C, P, vanilla=vanilla)
    init = jax.jit(lambda r, x: jmodel.init(r, x, train=False))(
        jax.random.key(1), jnp.zeros((1, N, 3), jnp.float32))
    variables = randomize({"params": init["params"],
                           "batch_stats": init["batch_stats"]}, seed=4)
    keras = _keras_object(variables)
    got = keras_compat.state_dict_from_keras_pointnet(keras, vanilla=vanilla)
    want = jax.tree_util.tree_map(
        np.asarray, jax_keras.flax_variables_from_keras_pointnet(keras, vanilla))
    _same_state(got, state_dict_from_flax(want))
    model = PointNet(C, P, vanilla=vanilla, device="cpu")
    model.load_state_dict(got)
    pts = _cloud(2, seed=9)
    ref = jmodel.apply(want, jnp.asarray(pts), train=False)
    _close(_eager(model.eval(), pts),
           [np.asarray(ref[k]) for k in ("classification_output",
                                         "segmentation_output", "se3")],
           ATOL, f"keras vanilla={vanilla}")


@pytest.mark.parametrize("name", ["classifier", "regressor"])
def test_keras_legacy_models_through_both_packages(name):
    _, variables, model = classifier_pair(name)
    keras = _keras_object(variables)
    if name == "classifier":
        got = keras_compat.state_dict_from_keras_classifier(keras)
        want = jax_keras.flax_variables_from_keras_classifier(keras)
    else:
        got = keras_compat.state_dict_from_keras_tnet_regressor(keras)
        want = jax_keras.flax_variables_from_keras_tnet_regressor(keras)
    want = jax.tree_util.tree_map(np.asarray, want)
    _same_state(got, state_dict_from_flax(want))
    _same_state(got, state_dict_from_flax(variables))
    model.load_state_dict(got)
