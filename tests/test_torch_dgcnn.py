"""The port's DGCNN against the JAX package's: the kNN graph, the edge
tensor, every head from converted weights (full widths on tiny clouds and
the JAX tests' TINY widths, both graph modes, head subsets), the train-mode
forward with its new batch statistics, the factored edge block against the
literal one, the factory's options, the converter and the serving CLI.

JAX runs its exact kNN (``exact_knn=True``; its approximate TPU search is
not ported) and, on the CPU, its literal edge dataflow. The bar is the
repo's parity invariant, 1e-4 absolute on every head.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import CLASS_LABELS, PART_LABELS, make_collect
from pointcloudprocessing_tpu.models import dgcnn as jax_dgcnn
from pointcloudprocessing_tpu.models.dgcnn import DGCNN as JaxDGCNN
from pointcloudprocessing_tpu_torch.convert import (
    flax_from_state_dict,
    state_dict_from_flax,
)
from pointcloudprocessing_tpu_torch.models import dgcnn
from pointcloudprocessing_tpu_torch.models.dgcnn import DGCNN
from pointcloudprocessing_tpu_torch.models.pointnet import FreezeFlags
from test_torch_pointnet import randomize

C, P = 5, 4
ATOL = 1e-4  # the repo's logit-parity bar between implementations
TINY = dict(k=8, edge_widths=(8, 16), emb_width=32)  # tests/test_dgcnn.py:22-27
FULL = dict(k=20)  # (64, 64, 128, 256), 1024: the canonical widths
ALL = ("classification_output", "segmentation_output", "se3")


def _cloud(b=2, n=64, seed=0):
    return np.random.default_rng(seed).normal(size=(b, n, 3)).astype(np.float32)


def _pair(widths: dict, graph: str = "dynamic", seed: int = 0, **port_kw):
    """A JAX DGCNN with randomized variables and the port's twin on the CPU,
    loaded with the converted weights."""
    jmodel = JaxDGCNN(num_classes=C, num_parts=P, exact_knn=True, graph=graph,
                      dropout_rate=0.0, **widths)
    init = jmodel.init(jax.random.key(seed), jnp.asarray(_cloud(1, 32)),
                       train=False)
    variables = randomize({"params": init["params"],
                           "batch_stats": init["batch_stats"]}, seed)
    model = DGCNN(C, P, graph=graph, dropout_rate=0.0, **widths, **port_kw)
    model.load_state_dict(state_dict_from_flax(variables))
    return jmodel, variables, model.eval()


@pytest.fixture(scope="module", params=[
    ("full", "dynamic"), ("full", "static"), ("tiny", "dynamic"), ("tiny", "static"),
], ids=lambda p: "-".join(p))
def pair(request):
    width, graph = request.param
    return _pair(FULL if width == "full" else TINY, graph)


def test_knn_graph_matches_jax():
    """Index sets identical to the JAX package's exact graph (self
    included), in input space and in a 16-wide feature space."""
    rng = np.random.default_rng(3)
    for feats in (_cloud(2, 64, 3), rng.normal(size=(2, 64, 16)).astype(np.float32)):
        want = np.asarray(jax_dgcnn.knn_graph(jnp.asarray(feats), 7, exact=True))
        got = dgcnn.knn_graph(torch.from_numpy(feats), 7)
        assert got.dtype == torch.int32 and got.shape == (2, 64, 7)
        for g, w in zip(got.numpy().reshape(-1, 7), want.reshape(-1, 7)):
            assert set(g.tolist()) == set(w.tolist())
        assert (got.numpy() == np.arange(64)[None, :, None]).any(-1).all()


def test_edge_features_match_jax():
    x = _cloud(1, 16, 4)
    idx = np.asarray(jax_dgcnn.knn_graph(jnp.asarray(x), 4, exact=True))
    want = np.asarray(jax_dgcnn.edge_features(jnp.asarray(x), jnp.asarray(idx)))
    got = dgcnn.edge_features(torch.from_numpy(x), torch.from_numpy(idx)).numpy()
    assert got.shape == (1, 16, 4, 6)
    np.testing.assert_array_equal(got, want)


def test_heads_match_jax(pair):
    """Every head, inference, from converted weights: within 1e-4."""
    jmodel, variables, model = pair
    x = _cloud(seed=11)
    want = jmodel.apply(variables, jnp.asarray(x), train=False)
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    assert set(got) == set(want) == set(ALL)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=ATOL, err_msg=key)


@pytest.mark.parametrize("heads", [("classification_output",),
                                   ("segmentation_output", "se3")],
                         ids=["cls", "seg+se3"])
def test_head_subsets_match_jax(heads):
    jmodel, variables, model = _pair(TINY, seed=4)
    x = _cloud(seed=12)
    want = jmodel.apply(variables, jnp.asarray(x), train=False, heads=heads)
    with torch.inference_mode():
        got = model(torch.from_numpy(x), heads=heads)
    assert set(got) == set(heads)
    for key in heads:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=ATOL, err_msg=key)


def _port_stats(model) -> dict:
    return {k: v.clone() for k, v in model.state_dict().items() if "running" in k}


@pytest.mark.parametrize("frozen", [False, True], ids=["batch-stats", "frozen-trunk"])
def test_train_mode_matches_jax(frozen):
    """Train-mode forward (dropout 0): outputs, and the new running
    statistics of every BatchNorm, against JAX's ``mutable=['batch_stats']``
    apply. A frozen trunk keeps its statistics, as in the JAX package."""
    jmodel, variables, model = _pair(TINY, seed=5)
    model.train()
    freeze = FreezeFlags(shared_network=frozen)
    jfreeze = jax_dgcnn.FreezeFlags(shared_network=frozen)
    x = _cloud(seed=13)
    want, new_stats = jmodel.apply(variables, jnp.asarray(x), train=True,
                                   freeze=jfreeze, mutable=["batch_stats"])
    got = model(torch.from_numpy(x), train=True, freeze=freeze)
    for key in ALL:
        np.testing.assert_allclose(got[key].detach().numpy(),
                                   np.asarray(want[key]), rtol=0, atol=ATOL,
                                   err_msg=key)
    want_sd = state_dict_from_flax({
        "params": variables["params"],
        "batch_stats": jax.tree_util.tree_map(np.asarray, new_stats["batch_stats"])})
    for key, value in _port_stats(model).items():
        np.testing.assert_allclose(value.numpy(), want_sd[key].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=key)
    old = state_dict_from_flax(variables)
    trunk = [k for k in want_sd if k.startswith(("ec", "emb")) and "running" in k]
    assert all(torch.equal(_port_stats(model)[k], old[k]) == frozen for k in trunk)


def test_factored_edge_matches_reference_in_port():
    """The factored edge block (p_i + q_j, the max/min collapse under fixed
    statistics through ``gather_maxmin``) computes the literal dataflow's
    function from the same weights: inference, train mode (outputs and
    statistics) and a frozen trunk in train mode."""
    _, variables, ref = _pair(TINY, seed=6, edge_impl="reference")
    fac = DGCNN(C, P, edge_impl="factored", dropout_rate=0.0, **TINY)
    fac.load_state_dict(state_dict_from_flax(variables))
    fac.eval()
    x = torch.from_numpy(_cloud(seed=7))
    with torch.inference_mode():
        out_r, out_f = ref(x), fac(x)
    for key in ALL:
        np.testing.assert_allclose(out_f[key].numpy(), out_r[key].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=key)
    for freeze in (FreezeFlags(), FreezeFlags(shared_network=True)):
        ref.train(), fac.train()
        tr_r = ref(x, train=True, freeze=freeze)
        tr_f = fac(x, train=True, freeze=freeze)
        np.testing.assert_allclose(
            tr_f["segmentation_output"].detach().numpy(),
            tr_r["segmentation_output"].detach().numpy(), rtol=1e-4, atol=1e-5)
        for (key, a), b in zip(_port_stats(ref).items(), _port_stats(fac).values()):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=key)


def test_converter_round_trip_is_bit_identical():
    """DGCNN's Flax tree (ecN/l1/conv, ecN/l1/bn, emb, mlp_cls_*, the split
    kernel of mlp_seg_1) maps both ways with no new rule, every leaf onto a
    tensor of the port's model."""
    _, variables, model = _pair(FULL, seed=8)
    sd = state_dict_from_flax(variables)
    want_sd = model.state_dict()
    assert set(sd) == set(want_sd)
    for key, tensor in want_sd.items():
        assert sd[key].shape == tensor.shape, key
    back = flax_from_state_dict(sd)

    def flat(tree, prefix=()):
        for name, value in tree.items():
            if isinstance(value, dict):
                yield from flat(value, prefix + (name,))
            else:
                yield prefix + (name,), value

    want, got = dict(flat(variables)), dict(flat(back))
    assert set(got) == set(want)
    for path, arr in want.items():
        assert got[path].dtype == arr.dtype, path
        np.testing.assert_array_equal(got[path], arr, err_msg="/".join(path))


def test_options_and_errors():
    from pointcloudprocessing_tpu_torch.core.config import parse_config
    from pointcloudprocessing_tpu_torch.models.factory import model_from_config

    def cfg(model, **options):
        params = {"input_width": 64, "epochs": 1, "patience": 1,
                  "batch_size": 2, "model": model}
        if options:
            params["model_options"] = options
        return parse_config({"info": {"name": "t", "class_labels": {"0": "a"},
                                      "part_labels": {"0": "p"}},
                             "params": params})

    m = model_from_config(cfg("dgcnn", k=10, graph="static"), device="cpu")
    assert isinstance(m, DGCNN) and m.k == 10 and m.graph == "static"
    assert model_from_config(cfg("dgcnn"), device="cpu").k == 20
    with pytest.raises(ValueError, match=r"Unknown params.model_options keys "
                       r"for dgcnn: \['radius'\] \(supported: 'k', 'graph'\)"):
        model_from_config(cfg("dgcnn", radius=1.0), device="cpu")
    with pytest.raises(ValueError, match="not supported for params.model='pointnet'"):
        model_from_config(cfg("pointnet", k=10), device="cpu")
    with pytest.raises(ValueError, match="graph must be"):
        model_from_config(cfg("dgcnn", graph="staticc"), device="cpu")
    with pytest.raises(ValueError, match="edge impl"):
        DGCNN(C, P, edge_impl="factoredd", **TINY)
    with pytest.raises(ValueError, match="not supported for params.model='pointnet2'"):
        model_from_config(cfg("pointnet2", k=10), device="cpu")
    assert dgcnn.dgcnn_for_width(3, 4, 8, device="cpu").k == 8
    canonical = dgcnn.dgcnn_for_width(3, 4, 1024, device="cpu")
    assert canonical.k == 20 and canonical.edge_widths == (64, 64, 128, 256)
    for flags in ((False,) * 4, (True, False, True, False)):
        want = jax_dgcnn.layer_trainability_dgcnn(jax_dgcnn.FreezeFlags(*flags))
        got = dgcnn.layer_trainability_dgcnn(FreezeFlags(*flags))
        assert list(got.items()) == list(want.items())


def test_entry_points_default_to_cuda():
    """``model_from_config`` (every family) and ``dgcnn_for_width`` build on
    CUDA unless asked for the CPU; without CUDA (as here) the default
    raises."""
    from pointcloudprocessing_tpu_torch.core.config import parse_config
    from pointcloudprocessing_tpu_torch.models.factory import model_from_config

    assert not torch.cuda.is_available()
    for model in ("pointnet", "pointnet2", "dgcnn"):
        cfg = parse_config({"info": {"name": "t", "class_labels": {"0": "a"},
                                     "part_labels": {"0": "p"}},
                            "params": {"input_width": 32, "epochs": 1,
                                       "patience": 1, "batch_size": 2,
                                       "model": model}})
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            model_from_config(cfg)
        built = model_from_config(cfg, device="cpu")
        assert next(built.parameters()).device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dgcnn.dgcnn_for_width(3, 4, 64)


@pytest.fixture(scope="module")
def dgcnn_stage(tmp_path_factory):
    """A DGCNN stage (``"model": "dgcnn"``, k 8 in its options), randomly
    initialised, saved as training saves it and converted by the tool."""
    import orbax.checkpoint as ocp

    from pointcloudprocessing_tpu.core.config import parse_config
    from pointcloudprocessing_tpu.models.factory import model_from_config
    from test_torch_serve import _load_tool

    root = tmp_path_factory.mktemp("torch_serve_dgcnn")
    stage_dir = root / "tiny" / "final"
    os.makedirs(stage_dir)
    config = {
        "info": {"name": "tiny",
                 "class_labels": {str(i): c for i, c in enumerate(CLASS_LABELS)},
                 "part_labels": {str(i): p for i, p in enumerate(PART_LABELS)}},
        "params": {"input_width": 64, "epochs": 1, "patience": 1,
                   "batch_size": 4, "model": "dgcnn",
                   "model_options": {"k": 8}},
    }
    with open(stage_dir / "tiny_config.json", "w") as f:
        json.dump(config, f)
    model = model_from_config(parse_config(config))
    variables = model.init(jax.random.key(1), jnp.zeros((1, 64, 3)), train=False)
    ckpt = ocp.StandardCheckpointer()
    ckpt.save(str(stage_dir / "best"), {"params": variables["params"],
                                        "batch_stats": variables["batch_stats"]})
    ckpt.wait_until_finished()
    assert os.path.exists(_load_tool().convert_stage(str(stage_dir)))
    collect = make_collect(str(root / "fresh"), num_frames=6,
                           points_per_frame=40, seed=7)
    return str(stage_dir), collect, root


def test_serve_cli_serves_a_dgcnn_stage(dgcnn_stage):
    """``serve.main --device cpu`` over the DGCNN stage writes the JAX
    serving CLI's records: class, part counts, and the identity SE(3)."""
    from pointcloudprocessing_tpu.serve import main as jax_main
    from pointcloudprocessing_tpu_torch.serve import main as port_main

    stage_dir, collect, root = dgcnn_stage
    args = ["--model", stage_dir, "--input", collect, "--batch", "4",
            "--scan-width", "64", "--model-width", "32", "--voxel-size", "0.5"]
    port_out, jax_out = str(root / "port.jsonl"), str(root / "jax.jsonl")
    assert port_main([*args, "--output", port_out, "--device", "cpu"]) == 0
    assert jax_main([*args, "--output", jax_out]) == 0
    with open(port_out) as f:
        got = [json.loads(line) for line in f]
    with open(jax_out) as f:
        want = [json.loads(line) for line in f]
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g["frame"] == w["frame"]
        assert g["class"] == w["class"]
        assert g["part_counts"] == w["part_counts"]
        assert sum(g["part_counts"].values()) == 32
        np.testing.assert_array_equal(g["se3"], np.eye(3))
