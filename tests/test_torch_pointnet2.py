"""The port's PointNet++ against the JAX package's: the grouping, the 3-NN
interpolation, every head from converted weights (the clamped 5/4 model on
4x64 clouds and the canonical 23/12 SSG model on 2x1024, in both kNN
modes, head subsets), the train-mode forward with its new batch statistics,
the trainability report and the factory.

Both packages run FPS by the distance matrix on the CPU. JAX's approximate
kNN (``approx_min_k``, its default) returns the exact top-k set on the
CPU, and the port's kNN is exact, so the port is held to JAX in both of
its modes and the neighbour sets are compared as sets. The
bar on the heads is the repo's 1e-4; a kNN or radius-mask flip between the
two frameworks' f32 roundings may move a few segmentation rows, so at most
0.1% of them may exceed it (the DGCNN rule).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudprocessing_tpu.models import pointnet2 as jax_pn2
from pointcloudprocessing_tpu.models.pointnet import FreezeFlags as JaxFreezeFlags
from pointcloudprocessing_tpu_torch.convert import state_dict_from_flax
from pointcloudprocessing_tpu_torch.models import pointnet2
from pointcloudprocessing_tpu_torch.models.pointnet import FreezeFlags
from test_torch_pointnet import randomize

ATOL = 1e-4  # the repo's logit-parity bar between implementations
SEG_ROWS = 1e-3  # share of segmentation rows that may exceed it
ALL = ("classification_output", "segmentation_output", "se3")
SHAPES = {"small": (5, 4, 64, 4), "canonical": (23, 12, 1024, 2)}  # C, P, n, b


def _cloud(b, n, seed):
    return np.random.default_rng(seed).normal(size=(b, n, 3)).astype(np.float32)


def _unit(b, n, seed):
    """A cloud on the unit-sphere scale the grouping runs at."""
    x = _cloud(b, n, seed)
    x -= x.mean(axis=1, keepdims=True)
    return (x / np.linalg.norm(x, axis=-1).max(axis=1)[:, None, None]).astype(
        np.float32)


def _pair(shape: str, exact: bool, seed: int = 0):
    """The JAX model with randomized variables and the port's twin on the
    CPU, loaded with the converted weights."""
    c, p, n, _ = SHAPES[shape]
    jmodel = jax_pn2.pointnet2_for_width(c, p, n, exact_knn=exact, dropout_rate=0.0)
    init = jax.jit(lambda r, x: jmodel.init(r, x, train=False))(
        jax.random.key(seed), jnp.asarray(_cloud(1, n, 99)))
    variables = randomize({"params": init["params"],
                           "batch_stats": init["batch_stats"]}, seed)
    model = pointnet2.pointnet2_for_width(c, p, n, dropout_rate=0.0, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables))
    return jmodel, variables, model.eval()


def _assert_heads_close(got: dict, want: dict, keys=ALL) -> None:
    assert set(got) == set(keys)
    for key in keys:
        g, w = got[key].detach().numpy(), np.asarray(want[key])
        assert g.shape == w.shape, key
        if key == "segmentation_output":
            rows = (np.abs(g - w).max(-1) > ATOL).mean()
            assert rows <= SEG_ROWS, f"{rows:.4f} of the rows beyond {ATOL}"
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=key)


@pytest.fixture(scope="module", params=[
    ("small", True), ("small", False), ("canonical", True), ("canonical", False),
], ids=lambda p: f"{p[0]}-{'exact' if p[1] else 'approx'}")
def pair(request):
    return _pair(*request.param), request.param[0]


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "approx"])
@pytest.mark.parametrize("case", [
    (64, 16, 8, 0.5, 0), (200, 32, 16, 0.4, 5), (1024, 512, 32, 0.2, 0),
], ids=["64-feats0", "200-feats5", "1024-sa1"])
def test_sample_and_group_matches_jax(case, exact):
    """FPS centroids identical; each kNN row the same index set; the grouped
    coordinates and features equal up to the centering's rounding."""
    n, m, k, radius, c = case
    xyz = _unit(2, n, n)
    feats = (np.random.default_rng(1).normal(size=(2, n, c)).astype(np.float32)
             if c else None)
    want_xyz, want = jax_pn2.sample_and_group(
        jnp.asarray(xyz), None if feats is None else jnp.asarray(feats), m, k,
        radius, exact_knn=exact)
    got_xyz, got = pointnet2.sample_and_group(
        torch.from_numpy(xyz), None if feats is None else torch.from_numpy(feats),
        m, k, radius)
    np.testing.assert_array_equal(got_xyz.numpy(), np.asarray(want_xyz))
    want_idx, _ = jax_pn2._grouping_knn(want_xyz, jnp.asarray(xyz), k, exact)
    got_idx, _ = pointnet2._grouping_knn(got_xyz, torch.from_numpy(xyz), k)
    assert got_idx.dtype == torch.int32 and got_idx.shape == (2, m, k)
    flips = sum(set(g) != set(w) for g, w in zip(
        got_idx.numpy().reshape(-1, k).tolist(),
        np.asarray(want_idx).reshape(-1, k).tolist()))
    assert flips == 0, f"{flips} kNN rows with another neighbour set"
    assert got.shape == (2, m, k, 3 + c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_three_nearest_matches_jax():
    """Identical indices, ties included (two coarse points coincide: the
    lower index wins, as ``jnp.argmin``'s), and the same distances."""
    fine = _unit(2, 300, 3)
    coarse = _unit(2, 40, 4)
    coarse[:, 7] = coarse[:, 2]
    fine[:, :5] = coarse[:, 2:3]  # fine points on the tied pair
    want_idx, want_d = jax_pn2._three_nearest(jnp.asarray(fine), jnp.asarray(coarse))
    got_idx, got_d = pointnet2._three_nearest(torch.from_numpy(fine),
                                              torch.from_numpy(coarse))
    assert got_idx.dtype == torch.int32
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    assert (got_idx.numpy()[:, :5, 0] == 2).all()
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=0, atol=1e-6)


def test_interpolate_features_matches_jax():
    fine, coarse = _unit(2, 256, 5), _unit(2, 64, 6)
    feats = np.random.default_rng(7).normal(size=(2, 64, 16)).astype(np.float32)
    want = jax_pn2.interpolate_features(*(jnp.asarray(a) for a in (fine, coarse, feats)))
    got = pointnet2.interpolate_features(*(torch.from_numpy(a)
                                           for a in (fine, coarse, feats)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_heads_match_jax(pair):
    """Every head, inference, from converted weights."""
    (jmodel, variables, model), shape = pair
    _, _, n, b = SHAPES[shape]
    x = _cloud(b, n, 11) * 3.0
    want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        variables, jnp.asarray(x))
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    _assert_heads_close(got, want)
    np.testing.assert_array_equal(got["se3"].numpy(), np.broadcast_to(np.eye(3), (b, 3, 3)))


@pytest.mark.parametrize("heads", [("classification_output",),
                                   ("segmentation_output", "se3")],
                         ids=["cls", "seg+se3"])
def test_head_subsets_match_jax(heads):
    jmodel, variables, model = _pair("small", True, seed=4)
    x = _cloud(4, 64, 12)
    want = jmodel.apply(variables, jnp.asarray(x), train=False, heads=heads)
    with torch.inference_mode():
        got = model(torch.from_numpy(x), heads=heads)
    _assert_heads_close(got, want, heads)


def _port_stats(model) -> dict:
    return {k: v.clone() for k, v in model.state_dict().items() if "running" in k}


@pytest.mark.parametrize("frozen", [False, True], ids=["batch-stats", "frozen-trunk"])
def test_train_mode_matches_jax(frozen):
    """Train-mode forward (dropout 0): outputs, and the new running
    statistics of every BatchNorm (over (b, m, k) in the set abstractions),
    against JAX's ``mutable=['batch_stats']`` apply. A frozen trunk keeps
    its statistics, as in the JAX package.

    The reference is JAX's apply in float64 on the same f32 weights and
    clouds. In f32, XLA's CPU reductions over the 4096 samples of a
    set-abstraction BatchNorm, followed by E[x^2] - E[x]^2, leave JAX
    1.6e-4 from its own float64 heads (the port: 4e-6); the two packages
    agree to 3e-9 in float64. So the port meets the repo's 1e-4 against
    JAX's float64 result, and JAX's f32 result within 1e-3.
    """
    jmodel, variables, model = _pair("small", True, seed=5)
    model.train()
    x = _cloud(4, 64, 13)
    jfreeze = JaxFreezeFlags(shared_network=frozen)
    with jax.enable_x64(True):
        want, new_stats = jmodel.apply(
            jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables),
            jnp.asarray(x, jnp.float64), train=True, freeze=jfreeze,
            mutable=["batch_stats"])
        want = {k: np.asarray(v, np.float32) for k, v in want.items()}
        new_stats = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                           new_stats)
    want32 = jmodel.apply(variables, jnp.asarray(x), train=True, freeze=jfreeze,
                          mutable=["batch_stats"])[0]
    got = model(torch.from_numpy(x), train=True,
                freeze=FreezeFlags(shared_network=frozen))
    _assert_heads_close(got, want)
    for key in ALL:
        np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(want32[key]),
                                   rtol=0, atol=1e-3, err_msg=key)
    want_sd = state_dict_from_flax({
        "params": variables["params"],
        "batch_stats": jax.tree_util.tree_map(np.asarray, new_stats["batch_stats"])})
    stats = _port_stats(model)
    assert set(stats) == {k for k in want_sd if "running" in k}
    for key, value in stats.items():
        np.testing.assert_allclose(value.numpy(), want_sd[key].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=key)
    old = state_dict_from_flax(variables)
    trunk = [k for k in stats if k.startswith("sa")]
    assert len(trunk) == 2 * 9
    assert all(torch.equal(stats[k], old[k]) == frozen for k in trunk)


def test_dropout_uses_the_generator():
    """Train-mode dropout in the classification head draws its masks from
    the generator passed to ``forward``: same seed, same output."""
    model = pointnet2.pointnet2_for_width(5, 4, 64, device="cpu",
                                          generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(_cloud(4, 64, 14))
    outs = [model(x, train=True, generator=torch.Generator().manual_seed(s),
                  heads=("classification_output",))["classification_output"]
            for s in (1, 1, 2)]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    with pytest.raises(ValueError, match="needs a torch.Generator"):
        model(x, train=True)


@pytest.mark.parametrize("flags", [(False,) * 4, (True, False, True, False),
                                   (False, True, False, True)])
def test_layer_trainability_matches_jax(flags):
    want = jax_pn2.layer_trainability_pointnet2(JaxFreezeFlags(*flags))
    got = pointnet2.layer_trainability_pointnet2(FreezeFlags(*flags))
    assert list(got.items()) == list(want.items())


def test_model_from_config_builds_pointnet2():
    """``"model": "pointnet2"`` builds the clamped or canonical SSG model on
    the CPU when asked, with the JAX factory's sizes; by default it builds on
    CUDA, which raises here; model options are refused."""
    from pointcloudprocessing_tpu.core.config import parse_config as jax_parse
    from pointcloudprocessing_tpu.models.factory import (
        model_from_config as jax_factory,
    )
    from pointcloudprocessing_tpu_torch.core.config import parse_config
    from pointcloudprocessing_tpu_torch.models.factory import model_from_config

    def raw(width, **extra):
        return {"info": {"name": "t", "class_labels": {"0": "a", "1": "b"},
                         "part_labels": {"0": "p"}},
                "params": {"input_width": width, "epochs": 1, "patience": 1,
                           "batch_size": 2, "model": "pointnet2", **extra}}

    for width in (64, 1024):
        cfg = parse_config(raw(width))
        model = model_from_config(cfg, device="cpu")
        want = jax_factory(jax_parse(raw(width)))
        assert isinstance(model, pointnet2.PointNet2)
        for level, spec in ((model.sa1, want.sa1), (model.sa2, want.sa2)):
            assert (level.num_centroids, level.k, level.radius) == spec[:3]
        assert next(model.parameters()).device.type == "cpu"
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            model_from_config(cfg)
    with pytest.raises(ValueError, match="not supported for params.model='pointnet2'"):
        model_from_config(parse_config(raw(64, model_options={"k": 3})), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pointnet2.pointnet2_for_width(3, 4, 64)


@pytest.mark.parametrize("sampler", ["fps", "stride"])
def test_pipeline_serves_pointnet2(sampler):
    """``PointCloudPipeline`` with PointNet++ at a scan width that does not
    tile (200: the segment sums take the any-rank route), voxel 0.25, both
    samplers: ``__call__`` against the JAX pipeline, ``stream()`` against
    ``__call__``. Every occupied voxel holds one point of the 1/32 grid
    (tests/test_torch_pipeline.py), so FPS distances are exact in f32."""
    from pointcloudprocessing_tpu.models.pipeline import PointCloudPipeline as JaxPipe
    from pointcloudprocessing_tpu_torch.models.pipeline import PointCloudPipeline

    jmodel, variables, model = _pair("small", True, seed=6)
    rng = np.random.default_rng(9)
    scans = []
    for _ in range(3):
        flat = rng.choice(64**3, size=200, replace=False)
        cells = np.stack(np.unravel_index(flat, (64,) * 3), -1)
        scans.append((cells * 8 + rng.integers(0, 8, (200, 3))) / 32.0)
    scans = np.asarray(scans, np.float32)
    kw = dict(scan_width=200, model_width=64, voxel_size=0.25, sampler=sampler)
    want = JaxPipe(jmodel, variables, **kw)(scans)
    pipe = PointCloudPipeline(model, **kw)
    got = pipe(scans)
    _assert_heads_close(got, want)
    streamed = list(pipe.stream(iter([scans[:2], scans])))
    assert len(streamed) == 2
    for key in ALL:
        np.testing.assert_array_equal(streamed[1][key].numpy(), got[key].numpy())
