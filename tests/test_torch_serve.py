"""The port's serving CLI against the JAX package's, on the same stage and
frames, plus the numpy helpers the port copies from the JAX package.

The stage is a randomly initialised model saved the way training saves it
(Orbax ``best/``), then converted by ``tools/convert_stage_to_torch.py``.
Random init can leave two classes (or parts) within float noise of each
other, where the two frameworks' last-ulp differences could pick different
argmaxes. Seed 3 is pinned because every frame's top-2 class margin and
every point's top-2 part margin exceed 1e-3; ``test_margins_are_decisive``
checks that, so a failure there says the pin went stale, not the port.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import CLASS_LABELS, PART_LABELS, make_collect

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 3
WIDTH, MODEL_W, VOXEL = 64, 32, 0.5
SERVE_ARGS = ["--batch", "4", "--voxel-size", str(VOXEL),
              "--scan-width", str(WIDTH), "--model-width", str(MODEL_W)]


def _load_tool():
    path = os.path.join(REPO, "tools", "convert_stage_to_torch.py")
    spec = importlib.util.spec_from_file_location("convert_stage_to_torch", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def stage(tmp_path_factory):
    import orbax.checkpoint as ocp

    from pointcloudprocessing_tpu.core.config import parse_config
    from pointcloudprocessing_tpu.models.factory import model_from_config

    root = tmp_path_factory.mktemp("torch_serve")
    stage_dir = root / "tiny" / "final"
    os.makedirs(stage_dir)
    config = {
        "info": {
            "name": "tiny",
            "class_labels": {str(i): c for i, c in enumerate(CLASS_LABELS)},
            "part_labels": {str(i): p for i, p in enumerate(PART_LABELS)},
        },
        "params": {"input_width": WIDTH, "epochs": 1, "patience": 1,
                   "batch_size": 4, "vanilla": False},
    }
    with open(stage_dir / "tiny_config.json", "w") as f:
        json.dump(config, f)
    model = model_from_config(parse_config(config))
    variables = model.init(
        jax.random.key(SEED), jnp.zeros((1, WIDTH, 3)), train=False
    )
    ckpt = ocp.StandardCheckpointer()
    ckpt.save(str(stage_dir / "best"), {"params": variables["params"],
                                        "batch_stats": variables["batch_stats"]})
    ckpt.wait_until_finished()
    weights = _load_tool().convert_stage(str(stage_dir))
    assert os.path.exists(weights)
    collect = make_collect(str(root / "fresh"), num_frames=9,
                           points_per_frame=40, seed=7)
    return str(stage_dir), collect, root


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_records_match_jax(stage):
    from pointcloudprocessing_tpu.serve import main as jax_main
    from pointcloudprocessing_tpu_torch.serve import main as port_main

    stage_dir, collect, root = stage
    jax_out, port_out = str(root / "jax.jsonl"), str(root / "port.jsonl")
    assert jax_main(["--model", stage_dir, "--input", collect,
                     "--output", jax_out, *SERVE_ARGS]) == 0
    assert port_main(["--model", stage_dir, "--input", collect,
                      "--output", port_out, "--device", "cpu", *SERVE_ARGS]) == 0
    want, got = _records(jax_out), _records(port_out)
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        assert g["frame"] == w["frame"]
        assert g["class"] == w["class"]
        assert g["part_counts"] == w["part_counts"]
        assert sum(g["part_counts"].values()) == MODEL_W
        np.testing.assert_allclose(g["se3"], w["se3"], rtol=0, atol=1e-4)


def test_margins_are_decisive(stage):
    """The pinned seed's class and part argmaxes are not near-ties."""
    from pointcloudprocessing_tpu.core.config import load_config
    from pointcloudprocessing_tpu_torch import serve
    from pointcloudprocessing_tpu_torch.models.factory import model_from_config
    from pointcloudprocessing_tpu_torch.models.pipeline import PointCloudPipeline

    stage_dir, collect, _ = stage
    cfg = load_config(serve._find_config(stage_dir))
    model = model_from_config(cfg, device="cpu")
    model.load_state_dict(torch.load(os.path.join(stage_dir, serve.WEIGHTS)))
    pipe = PointCloudPipeline(model, WIDTH, MODEL_W, voxel_size=VOXEL)
    class_map = {c: i for i, c in enumerate(cfg.class_labels)}
    part_map = {p: i for i, p in enumerate(cfg.part_labels)}
    for names, scans in serve._scan_batches(
        serve._frame_paths(collect), class_map, part_map, WIDTH, 4
    ):
        out = pipe(scans)
        for key in ("classification_output", "segmentation_output"):
            top2 = torch.topk(out[key][: len(names)], 2, dim=-1).values
            assert (top2[..., 0] - top2[..., 1]).min() > 1e-3, key


def test_cuda_device_required_without_fallback(stage, capsys):
    from pointcloudprocessing_tpu_torch.serve import main as port_main

    stage_dir, collect, root = stage
    assert not torch.cuda.is_available()
    rc = port_main(["--model", stage_dir, "--input", collect,
                    "--output", str(root / "none.jsonl")])
    assert rc == 1
    assert "CUDA is not available" in capsys.readouterr().err
    assert not os.path.exists(root / "none.jsonl")


def test_frame_parse_and_resample_match_jax(stage):
    from pointcloudprocessing_tpu.data import frames as jax_frames
    from pointcloudprocessing_tpu.ops.resample import adjust_to_input_width_np as jr
    from pointcloudprocessing_tpu_torch.data import frames
    from pointcloudprocessing_tpu_torch.ops.resample import adjust_to_input_width_np
    from pointcloudprocessing_tpu_torch.serve import _frame_paths

    _, collect, _ = stage
    class_map = {c: i for i, c in enumerate(CLASS_LABELS)}
    part_map = {p: i for i, p in enumerate(PART_LABELS)}
    rng_j, rng_p = np.random.default_rng(3), np.random.default_rng(3)
    for path in _frame_paths(collect):
        want = jax_frames.parse_frame_file(path, class_map, part_map)
        got = frames.parse_frame_file(path, class_map, part_map)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[2], want[2])
        with open(path) as f:
            text = f.read()
        slow_w = jax_frames._parse_frame_text_python(text, class_map, part_map)
        slow_g = frames._parse_frame_text_python(text, class_map, part_map)
        for g, w in zip(slow_g, slow_w):
            np.testing.assert_array_equal(g, w)
        for width in (WIDTH, 16):
            w_obs, w_parts = jr(want[0], want[2], width, rng_j)
            g_obs, g_parts = adjust_to_input_width_np(got[0], got[2], width, rng_p)
            np.testing.assert_array_equal(g_obs, w_obs)
            np.testing.assert_array_equal(g_parts, w_parts)
    with pytest.raises(frames.FrameError):
        frames.parse_frame_text("(1, 2, 3) unknown-class wing\n", class_map, part_map)


def test_write_aftr_frame_matches_jax(tmp_path):
    from pointcloudprocessing_tpu.data.frames import write_aftr_frame as jw
    from pointcloudprocessing_tpu_torch.data.frames import write_aftr_frame

    pts = np.random.default_rng(2).normal(size=(6, 3)).astype(np.float32)
    labels = np.array([["kc-46", "wing"]] * 6)
    jw(str(tmp_path / "a.txt"), pts, labels)
    write_aftr_frame(str(tmp_path / "b.txt"), pts, labels)
    assert (tmp_path / "a.txt").read_text() == (tmp_path / "b.txt").read_text()


@pytest.fixture(scope="module")
def pointnet2_stage(tmp_path_factory):
    """A PointNet++ stage (``"model": "pointnet2"``, width 64, so the SA
    levels clamp to 32 and 8 centroids), randomly initialised, saved as
    training saves it and converted by the tool."""
    import orbax.checkpoint as ocp

    from pointcloudprocessing_tpu.core.config import parse_config
    from pointcloudprocessing_tpu.models.factory import model_from_config
    from test_torch_pointnet import randomize

    root = tmp_path_factory.mktemp("torch_serve_pointnet2")
    stage_dir = root / "tiny" / "final"
    os.makedirs(stage_dir)
    config = {
        "info": {"name": "tiny",
                 "class_labels": {str(i): c for i, c in enumerate(CLASS_LABELS)},
                 "part_labels": {str(i): p for i, p in enumerate(PART_LABELS)}},
        "params": {"input_width": 64, "epochs": 1, "patience": 1,
                   "batch_size": 4, "model": "pointnet2"},
    }
    with open(stage_dir / "tiny_config.json", "w") as f:
        json.dump(config, f)
    model = model_from_config(parse_config(config))
    cloud = np.random.default_rng(0).normal(size=(1, 64, 3)).astype(np.float32)
    variables = model.init(jax.random.key(SEED), jnp.asarray(cloud), train=False)
    # random BN statistics and steeper output layers: at its init the model
    # gives every part ~1/3, where argmaxes are near-ties
    variables = randomize({"params": variables["params"],
                           "batch_stats": variables["batch_stats"]}, SEED)
    for head in ("mlp_cls_out", "mlp_seg_out"):
        layer = variables["params"][head]
        layer[next(iter(layer))]["kernel"] *= 30.0
    ckpt = ocp.StandardCheckpointer()
    ckpt.save(str(stage_dir / "best"), variables)
    ckpt.wait_until_finished()
    assert os.path.exists(_load_tool().convert_stage(str(stage_dir)))
    collect = make_collect(str(root / "fresh"), num_frames=6,
                           points_per_frame=220, seed=7)
    return str(stage_dir), collect, root


def test_serve_cli_serves_a_pointnet2_stage(pointnet2_stage):
    """``serve.main --device cpu`` over the PointNet++ stage at a scan width
    that does not tile (200, so the segment sums take the any-rank route)
    writes the JAX serving CLI's records: class, part counts, identity
    SE(3); the class and part argmaxes are not near-ties (margin > 1e-3)."""
    from pointcloudprocessing_tpu.serve import main as jax_main
    from pointcloudprocessing_tpu_torch.serve import main as port_main

    stage_dir, collect, root = pointnet2_stage
    args = ["--model", stage_dir, "--input", collect, "--batch", "4",
            "--scan-width", "200", "--model-width", "64", "--voxel-size", "0.5"]
    port_out, jax_out = str(root / "port.jsonl"), str(root / "jax.jsonl")
    assert port_main([*args, "--output", port_out, "--device", "cpu"]) == 0
    assert jax_main([*args, "--output", jax_out]) == 0
    got, want = _records(port_out), _records(jax_out)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g["frame"] == w["frame"]
        assert g["class"] == w["class"]
        assert g["part_counts"] == w["part_counts"]
        assert sum(g["part_counts"].values()) == 64
        np.testing.assert_array_equal(g["se3"], np.eye(3))
    _assert_decisive(stage_dir, collect, 200, 64, 0.5)


def _assert_decisive(stage_dir, collect, width, model_width, voxel):
    from pointcloudprocessing_tpu.core.config import load_config
    from pointcloudprocessing_tpu_torch import serve
    from pointcloudprocessing_tpu_torch.models.factory import model_from_config
    from pointcloudprocessing_tpu_torch.models.pipeline import PointCloudPipeline

    cfg = load_config(serve._find_config(stage_dir))
    model = model_from_config(cfg, device="cpu")
    model.load_state_dict(torch.load(os.path.join(stage_dir, serve.WEIGHTS)))
    pipe = PointCloudPipeline(model, width, model_width, voxel_size=voxel)
    class_map = {c: i for i, c in enumerate(cfg.class_labels)}
    part_map = {p: i for i, p in enumerate(cfg.part_labels)}
    for names, scans in serve._scan_batches(
        serve._frame_paths(collect), class_map, part_map, width, 4
    ):
        out = pipe(scans)
        for key in ("classification_output", "segmentation_output"):
            top2 = torch.topk(out[key][: len(names)], 2, dim=-1).values
            assert (top2[..., 0] - top2[..., 1]).min() > 1e-3, key
