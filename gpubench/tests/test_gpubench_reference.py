"""The plain reference against the port's CPU path at tiny sizes, on the same
frames and weights: the voxel downsample and FPS picks bit for bit, both
models' heads, and a train step."""

import json

import numpy as np
import pytest
import torch

from gpubench.runners import train_step
from gpubench.harness import frames
from gpubench.harness.session import program_with_weights
from gpubench.reference import fps as ref_fps
from gpubench.reference import pipeline as ref_pipeline
from gpubench.reference import voxel as ref_voxel
from gpubench.tests.helpers import ROOT, small_cell

SEED = 2**31 + 77


@pytest.fixture(scope="module")
def pool():
    with open(ROOT / "gpubench/traffic/kc46_frames_b256.json") as f:
        spec = json.load(f)["frames"]
    spec.update(pool_frames=4, width=2048, native_points=[1024, 3072])
    return frames.make_pool(spec, SEED)


def test_voxel_downsample_is_the_ports_bit_for_bit(pool):
    from pointcloudprocessing_tpu_torch.ops.voxel import voxel_downsample_batch

    scans = torch.from_numpy(pool.points)
    got, got_mask = voxel_downsample_batch(scans, 0.02)
    want, want_mask = ref_voxel.voxel_downsample(scans, 0.02)
    assert torch.equal(got_mask, want_mask)
    assert torch.equal(got, want)
    assert got_mask.sum(dim=1).min() < 2048  # some frames merge rows


def test_run_sums_add_left_to_right():
    data = torch.tensor([[[1.0], [2.0], [3.0], [4.0], [5.0]]])
    head = torch.tensor([[True, False, True, False, False]])
    sums, runs = ref_voxel.run_sums(data, head)
    assert runs.tolist() == [2]
    assert sums[0, :, 0].tolist() == [3.0, 12.0, 0.0, 0.0, 0.0]


def test_morton_key_interleaves_x_over_y_over_z():
    keys = ref_voxel.morton_key(torch.tensor([[1, 0, 0], [0, 1, 0], [0, 0, 1], [2, 0, 0]]))
    assert keys.tolist() == [4, 2, 1, 32]


def test_fps_picks_are_the_ports(pool):
    from pointcloudprocessing_tpu_torch.ops.fps import farthest_point_sample_and_gather
    from pointcloudprocessing_tpu_torch.ops.voxel import voxel_downsample_batch

    voxels, mask = voxel_downsample_batch(torch.from_numpy(pool.points), 0.02)
    idx, sampled = farthest_point_sample_and_gather(voxels, 512, mask)
    want_idx, want = ref_fps.farthest_point_sample(voxels, 512, mask)
    assert torch.equal(idx.long(), want_idx)
    assert torch.equal(sampled, want)


@pytest.mark.parametrize("workload", ["pointnet_serve_8192", "pointnet2_serve_8192"])
def test_serving_heads_are_the_ports(workload, pool):
    from pointcloudprocessing_tpu_torch.models.pipeline import PointCloudPipeline

    cell = small_cell(workload, width=2048)
    model, weights = program_with_weights(cell, SEED, "cpu")
    pipe = PointCloudPipeline(model, scan_width=2048, model_width=1024, voxel_size=0.02,
                              sampler="fps")
    got = pipe(pool.points)
    want = ref_pipeline.serve(cell.model.reference_forward(cell.config, weights),
                              torch.from_numpy(pool.points), 0.02, 1024)
    for head in ("classification_output", "segmentation_output", "se3"):
        np.testing.assert_allclose(got[head].numpy(), want[head].numpy(), rtol=0, atol=1e-6)


def test_train_steps_are_the_ports():
    """Three steps of the port's train step against the reference's, on
    the same weights, frames, jitter and dropout draws: the first step's
    loss and the median leaf's first gradient agree to f32 rounding (later
    steps and the worst leaf carry Adam's sign flips at this small batch)."""
    from pointcloudprocessing_tpu_torch.core.config import LearningConfig
    from pointcloudprocessing_tpu_torch.models.pointnet import FreezeFlags
    from pointcloudprocessing_tpu_torch.train import steps

    cell = small_cell("pointnet_train_8192", batch=8, width=512)
    mix = cell.traffic
    model, weights = program_with_weights(cell, SEED, "cpu", train=True)
    state, optimizer = steps.init_train_state(
        model, LearningConfig(mix["learning_rate"], mix["decay_steps"], mix["decay_rate"]))
    step = steps.make_train_step(model, optimizer, tuple(mix["loss_weights"]), FreezeFlags(),
                                 tuple(mix["jitter_stdev"]))
    pool = frames.make_pool(mix["frames"], SEED)
    params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    buffers = {n: t.clone() for n, t in model.named_buffers()}
    b, losses, first = mix["batch"], [], None
    for s in range(3):
        rows = slice(s * b, (s + 1) * b)
        targets = {"classification_output": torch.from_numpy(pool.class_label[rows]),
                   "segmentation_output": torch.from_numpy(pool.part_labels[rows]),
                   "se3": torch.from_numpy(pool.se3[rows])}
        state, logs = step(state, torch.from_numpy(pool.points[rows]), targets, SEED)
        losses.append(float(logs["loss"]))
        if s == 0:
            first = {n: m / (1 - steps.ADAM_B1) for n, m in state.opt_state.mu.items()}
    change = {n: p.detach() - params0[n] for n, p in model.named_parameters()}
    want = train_step.reference_steps(cell, SEED, params0, buffers, pool, "cpu", 3)
    gaps = train_step.gaps((losses, first, change), want)
    assert gaps["first_loss_gap"] < 1e-5, gaps
    assert gaps["grad_norm_gap_median"] < 1e-4, gaps
    assert gaps["change_norm_gap_median"] < 1e-2, gaps
