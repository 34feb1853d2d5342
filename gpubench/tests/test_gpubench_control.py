"""What ``correct`` must catch.

On the CPU: a run driven past the harness's look for a chip, with the timed
path broken underneath, comes out not correct for each fault its cell can
have (an answer altered where it is produced; half of the batch left out;
a step that returns its state unchanged). One chip has no exchange between
chips to leave out.

On the card (``card``): the control, the reference computed in TF32 in the
program's place, fails the cell's limits, at a size a test run holds.
"""

import pytest
import torch

from gpubench import probe
from gpubench.tests.helpers import SEED, measure, small_cell


def test_a_sound_serving_run_is_correct():
    assert measure(small_cell("pointnet_serve_8192", width=2048))["correct"]


@pytest.mark.parametrize("fault", ["answer_altered", "half_batch"])
@pytest.mark.parametrize("workload", ["pointnet_serve_8192", "pointnet2_serve_8192"])
def test_a_broken_serving_path_is_not_correct(workload, fault, monkeypatch):
    from pointcloudprocessing_tpu_torch.models.pipeline import PointCloudPipeline

    run_one = PointCloudPipeline._run_one

    def broken(self, model, points):
        if fault == "half_batch":  # the first half served, its answers given to both halves
            half = run_one(self, model, points[: points.shape[0] // 2])
            return {k: torch.cat([v, v]) for k, v in half.items()}
        out = run_one(self, model, points)
        cls = out["classification_output"].clone()
        cls[0] = cls[0].roll(1)
        return dict(out, classification_output=cls)

    monkeypatch.setattr(PointCloudPipeline, "_run_one", broken)
    line = measure(small_cell(workload, width=2048))
    assert line["correct"] is False, line["compared"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_a_broken_train_step_is_not_correct(fault, monkeypatch):
    from pointcloudprocessing_tpu_torch.train import steps

    if fault == "state_unchanged":
        monkeypatch.setattr(steps.Optimizer, "update_", lambda self, params, state: None)
    else:
        forward_backward = steps._forward_backward

        def half(model, loss_weights, freeze, jitter_stdev, x, targets, *rest, **kw):
            rows = slice(0, x.shape[0] // 2)
            return forward_backward(model, loss_weights, freeze, jitter_stdev, x[rows],
                                    {k: v[rows] for k, v in targets.items()}, *rest, **kw)

        monkeypatch.setattr(steps, "_forward_backward", half)
    line = measure(small_cell("pointnet_train_8192", batch=8, width=512))
    assert line["correct"] is False, line["compared"]


@pytest.mark.card
@pytest.mark.parametrize("workload", ["pointnet_serve_8192", "pointnet2_serve_8192"])
def test_the_tf32_control_fails_a_serving_limit(workload, card):
    cell = small_cell(workload, batch=16, width=8192)
    gaps = probe.control_serve(cell, SEED, card)
    assert any(gaps[k] > v["limit"] for k, v in cell.limits.items()), gaps


@pytest.mark.card
def test_the_tf32_control_fails_a_training_limit(card):
    cell = small_cell("pointnet_train_8192", batch=8, width=8192)
    control, half = probe.control_train(cell, SEED, card)
    assert any(control[k] > v["limit"] for k, v in cell.limits.items()), control
    assert any(half[k] > v["limit"] for k, v in cell.limits.items()), half
