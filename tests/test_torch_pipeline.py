"""The port's serving slice (voxel downsample -> sampler -> PointNet) against
the JAX package's PointCloudPipeline, on the CPU.

Scans are built so that every occupied voxel holds exactly one point on the
1/32 grid: distinct cells drawn without replacement, one grid point inside
each. Voxel centroids are then the points themselves and every FPS distance
is exact in f32, so the JAX CPU path (distance-matrix FPS) and the port's
plain FPS must pick the same indices; the outputs then agree to the model's
1e-4 parity bar.
"""

import numpy as np
import pytest
import torch

from pointcloudprocessing_tpu.models.pipeline import (
    PointCloudPipeline as JaxPipeline,
)
from pointcloudprocessing_tpu.models.pointnet import PointNet as JaxPointNet
from pointcloudprocessing_tpu_torch.models.pipeline import PointCloudPipeline
from test_torch_pointnet import jax_variables, torch_model

B, SCAN_W, MODEL_W, C, P = 2, 256, 64, 5, 3
VOXEL = 0.25
ATOL = 1e-4


def _one_point_per_voxel_scans(rng, b=B):
    cells_per_axis = 64
    scans = []
    for _ in range(b):
        flat = rng.choice(cells_per_axis**3, size=SCAN_W, replace=False)
        cells = np.stack(np.unravel_index(flat, (cells_per_axis,) * 3), -1)
        offset = rng.integers(0, 8, (SCAN_W, 3))  # 8/32 = one voxel edge
        scans.append((cells * 8 + offset) / 32.0)
    return np.asarray(scans, np.float32)


@pytest.fixture(scope="module")
def models():
    jmodel = JaxPointNet(num_classes=C, num_parts=P)
    variables = jax_variables(jmodel, MODEL_W, seed=1)
    return jmodel, variables, torch_model(variables, C, P, vanilla=False)


@pytest.mark.parametrize("sampler", ["fps", "stride", "head"])
def test_pipeline_matches_jax(models, sampler):
    jmodel, variables, tmodel = models
    scans = _one_point_per_voxel_scans(np.random.default_rng(8))
    jpipe = JaxPipeline(jmodel, variables, scan_width=SCAN_W,
                        model_width=MODEL_W, voxel_size=VOXEL, sampler=sampler)
    pipe = PointCloudPipeline(tmodel, scan_width=SCAN_W, model_width=MODEL_W,
                              voxel_size=VOXEL, sampler=sampler)
    want = jpipe(scans)
    got = pipe(scans)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(
            got[key].numpy(), np.asarray(want[key]), rtol=0, atol=ATOL,
            err_msg=key,
        )
    np.testing.assert_allclose(
        got["classification_output"].sum(-1).numpy(), 1.0, atol=1e-5
    )


def test_stream_matches_call(models):
    _, _, tmodel = models
    pipe = PointCloudPipeline(tmodel, scan_width=SCAN_W, model_width=MODEL_W,
                              voxel_size=VOXEL)
    rng = np.random.default_rng(9)
    batches = [_one_point_per_voxel_scans(rng) for _ in range(3)]
    streamed = list(pipe.stream(iter(batches)))
    assert len(streamed) == 3
    for batch, out in zip(batches, streamed):
        direct = pipe(batch)
        for key in direct:
            assert torch.equal(out[key], direct[key]), key


def test_stream_early_exit(models):
    """Abandoning the stream must not deadlock the producer thread."""
    _, _, tmodel = models
    pipe = PointCloudPipeline(tmodel, scan_width=SCAN_W, model_width=MODEL_W,
                              voxel_size=VOXEL, sampler="stride")
    rng = np.random.default_rng(10)
    batches = (rng.uniform(-5, 5, (B, SCAN_W, 3)).astype(np.float32)
               for _ in range(100))
    gen = pipe.stream(batches, prefetch=1)
    next(gen)
    gen.close()  # runs the shutdown path; returns only once the thread ended


def test_pipeline_config_rules(models):
    _, _, tmodel = models
    with pytest.raises(ValueError, match="stride"):
        PointCloudPipeline(tmodel, scan_width=SCAN_W, model_width=MODEL_W,
                           sampler="stride")
    with pytest.raises(ValueError, match="sampler"):
        PointCloudPipeline(tmodel, scan_width=SCAN_W, model_width=MODEL_W,
                           voxel_size=VOXEL, sampler="random")
    # fps from a full-width unmasked scan is an identity: head truncation
    same = PointCloudPipeline(tmodel, scan_width=SCAN_W, model_width=SCAN_W)
    assert same.sampler == "head"
    pipe = PointCloudPipeline(tmodel, scan_width=SCAN_W, model_width=MODEL_W)
    with pytest.raises(ValueError, match="width"):
        pipe(np.zeros((B, SCAN_W + 1, 3), np.float32))
