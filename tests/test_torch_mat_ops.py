"""The port's SO(3)/SE(3) math and ICP against the JAX package on the CPU.

Both sides take the same float64 numpy inputs and compute in f32 (the JAX
package has x64 off; the port casts as ``jnp.asarray`` does). Bars: 1e-6
absolute on every ``mat_ops`` output but Euler angles, which are held at
1e-6 of a radian (the degrees are ``rad2deg`` of them, so one f32 ulp of
an angle near 180 degrees is 1.5e-5 degrees); ICP's R, t and rmse at 1e-5.
The SVD-based functions are compared on generic inputs (distinct singular
values) and on the reflection case of ``tests/test_mat_ops.py``, where the
results do not depend on the SVD's sign choices.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudprocessing_tpu.ops import mat_ops as jax_mat_ops
from pointcloudprocessing_tpu_torch.ops import mat_ops
from pointcloudprocessing_tpu_torch.ops.icp import icp

jax_icp_mod = importlib.import_module("pointcloudprocessing_tpu.ops.icp")
ATOL = 1e-6
CPU = "cpu"


def close(got, want, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert got.dtype == np.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.fixture
def angles():
    gen = np.random.default_rng(0)
    return gen.uniform(-180, 180, (3, 7))  # roll, pitch, yaw rows, float64


@pytest.mark.parametrize("fn", ["yaw_matrix", "pitch_matrix", "roll_matrix"])
def test_elementary_rotations(fn, angles):
    rad = np.deg2rad(angles[0])
    close(getattr(mat_ops, fn)(rad, device=CPU), getattr(jax_mat_ops, fn)(rad))
    close(getattr(mat_ops, fn)(rad[0], device=CPU), getattr(jax_mat_ops, fn)(rad[0]))


@pytest.mark.parametrize("fn", ["apply_yaw", "apply_pitch", "apply_roll"])
def test_apply_helpers(fn, angles):
    gen = np.random.default_rng(1)
    dcm = gen.normal(size=(7, 3, 3))
    rad = np.deg2rad(angles[1])
    close(getattr(mat_ops, fn)(dcm, rad, device=CPU),
          getattr(jax_mat_ops, fn)(jnp.asarray(dcm), rad))


def test_get_dcm_and_euler_round_trip(angles):
    roll, pitch, yaw = angles
    pitch = pitch / 2.1  # within (-90, 90), where the extraction inverts
    got = mat_ops.get_dcm(roll, pitch, yaw, device=CPU)
    want = jax_mat_ops.get_dcm(roll, pitch, yaw)
    close(got, want)
    close(mat_ops.get_dcm(roll[0], pitch[0], yaw[0], device=CPU),
          jax_mat_ops.get_dcm(roll[0], pitch[0], yaw[0]))
    got_rpy = mat_ops.get_roll_pitch_yaw_deg(got, device=CPU)
    want_rpy = jax_mat_ops.get_roll_pitch_yaw_deg(want)
    assert set(got_rpy) == set(want_rpy) == {"roll", "pitch", "yaw"}
    for k in got_rpy:
        close(torch.deg2rad(got_rpy[k]), jnp.deg2rad(want_rpy[k]))
    # the extraction inverts the world-to-body matrix, get_dcm's transpose
    back = mat_ops.get_roll_pitch_yaw_deg(got.transpose(-1, -2), device=CPU)
    for k, v in {"roll": roll, "pitch": pitch, "yaw": yaw}.items():
        np.testing.assert_allclose(back[k].numpy(), v, atol=1e-3)


def test_dcm_pointing_at_origin(angles):
    gen = np.random.default_rng(2)
    pos = gen.uniform(-20, 20, (7, 3))
    close(mat_ops.get_dcm_positive_x_pointing_at_origin(pos, angles[0], device=CPU),
          jax_mat_ops.get_dcm_positive_x_pointing_at_origin(pos, angles[0]))
    for i in range(3):  # one viewpoint at a time, as the mesh sampler calls it
        got = mat_ops.get_dcm_positive_x_pointing_at_origin(pos[i], angles[0, i],
                                                            device=CPU)
        close(got, jax_mat_ops.get_dcm_positive_x_pointing_at_origin(pos[i], angles[0, i]))
        # +x of the camera frame points from the viewpoint at the origin
        x_world = got.numpy()[0]
        np.testing.assert_allclose(x_world, -pos[i] / np.linalg.norm(pos[i]), atol=1e-5)


def test_reorthogonalize_generic():
    gen = np.random.default_rng(3)
    dcm = np.asarray(jax_mat_ops.get_dcm(10.0, 20.0, 30.0), np.float64)
    dcm = dcm + gen.normal(scale=1e-2, size=(3, 3))
    got = mat_ops.reorthogonalize(dcm, device=CPU)
    close(got, jax_mat_ops.reorthogonalize(jnp.asarray(dcm)))
    close(got @ got.T, np.eye(3, dtype=np.float32))
    batched = dcm + gen.normal(scale=1e-2, size=(4, 3, 3))
    close(mat_ops.reorthogonalize(batched, device=CPU),
          jax_mat_ops.reorthogonalize(jnp.asarray(batched)))


def test_convert_radar_to_global():
    gen = np.random.default_rng(4)
    returns = np.stack([gen.uniform(5, 60, 9), gen.uniform(-180, 180, 9),
                        gen.uniform(-30, 30, 9)], axis=1)
    pos, rpy = np.array([1.0, -2.0, 3.0]), np.array([2.0, -5.0, 70.0])
    close(mat_ops.convert_radar_to_global(returns, pos, rpy, device=CPU),
          jax_mat_ops.convert_radar_to_global(returns, jnp.asarray(pos),
                                              jnp.asarray(rpy)), atol=ATOL)
    close(mat_ops.convert_radar_to_global(returns[0], pos, rpy, device=CPU),
          jax_mat_ops.convert_radar_to_global(returns[0], jnp.asarray(pos),
                                              jnp.asarray(rpy)), atol=ATOL)


def test_solve_kabsch_generic():
    gen = np.random.default_rng(5)
    r_true = np.asarray(jax_mat_ops.get_dcm(14.0, -25.0, 40.0), np.float64)
    t_true = np.array([1.0, -2.0, 0.5])
    measured = gen.uniform(-5, 5, (50, 3))
    truth = measured @ r_true.T + t_true + gen.normal(scale=1e-3, size=(50, 3))
    got = mat_ops.solve_kabsch(truth, measured, device=CPU)
    want = jax_mat_ops.solve_kabsch(truth, measured)
    for g, w in zip(got, want):
        close(g, w)
    assert float(got[2]) < 3e-3


def test_solve_kabsch_reflection_case():
    """``tests/test_mat_ops.py``'s planar, mirrored correspondence: det -1
    without the fix; the fix gives the same proper rotation on both sides."""
    measured = np.array([[1.0, 0, 0], [0, 1.0, 0], [-1.0, 0, 0], [0, -1.0, 0]])
    truth = measured.copy()
    truth[:, 2] = 0.0
    truth = truth @ np.diag([1.0, -1.0, 1.0])
    got = mat_ops.solve_kabsch(truth, measured, device=CPU)
    want = jax_mat_ops.solve_kabsch(truth, measured)
    for g, w in zip(got, want):
        close(g, w)
    assert np.linalg.det(got[0].numpy()) == pytest.approx(1.0, abs=1e-5)


def test_se3_compose_and_relative_pose_batched():
    gen = np.random.default_rng(6)
    rot = np.asarray(jax_mat_ops.get_dcm(*gen.uniform(-60, 60, (3, 5))), np.float64)
    trans = gen.uniform(-10, 10, (5, 3))
    got = mat_ops.se3_compose(rot, trans, device=CPU)
    close(got, jax_mat_ops.se3_compose(jnp.asarray(rot), jnp.asarray(trans)))
    close(mat_ops.se3_compose(rot[0], trans[0], device=CPU),
          jax_mat_ops.se3_compose(jnp.asarray(rot[0]), jnp.asarray(trans[0])))
    sensor, target = got.numpy(), got.numpy()[::-1].copy()
    close(mat_ops.relative_pose(sensor, target, device=CPU),
          jax_mat_ops.relative_pose(jnp.asarray(sensor), jnp.asarray(target)))
    close(mat_ops.relative_pose(sensor[1], target[1], device=CPU),
          jax_mat_ops.relative_pose(jnp.asarray(sensor[1]), jnp.asarray(target[1])))


def test_jit_aliases():
    assert mat_ops.get_dcm_jit is mat_ops.get_dcm
    assert mat_ops.solve_kabsch_jit is mat_ops.solve_kabsch


def test_entry_points_default_to_cuda():
    """Without CUDA (as here) the default device raises; CPU callers say so."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mat_ops.get_dcm(0.0, 0.0, 0.0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        icp(np.zeros((4, 3)), np.zeros((4, 3)))


def icp_clouds(seed: int, n: int = 256):
    gen = np.random.default_rng(seed)
    target = gen.uniform(-2, 2, (n, 3)).astype(np.float32)
    r_true = np.asarray(jax_mat_ops.get_dcm(4.0, -3.0, 6.0))
    t_true = np.array([0.1, -0.05, 0.2], np.float32)
    return ((target - t_true) @ r_true).astype(np.float32), target


@pytest.mark.parametrize("iterations", [0, 1, 5, 30])
def test_icp_matches_jax(iterations):
    source, target = icp_clouds(7)
    got = icp(source, target, iterations=iterations, device=CPU)
    want = jax_icp_mod.icp(jnp.asarray(source), jnp.asarray(target),
                           iterations=iterations)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
    if iterations == 0:  # the fori_loop's initial carry
        assert np.array_equal(got[0].numpy(), np.eye(3))
        assert np.array_equal(got[1].numpy(), np.zeros(3))
        assert float(got[2]) == np.inf
    if iterations == 30:
        assert float(got[2]) < 1e-5


def test_icp_inexact_mode_is_answered_exactly():
    source, target = icp_clouds(8)
    exact = icp(source, target, iterations=3, device=CPU)
    approx = icp(source, target, iterations=3, exact_nn=False, device=CPU)
    for e, a in zip(exact, approx):
        assert torch.equal(e, a)
