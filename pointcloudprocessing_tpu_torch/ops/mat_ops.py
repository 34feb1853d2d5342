"""SO(3)/SE(3) math (``pointcloudprocessing_tpu/ops/mat_ops.py``).

Every function takes array-likes or tensors and computes in f32 on
``device`` (CUDA unless the caller asks for the CPU), as the JAX package
computes with x64 off: a float64 input is cast to f32 first. The products
run with TF32 off (:func:`~pointcloudprocessing_tpu_torch.ops.knn.full_f32_matmul`,
the JAX package's ``"highest"`` precision): calibration, frame composition
and radar-to-global conversion feed millimetre-scale math downstream.

The SVD-based functions (:func:`reorthogonalize`, :func:`solve_kabsch`)
return products that do not change when the SVD flips the signs of a
paired left and right singular vector, so they agree with the JAX package
wherever the nonzero singular values are distinct or the flip is the
determinant fix's.
"""

from __future__ import annotations

import math

import torch

from pointcloudprocessing_tpu_torch.ops.knn import full_f32_matmul
from pointcloudprocessing_tpu_torch.utils.device import require_device


def f32(x, device) -> torch.Tensor:
    """``x`` as an f32 tensor on ``device`` (``jnp.asarray`` with x64 off)."""
    return torch.as_tensor(x, dtype=torch.float32, device=require_device(device))


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    with full_f32_matmul():
        return torch.matmul(a, b)


def _rotation(rows) -> torch.Tensor:
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def yaw_matrix(yaw_rad, device="cuda") -> torch.Tensor:
    """Rotation about +z."""
    a = f32(yaw_rad, device)
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return _rotation([[c, s, z], [-s, c, z], [z, z, o]])


def pitch_matrix(pitch_rad, device="cuda") -> torch.Tensor:
    """Rotation about +y."""
    a = f32(pitch_rad, device)
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return _rotation([[c, z, -s], [z, o, z], [s, z, c]])


def roll_matrix(roll_rad, device="cuda") -> torch.Tensor:
    """Rotation about +x."""
    a = f32(roll_rad, device)
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return _rotation([[o, z, z], [z, c, s], [z, -s, c]])


def apply_yaw(dcm, yaw_rad, device="cuda") -> torch.Tensor:
    return _matmul(yaw_matrix(yaw_rad, device), f32(dcm, device))


def apply_pitch(dcm, pitch_rad, device="cuda") -> torch.Tensor:
    return _matmul(pitch_matrix(pitch_rad, device), f32(dcm, device))


def apply_roll(dcm, roll_rad, device="cuda") -> torch.Tensor:
    return _matmul(roll_matrix(roll_rad, device), f32(dcm, device))


def get_dcm(roll_deg, pitch_deg, yaw_deg, device="cuda") -> torch.Tensor:
    """Body-to-world DCM from roll/pitch/yaw degrees:
    ``roll(pitch(yaw(I))).T`` with premultiplied elementary rotations."""
    eye = torch.eye(3, dtype=torch.float32, device=require_device(device))
    m = apply_yaw(eye, torch.deg2rad(f32(yaw_deg, device)), device)
    m = apply_pitch(m, torch.deg2rad(f32(pitch_deg, device)), device)
    m = apply_roll(m, torch.deg2rad(f32(roll_deg, device)), device)
    return m.transpose(-1, -2)


def get_roll_pitch_yaw_deg(dcm, device="cuda") -> dict:
    """Euler extraction: {"roll", "pitch", "yaw"} in degrees."""
    dcm = f32(dcm, device)
    yaw = torch.atan2(dcm[..., 0, 1], dcm[..., 0, 0])
    pitch = -torch.asin(dcm[..., 0, 2])
    roll = torch.atan2(dcm[..., 1, 2], dcm[..., 2, 2])
    return {"roll": torch.rad2deg(roll), "pitch": torch.rad2deg(pitch),
            "yaw": torch.rad2deg(yaw)}


def get_dcm_positive_x_pointing_at_origin(pos, roll_deg=0.0,
                                          device="cuda") -> torch.Tensor:
    """DCM for a camera at ``pos`` (..., 3) with +x pointing at the origin;
    ``roll_deg`` broadcasts against ``pos``'s batch shape."""
    pos = f32(pos, device)
    pitch_rad = torch.atan2(
        pos[..., 2], torch.sqrt(pos[..., 0] ** 2 + pos[..., 1] ** 2))
    yaw_rad = math.pi + torch.atan2(pos[..., 1], pos[..., 0])
    eye = torch.eye(3, dtype=pos.dtype, device=pos.device).expand(
        *pos.shape[:-1], 3, 3)
    dcm = apply_yaw(eye, yaw_rad, device)
    dcm = apply_pitch(dcm, pitch_rad, device)
    return apply_roll(dcm, torch.deg2rad(f32(roll_deg, device)), device)


def reorthogonalize(dcm, device="cuda") -> torch.Tensor:
    """Nearest orthogonal matrix via SVD: ``u @ vt``."""
    u, _, vt = torch.linalg.svd(f32(dcm, device))
    return _matmul(u, vt)


def convert_radar_to_global(rg_az_el, radar_pos, radar_rpy,
                            device="cuda") -> torch.Tensor:
    """Spherical radar return(s) (..., 3) of (range_m, azimuth_deg,
    elevation_deg) -> global cartesian point(s), for a radar at
    ``radar_pos`` with (roll, pitch, yaw) ``radar_rpy`` in degrees."""
    rg_az_el = f32(rg_az_el, device)
    radar_rpy = f32(radar_rpy, device)
    g_r_r = get_dcm(radar_rpy[0], radar_rpy[1], radar_rpy[2], device)
    rng = rg_az_el[..., 0]
    az = torch.deg2rad(rg_az_el[..., 1])
    polar = torch.deg2rad(90.0 - rg_az_el[..., 2])
    point = torch.stack([rng * torch.cos(az) * torch.sin(polar),
                         rng * torch.sin(az) * torch.sin(polar),
                         rng * torch.cos(polar)], dim=-1)
    return _matmul(point, g_r_r.T) + f32(radar_pos, device)


def solve_kabsch(truth_vecs, measured_vecs, device="cuda"):
    """Kabsch rigid alignment: (R (3, 3), t (3,), rmse) minimizing
    ``||R @ measured + t - truth||`` over (n, 3) correspondences. The
    reflection fix flips Vt's last row by a select on det's sign (no
    branch on a value)."""
    truth_vecs = f32(truth_vecs, device)
    measured_vecs = f32(measured_vecs, device)
    truth_mean = truth_vecs.mean(dim=0)
    meas_mean = measured_vecs.mean(dim=0)
    h = _matmul((measured_vecs - meas_mean).T, truth_vecs - truth_mean)
    u, _, vt = torch.linalg.svd(h)
    det = torch.linalg.det(_matmul(vt.T, u.T))
    flip = torch.where(det < 0, -1.0, 1.0)
    vt = torch.cat([vt[:2], vt[2:] * flip], dim=0)
    r = _matmul(vt.T, u.T)
    t = truth_mean - _matmul(r, meas_mean)
    aligned = _matmul(measured_vecs, r.T) + t
    rmse = torch.sqrt(torch.mean(torch.sum((aligned - truth_vecs) ** 2, dim=1)))
    return r, t, rmse


def se3_compose(rotation, translation, device="cuda") -> torch.Tensor:
    """Pack (R (..., 3, 3), t (..., 3)) into (..., 4, 4) SE(3) matrices."""
    rotation = f32(rotation, device)
    translation = f32(translation, device)
    top = torch.cat([rotation, translation[..., :, None]], dim=-1)
    bottom = rotation.new_tensor([[0.0, 0.0, 0.0, 1.0]]).expand(
        *rotation.shape[:-2], 1, 4)
    return torch.cat([top, bottom], dim=-2)


def relative_pose(sensor_pose, target_pose, device="cuda") -> torch.Tensor:
    """Target pose in the sensor frame from two (..., 4, 4) world poses:
    ``[Rs^T Rt | Rs^T (pt - ps); 0 0 0 1]``."""
    sensor_pose = f32(sensor_pose, device)
    target_pose = f32(target_pose, device)
    rs, rt = sensor_pose[..., :3, :3], target_pose[..., :3, :3]
    ps, pt = sensor_pose[..., :3, 3], target_pose[..., :3, 3]
    so3 = _matmul(rs.transpose(-1, -2), rt)
    t = _matmul(rs.transpose(-1, -2), (pt - ps)[..., None])[..., 0]
    return se3_compose(so3, t, device)


# the JAX package's jitted names, for host-side callers
get_dcm_jit = get_dcm
solve_kabsch_jit = solve_kabsch
