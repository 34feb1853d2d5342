"""Corner-reflector analysis math, headless
(``pointcloudprocessing_tpu/toolkit/reflector_analysis.py``).

The geometry/physics behind the reference's RadarCalibration corner-reflector
panel, extracted from the GUI so it is testable and reusable:

- ``compute_rcs``: trihedral RCS 4*pi*a^4 / (3*lambda^2)
  (gui/RadarCalibration.py:444-446).
- ``reflector_pose``: the trihedral's corner triangle + apex under a
  roll/pitch/yaw pose (:448-485, geometry only — no plotting).
- ``trace_reflections``: multi-bounce ray path through the reflector and the
  measured-vs-actual distance bookkeeping (:487-527).
"""

from __future__ import annotations

import numpy as np

from pointcloudprocessing_tpu_torch.toolkit import corner_reflector
from pointcloudprocessing_tpu_torch.toolkit import mat_ops


# copied from pointcloudprocessing_tpu/toolkit/reflector_analysis.py::compute_rcs
def compute_rcs(a: float, wavelength: float) -> float:
    """Trihedral corner-reflector radar cross-section (m^2)."""
    return (4 * np.pi * (a**4)) / (3 * (wavelength**2))


# adapted from pointcloudprocessing_tpu/toolkit/reflector_analysis.py::reflector_pose:
# the rotation on ``device``
def reflector_pose(
    edge_length: float, roll: float, pitch: float, yaw: float, device="cuda"
) -> dict[str, np.ndarray]:
    """Corner triangle (CCW) + apex of a trihedral reflector with the given
    aperture edge length, rotated by roll/pitch/yaw degrees (the rotation
    built in f32 on ``device``, CUDA unless the caller asks for the CPU).

    Returns {'corners': (3, 3), 'apex': (3,)}.
    """
    r = np.sqrt(3) * edge_length / 6  # incircle radius of the aperture
    corners = np.array(
        [
            [-0.5 * edge_length, -r, 0],
            [0.5 * edge_length, -r, 0],
            [0, 2 * r, 0],
        ]
    )
    apex = np.array([0, 0, -edge_length / np.sqrt(6)])

    rot = mat_ops.get_dcm(roll, pitch, yaw, device)
    corners = (rot @ corners.T).T
    apex = rot @ apex
    return {"corners": corners, "apex": apex}


# copied from pointcloudprocessing_tpu/toolkit/reflector_analysis.py::trace_reflections
def trace_reflections(
    ray_origin: np.ndarray,
    reflector_info: dict[str, np.ndarray],
    ray_vector: np.ndarray | None = None,
    max_bounces: int = 16,
    print_func=print,
) -> dict:
    """Trace a ray through the reflector until it escapes.

    Returns {'rays': (m, 2, 3) segment list, 'total_distance': float,
    'returned_to_source': bool}. The final segment extends the escaping ray
    back to the source plane (z of the original origin), matching the
    reference's distance bookkeeping (gui/RadarCalibration.py:487-527).
    """
    ray_vector = np.array([0.0, 0.0, -1.0]) if ray_vector is None else ray_vector
    ultimate_origin = ray_origin
    segments: list = []

    for _ in range(max_bounces):
        reflection = corner_reflector.get_reflection(
            ray_origin,
            ray_vector,
            reflector_info["corners"],
            reflector_info["apex"],
            print_func,
        )
        if reflection == {}:
            if not segments:
                segments.append([ray_origin, ray_origin * np.array([1, 1, -1])])
            else:
                scaling = (ultimate_origin[2] - ray_origin[2]) / ray_vector[2]
                if not np.isfinite(scaling):
                    scaling = 0.0
                segments.append([ray_origin, ray_origin + ray_vector * scaling])
            break
        segments.append([ray_origin, reflection["collision_point"]])
        ray_origin = reflection["collision_point"]
        ray_vector = reflection["reflection_vector"]

    rays = np.array(segments)
    total = float(sum(np.linalg.norm(s[1] - s[0]) for s in segments))
    if rays.shape[0] >= 2:
        returned = bool(
            np.linalg.norm(np.cross(np.array([0, 0, 1]), rays[-1][1] - rays[-1][0]))
            < 1e-5
        )
    else:
        returned = False
    return {"rays": rays, "total_distance": total, "returned_to_source": returned}
