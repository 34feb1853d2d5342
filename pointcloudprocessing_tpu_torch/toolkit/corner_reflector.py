"""Trihedral corner-reflector ray tracing
(``pointcloudprocessing_tpu/toolkit/corner_reflector.py``).

API parity with utils/corner_reflector.py: ``moller_trumbore`` (:4-61)
returns the ray-triangle intersection distance or None; ``get_reflection``
(:63-110) builds the three reflector faces from the corner triangle + apex
and returns {'collision_point', 'reflection_vector'} for the first hit
face, or {} on miss / bad input shapes.
"""

from __future__ import annotations

from typing import Callable

import numpy as np


# copied from pointcloudprocessing_tpu/toolkit/corner_reflector.py::moller_trumbore
def moller_trumbore(ray_origin, ray_vector, triangle):
    """Möller–Trumbore ray/triangle intersection.

    ``triangle`` is {'corners': (3,3)}; returns distance t along the ray or
    None (parallel, outside, or behind the origin).
    """
    epsilon = 1e-6
    v0, v1, v2 = triangle["corners"][0], triangle["corners"][1], triangle["corners"][2]

    edge1 = v1 - v0
    edge2 = v2 - v0
    h = np.cross(ray_vector, edge2)
    det = np.dot(edge1, h)
    if -epsilon < det < epsilon:
        return None

    inv_det = 1.0 / det
    s = ray_origin - v0
    u = inv_det * np.dot(s, h)
    if u < 0.0 or u > 1.0:
        return None

    q = np.cross(s, edge1)
    v = inv_det * np.dot(ray_vector, q)
    if v < 0.0 or u + v > 1.0:
        return None

    t = inv_det * np.dot(edge2, q)
    if t > epsilon:
        return t
    return None


# copied from pointcloudprocessing_tpu/toolkit/corner_reflector.py::get_reflection
def get_reflection(
    ray_origin: np.ndarray,
    ray_vector: np.ndarray,
    corners: np.ndarray,
    apex: np.ndarray,
    print_func: Callable[[str], None] = print,
) -> dict[str, np.ndarray]:
    """First reflection of a ray off the reflector's three faces.

    ``corners``: (3, 3) CCW looking into the reflector; ``apex``: (3,).
    Returns {'collision_point', 'reflection_vector'} or {} on miss.
    """
    expected = {
        "ray_origin": (ray_origin, (3,)),
        "ray_vector": (ray_vector, (3,)),
        "corners": (corners, (3, 3)),
        "apex": (apex, (3,)),
    }
    for name, (value, want) in expected.items():
        if np.shape(value) != want:
            print_func(
                f"get_reflection: bad shape for {name!r} — "
                f"expected {want}, got {np.shape(value)}"
            )
            return {}

    ring = np.concatenate((corners, corners[:1]), axis=0)
    triangles = []
    for i in range(3):
        normal = np.cross(ring[i + 1] - ring[i], apex - ring[i + 1])
        triangles.append(
            {
                "corners": np.array([ring[i], ring[i + 1], apex]),
                "normal": normal / np.linalg.norm(normal),
            }
        )

    for tri in triangles:
        d_int = moller_trumbore(ray_origin, ray_vector, tri)
        if d_int is not None:
            return {
                "collision_point": ray_origin + ray_vector * d_int,
                "reflection_vector": ray_vector
                - 2 * np.dot(ray_vector, tri["normal"]) * tri["normal"],
            }
    return {}
