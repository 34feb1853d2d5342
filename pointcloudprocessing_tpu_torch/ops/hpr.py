"""Hidden-point removal: the points of a cloud visible from a viewpoint
(``pointcloudprocessing_tpu/ops/hpr.py``).

Two forms, as in the JAX package:

- :func:`hidden_point_removal`: Katz, Tal and Basri (2007), a spherical
  inversion about the camera and the points whose inversions lie on the
  convex hull. Numpy and scipy in float64 on the host (Qhull), as the
  offline synthesis path runs it.
- :func:`hidden_point_removal_mask`: a fixed-shape z-buffer over
  octahedral direction bins on the device, one two-key sort and no hull.
"""

from __future__ import annotations

import numpy as np
import torch

INT32_MAX = 2**31 - 1


def _norm3(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over a last axis of 3, summed in the JAX package's
    order (x^2 + y^2) + z^2, so bins and depths agree with it bit for bit."""
    sq = v * v
    return torch.sqrt(sq[..., 0] + sq[..., 1] + sq[..., 2])


def spherical_flip(points: torch.Tensor, camera: torch.Tensor,
                   radius: float) -> torch.Tensor:
    """Invert points about a sphere of ``radius`` centered on the camera."""
    rel = points - camera
    norm = torch.clamp(_norm3(rel)[..., None], min=1e-12)
    return rel + 2.0 * (radius - norm) * rel / norm


# copied from pointcloudprocessing_tpu/ops/hpr.py::hidden_point_removal
def hidden_point_removal(
    points: np.ndarray, camera: np.ndarray, radius: float | None = None
) -> np.ndarray:
    """Indices of points visible from ``camera``.

    Args:
      points: (n, 3) host array.
      camera: (3,) camera position.
      radius: inversion sphere radius; None -> 100 * max distance from the
        camera (larger radii leak occluded back-face points into the hull).

    Returns sorted int indices of visible points.
    """
    from scipy.spatial import ConvexHull

    points = np.asarray(points, dtype=np.float64)
    camera = np.asarray(camera, dtype=np.float64)
    rel = points - camera
    dists = np.linalg.norm(rel, axis=-1)
    if radius is None:
        radius = float(dists.max()) * 100.0

    # host-side f64 flip: the ~radius-magnitude flipped coordinates carry
    # depth differences compressed by ~1/200, and Qhull needs the double
    # precision the casts above establish (an f32 flip loses them)
    norm = np.maximum(dists[:, None], 1e-12)
    flipped = rel + 2.0 * (radius - norm) * rel / norm
    # include the camera origin so the hull encloses the viewpoint
    cloud = np.concatenate([flipped, np.zeros((1, 3))], axis=0)
    hull = ConvexHull(cloud)
    visible = np.unique(hull.vertices)
    return np.sort(visible[visible < len(points)])


def _octahedral_bins(direction: torch.Tensor, grid: int) -> torch.Tensor:
    """Unit directions (..., 3) -> int32 cells of a ``grid`` x ``grid``
    octahedral map of the sphere (about uniform solid angle a cell, no
    poles)."""
    a = direction.abs()
    ax = (a[..., 0] + a[..., 1] + a[..., 2])[..., None]
    p = direction[..., :2] / torch.clamp(ax, min=1e-12)
    # fold the lower hemisphere outward
    lower = direction[..., 2:3] < 0.0
    folded = (1.0 - p.flip(-1).abs()) * torch.where(p >= 0.0, 1.0, -1.0)
    p = torch.where(lower, folded, p)
    cell = torch.clamp(((p * 0.5 + 0.5) * grid).to(torch.int32), 0, grid - 1)
    return cell[..., 0] * grid + cell[..., 1]


def hidden_point_removal_mask(
    points: torch.Tensor,
    camera,
    valid_mask: torch.Tensor | None = None,
    grid: int = 64,
    tol: float = 0.05,
) -> torch.Tensor:
    """Fixed-shape visibility on the points' device: (b, n) bool mask.

    A z-buffer over octahedral direction bins: a point is visible when its
    camera distance is within ``(1 + tol)`` of the nearest point sharing its
    direction bin. Slightly stricter than the hull at silhouette edges; its
    angular resolution is the bin size (``grid``).

    Args:
      points: (b, n, 3) (or (n, 3), promoted and returned as (n,)).
      camera: (b, 3) or (3,) viewpoint(s); a (3,) camera serves every cloud.
      valid_mask: optional (b, n) bool; invalid rows are never visible.
      grid: octahedral cells per axis (grid^2 bins over the sphere).
      tol: relative depth window counted as the front surface.

    The JAX package's two-key sort on (bin, r) is a stable sort by r then a
    stable sort by bin; its segmented copy-forward of each bin's first
    (nearest) r is a ``cummax`` over the segment starts and a gather.
    """
    single = points.dim() == 2
    camera = torch.as_tensor(camera, dtype=points.dtype, device=points.device)
    if single:
        points = points[None]
        camera = camera[None]
        valid_mask = None if valid_mask is None else valid_mask[None]
    if camera.dim() == 1:
        camera = camera.expand(points.shape[0], 3)
    b, n = points.shape[:2]
    if valid_mask is None:
        valid_mask = torch.ones((b, n), dtype=torch.bool, device=points.device)

    rel = points - camera[:, None, :]
    r = _norm3(rel)
    direction = rel / torch.clamp(r, min=1e-12)[..., None]
    bins = torch.where(valid_mask, _octahedral_bins(direction, grid), INT32_MAX)

    order = torch.sort(r, dim=1, stable=True).indices
    sbin, by_bin = torch.sort(bins.gather(1, order), dim=1, stable=True)
    sidx = order.gather(1, by_bin)
    sr = r.gather(1, sidx)

    # each row's segment start, then the segment's first (nearest) r
    is_new = torch.ones((b, n), dtype=torch.bool, device=points.device)
    is_new[:, 1:] = sbin[:, 1:] != sbin[:, :-1]
    pos = torch.arange(n, device=points.device).expand(b, n)
    start = torch.where(is_new, pos, 0).cummax(dim=1).values
    seg_min = sr.gather(1, start)
    svis = sr <= seg_min * (1.0 + tol)

    vis = torch.empty_like(svis).scatter_(1, sidx, svis)
    out = vis & valid_mask
    return out[0] if single else out
