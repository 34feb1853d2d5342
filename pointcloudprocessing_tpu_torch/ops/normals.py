"""PCA normal estimation over kNN neighbourhoods
(``pointcloudprocessing_tpu/ops/normals.py``).

For each point: its k nearest neighbours, their 3x3 covariance, and the
eigenvector of its smallest eigenvalue from a closed-form symmetric 3x3
solver (trigonometric method), elementwise over six covariance-component
tensors. Two methods:

- ``exact``: the (n, n) distance matrix, the k-th distance VALUE per row
  from ``torch.topk`` (a threshold, so ties cannot change the selection),
  and the moment sums of the selected neighbours as one f32 matmul. The JAX
  package's ``approx`` method (``approx_min_k``, a TPU partial reduction) is
  not ported; it maps to this exact path.
- ``window``: the windowed moment-sum kernel (``ops/cuda/window_normals``)
  over an index window, for clouds in a spatially local order (the voxel
  downsample's Morton order). It never builds the (n, n) matrix.

Second moments are taken of centroid-centred coordinates: raw-coordinate
products cancel catastrophically in f32 for clouds far from the origin.
"""

from __future__ import annotations

import math

import torch

from pointcloudprocessing_tpu_torch.ops.cuda.window_normals import (
    windowed_moment_sums,
)
from pointcloudprocessing_tpu_torch.ops.knn import full_f32_matmul, pairwise_sq_dists

_EPS = 1e-12


def _smallest_eigvec_components(xx, xy, xz, yy, yz, zz):
    """Unit eigenvector (vx, vy, vz) of the smallest eigenvalue of the
    symmetric matrix [[xx,xy,xz],[xy,yy,yz],[xz,yz,zz]]; elementwise over
    component tensors of any shape."""
    q = (xx + yy + zz) / 3.0
    bxx, byy, bzz = xx - q, yy - q, zz - q
    p2 = (bxx * bxx + byy * byy + bzz * bzz + 2.0 * (xy * xy + xz * xz + yz * yz)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=_EPS))
    detb = (
        bxx * (byy * bzz - yz * yz)
        - xy * (xy * bzz - yz * xz)
        + xz * (xy * yz - byy * xz)
    )
    r = torch.clamp(detb / (2.0 * (p * p * p) + _EPS), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    # smallest eigenvalue of the three trigonometric roots
    lam = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)

    # rows of (A - lam I)
    mxx, myy, mzz = xx - lam, yy - lam, zz - lam
    # cross products of row pairs (candidate null-space directions)
    c01x = xy * yz - myy * xz
    c01y = xz * xy - mxx * yz
    c01z = mxx * myy - xy * xy
    c02x = xy * mzz - yz * xz
    c02y = xz * xz - mxx * mzz
    c02z = mxx * yz - xy * xz
    c12x = myy * mzz - yz * yz
    c12y = yz * xz - xy * mzz
    c12z = xy * yz - myy * xz

    n01 = c01x * c01x + c01y * c01y + c01z * c01z
    n02 = c02x * c02x + c02y * c02y + c02z * c02z
    n12 = c12x * c12x + c12y * c12y + c12z * c12z

    # the largest-norm candidate, in the order 01, 02, 12 (robust null vector)
    use02 = n02 > n01
    bx = torch.where(use02, c02x, c01x)
    by = torch.where(use02, c02y, c01y)
    bz = torch.where(use02, c02z, c01z)
    bn = torch.where(use02, n02, n01)
    use12 = n12 > bn
    bx = torch.where(use12, c12x, bx)
    by = torch.where(use12, c12y, by)
    bz = torch.where(use12, c12z, bz)
    bn = torch.where(use12, n12, bn)

    # degenerate (isotropic) neighbourhoods: fall back to +z
    good = bn > _EPS
    bx = torch.where(good, bx, 0.0)
    by = torch.where(good, by, 0.0)
    bz = torch.where(good, bz, 1.0)
    inv = torch.rsqrt(bx * bx + by * by + bz * bz)
    return bx * inv, by * inv, bz * inv


def smallest_eigenvector_sym3x3(a: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric (..., 3, 3)."""
    a = a.float()
    vx, vy, vz = _smallest_eigvec_components(
        a[..., 0, 0], a[..., 0, 1], a[..., 0, 2],
        a[..., 1, 1], a[..., 1, 2], a[..., 2, 2],
    )
    return torch.stack([vx, vy, vz], dim=-1)


def _covariance_normals(sums: tuple[torch.Tensor, ...]) -> tuple[torch.Tensor, ...]:
    """(cnt, sx, sy, sz, sxx, sxy, sxz, syy, syz, szz) -> normal components,
    through the shift-invariant covariance."""
    cnt, sx, sy, sz, sxx, sxy, sxz, syy, syz, szz = sums
    cnt = torch.clamp(cnt, min=1.0)
    mx, my, mz = sx / cnt, sy / cnt, sz / cnt
    return _smallest_eigvec_components(
        sxx / cnt - mx * mx,
        sxy / cnt - mx * my,
        sxz / cnt - mx * mz,
        syy / cnt - my * my,
        syz / cnt - my * mz,
        szz / cnt - mz * mz,
    )


def _orient_to_viewpoint(normals, points, viewpoint):
    """Flip each (..., n, 3) normal to face ``viewpoint`` (..., 3); a normal
    perpendicular to the view direction is kept."""
    to_view = viewpoint[..., None, :] - points
    sign = torch.sign(torch.sum(normals * to_view, dim=-1, keepdim=True))
    return normals * torch.where(sign == 0, 1.0, sign)


def _estimate_normals_exact(points, k, valid_mask, viewpoint):
    """Brute-force normals of (b, n, 3) clouds with (b, n) masks."""
    d = pairwise_sq_dists(points, points)  # (b, n, n)
    d = torch.where(valid_mask[:, None, :], d, float("inf"))
    # the k-th distance VALUE, a threshold: fewer than k valid points give
    # inf, and every valid point is selected (count-normalized below)
    kth = -torch.topk(-d, k, dim=-1).values[..., -1]
    sel = ((d <= kth[..., None]) & valid_mask[:, None, :]).to(points.dtype)
    del d

    denom = torch.clamp(valid_mask.to(points.dtype).sum(dim=1), min=1.0)
    centroid = torch.where(valid_mask[..., None], points, 0.0).sum(dim=1) / denom[:, None]
    c = points - centroid[:, None, :]
    cx, cy, cz = c.unbind(-1)
    feats = torch.stack(
        [torch.ones_like(cx), cx, cy, cz, cx * cx, cx * cy, cx * cz, cy * cy,
         cy * cz, cz * cz], dim=-1)  # (b, n, 10)
    with full_f32_matmul():
        sums = torch.matmul(sel, feats)  # (b, n, 10)
    normals = torch.stack(_covariance_normals(sums.unbind(-1)), dim=-1)
    if viewpoint is not None:
        normals = _orient_to_viewpoint(normals, points, viewpoint)
    return normals


def window_arguments(planes, valid_mask, window: int):
    """The windowed kernel's arguments for (b, 3, n) planes: padded to a
    multiple of 128 with invalid rows, centred per cloud (f32
    cancellation), ``q_block = 256 if n % 256 == 0 else 128`` and the window
    clamped to fit. Returns (padded planes, centred planes, padded bool
    mask, window, q_block)."""
    b, _, n_in = planes.shape
    n = max(-(-n_in // 128) * 128, 128)
    valid_mask = valid_mask.bool()
    if n != n_in:
        planes = torch.cat([planes, planes.new_zeros(b, 3, n - n_in)], dim=2)
        valid_mask = torch.cat(
            [valid_mask, valid_mask.new_zeros(b, n - n_in)], dim=1)
    q_block = 256 if n % 256 == 0 else 128
    window = min(window, (n - q_block) // 2 // 128 * 128)
    denom = torch.clamp(valid_mask.sum(dim=1).to(planes.dtype), min=1.0)
    centroid = torch.where(valid_mask[:, None, :], planes, 0.0).sum(dim=2) / denom[:, None]
    centered = (planes - centroid[:, :, None]).contiguous()
    return planes, centered, valid_mask.contiguous(), window, q_block


def _estimate_normals_window(points, valid_mask, k, viewpoint, window=256,
                             layout="bnc"):
    """Batched windowed-kNN normals through the moment-sum kernel.

    Points must be in a spatially local index order. The moment sums of
    :func:`window_arguments`' centred planes are solved elementwise,
    oriented and cropped back. ``layout='bcn'`` takes and returns
    plane-major (b, 3, n) tensors, the kernel's own layout.
    """
    planes = points if layout == "bcn" else points.transpose(1, 2)
    n_in = planes.shape[2]
    planes, centered, valid_mask, window, q_block = window_arguments(
        planes, valid_mask, window)
    sums = windowed_moment_sums(centered, valid_mask, k, window=window,
                                q_block=q_block, layout="bcn")
    normals = torch.stack(_covariance_normals(sums), dim=1)  # (b, 3, n)
    if viewpoint is not None:
        to_view = viewpoint[..., :, None] - planes
        sign = torch.sign(torch.sum(normals * to_view, dim=1, keepdim=True))
        normals = normals * torch.where(sign == 0, 1.0, sign)
    normals = normals[:, :, :n_in]
    return normals.contiguous() if layout == "bcn" else normals.transpose(1, 2).contiguous()


def estimate_normals(
    points: torch.Tensor,
    k: int = 16,
    valid_mask: torch.Tensor | None = None,
    viewpoint: torch.Tensor | None = None,
    exact: bool = False,
    method: str | None = None,
    window: int = 256,
) -> torch.Tensor:
    """Per-point unit normals of one (n, 3) cloud.

    valid_mask: optional (n,) bool; viewpoint: optional (3,), normals are
    oriented toward it. ``method`` overrides ``exact``: "exact" and "approx"
    (both the exact path, see the module docstring) or "window" (the
    windowed kernel; the points must be in a spatially local order).
    Returns (n, 3) unit normals.
    """
    mask = None if valid_mask is None else valid_mask[None]
    vp = None if viewpoint is None else viewpoint[None]
    return estimate_normals_batch(points[None], k, mask, vp, exact, method,
                                  window)[0]


def estimate_normals_batch(
    points: torch.Tensor,
    k: int = 16,
    valid_mask: torch.Tensor | None = None,
    viewpoint: torch.Tensor | None = None,
    exact: bool = False,
    method: str | None = None,
    window: int = 256,
    layout: str = "bnc",
) -> torch.Tensor:
    """Batched :func:`estimate_normals`: (b, n, 3) -> (b, n, 3).

    valid_mask (b, n) bool, viewpoint (b, 3). ``layout='bcn'`` takes and
    returns plane-major (b, 3, n) tensors (window method only: it pairs
    with ``voxel_downsample_batch(layout='bcn')``, copy-free)."""
    if layout not in ("bnc", "bcn"):
        raise ValueError(f"Unknown layout {layout!r}")
    if layout == "bcn" and method != "window":
        raise ValueError("layout='bcn' is only supported for method='window'")
    if method not in (None, "exact", "approx", "window"):
        raise KeyError(method)
    if valid_mask is None:
        n_axis = points.shape[2] if layout == "bcn" else points.shape[1]
        valid_mask = torch.ones((points.shape[0], n_axis), dtype=torch.bool,
                                device=points.device)
    if method == "window":
        return _estimate_normals_window(points, valid_mask, k, viewpoint,
                                        window=window, layout=layout)
    del exact  # "exact" and "approx" both run the exact path
    return _estimate_normals_exact(points, k, valid_mask.bool(), viewpoint)
