"""Procedural triangle meshes for synthetic multi-class workloads.

The reference's class-test sweep (point_cloud_analysis/examples/class_test/)
runs over .obj aircraft models that are not redistributable; these parametric
shapes provide geometrically distinct stand-ins so the N-way classification
experiments are runnable from a clean checkout. Each factory returns a
:class:`~pointcloudprocessing_tpu_torch.synthesis.mesh.Mesh`
(numpy only; ``pointcloudprocessing_tpu/synthesis/procedural.py``).
"""

from __future__ import annotations

import numpy as np

from .mesh import Mesh

# copied from pointcloudprocessing_tpu/synthesis/procedural.py::_BOX_FACES
_BOX_FACES = np.array(
    [
        [0, 1, 2], [0, 2, 3],  # bottom (z-)
        [4, 6, 5], [4, 7, 6],  # top (z+)
        [0, 4, 5], [0, 5, 1],  # y-
        [3, 2, 6], [3, 6, 7],  # y+
        [0, 3, 7], [0, 7, 4],  # x-
        [1, 5, 6], [1, 6, 2],  # x+
    ],
    dtype=np.int32,
)


# copied from pointcloudprocessing_tpu/synthesis/procedural.py::box_mesh
def box_mesh(extents: tuple[float, float, float] = (1.0, 1.0, 1.0)) -> Mesh:
    """Axis-aligned box centered at the origin."""
    ex, ey, ez = (e / 2.0 for e in extents)
    corners = np.array(
        [
            [-ex, -ey, -ez], [ex, -ey, -ez], [ex, ey, -ez], [-ex, ey, -ez],
            [-ex, -ey, ez], [ex, -ey, ez], [ex, ey, ez], [-ex, ey, ez],
        ]
    )
    return Mesh(vertices=corners, triangles=_BOX_FACES.copy())


# copied from pointcloudprocessing_tpu/synthesis/procedural.py::octahedron_mesh
def octahedron_mesh(radius: float = 1.0, subdivisions: int = 1) -> Mesh:
    """Octahedron (optionally subdivided + reprojected -> sphere-like)."""
    v = radius * np.array(
        [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
        dtype=float,
    )
    f = np.array(
        [
            [0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
            [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5],
        ],
        dtype=np.int32,
    )
    for _ in range(subdivisions):
        v, f = _subdivide(v, f)
        v = v / np.linalg.norm(v, axis=-1, keepdims=True) * radius
    return Mesh(vertices=v, triangles=f)


# copied from pointcloudprocessing_tpu/synthesis/procedural.py::_subdivide
def _subdivide(vertices: np.ndarray, faces: np.ndarray):
    """Loop-style 1->4 triangle split (new vertices at edge midpoints)."""
    edge_cache: dict[tuple[int, int], int] = {}
    verts = list(vertices)

    def midpoint(a: int, b: int) -> int:
        key = (min(a, b), max(a, b))
        if key not in edge_cache:
            edge_cache[key] = len(verts)
            verts.append((vertices[a] + vertices[b]) / 2.0)
        return edge_cache[key]

    out = []
    for a, b, c in faces:
        ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
        out.extend([[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]])
    return np.asarray(verts), np.asarray(out, dtype=np.int32)


# copied from pointcloudprocessing_tpu/synthesis/procedural.py::compound_mesh
def compound_mesh(*parts: Mesh) -> Mesh:
    """Concatenate meshes (no boolean union — overlapping shells are fine
    for surface sampling)."""
    vertices, triangles, offset = [], [], 0
    for part in parts:
        vertices.append(part.vertices)
        triangles.append(part.triangles + offset)
        offset += len(part.vertices)
    return Mesh(
        vertices=np.concatenate(vertices), triangles=np.concatenate(triangles)
    )


# copied from pointcloudprocessing_tpu/synthesis/procedural.py::aircraft_like_mesh
def aircraft_like_mesh(
    fuselage_len: float = 6.0,
    wing_span: float = 5.0,
    tail_height: float = 1.2,
) -> Mesh:
    """Crude plane: fuselage box + wing plate + vertical stabilizer."""
    fuselage = box_mesh((fuselage_len, 0.8, 0.8))
    wing = box_mesh((1.2, wing_span, 0.15))
    tail = box_mesh((0.8, 0.15, tail_height))
    tail.translate(np.array([-fuselage_len / 2 + 0.5, 0.0, tail_height / 2]))
    return compound_mesh(fuselage, wing, tail)


# copied from pointcloudprocessing_tpu/synthesis/procedural.py::labeled_compound
def labeled_compound(parts: list[tuple[str, Mesh]]) -> tuple[Mesh, np.ndarray]:
    """Concatenate named sub-meshes; returns (mesh, part-name per triangle).

    The per-triangle name array composes with
    ``sample_points_uniformly(..., return_triangle_indices=True)`` to give
    every sampled surface point the part label of its source component —
    ground-truth segmentation targets for synthetic training data.
    """
    mesh = compound_mesh(*(m for _, m in parts))
    names = np.concatenate(
        [np.full(len(m.triangles), name, dtype=object) for name, m in parts]
    )
    return mesh, names


# copied from pointcloudprocessing_tpu/synthesis/procedural.py::_tube_mesh
def _tube_mesh(length: float, radius: float, sides: int = 12) -> Mesh:
    """Closed axial tube along x, centered at the origin."""
    ang = np.linspace(0.0, 2 * np.pi, sides, endpoint=False)
    ring = np.stack([np.cos(ang), np.sin(ang)], axis=-1) * radius
    front = np.concatenate(
        [np.full((sides, 1), length / 2.0), ring], axis=1
    )
    back = np.concatenate([np.full((sides, 1), -length / 2.0), ring], axis=1)
    verts = np.concatenate(
        [front, back, [[length / 2.0, 0, 0]], [[-length / 2.0, 0, 0]]]
    )
    faces = []
    for i in range(sides):
        j = (i + 1) % sides
        faces.extend(
            [
                [i, sides + i, sides + j],  # barrel quads
                [i, sides + j, j],
                [2 * sides, j, i],  # nose fan
                [2 * sides + 1, sides + i, sides + j],  # tail fan
            ]
        )
    return Mesh(vertices=verts, triangles=np.asarray(faces, dtype=np.int32))


# copied from pointcloudprocessing_tpu/synthesis/procedural.py::kc46_like_mesh
def kc46_like_mesh() -> tuple[Mesh, np.ndarray]:
    """KC-46-like tanker with labeled parts; returns (mesh, triangle parts).

    A procedural stand-in for the reference's AftrBurner KC-46 simulation
    asset (its kc46 collects are not redistributable —
    point_cloud_analysis/kc46_lidar_config.json:43-56 names them). Parts use
    the real kc46 part-label vocabulary (kc46_lidar_config.json:36-42):
    fuselage tube, swept wing plates, two underslung engine pods, horizontal
    and vertical stabilizers, and the three-part refueling boom (hull, wing,
    hose) trailing the tail — proportions roughly match a KC-46 (len ~50 m,
    span ~48 m) scaled by 1/8 so default MeshSampler viewpoint distances
    (5-10) frame the craft like the reference collects do.
    """
    s = 1.0 / 8.0
    fuselage = _tube_mesh(50.0 * s, 2.5 * s, sides=14)
    wing = box_mesh((6.0 * s, 48.0 * s, 0.6 * s))
    wing.translate(np.array([2.0 * s, 0.0, -1.2 * s]))
    eng_l = _tube_mesh(5.5 * s, 1.4 * s, sides=10)
    eng_l.translate(np.array([4.5 * s, -8.0 * s, -3.2 * s]))
    eng_r = _tube_mesh(5.5 * s, 1.4 * s, sides=10)
    eng_r.translate(np.array([4.5 * s, 8.0 * s, -3.2 * s]))
    hstab = box_mesh((4.0 * s, 19.0 * s, 0.45 * s))
    hstab.translate(np.array([-22.0 * s, 0.0, 1.0 * s]))
    vstab = box_mesh((5.0 * s, 0.5 * s, 13.0 * s))
    vstab.translate(np.array([-21.0 * s, 0.0, 7.0 * s]))
    boom_hull = _tube_mesh(12.0 * s, 0.55 * s, sides=8)
    boom_hull.rotate(
        np.array([[np.cos(0.35), 0, -np.sin(0.35)], [0, 1, 0], [np.sin(0.35), 0, np.cos(0.35)]])
    )
    boom_hull.translate(np.array([-29.0 * s, 0.0, -3.0 * s]))
    boom_wing = box_mesh((1.5 * s, 6.0 * s, 0.25 * s))
    boom_wing.translate(np.array([-31.0 * s, 0.0, -3.5 * s]))
    boom_hose = _tube_mesh(6.0 * s, 0.22 * s, sides=6)
    boom_hose.rotate(
        np.array([[np.cos(0.5), 0, -np.sin(0.5)], [0, 1, 0], [np.sin(0.5), 0, np.cos(0.5)]])
    )
    boom_hose.translate(np.array([-36.0 * s, 0.0, -6.0 * s]))
    return labeled_compound(
        [
            ("fuselage", fuselage),
            ("wing", wing),
            ("engine", eng_l),
            ("engine", eng_r),
            ("hstab", hstab),
            ("vstab", vstab),
            ("boom_hull", boom_hull),
            ("boom_wing", boom_wing),
            ("boom_hose", boom_hose),
        ]
    )


# copied from pointcloudprocessing_tpu/synthesis/procedural.py::f15_like_mesh
def f15_like_mesh() -> tuple[Mesh, np.ndarray]:
    """F-15-like twin-engine fighter with labeled parts.

    Procedural stand-in for the reference's "f15_scale" AftrBurner asset
    (its five f15 collects are not redistributable —
    f15_lidar_config.json:44-60 names them). Uses exactly the five part
    labels the reference's own f-15 template cloud carries
    (examples/reference_point_clouds/f-15_model.txt: fuselage, wing,
    engine, vstab, hstab) from the real 12-part vocabulary
    (f15_lidar_config.json:30-43). Proportions follow an F-15 (19.4 m
    length, 13 m span, twin engines, TWIN vertical stabilizers) at the
    template cloud's ~1/8.5 model scale, so the overall extent (~2.3 m)
    matches the reference model and default MeshSampler viewpoint
    distances (5-10) frame it comparably.
    """
    s = 1.0 / 8.5
    fuselage = _tube_mesh(19.4 * s, 1.05 * s, sides=12)
    fuselage.translate(np.array([1.0 * s, 0.0, 0.0]))
    wing = box_mesh((5.2 * s, 13.0 * s, 0.22 * s))
    wing.translate(np.array([-1.0 * s, 0.0, 0.35 * s]))
    eng_l = _tube_mesh(6.0 * s, 0.62 * s, sides=10)
    eng_l.translate(np.array([-6.2 * s, -0.75 * s, -0.25 * s]))
    eng_r = _tube_mesh(6.0 * s, 0.62 * s, sides=10)
    eng_r.translate(np.array([-6.2 * s, 0.75 * s, -0.25 * s]))
    hstab = box_mesh((2.9 * s, 8.6 * s, 0.18 * s))
    hstab.translate(np.array([-8.3 * s, 0.0, 0.1 * s]))
    vstab_l = box_mesh((3.2 * s, 0.3 * s, 3.1 * s))
    vstab_l.translate(np.array([-7.6 * s, -2.1 * s, 1.9 * s]))
    vstab_r = box_mesh((3.2 * s, 0.3 * s, 3.1 * s))
    vstab_r.translate(np.array([-7.6 * s, 2.1 * s, 1.9 * s]))
    return labeled_compound(
        [
            ("fuselage", fuselage),
            ("wing", wing),
            ("engine", eng_l),
            ("engine", eng_r),
            ("hstab", hstab),
            ("vstab", vstab_l),
            ("vstab", vstab_r),
        ]
    )


# copied from pointcloudprocessing_tpu/synthesis/procedural.py::shape_library
def shape_library(n: int) -> dict[str, Mesh]:
    """``n`` geometrically distinct meshes keyed by a stable name.

    Deterministic: entry k is the same mesh regardless of ``n``. Used by the
    class-test data generator to stand in for the reference's n-aircraft
    library.
    """
    factories = [
        ("cube", lambda: box_mesh((2.0, 2.0, 2.0))),
        ("rod", lambda: box_mesh((6.0, 0.5, 0.5))),
        ("plate", lambda: box_mesh((4.0, 4.0, 0.2))),
        ("octa", lambda: octahedron_mesh(2.0, 1)),
        ("plane", lambda: aircraft_like_mesh()),
        ("sphere", lambda: octahedron_mesh(2.0, 3)),
        ("tall", lambda: box_mesh((0.8, 0.8, 5.0))),
        ("wide-plane", lambda: aircraft_like_mesh(4.0, 9.0, 0.8)),
    ]
    out: dict[str, Mesh] = {}
    for k in range(n):
        name, fn = factories[k % len(factories)]
        mesh = fn()
        if k >= len(factories):
            # later entries: progressively rescaled variants stay distinct
            mesh.scale(1.0 + 0.35 * (k // len(factories)), np.zeros(3))
            name = f"{name}-{k // len(factories)}"
        out[name] = mesh
    return out
