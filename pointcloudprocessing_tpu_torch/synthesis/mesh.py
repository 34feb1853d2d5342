"""Minimal triangle-mesh type: OBJ loading + uniform surface sampling
(numpy only; ``pointcloudprocessing_tpu/synthesis/mesh.py``).

Replaces the open3d surface the reference's MeshSampler leans on
(examples/MeshSampler.py:230,314-323 — ``read_triangle_mesh``, ``scale``,
``sample_points_uniformly``, vertex normals) with a dependency-free
implementation: a simple Wavefront-OBJ reader (v/f records, quads fan-
triangulated) and vectorized area-weighted barycentric surface sampling.
"""

from __future__ import annotations

import dataclasses

import numpy as np


# copied from pointcloudprocessing_tpu/synthesis/mesh.py::Mesh
@dataclasses.dataclass
class Mesh:
    vertices: np.ndarray  # (v, 3) float64
    triangles: np.ndarray  # (t, 3) int32

    def scale(self, factor: float, center: np.ndarray | None = None) -> "Mesh":
        center = np.zeros(3) if center is None else np.asarray(center)
        self.vertices = (self.vertices - center) * factor + center
        return self

    def rotate(self, rotation: np.ndarray, center: np.ndarray | None = None) -> "Mesh":
        center = np.zeros(3) if center is None else np.asarray(center)
        self.vertices = (self.vertices - center) @ np.asarray(rotation).T + center
        return self

    def translate(self, offset: np.ndarray) -> "Mesh":
        self.vertices = self.vertices + np.asarray(offset)
        return self

    def triangle_areas(self) -> np.ndarray:
        v = self.vertices
        t = self.triangles
        cross = np.cross(v[t[:, 1]] - v[t[:, 0]], v[t[:, 2]] - v[t[:, 0]])
        return 0.5 * np.linalg.norm(cross, axis=-1)

    def triangle_normals(self) -> np.ndarray:
        v = self.vertices
        t = self.triangles
        cross = np.cross(v[t[:, 1]] - v[t[:, 0]], v[t[:, 2]] - v[t[:, 0]])
        norm = np.linalg.norm(cross, axis=-1, keepdims=True)
        return cross / np.maximum(norm, 1e-12)

    def vertex_normals(self) -> np.ndarray:
        """Area-weighted average of incident triangle normals."""
        tn = self.triangle_normals() * self.triangle_areas()[:, None]
        vn = np.zeros_like(self.vertices)
        for i in range(3):
            np.add.at(vn, self.triangles[:, i], tn)
        norm = np.linalg.norm(vn, axis=-1, keepdims=True)
        return vn / np.maximum(norm, 1e-12)


# copied from pointcloudprocessing_tpu/synthesis/mesh.py::load_obj
def load_obj(path: str) -> Mesh:
    """Parse a Wavefront OBJ file (v and f records; f may reference
    v/vt/vn — only the vertex index is used; quads+ fan-triangulated;
    negative indices resolved per spec)."""
    vertices: list[list[float]] = []
    faces: list[list[int]] = []
    with open(path, "r") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                vertices.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = []
                for token in line.split()[1:]:
                    raw = token.split("/")[0]
                    i = int(raw)
                    idx.append(i - 1 if i > 0 else len(vertices) + i)
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    if not vertices:
        raise ValueError(f"No vertices found in {path}")
    return Mesh(
        vertices=np.asarray(vertices, dtype=np.float64),
        triangles=np.asarray(faces, dtype=np.int32).reshape(-1, 3),
    )


# copied from pointcloudprocessing_tpu/synthesis/mesh.py::load_off
def load_off(path: str) -> Mesh:
    """Parse an Object File Format (.off) mesh — the format ModelNet10/40
    ship in (reference workload: examples/pointnet_example.ipynb). Handles
    the common header quirk where the counts share the 'OFF' line."""
    with open(path, "r") as f:
        tokens: list[str] = []
        header = f.readline().strip()
        if not header.upper().startswith("OFF"):
            raise ValueError(f"{path}: not an OFF file (header {header!r})")
        rest = header[3:].strip()
        if rest:  # counts glued to the magic ("OFF 123 456 0")
            tokens.extend(rest.split())
        for line in f:
            line = line.split("#", 1)[0].strip()
            if line:
                tokens.extend(line.split())
    nv, nf = int(tokens[0]), int(tokens[1])
    cursor = 3
    vertices = np.array(
        [float(t) for t in tokens[cursor : cursor + nv * 3]], dtype=np.float64
    ).reshape(nv, 3)
    cursor += nv * 3
    faces: list[list[int]] = []
    for _ in range(nf):
        k = int(tokens[cursor])
        idx = [int(t) for t in tokens[cursor + 1 : cursor + 1 + k]]
        cursor += 1 + k
        for j in range(1, k - 1):  # fan-triangulate
            faces.append([idx[0], idx[j], idx[j + 1]])
    return Mesh(
        vertices=vertices, triangles=np.asarray(faces, dtype=np.int32).reshape(-1, 3)
    )


# copied from pointcloudprocessing_tpu/synthesis/mesh.py::sample_points_uniformly
def sample_points_uniformly(
    mesh: Mesh,
    number_of_points: int,
    rng: np.random.Generator | None = None,
    return_triangle_indices: bool = False,
):
    """Uniform area-weighted surface sampling (vectorized).

    Matches the semantics of open3d's ``sample_points_uniformly``
    (examples/MeshSampler.py:230): triangles chosen proportionally to area,
    points placed with uniform barycentric coordinates. With
    ``return_triangle_indices`` also returns the (n,) source-triangle index
    of every sample, so per-triangle annotations (e.g. part labels on a
    labeled compound mesh) transfer to the sampled cloud.
    """
    gen = rng if rng is not None else np.random.default_rng()
    areas = mesh.triangle_areas()
    probs = areas / areas.sum()
    tri_idx = gen.choice(len(areas), size=number_of_points, p=probs)

    u = gen.uniform(size=(number_of_points, 1))
    v = gen.uniform(size=(number_of_points, 1))
    flip = (u + v) > 1.0
    u = np.where(flip, 1.0 - u, u)
    v = np.where(flip, 1.0 - v, v)

    t = mesh.triangles[tri_idx]
    a = mesh.vertices[t[:, 0]]
    b = mesh.vertices[t[:, 1]]
    c = mesh.vertices[t[:, 2]]
    points = a + u * (b - a) + v * (c - a)
    if return_triangle_indices:
        return points, tri_idx
    return points
