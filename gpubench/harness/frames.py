"""The general generator of LiDAR frames: labelled aircraft surfaces sampled,
posed and resampled to a fixed width, from a traffic file's ``frames``
parameters and the run's seed.

The meshes are copies of ``pointcloudprocessing_tpu_torch/synthesis/
procedural.py`` (``kc46_like_mesh``, ``aircraft_like_mesh`` and their
helpers), and the resampling follows the rule of ``pointcloudprocessing_tpu_
torch/ops/resample.py::adjust_to_input_width_np`` (the first ``width``
points; below that, repeats of points drawn uniformly), so that a later
change to the program cannot change the benchmark's inputs.

Every seed gets the same set of sizes and classes, in another order: the
native point counts are evenly spaced over ``native_points`` and each class
takes the same share of the pool, then the seed permutes both. The seed
draws the surface samples, the poses and the noise. Part proportions of the
non-kc46 classes come from ``proportion_seed``, so every seed sees the same
23 meshes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# ---- meshes: (vertices (v, 3) float64, triangles (t, 3) int32, part per triangle)

# copied from pointcloudprocessing_tpu_torch/synthesis/procedural.py::_BOX_FACES
_BOX_FACES = np.array(
    [
        [0, 1, 2], [0, 2, 3], [4, 6, 5], [4, 7, 6], [0, 4, 5], [0, 5, 1],
        [3, 2, 6], [3, 6, 7], [0, 3, 7], [0, 7, 4], [1, 5, 6], [1, 6, 2],
    ],
    dtype=np.int32,
)


@dataclasses.dataclass
class Part:
    vertices: np.ndarray
    triangles: np.ndarray

    def translate(self, offset) -> "Part":
        self.vertices = self.vertices + np.asarray(offset, dtype=float)
        return self

    def rotate(self, rotation) -> "Part":
        self.vertices = self.vertices @ np.asarray(rotation).T
        return self


# copied from pointcloudprocessing_tpu_torch/synthesis/procedural.py::box_mesh
def box(extents) -> Part:
    ex, ey, ez = (e / 2.0 for e in extents)
    corners = np.array(
        [[-ex, -ey, -ez], [ex, -ey, -ez], [ex, ey, -ez], [-ex, ey, -ez],
         [-ex, -ey, ez], [ex, -ey, ez], [ex, ey, ez], [-ex, ey, ez]])
    return Part(corners, _BOX_FACES.copy())


# copied from pointcloudprocessing_tpu_torch/synthesis/procedural.py::_tube_mesh
def tube(length: float, radius: float, sides: int = 12) -> Part:
    ang = np.linspace(0.0, 2 * np.pi, sides, endpoint=False)
    ring = np.stack([np.cos(ang), np.sin(ang)], axis=-1) * radius
    front = np.concatenate([np.full((sides, 1), length / 2.0), ring], axis=1)
    back = np.concatenate([np.full((sides, 1), -length / 2.0), ring], axis=1)
    verts = np.concatenate([front, back, [[length / 2.0, 0, 0]], [[-length / 2.0, 0, 0]]])
    faces = []
    for i in range(sides):
        j = (i + 1) % sides
        faces.extend([[i, sides + i, sides + j], [i, sides + j, j],
                      [2 * sides, j, i], [2 * sides + 1, sides + i, sides + j]])
    return Part(verts, np.asarray(faces, dtype=np.int32))


@dataclasses.dataclass
class LabelledMesh:
    vertices: np.ndarray
    triangles: np.ndarray
    parts: np.ndarray  # part name per triangle

    def areas(self) -> np.ndarray:
        v, t = self.vertices, self.triangles
        cross = np.cross(v[t[:, 1]] - v[t[:, 0]], v[t[:, 2]] - v[t[:, 0]])
        return 0.5 * np.linalg.norm(cross, axis=-1)


# copied from pointcloudprocessing_tpu_torch/synthesis/procedural.py::labeled_compound
def labelled(parts: list[tuple[str, Part]]) -> LabelledMesh:
    vertices, triangles, names, offset = [], [], [], 0
    for name, part in parts:
        vertices.append(part.vertices)
        triangles.append(part.triangles + offset)
        names.append(np.full(len(part.triangles), name, dtype=object))
        offset += len(part.vertices)
    return LabelledMesh(np.concatenate(vertices), np.concatenate(triangles),
                        np.concatenate(names))


def _rot_y(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])


# copied from pointcloudprocessing_tpu_torch/synthesis/procedural.py::kc46_like_mesh
def kc46_like_mesh() -> LabelledMesh:
    """KC-46-like tanker at 1/8 scale with the kc46 part vocabulary."""
    s = 1.0 / 8.0
    wing = box((6.0 * s, 48.0 * s, 0.6 * s)).translate([2.0 * s, 0.0, -1.2 * s])
    hstab = box((4.0 * s, 19.0 * s, 0.45 * s)).translate([-22.0 * s, 0.0, 1.0 * s])
    vstab = box((5.0 * s, 0.5 * s, 13.0 * s)).translate([-21.0 * s, 0.0, 7.0 * s])
    return labelled([
        ("fuselage", tube(50.0 * s, 2.5 * s, sides=14)),
        ("wing", wing),
        ("engine", tube(5.5 * s, 1.4 * s, sides=10).translate([4.5 * s, -8.0 * s, -3.2 * s])),
        ("engine", tube(5.5 * s, 1.4 * s, sides=10).translate([4.5 * s, 8.0 * s, -3.2 * s])),
        ("hstab", hstab),
        ("vstab", vstab),
        ("boom_hull", tube(12.0 * s, 0.55 * s, sides=8).rotate(_rot_y(0.35))
         .translate([-29.0 * s, 0.0, -3.0 * s])),
        ("boom_wing", box((1.5 * s, 6.0 * s, 0.25 * s)).translate([-31.0 * s, 0.0, -3.5 * s])),
        ("boom_hose", tube(6.0 * s, 0.22 * s, sides=6).rotate(_rot_y(0.5))
         .translate([-36.0 * s, 0.0, -6.0 * s])),
    ])


# copied from pointcloudprocessing_tpu_torch/synthesis/procedural.py::aircraft_like_mesh
def aircraft_like_mesh(fuselage_len: float = 6.0, wing_span: float = 5.0,
                       tail_height: float = 1.2) -> LabelledMesh:
    """Fuselage box, wing plate and vertical stabilizer, labelled as such."""
    tail = box((0.8, 0.15, tail_height)).translate(
        [-fuselage_len / 2 + 0.5, 0.0, tail_height / 2])
    return labelled([("fuselage", box((fuselage_len, 0.8, 0.8))),
                     ("wing", box((1.2, wing_span, 0.15))),
                     ("vstab", tail)])


# ---- the pool

@dataclasses.dataclass
class Pool:
    """A pool of frames in host memory, in the order the cell feeds them."""

    points: np.ndarray       # (frames, width, 3) float32
    class_label: np.ndarray  # (frames,) int64
    part_labels: np.ndarray  # (frames, width) int32
    se3: np.ndarray          # (frames, 3, 3) float32: the pose's rotation
    native: np.ndarray       # (frames,) int: points sampled before resampling

    def arrays(self) -> dict[str, np.ndarray]:
        """The arrays under the names ``data/loader.py::DeviceLoader`` reads."""
        return {"observations": self.points, "class_label": self.class_label,
                "part_labels": self.part_labels, "se3": self.se3}


def class_meshes(spec: dict) -> list[LabelledMesh]:
    """One mesh a class: the kc46 class's tanker, every other class an
    aircraft with proportions drawn from ``proportion_seed``."""
    rng = np.random.default_rng(spec["proportion_seed"])
    props = spec["aircraft_proportions"]
    meshes = []
    for c in range(spec["classes"]):
        draw = {k: float(rng.uniform(*props[k])) for k in sorted(props)}
        meshes.append(kc46_like_mesh() if c == spec["kc46_class"]
                      else aircraft_like_mesh(**draw))
    return meshes


def rotations(yaw, pitch, roll):
    """Rz(yaw) Ry(pitch) Rx(roll), (frames, 3, 3), from (frames,) angles."""
    import torch

    cz, sz, cy, sy, cx, sx = (torch.cos(yaw), torch.sin(yaw), torch.cos(pitch),
                              torch.sin(pitch), torch.cos(roll), torch.sin(roll))
    one, zero = torch.ones_like(yaw), torch.zeros_like(yaw)
    rz = torch.stack([cz, -sz, zero, sz, cz, zero, zero, zero, one], -1).view(-1, 3, 3)
    ry = torch.stack([cy, zero, sy, zero, one, zero, -sy, zero, cy], -1).view(-1, 3, 3)
    rx = torch.stack([one, zero, zero, zero, cx, -sx, zero, sx, cx], -1).view(-1, 3, 3)
    return rz @ ry @ rx


def make_pool(spec: dict, seed: int, device="cpu") -> Pool:
    """``spec["pool_frames"]`` frames of ``spec["width"]`` points from
    ``seed``, drawn on ``device`` in a few large calls and brought to host
    memory: a class, its mesh's surface sampled by area at a native count,
    posed (yaw, pitch, roll) at a distance along a random bearing, Gaussian
    noise, then resampled to the width (the first ``width`` points, or
    repeats drawn uniformly from the frame's points).
    The same seed on the same kind of device gives the same pool."""
    import torch

    frames, width = spec["pool_frames"], spec["width"]
    g = torch.Generator(device=device).manual_seed(
        int(np.random.SeedSequence([seed, 0x6B6334]).generate_state(1)[0]))
    f32 = dict(dtype=torch.float32, device=device)

    def uniform(lo_hi, n):
        lo, hi = lo_hi
        return lo + (hi - lo) * torch.rand(n, generator=g, **f32)

    meshes = class_meshes(spec)
    part_index = {name: int(i) for i, name in spec["part_labels"].items()}
    lo, hi = spec["native_points"]
    counts = torch.from_numpy(np.linspace(lo, hi, frames).round().astype(np.int64)).to(device)
    native = counts[torch.randperm(frames, generator=g, device=device)]
    classes = (torch.arange(frames, device=device) % spec["classes"])[
        torch.randperm(frames, generator=g, device=device)]
    # every class's triangles in one table; class c's area CDF lies in (c, c + 1]
    offsets = torch.tensor(np.cumsum([0] + [len(m.triangles) for m in meshes]), device=device)
    corners = torch.from_numpy(np.concatenate(
        [m.vertices[m.triangles] for m in meshes]).astype(np.float32)).to(device)
    tri_part = torch.tensor(np.concatenate(
        [[part_index[p] for p in m.parts] for m in meshes]), dtype=torch.int32, device=device)
    cdf = torch.from_numpy(np.concatenate([
        c + np.cumsum(m.areas()) / m.areas().sum() for c, m in enumerate(meshes)])).to(device)
    frame_of = torch.repeat_interleave(torch.arange(frames, device=device), native)
    total = frame_of.numel()
    cls = classes[frame_of]
    u = torch.rand(total, generator=g, dtype=torch.float64, device=device)
    tri = torch.minimum(torch.searchsorted(cdf, cls + u), offsets[cls + 1] - 1)
    uv = torch.rand((total, 2), generator=g, **f32)
    uv = torch.where(uv.sum(dim=1, keepdim=True) > 1.0, 1.0 - uv, uv)
    a, b, c = corners[tri].unbind(1)
    surface = a + uv[:, :1] * (b - a) + uv[:, 1:] * (c - a)
    rad = np.pi / 180.0
    rot = rotations(uniform(spec["yaw_deg"], frames) * rad,
                    uniform(spec["pitch_deg"], frames) * rad,
                    uniform(spec["roll_deg"], frames) * rad)
    bearing = uniform((-180.0, 180.0), frames) * rad
    elevation = uniform(spec["elevation_deg"], frames) * rad
    distance = uniform(spec["distance"], frames)
    centre = distance[:, None] * torch.stack([
        torch.cos(bearing) * torch.cos(elevation),
        torch.sin(bearing) * torch.cos(elevation), torch.sin(elevation)], dim=1)
    r = rot[frame_of]
    cloud = (r * surface[:, None, :]).sum(dim=-1) + centre[frame_of]
    cloud = cloud + torch.randn((total, 3), generator=g, **f32) * spec["noise_stdev"]
    # the resample: slot s of frame f takes point s while s < native, else a
    # repeat floor(u * native) of the frame's points
    slot = torch.arange(width, device=device)[None, :]
    repeat = (torch.rand((frames, width), generator=g, **f32) * native[:, None]).long()
    pick = torch.where(slot < native[:, None], slot, torch.minimum(repeat, native[:, None] - 1))
    starts = torch.cumsum(native, 0) - native
    rows = (starts[:, None] + pick).reshape(-1)
    return Pool(cloud[rows].reshape(frames, width, 3).cpu().numpy(),
                classes.cpu().numpy().astype(np.int64),
                tri_part[tri[rows]].reshape(frames, width).cpu().numpy(),
                rot.cpu().numpy().astype(np.float32), native.cpu().numpy())
