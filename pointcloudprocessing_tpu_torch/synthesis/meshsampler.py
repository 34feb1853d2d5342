"""MeshSampler: synthetic viewpoint observations from a mesh
(``pointcloudprocessing_tpu/synthesis/meshsampler.py``).

The same constructor (mesh_path, mesh_label, rotation_matrix,
center_point, scale, random_seed, mesh) with a ``device`` (CUDA unless the
caller asks for the CPU), the same ``create_viewpoint_observations`` /
``create_labeled_viewpoint_observations`` /
``create_full_sample_observations`` signatures and parallel-array returns
(observations, labels or parts, positions, dcms), and ``pad_observation``.

The numpy Generator makes every draw (the dense surface sample, the
viewpoints, the camera rolls, the shuffles), so a ``random_seed`` gives the
JAX package's viewpoints, shuffles and padding exactly. Hidden-point
removal is the host Qhull step of :mod:`..ops.hpr`; the look-at DCMs of
all viewpoints are built in f32 on ``device`` by :mod:`..ops.mat_ops` in
one call and brought back to numpy. The plotly viewers are gated on
plotly, as in the JAX module.
"""

from __future__ import annotations

import numpy as np

from pointcloudprocessing_tpu_torch.ops import mat_ops
from pointcloudprocessing_tpu_torch.ops.hpr import hidden_point_removal
from pointcloudprocessing_tpu_torch.synthesis.mesh import (
    Mesh,
    load_obj,
    sample_points_uniformly,
)


# copied from pointcloudprocessing_tpu/synthesis/meshsampler.py::pad_observation
def pad_observation(n: int, observation: list) -> list:
    """Clip to n, or pad by repeating from the front (reference
    MeshSampler.py:342-348)."""
    if n <= len(observation):
        return observation[:n]
    out = list(observation)
    for i in range(n - len(observation)):
        out.append(out[i])
    return out


# copied from pointcloudprocessing_tpu/synthesis/meshsampler.py::_viewpoints_from_ranges
def _viewpoints_from_ranges(gen, n, dist_range, az_range, elev_range):
    """Random spherical viewpoints -> cartesian (reference
    MeshSampler.py:233-236,292-295)."""
    viewangles = np.array(
        [
            gen.uniform(low=dist_range[0], high=dist_range[1], size=n),
            gen.uniform(low=az_range[0], high=az_range[1], size=n),
            gen.uniform(low=elev_range[0], high=elev_range[1], size=n),
        ]
    )
    return np.array(
        [
            viewangles[0]
            * np.cos(np.deg2rad(viewangles[1]))
            * np.sin(np.deg2rad(90 - viewangles[2])),
            viewangles[0]
            * np.sin(np.deg2rad(viewangles[1]))
            * np.sin(np.deg2rad(90 - viewangles[2])),
            viewangles[0] * np.cos(np.deg2rad(90 - viewangles[2])),
        ]
    ).T


class MeshSampler:
    def __init__(
        self,
        mesh_path: str | None,
        mesh_label: str,
        rotation_matrix: np.ndarray = np.eye(3),
        center_point: np.ndarray = np.zeros(3),
        scale: float = 1.0,
        random_seed: int = 42,
        mesh: Mesh | None = None,
        device="cuda",
    ):
        """``mesh`` accepts an in-memory Mesh (e.g. from
        synthesis.procedural) as an alternative to ``mesh_path``. The mesh
        is copied before the scale/rotate/center transforms so the caller's
        object is never mutated (callers commonly reuse one Mesh across
        several samplers). The look-at DCMs are computed on ``device``."""
        self.ADVISORY_HEADER = "MeshSampler:  "
        self.path = mesh_path
        self._R = np.asarray(rotation_matrix, dtype=float)
        self._p = np.asarray(center_point, dtype=float)
        self.label = mesh_label
        self._seed = random_seed
        self.device = device

        self.mesh: Mesh | None = None
        if self.path is not None:
            self.mesh = load_obj(self.path)
        elif mesh is not None:
            self.mesh = Mesh(
                vertices=np.array(mesh.vertices), triangles=np.array(mesh.triangles)
            )
        if self.mesh is not None:
            self.mesh.scale(scale, np.zeros(3))
            self._rotate_and_center_3d_mesh()

    # -- plotly viewers (reference MeshSampler.py:61-191; gated) -----------

    def show_scene(self, cloud, title: str = "Capture Scene") -> None:
        """Mesh + returns + camera positions overlay (reference
        MeshSampler.py:130-191). ``cloud`` is a mapping with xg/yg/zg,
        strength, cam_xg/cam_yg/cam_zg columns (e.g. a DataFrame)."""
        assert self.mesh is not None, "show_scene:  no mesh loaded"
        try:
            import plotly.graph_objects as go
        except ImportError:
            print(f"{self.ADVISORY_HEADER}plotly is not installed.")
            return
        v, f = self.mesh.vertices, self.mesh.triangles
        fig = go.Figure(
            data=[
                go.Mesh3d(x=v[:, 0], y=v[:, 1], z=v[:, 2],
                          i=f[:, 0], j=f[:, 1], k=f[:, 2],
                          color="lightblue", opacity=1.0),
                go.Scatter3d(x=cloud["xg"], y=cloud["yg"], z=cloud["zg"],
                             mode="markers",
                             marker=dict(size=2, color=cloud["strength"],
                                         colorscale="Viridis",
                                         colorbar=dict(title="Magnitude")),
                             name="Returns"),
                go.Scatter3d(x=cloud["cam_xg"], y=cloud["cam_yg"],
                             z=cloud["cam_zg"], mode="markers",
                             marker=dict(size=2, color="red"), name="Camera"),
            ]
        )
        fig.update_layout(
            scene=dict(xaxis_title="X", yaxis_title="Y", zaxis_title="Z",
                       aspectmode="data"),
            title=title, margin=dict(l=0, r=0, b=0, t=40),
        )
        fig.show()

    def show_mesh(self, title: str = "Mesh") -> None:
        if self.mesh is None:
            print(f"{self.ADVISORY_HEADER}No mesh loaded.")
            return
        try:
            import plotly.graph_objects as go
        except ImportError:
            print(f"{self.ADVISORY_HEADER}plotly is not installed.")
            return
        v, f = self.mesh.vertices, self.mesh.triangles
        fig = go.Figure(
            data=[go.Mesh3d(x=v[:, 0], y=v[:, 1], z=v[:, 2],
                            i=f[:, 0], j=f[:, 1], k=f[:, 2],
                            color="lightblue", opacity=1.0)]
        )
        fig.update_layout(scene=dict(aspectmode="data"), title=title)
        fig.show()

    def display_point_clouds(self, clouds: list, labels: list,
                             title: str = "Point Cloud") -> None:
        assert len(clouds) == len(labels), (
            "display_point_clouds:  ensure there is a label for each cloud"
        )
        try:
            import plotly.graph_objects as go
        except ImportError:
            print(f"{self.ADVISORY_HEADER}plotly is not installed.")
            return
        plots = [
            go.Scatter3d(x=c[:, 0], y=c[:, 1], z=c[:, 2], mode="markers",
                         marker=dict(size=2, opacity=1.0), name=labels[i])
            for i, c in enumerate(clouds)
        ]
        fig = go.Figure(data=plots)
        fig.update_layout(
            scene=dict(xaxis_title="X", yaxis_title="Y", zaxis_title="Z",
                       aspectmode="data"),
            title=title, margin=dict(l=0, r=0, b=0, t=40),
        )
        fig.show()

    def _look_at_dcms(self, viewpoints: np.ndarray, camera_roll: np.ndarray) -> np.ndarray:
        """(n, 3, 3) f32 DCMs, +x from each viewpoint at the origin, rolled
        by ``camera_roll`` degrees: one call on the sampler's device."""
        return mat_ops.get_dcm_positive_x_pointing_at_origin(
            viewpoints, camera_roll, device=self.device).cpu().numpy()

    def _rotate_and_center_3d_mesh(self) -> None:
        """Rotate about the configured center then translate it to the origin
        (reference MeshSampler.py:325-340)."""
        if self.mesh is None:
            print(f"{self.ADVISORY_HEADER}No mesh loaded.")
            return
        self.mesh.rotate(self._R, self._p)
        self.mesh.translate(-self._p)

    def create_viewpoint_observations(
        self,
        n: int,
        p: int,
        pad: int,
        dist_range: tuple = (5.0, 10.0),
        az_range: tuple = (0.0, 359.0),
        elev_range: tuple = (-5.0, 20.0),
        camera_rot: float = 0.0,
        reproject: bool = False,
    ):
        """Per-viewpoint visible-surface observations (reference
        MeshSampler.py:253-312): dense uniform sample once, then per random
        viewpoint hidden-point removal, optional camera-frame reprojection,
        shuffle, pad/clip to ``pad`` points."""
        observations, labels, position, dcm = [], [], [], []
        if self.mesh is None:
            print(f"{self.ADVISORY_HEADER}No mesh loaded.")
            return (np.array(observations), np.array(labels), np.array(position), np.array(dcm))

        gen = np.random.default_rng(seed=self._seed)
        points = sample_points_uniformly(self.mesh, p, gen)
        viewpoints = _viewpoints_from_ranges(gen, n, dist_range, az_range, elev_range)
        camera_roll = np.array(gen.uniform(low=-camera_rot, high=camera_rot, size=n))

        dcms = self._look_at_dcms(viewpoints, camera_roll)
        for i, vp in enumerate(viewpoints):
            c_r_w = dcms[i]
            # NOTE: the reference passes the camera as ``-vp``
            # (MeshSampler.py:300) — an open3d-convention artifact producing
            # back-face views; we sight from the actual viewpoint.
            visible_idx = hidden_point_removal(points, vp)
            in_sight = points[visible_idx]
            if reproject:
                in_sight = (c_r_w @ (in_sight.T - vp.reshape(3, 1))).T
            gen.shuffle(in_sight)
            observations.append(np.array(pad_observation(pad, list(in_sight))))
            labels.append(self.label)
            position.append(np.zeros(3) if reproject else vp)
            dcm.append(c_r_w)

        return (np.array(observations), np.array(labels), np.array(position), np.array(dcm))

    def create_labeled_viewpoint_observations(
        self,
        n: int,
        p: int,
        pad: int,
        triangle_parts: np.ndarray,
        dist_range: tuple = (5.0, 10.0),
        az_range: tuple = (0.0, 359.0),
        elev_range: tuple = (-5.0, 20.0),
        camera_rot: float = 0.0,
        reproject: bool = False,
    ):
        """Viewpoint observations with per-point part labels.

        Same pipeline as :meth:`create_viewpoint_observations` (dense
        uniform sample, per-viewpoint hidden-point removal, shuffle,
        pad/clip — reference MeshSampler.py:253-312), but the mesh is a
        labeled compound: ``triangle_parts`` names each triangle's part and
        every sampled point inherits its source triangle's name through
        HPR/shuffle/pad, yielding segmentation ground truth the reference
        obtained from its AftrBurner simulation.

        Returns (observations (n, pad, 3), part_labels (n, pad) object,
        positions (n, 3), dcms (n, 3, 3)).
        """
        observations, parts, position, dcm = [], [], [], []
        assert self.mesh is not None, "create_labeled_viewpoint_observations: no mesh loaded"
        triangle_parts = np.asarray(triangle_parts, dtype=object)
        assert len(triangle_parts) == len(self.mesh.triangles), (
            "triangle_parts must name every mesh triangle"
        )

        gen = np.random.default_rng(seed=self._seed)
        points, tri_idx = sample_points_uniformly(
            self.mesh, p, gen, return_triangle_indices=True
        )
        point_parts = triangle_parts[tri_idx]
        viewpoints = _viewpoints_from_ranges(gen, n, dist_range, az_range, elev_range)
        camera_roll = np.array(gen.uniform(low=-camera_rot, high=camera_rot, size=n))

        dcms = self._look_at_dcms(viewpoints, camera_roll)
        for i, vp in enumerate(viewpoints):
            c_r_w = dcms[i]
            visible_idx = hidden_point_removal(points, vp)
            in_sight = points[visible_idx]
            in_sight_parts = point_parts[visible_idx]
            if reproject:
                in_sight = (c_r_w @ (in_sight.T - vp.reshape(3, 1))).T
            perm = gen.permutation(len(in_sight))
            # pad by repeating from the front with the SAME indices for
            # points and labels (pad_observation semantics, label-aligned)
            idx = np.asarray(pad_observation(pad, list(perm)), dtype=np.int64)
            observations.append(in_sight[idx])
            parts.append(in_sight_parts[idx])
            position.append(np.zeros(3) if reproject else vp)
            dcm.append(c_r_w)

        return (
            np.array(observations),
            np.array(parts, dtype=object),
            np.array(position),
            np.array(dcm),
        )

    def create_full_sample_observations(
        self,
        n: int,
        p: int,
        pad: int,
        dist_range: tuple = (5.0, 10.0),
        az_range: tuple = (0.0, 359.0),
        elev_range: tuple = (-5.0, 20.0),
        camera_rot: float = 0.0,
        reproject: bool = False,
    ):
        """Full-surface (no occlusion) observations per viewpoint (reference
        MeshSampler.py:193-251)."""
        observations, labels, position, dcm = [], [], [], []
        if self.mesh is None:
            print(f"{self.ADVISORY_HEADER}No mesh loaded.")
            return (np.array(observations), np.array(labels), np.array(position), np.array(dcm))

        gen = np.random.default_rng(seed=self._seed)
        points = sample_points_uniformly(self.mesh, p, gen)
        viewpoints = _viewpoints_from_ranges(gen, n, dist_range, az_range, elev_range)
        camera_roll = np.array(gen.uniform(low=-camera_rot, high=camera_rot, size=n))

        dcms = self._look_at_dcms(viewpoints, camera_roll)
        for i, vp in enumerate(viewpoints):
            c_r_w = dcms[i]
            in_sight = points.copy()
            if reproject:
                in_sight = (c_r_w @ (in_sight.T - vp.reshape(3, 1))).T
            observations.append(np.array(pad_observation(pad, list(in_sight))))
            labels.append(self.label)
            position.append(np.zeros(3) if reproject else vp)
            dcm.append(c_r_w)

        return (np.array(observations), np.array(labels), np.array(position), np.array(dcm))
