"""Write MeshSampler observations out as an AftrBurner-style collect
(numpy only; ``pointcloudprocessing_tpu/synthesis/collect.py``, on the
port's ``data/frames.py::write_aftr_frame``).

Bridges the synthesis path to the ingest path: the reference's training data
arrives as collect directories (``Lidar/frame_N.txt`` + a
``_palindrome_state__*.log`` pose log — PointCloudSet.py:116-218,472-509);
this writer produces the same layout from synthesized observations so that
fully self-contained experiments (e.g. the class-test sweep) can run without
recorded sensor data.
"""

from __future__ import annotations

import os

import numpy as np

from ..data.frames import write_aftr_frame

# copied from pointcloudprocessing_tpu/synthesis/collect.py::_POSE_HEADER
_POSE_HEADER = "Time   Frame   Sensor Pose   Tanker Pose"


# copied from pointcloudprocessing_tpu/synthesis/collect.py::_pose_row
def _pose_row(timestamp: str, frame: int, sensor: np.ndarray, tanker: np.ndarray) -> str:
    tokens = [timestamp, str(frame)]
    for m in (sensor, tanker):
        tokens.extend(repr(float(v)) for v in np.asarray(m).T.ravel())  # column-major
    return " ".join(tokens)


# copied from pointcloudprocessing_tpu/synthesis/collect.py::write_collect
def write_collect(
    collect_dir: str,
    observations: np.ndarray,
    class_name: str,
    part_names: np.ndarray,
    dcms: np.ndarray | None = None,
    positions: np.ndarray | None = None,
    fast: bool = False,
) -> str:
    """Write one collect directory.

    Args:
      collect_dir: output directory (created; typically named ``collect_*``).
      observations: (f, n, 3) point clouds.
      class_name: class label applied to every point.
      part_names: (f, n) per-point part-label strings.
      dcms: optional (f, 3, 3) sensor orientations — stored as the tanker
        pose rotation with an identity sensor pose, so the ingest-side
        ``tanker_in_sensor_frame`` rotation reproduces them.
      positions: optional (f, 3) translations for the tanker pose.

    Returns collect_dir.
    """
    observations = np.asarray(observations)
    num_frames = observations.shape[0]
    lidar = os.path.join(collect_dir, "Lidar")
    os.makedirs(lidar, exist_ok=True)

    rows = [_POSE_HEADER]
    for i in range(num_frames):
        sensor = np.eye(4)
        tanker = np.eye(4)
        if dcms is not None:
            tanker[:3, :3] = dcms[i]
        if positions is not None:
            tanker[:3, 3] = positions[i]
        stamp = f"2026.Jan.01_00.00.{i % 60:02d}.{i:07d}.UTC"
        rows.append(_pose_row(stamp, i, sensor, tanker))
    log_path = os.path.join(
        collect_dir, "_palindrome_state__2026.Jan.01_00.00.00.UTC.log"
    )
    with open(log_path, "w") as f:
        f.write("\n".join(rows) + "\n")

    for i in range(num_frames):
        if fast:
            _write_frame_fast(
                os.path.join(lidar, f"frame_{i}.txt"),
                observations[i],
                class_name,
                np.asarray(part_names[i]),
            )
        else:
            labels = np.stack(
                [np.full(observations.shape[1], class_name), np.asarray(part_names[i])],
                axis=1,
            )
            write_aftr_frame(
                os.path.join(lidar, f"frame_{i}.txt"), observations[i], labels
            )
    return collect_dir


# copied from pointcloudprocessing_tpu/synthesis/collect.py::_write_frame_fast
def _write_frame_fast(
    path: str, points: np.ndarray, class_name: str, parts: np.ndarray
) -> None:
    """Vectorized frame writer: same "(x, y, z) class part" line grammar as
    data.frames.write_aftr_frame, ~40x faster for multi-thousand-frame
    collects (floats rendered at 6 decimals instead of full f64 repr — the
    ingest grammar and downstream training are precision-insensitive at
    that scale: jitter augment alone is 0.1 m)."""
    lines = [
        f"({x:.6f}, {y:.6f}, {z:.6f}) {class_name} {part}"
        for (x, y, z), part in zip(points, parts)
    ]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


# copied from pointcloudprocessing_tpu/synthesis/collect.py::dominant_axis_parts
def dominant_axis_parts(
    observations: np.ndarray,
    part_names: tuple[str, str, str] = ("engine", "wing", "fuselage"),
) -> np.ndarray:
    """Geometric part labeling for synthetic clouds: each point is labeled by
    its dominant centered coordinate axis (x, y, z order), giving the
    segmentation head a learnable signal on procedural shapes."""
    observations = np.asarray(observations)
    centered = observations - observations.mean(axis=1, keepdims=True)
    axis = np.argmax(np.abs(centered), axis=-1)  # (f, n) in {0,1,2}
    return np.asarray(part_names, dtype=object)[axis]
