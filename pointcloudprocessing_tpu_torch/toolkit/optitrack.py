"""OptiTrack pose-log reader (``pointcloudprocessing_tpu/toolkit/optitrack.py``;
API parity: utils/OptiTrack.py:4-68).

Same constructor (per-body mounting-rotation corrections with the reference's
corner_reflector/mmwave/lidar defaults, :7-23) and ``parse_log`` contract:
{timestamp (tz-aware datetime): {body name: 4x4 pose}} with the OptiTrack
timestamp truncated to microseconds and each 16-float block decoded
column-major then mounting-corrected (:49-58).
"""

from __future__ import annotations

import os
import re
from datetime import datetime, timezone
from typing import Callable

import numpy as np

# copied from pointcloudprocessing_tpu/toolkit/optitrack.py::_DEFAULT_OBJECT_R
_DEFAULT_OBJECT_R = {
    "corner_reflector": np.array([[0, 1, 0], [0, 0, 1], [1, 0, 0]]),
    "mmwave": np.array([[0, 1, 0], [0, 0, 1], [1, 0, 0]]),
    "lidar": np.array([[0, 1, 0], [0, 0, 1], [1, 0, 0]]),
}


# copied from pointcloudprocessing_tpu/toolkit/optitrack.py::OptiTrack
class OptiTrack:
    def __init__(
        self,
        object_R: dict[str, np.ndarray] | None = None,
        print_func: Callable[[str], None] = print,
    ):
        self._print = print_func
        self._object_R = _DEFAULT_OBJECT_R if object_R is None else object_R

    def parse_log(self, path: str) -> dict:
        if not os.path.isfile(path):
            self._print("OptiTrack log file failed to load.")
            return {}
        try:
            output: dict = {}
            with open(path, "r") as f:
                for line in f.readlines():
                    line = line.strip()
                    if not line or line[0] == "#":
                        continue
                    tokens = line.replace("\t", " ").split(" ")

                    # truncate sub-microsecond digits so strptime accepts it
                    stamp_str = re.sub(r"(\.\d{6})\d+", r"\1", tokens.pop(0))
                    timestamp = datetime.strptime(
                        stamp_str, "%Y.%b.%d_%H.%M.%S.%f.UTC"
                    ).replace(tzinfo=timezone.utc)
                    output[timestamp] = {}

                    num_items = int(tokens.pop(0))
                    for item in range(num_items):
                        name = tokens[17 * item]
                        values = [
                            float(tokens[17 * item + el + 1]) for el in range(16)
                        ]
                        pose = np.array(values).reshape((4, 4)).T
                        if name in self._object_R:
                            pose[:3, :3] = pose[:3, :3] @ self._object_R[name]
                        output[timestamp][name] = pose
            return output
        except Exception as e:
            self._print(
                f"OptiTrack:  Error occured while parsing file:\n\t{type(e)}: {e}"
            )
            return {}


# copied from pointcloudprocessing_tpu/toolkit/optitrack.py::body_time_series
def body_time_series(data: dict) -> dict[str, np.ndarray]:
    """Stack a parsed log into per-body (t, 4, 4) pose arrays — the headless
    core of the OptiTrack time-series page (reference
    gui/OptiTrackCalibration.py:143-189)."""
    bodies: dict[str, list] = {}
    for _, items in data.items():
        for name, pose in items.items():
            bodies.setdefault(name, []).append(pose)
    return {name: np.array(poses) for name, poses in bodies.items()}


# adapted from pointcloudprocessing_tpu/toolkit/optitrack.py::compute_sync_offsets:
# the Euler angles on ``device``
def compute_sync_offsets(data: dict, a_name: str, b_name: str,
                         device="cuda") -> dict | None:
    """Mean/variance of body B's pose expressed in body A's frame across all
    timestamps where both are tracked (reference gui/OptiTrackCalibration.py
    :320-356 'sync' — with its yaw/roll accumulation swap fixed). Returns
    {axis: {mean, var}} for x/y/z/roll/pitch/yaw, or None without overlap.
    The Euler angles are taken in f32 on ``device`` (CUDA unless the caller
    asks for the CPU)."""
    from pointcloudprocessing_tpu_torch.toolkit import mat_ops

    offsets: dict[str, list] = {
        "x": [], "y": [], "z": [], "roll": [], "pitch": [], "yaw": []
    }
    for _, items in data.items():
        if a_name not in items or b_name not in items:
            continue
        a, b = items[a_name], items[b_name]
        delta_t = a[:3, :3].T @ (b[:3, 3] - a[:3, 3])
        rel = a[:3, :3].T @ b[:3, :3]
        rpy = mat_ops.get_roll_pitch_yaw_deg(rel, device)
        offsets["x"].append(delta_t[0])
        offsets["y"].append(delta_t[1])
        offsets["z"].append(delta_t[2])
        offsets["roll"].append(float(rpy["roll"]))
        offsets["pitch"].append(float(rpy["pitch"]))
        offsets["yaw"].append(float(rpy["yaw"]))
    if not offsets["x"]:
        return None
    return {
        k: {"mean": float(np.mean(v)), "var": float(np.var(v))}
        for k, v in offsets.items()
    }
