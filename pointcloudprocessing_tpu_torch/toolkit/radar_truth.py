"""Radar-vs-truth calibration bookkeeping, headless
(``pointcloudprocessing_tpu/toolkit/radar_truth.py``).

The data logic of the reference's RadarCalibration view, extracted from Qt:

- ``lookup_truth_position``: bisect the OptiTrack timeline for a radar frame
  time and express the corner reflector in the radar body frame
  (gui/RadarCalibration.py:308-319).
- ``compute_centroid``: measured centroid of the filtered returns vs truth
  (:529-541).
- ``CalibrationAccumulator``: the accumulate-to-pickle point-pair store and
  the final Kabsch solve (:543-577), with an injectable path (the reference
  hardcodes data/data_bu.pkl).
"""

from __future__ import annotations

import bisect
import os
import pickle
from typing import Callable

import numpy as np

from pointcloudprocessing_tpu_torch.toolkit.calibration import solve_kabsch


# copied from pointcloudprocessing_tpu/toolkit/radar_truth.py::lookup_truth_position
def lookup_truth_position(
    truth_data: dict,
    frame_time,
    radar_body: str = "mmwave",
    target_body: str = "corner_reflector",
) -> np.ndarray:
    """Target position in the radar body frame at the OptiTrack sample
    nearest-after ``frame_time``.

    ``truth_data`` is OptiTrack.parse_log output ({timestamp: {name: 4x4}}).
    """
    opti_ts = list(truth_data.keys())
    idx = bisect.bisect_left(opti_ts, frame_time)
    idx = min(idx, len(opti_ts) - 1)
    pose_radar = truth_data[opti_ts[idx]][radar_body]
    pose_target = truth_data[opti_ts[idx]][target_body]
    rel = pose_radar[:3, :3].T @ (pose_target[:3, 3:] - pose_radar[:3, 3:])
    return rel.T[0]


# copied from pointcloudprocessing_tpu/toolkit/radar_truth.py::compute_centroid
def compute_centroid(points: np.ndarray, truth_position: np.ndarray) -> dict:
    """{'measured': centroid of points, 'truth': truth_position,
    'error': euclidean distance}."""
    measured = np.mean(np.asarray(points), axis=0)
    truth = np.asarray(truth_position)
    return {
        "measured": measured,
        "truth": truth,
        "error": float(np.linalg.norm(truth - measured)),
    }


# adapted from pointcloudprocessing_tpu/toolkit/radar_truth.py::CalibrationAccumulator:
# the Kabsch solve on ``device``
class CalibrationAccumulator:
    """Accumulates (measured, truth) centroid pairs to disk and solves the
    radar<->truth extrinsic with Kabsch on ``device`` (CUDA unless the
    caller asks for the CPU)."""

    def __init__(self, path: str = "data/data_bu.pkl",
                 print_func: Callable[[str], None] = print, device="cuda"):
        self.path = path
        self.device = device
        self._print = print_func
        self.collected: dict[str, list] = {"measured": [], "truth": []}

    def load(self) -> bool:
        if os.path.isfile(self.path):
            with open(self.path, "rb") as f:
                self.collected = pickle.load(f)
            return True
        return False

    def reset(self) -> None:
        self.collected = {"measured": [], "truth": []}

    def add(self, centroid: dict) -> int:
        """Append a compute_centroid result and persist; returns the sample
        count."""
        self.collected["measured"].append(np.asarray(centroid["measured"]))
        self.collected["truth"].append(np.asarray(centroid["truth"]))
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "wb") as f:
            pickle.dump(self.collected, f)
        return len(self.collected["measured"])

    def calibrate(self):
        """Kabsch solve over the accumulated pairs; returns (R, t, rmse) or
        None when no data exists."""
        if not self.collected["measured"] and not self.load():
            self._print("No points available for calibration.")
            return None
        return solve_kabsch(
            np.array(self.collected["truth"]), np.array(self.collected["measured"]),
            self.device,
        )
