"""mmWave radar CSV -> global-frame point cloud, with the PyTorch port
(twin of ``examples/data_exploration.py``).

Reads range/azimuth/elevation returns from a CSV (the standard ``csv``
module: no pandas), converts each to a global cartesian point with the
radar's pose (``convert_radar_to_global``, on ``--device``), and writes an
AftrBurner-style frame.

CSV columns expected: range_m, azimuth_deg, elevation_deg[, strength]

Usage: python examples/torch/data_exploration.py <returns.csv>
[out_frame.txt] [--device cuda|cpu]
"""

import argparse
import csv
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from pointcloudprocessing_tpu_torch.data import write_aftr_frame  # noqa: E402
from pointcloudprocessing_tpu_torch.ops import mat_ops  # noqa: E402
from pointcloudprocessing_tpu_torch.utils.device import require_device  # noqa: E402

RADAR_POS = np.array([0.0, 0.0, 1.0])       # radar mounting position (m)
RADAR_RPY = np.array([0.0, 0.0, 0.0])       # roll/pitch/yaw (deg)
SCALE_RANGE = 1.0                           # range scaling (notebook cell 2)
COLUMNS = ("range_m", "azimuth_deg", "elevation_deg")


def read_returns(csv_path: str) -> np.ndarray:
    """The CSV's (range, azimuth, elevation) columns as an (n, 3) array."""
    with open(csv_path, newline="") as f:
        rows = list(csv.DictReader(f))
    return np.array([[float(row[c]) for c in COLUMNS] for row in rows],
                    dtype=float).reshape(-1, 3)


def main(csv_path: str, out_path: str | None = None, device="cuda") -> None:
    device = require_device(device)
    rae = read_returns(csv_path)
    rae[:, 0] *= SCALE_RANGE

    points = mat_ops.convert_radar_to_global(
        rae, RADAR_POS, RADAR_RPY, device).cpu().numpy()
    print(f"{len(points)} returns -> global frame")
    print("extent x/y/z:",
          points.min(axis=0).round(2), "to", points.max(axis=0).round(2))

    if out_path:
        write_aftr_frame(out_path, points)
        print(f"wrote {out_path}")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("csv_path")
    parser.add_argument("out_path", nargs="?", default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    main(args.csv_path, args.out_path, args.device)
