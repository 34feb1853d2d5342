"""Relative-pose math from a palindrome state log, with the PyTorch port
(twin of ``examples/pose_computation.py``).

Parses a ``_palindrome_state__*.log``, takes the tanker pose in the sensor
frame per frame (the ingest path's SE(3) algebra), and reports Euler
angle and translation trajectories; the angles are computed on
``--device``.

Usage: python examples/torch/pose_computation.py <palindrome_state_log>
[--device cuda|cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from pointcloudprocessing_tpu_torch.data import parse_state_info  # noqa: E402
from pointcloudprocessing_tpu_torch.toolkit import mat_ops  # noqa: E402
from pointcloudprocessing_tpu_torch.utils.device import require_device  # noqa: E402


def main(path: str, device="cuda") -> None:
    device = require_device(device)
    info = parse_state_info(path)
    print(f"frames: {len(info)}")
    for frame in sorted(info)[:20]:
        rel = info[frame].get("tanker_in_sensor_frame")
        if rel is None:
            print(f"frame {frame}: no Sensor/Tanker poses in log")
            continue
        angles = mat_ops.get_roll_pitch_yaw_deg(rel[:3, :3], device)
        t = rel[:3, 3]
        print(
            f"frame {frame}: t=({t[0]:+.2f}, {t[1]:+.2f}, {t[2]:+.2f}) m  "
            f"rpy=({float(angles['roll']):+.1f}, {float(angles['pitch']):+.1f}, "
            f"{float(angles['yaw']):+.1f}) deg"
        )
    if len(info) > 20:
        print(f"... {len(info) - 20} more frames")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("log", help="a _palindrome_state__*.log file")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    main(args.log, args.device)
