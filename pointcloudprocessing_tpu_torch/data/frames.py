"""AftrBurner text-frame and pose-log parsing, frame writing (numpy only).

Frame format: one "(x, y, z) class part" line per point. An unknown class
or part label invalidates the whole frame; non-finite coordinates drop the
point. A collect's ``_palindrome_state__*.log`` gives each frame's SE(3)
poses (``parse_state_info``). The hot path runs through the repo's C++
scanner (``native/``, built and bound by the port's ``utils/native.py``),
with a vectorized pandas fallback.
"""

from __future__ import annotations

import io
import os
from typing import Callable

import numpy as np

from pointcloudprocessing_tpu_torch.core import constants
from pointcloudprocessing_tpu_torch.utils.native import parse_aftr_frame_native


# copied from pointcloudprocessing_tpu/data/frames.py::FrameError
class FrameError(ValueError):
    """Raised for malformed or invalid frames (the caller skips the frame)."""


# copied from pointcloudprocessing_tpu/data/frames.py::parse_frame_text
def parse_frame_text(
    text: str | bytes,
    class_labels: dict[str, int],
    part_labels: dict[str, int],
) -> tuple[np.ndarray, int, np.ndarray]:
    """Parse one frame's text into (points (n,3) f32, class_id, part_ids (n,)).

    Raises FrameError when any line has an unknown label or wrong structure.
    Non-finite points are dropped silently.
    """
    raw = text.encode() if isinstance(text, str) else text

    class_vocab = list(class_labels.keys())
    part_vocab = list(part_labels.keys())

    try:
        # upper bound on line count = byte_len / minimal line length (~12)
        max_points = max(16, len(raw) // 10)
        native = parse_aftr_frame_native(raw, class_vocab, part_vocab, max_points)
    except ValueError as e:
        raise FrameError(str(e)) from e

    if native is not None:
        xyz, cls_idx, part_idx, valid, had_unknown, _ = native
        if had_unknown:
            raise FrameError("Frame contains labels not in the label maps")
        if len(xyz) == 0:
            raise FrameError("Empty frame")
        xyz = xyz[valid]
        part_idx = part_idx[valid]
        cls_idx = cls_idx[valid]
        if len(xyz) == 0:
            raise FrameError("Frame has no finite points")
        return xyz, int(cls_idx[-1]), part_idx.astype(np.int64)

    return _parse_frame_text_python(raw.decode(), class_labels, part_labels)


# copied from pointcloudprocessing_tpu/data/frames.py::_parse_frame_text_python
def _parse_frame_text_python(
    text: str,
    class_labels: dict[str, int],
    part_labels: dict[str, int],
) -> tuple[np.ndarray, int, np.ndarray]:
    """Vectorized pandas fallback for the frame parser."""
    import pandas as pd

    cleaned = text.replace("(", " ").replace(")", " ").replace(",", " ")
    try:
        df = pd.read_csv(
            io.StringIO(cleaned),
            sep=r"\s+",
            header=None,
            names=["x", "y", "z", "cls", "part"],
            dtype={"x": np.float64, "y": np.float64, "z": np.float64,
                   "cls": str, "part": str},
            engine="c",
        )
    except Exception as e:
        raise FrameError(f"Malformed frame: {e}") from e
    if df.isnull().any(axis=None) and df[["cls", "part"]].isnull().any(axis=None):
        raise FrameError("Frame lines missing labels")

    cls_idx = df["cls"].map(class_labels)
    part_idx = df["part"].map(part_labels)
    if cls_idx.isnull().any() or part_idx.isnull().any():
        raise FrameError("Frame contains labels not in the label maps")

    xyz = df[["x", "y", "z"]].to_numpy(dtype=np.float32)
    finite = np.isfinite(xyz).all(axis=1)
    xyz = xyz[finite]
    part_arr = part_idx.to_numpy(dtype=np.int64)[finite]
    cls_arr = cls_idx.to_numpy(dtype=np.int64)[finite]
    if len(xyz) == 0:
        raise FrameError("Frame has no finite points")
    return xyz, int(cls_arr[-1]), part_arr


# copied from pointcloudprocessing_tpu/data/frames.py::parse_frame_file
def parse_frame_file(
    path: str, class_labels: dict[str, int], part_labels: dict[str, int]
):
    with open(path, "rb") as f:
        return parse_frame_text(f.read(), class_labels, part_labels)


# copied from pointcloudprocessing_tpu/data/frames.py::parse_state_info
def parse_state_info(filepath: str) -> dict[int, dict]:
    """Parse a ``_palindrome_state__*.log`` file.

    Returns {frame_number: {<header key>: value, ..., 'tanker_in_sensor_frame':
    (4,4)}} with SE(3) blocks decoded column-major, exactly like the
    reference (PointCloudSet.py:497-507).
    """
    with open(filepath, "r") as f:
        header = f.readline().strip().split("   ")
        keys = [k for k in header if len(k) > 1]

        lines = f.read().splitlines()

    data: dict[int, dict] = {}
    se3_keys = keys[2:]
    for line in lines:
        tokens = line.strip().split(" ")
        if len(tokens) < 2:
            continue
        frame = int(tokens[1])
        entry: dict = {keys[0]: tokens[0], keys[1]: tokens[1]}

        values = np.array(tokens[2:], dtype=np.float64)
        for i, key in enumerate(se3_keys):
            block = values[i * constants.SE3_SIZE : (i + 1) * constants.SE3_SIZE]
            # column-major: 16 floats are 4 columns of 4
            entry[key] = block.reshape(constants.SE3_COLS, constants.SE3_ROWS).T

        if "Sensor Pose" in keys and "Tanker Pose" in keys:
            sensor = entry["Sensor Pose"]
            tanker = entry["Tanker Pose"]
            so3 = sensor[:3, :3].T @ tanker[:3, :3]
            t = sensor[:3, :3].T @ (tanker[:3, 3:] - sensor[:3, 3:])
            top = np.concatenate([so3, t], axis=1)
            entry["tanker_in_sensor_frame"] = np.concatenate(
                [top, np.array([[0.0, 0.0, 0.0, 1.0]])], axis=0
            )
        data[frame] = entry
    return data


# copied from pointcloudprocessing_tpu/data/frames.py::write_aftr_frame
def write_aftr_frame(
    path: str,
    points: np.ndarray,
    labels: np.ndarray = np.array([]),
    print_func: Callable[[str], None] = print,
) -> None:
    """Write an AftrBurner-style frame file: "(x, y, z) label..." lines."""
    if len(points.shape) != 2 or points.shape[1] != 3:
        print_func(
            f"Unable to create aftr frame -> points vector must be shape (N, 3), not {points.shape}."
        )
        return
    if points.shape[0] != labels.shape[0] and labels.shape[0] != 0:
        print_func(
            "Unable to create aftr frame -> if labels are available, the number of labels "
            f"much match the number of points. Currently there are {points.shape[0]} points "
            f"and {labels.shape[0]} labels."
        )
        return
    if not os.path.isdir(os.path.dirname(path) or "."):
        print_func("Unable to create aftr frame -> path does not exist.")
        return

    with open(path, "w") as f:
        for i, pt in enumerate(points):
            f.write(f"({pt[0]}, {pt[1]}, {pt[2]})")
            if labels.shape[0] > 0:
                row = labels[i]
                if np.ndim(row) == 0:
                    f.write(f" {row}")
                else:
                    for lbl in row:
                        f.write(f" {lbl}")
            f.write("\n")


# copied from pointcloudprocessing_tpu/data/frames.py::get_dir_contents
def get_dir_contents(
    dir_path: str, print_func: Callable[[str], None] = print
) -> list[str]:
    """Directory listing with advisory messages (reference:
    PointCloudSet.py:523-539 free function)."""
    try:
        return os.listdir(dir_path) or []
    except FileNotFoundError:
        print_func(f"Error: The directory '{dir_path}' was not found.")
    except NotADirectoryError:
        print_func(f"Error: The path '{dir_path}' is not a directory.")
    except PermissionError:
        print_func(f"Error: Permission denied to read '{dir_path}'.")
    except Exception as e:  # pragma: no cover
        print_func(f"An error occurred: {e}")
    return []
