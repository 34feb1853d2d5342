"""Headless MCAP -> AftrBurner conversion workflow
(``pointcloudprocessing_tpu/toolkit/conversion.py``).

The logic behind the RadarConversion GUI page (reference
gui/RadarConversion.py:196-230), extracted so it is testable without Qt:
single-frame and batch export with a consistent ``index.txt`` (the reference
wrote ``__index.log`` for single frames and ``index.txt`` for batches —
quirk fixed per SURVEY §7).
"""

from __future__ import annotations

import os
from typing import Callable, Mapping

import numpy as np

from pointcloudprocessing_tpu_torch.toolkit.tqdm_capture import TQDMCapture


# copied from pointcloudprocessing_tpu/toolkit/conversion.py::frame_xyz
def frame_xyz(frame: Mapping) -> np.ndarray:
    """(N, 3) float32 positions from a parsed Provizio frame's structured
    array (reference: gui/RadarConversion.py:199 field extraction)."""
    from numpy.lib.recfunctions import structured_to_unstructured

    return structured_to_unstructured(frame["data"][["x", "y", "z"]], np.float32)


# copied from pointcloudprocessing_tpu/toolkit/conversion.py::frame_color
def frame_color(frame: Mapping) -> np.ndarray:
    """(N,) float32 color/intensity channel (the frame's first field)."""
    return np.array(frame["data"][frame["fields"][0]], dtype=np.float32)


# copied from pointcloudprocessing_tpu/toolkit/conversion.py::write_frame
def write_frame(provizio, frame: Mapping, output_dir: str, index: int) -> str:
    """Export one frame as ``frame_<index>.txt`` and append its metadata to
    ``index.txt``. Returns the frame path."""
    path = os.path.join(output_dir, f"frame_{index}.txt")
    provizio.to_aftr_frame(path, frame_xyz(frame))
    with open(os.path.join(output_dir, "index.txt"), "a") as f:
        f.write(f"frame_{index}.txt {frame['log_time'].isoformat()}\n")
    return path


# copied from pointcloudprocessing_tpu/toolkit/conversion.py::convert_all_frames
def convert_all_frames(
    provizio,
    frames: Mapping,
    output_dir: str,
    progress_func: Callable[[int], None] | None = None,
) -> int:
    """Batch export with tqdm-derived progress percentages (reference
    :221-230 — tqdm output captured and parsed for the progress bar).
    Returns the number of frames written."""
    from tqdm import tqdm

    capture = TQDMCapture()
    count = 0
    for i, key in enumerate(tqdm(list(frames), file=capture)):
        write_frame(provizio, frames[key], output_dir, i)
        count += 1
        if progress_func is not None:
            pct = capture.get_percent()
            if pct is not None:
                progress_func(pct)
    if progress_func is not None:
        progress_func(100)
    return count
