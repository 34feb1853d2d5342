"""The sensor toolkit (``pointcloudprocessing_tpu/toolkit``): calibration,
corner-reflector tracing, OptiTrack and Provizio readers, conversion,
plotting and training-history logic, headless; the PyQt6 GUI in ``gui/``.
Functions that reach ``ops/mat_ops.py`` take ``device=`` (CUDA unless the
caller asks for the CPU) and return numpy."""

from pointcloudprocessing_tpu_torch.toolkit.calibration import solve_kabsch
from pointcloudprocessing_tpu_torch.toolkit.corner_reflector import (
    moller_trumbore,
    get_reflection,
)
from pointcloudprocessing_tpu_torch.toolkit.optitrack import OptiTrack
from pointcloudprocessing_tpu_torch.toolkit.provizio import Provizio, ROS
from pointcloudprocessing_tpu_torch.toolkit.tqdm_capture import TQDMCapture
from pointcloudprocessing_tpu_torch.toolkit import globals  # noqa: A004 (API parity)
from pointcloudprocessing_tpu_torch.toolkit import mat_ops
from pointcloudprocessing_tpu_torch.toolkit.reflector_analysis import (
    compute_rcs,
    reflector_pose,
    trace_reflections,
)
from pointcloudprocessing_tpu_torch.toolkit.radar_truth import (
    lookup_truth_position,
    compute_centroid,
    CalibrationAccumulator,
)
from pointcloudprocessing_tpu_torch.toolkit.training_history import load_training_history
from pointcloudprocessing_tpu_torch.toolkit.plotting import PointCloudPlot

__all__ = [
    "solve_kabsch",
    "moller_trumbore",
    "get_reflection",
    "OptiTrack",
    "Provizio",
    "ROS",
    "TQDMCapture",
    "globals",
    "mat_ops",
    "compute_rcs",
    "reflector_pose",
    "trace_reflections",
    "lookup_truth_position",
    "compute_centroid",
    "CalibrationAccumulator",
    "load_training_history",
    "PointCloudPlot",
]
