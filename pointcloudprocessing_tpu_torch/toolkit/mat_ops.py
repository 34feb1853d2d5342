"""Toolkit-facing matrix ops (``pointcloudprocessing_tpu/toolkit/mat_ops.py``;
API parity with point_cloud_toolkit/utils/mat_ops.py).

Every function is a numpy-facing wrapper over the port's
``ops/mat_ops.py``, keeping the toolkit's call signatures: it computes in
f32 on ``device`` (CUDA unless the caller asks for the CPU; without CUDA
the default raises) and returns numpy.
"""

from __future__ import annotations

import numpy as np

from pointcloudprocessing_tpu_torch.ops import mat_ops as _ops


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _yaw(dcm: np.ndarray, yaw_rad: float, device="cuda") -> np.ndarray:
    return _np(_ops.apply_yaw(np.asarray(dcm, dtype=float), yaw_rad, device))


def _pitch(dcm: np.ndarray, pitch_rad: float, device="cuda") -> np.ndarray:
    return _np(_ops.apply_pitch(np.asarray(dcm, dtype=float), pitch_rad, device))


def _roll(dcm: np.ndarray, roll_rad: float, device="cuda") -> np.ndarray:
    return _np(_ops.apply_roll(np.asarray(dcm, dtype=float), roll_rad, device))


def get_roll_pitch_yaw_deg(dcm: np.ndarray, device="cuda") -> dict:
    out = _ops.get_roll_pitch_yaw_deg(np.asarray(dcm, dtype=float), device)
    return {k: _np(v) for k, v in out.items()}


def get_dcm(roll_deg: float, pitch_deg: float, yaw_deg: float,
            device="cuda") -> np.ndarray:
    return _np(_ops.get_dcm(roll_deg, pitch_deg, yaw_deg, device))


def get_DCM_positive_x_pointing_at_origin(pos: np.ndarray, roll_deg: float = 0.0,
                                          device="cuda") -> np.ndarray:
    return _np(_ops.get_dcm_positive_x_pointing_at_origin(
        np.asarray(pos, dtype=float), roll_deg, device))


def reorthogonalize(dcm: np.ndarray, device="cuda") -> np.ndarray:
    return _np(_ops.reorthogonalize(np.asarray(dcm, dtype=float), device))


# copied from pointcloudprocessing_tpu/toolkit/mat_ops.py::plot_euler_angles
def plot_euler_angles(traces: np.ndarray, trace_labels: list, title: str) -> None:
    """Euler-angle trace plot (reference utils/mat_ops.py:67-90; plotly-gated)."""
    assert len(traces.shape) == 2, "`traces` must be a 2D np.ndarray"
    assert traces.shape[0] == len(trace_labels), (
        "Number of trace labels must equal number of traces"
    )
    try:
        import plotly.graph_objects as go
        from plotly.subplots import make_subplots
    except ImportError:
        print("plot_euler_angles: plotly is not installed.")
        return
    x = np.arange(1, traces.shape[1])
    fig = make_subplots()
    for i, trace in enumerate(traces):
        fig.add_trace(go.Scatter(x=x, y=trace, mode="lines", name=trace_labels[i]))
    fig.update_layout(title=title)
    fig.update_yaxes(title_text="Angle (deg)")
    fig.show()


def convert_radar_to_global(
    rg_az_el: np.ndarray, radar_pos: np.ndarray, radar_rpy: np.ndarray,
    device="cuda",
) -> np.ndarray:
    return _np(_ops.convert_radar_to_global(
        np.asarray(rg_az_el, dtype=float),
        np.asarray(radar_pos, dtype=float),
        np.asarray(radar_rpy, dtype=float),
        device,
    ))
