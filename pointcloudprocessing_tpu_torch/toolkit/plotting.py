"""Plot widgets (``pointcloudprocessing_tpu/toolkit/plotting.py``; API
parity: utils/custom_plotting.py).

The data/filter logic is headless and fully tested; figure construction
(``get_fig``/``show``) requires plotly and the Qt canvases require
matplotlib's Qt backend — both degrade with a clear advisory when missing.

Parity map:
- ``PointCloudPlot`` (:130-330): tagged scatter buffers, red truth markers,
  radius + color-percentile filters AND-combined, ``get_points`` /
  ``get_max_radius_from``.
- ``LinePlot`` (:13-128): dual-y line series ('accuracy'/'error' on y1,
  'loss' on y2 chosen by the caller).
- ``QuiverPlot`` (:333-420): position+normal cone/quiver data.
- ``LineCanvas`` (:422-469): 2D line-segment figure.
"""

from __future__ import annotations

from typing import Callable

import numpy as np


# copied from pointcloudprocessing_tpu/toolkit/plotting.py::_require_plotly
def _require_plotly(print_func):
    try:
        import plotly.graph_objects as go

        if not hasattr(go, "Figure"):  # stubbed/partial module
            raise ImportError("plotly.graph_objects lacks Figure")
        return go
    except ImportError:
        print_func("plotly is not installed — figure rendering unavailable.")
        return None


# copied from pointcloudprocessing_tpu/toolkit/plotting.py::PointCloudPlot
class PointCloudPlot:
    def __init__(self, title: str = "", print_func: Callable[[str], None] = print):
        self._title = title
        self._print = print_func
        self._size_lims = [1, 10]
        self._opacity_lims = [0.0, 1.0]
        self.clear()
        self._filter = None
        self._color_filter = None
        self._radius_filter = None

    # -- buffers -----------------------------------------------------------

    def add(self, data: np.ndarray, color: np.ndarray, tag: str,
            size: int = 5, opacity: float = 1.0) -> None:
        size = int(np.clip(size, *self._size_lims))
        opacity = float(np.clip(opacity, *self._opacity_lims))
        n = data.shape[0]
        if self._data.shape[0] < 1:
            self._data = np.asarray(data)
            self._colors = np.asarray(color)
            self._tags = np.array([tag] * n)
            self._size = np.array([size] * n)
            self._opacity = np.array([opacity] * n)
        else:
            self._data = np.concatenate((self._data, data), axis=0)
            self._colors = np.concatenate((self._colors, color), axis=0)
            self._tags = np.concatenate((self._tags, np.array([tag] * n)))
            self._size = np.concatenate((self._size, np.array([size] * n)))
            self._opacity = np.concatenate((self._opacity, np.array([opacity] * n)))

    def add_red_point(self, pt: np.ndarray, tag: str = "", size: int = 5) -> None:
        size = int(np.clip(size, *self._size_lims))
        if self._red_points.shape[0] < 1:
            self._red_points = np.array([pt])
            self._red_tags = np.array([tag])
            self._red_size = np.array([size])
        else:
            self._red_points = np.concatenate((self._red_points, [pt]), axis=0)
            self._red_tags = np.concatenate((self._red_tags, [tag]))
            self._red_size = np.concatenate((self._red_size, [size]))

    def clear_red_points(self) -> None:
        self._red_points = np.array([])
        self._red_tags = np.array([])
        self._red_size = np.array([])

    def clear_filter(self) -> None:
        self._filter = None
        self._radius_filter = None
        self._color_filter = None

    def clear(self) -> None:
        self._data = np.array([])
        self._colors = np.array([])
        self._tags = np.array([])
        self._size = np.array([])
        self._opacity = np.array([])
        self.clear_red_points()

    def remove(self, tag: str) -> None:
        indices = np.where(self._tags == tag)
        self._data = np.delete(self._data, indices, axis=0)
        self._colors = np.delete(self._colors, indices, axis=0)
        self._tags = np.delete(self._tags, indices, axis=0)
        self._size = np.delete(self._size, indices, axis=0)
        self._opacity = np.delete(self._opacity, indices, axis=0)

    def set_size(self, tag: str, size: int) -> None:
        self._size[self._tags == tag] = int(np.clip(size, *self._size_lims))

    def set_opacity(self, tag: str, opacity: float) -> None:
        self._opacity[self._tags == tag] = float(np.clip(opacity, *self._opacity_lims))

    # -- filters -----------------------------------------------------------

    def filter_by_radius(self, center: np.ndarray, radius: float) -> None:
        self._radius_filter = (
            np.sum((self._data - center) ** 2, axis=1) < radius**2
        )

    def filter_by_color(self, value: float, show_greater_than: bool = True) -> None:
        """Percentile-of-range color filter; value in [0, 100]."""
        if 0 <= value <= 100:
            _min, _max = self._colors.min(), self._colors.max()
            threshold = (value / 100) * (_max - _min) + _min
            if show_greater_than:
                self._color_filter = self._colors > threshold
            else:
                self._color_filter = self._colors <= threshold
        else:
            self._print(
                f"PointCloudPlot:  filter_by_color requires a value in range [0, 100], not {value}"
            )

    def _combine_filters(self):
        if self._color_filter is not None and self._radius_filter is not None:
            self._filter = self._radius_filter & self._color_filter
        elif self._color_filter is not None:
            self._filter = self._color_filter
        elif self._radius_filter is not None:
            self._filter = self._radius_filter
        else:
            self._filter = None
        return self._filter

    def get_points(self) -> np.ndarray:
        self._combine_filters()
        if self._filter is None:
            return self._data
        return self._data[self._filter]

    def get_max_radius_from(self, value: np.ndarray) -> float:
        return float(np.max(np.sqrt(np.sum((self._data - value) ** 2, axis=1))))

    # -- rendering ---------------------------------------------------------

    def get_fig(self):
        go = _require_plotly(self._print)
        if go is None:
            return None
        fig = go.Figure()
        filt = self._combine_filters()
        if self._data.shape[0] > 0:
            data = self._data if filt is None else self._data[filt]
            colors = self._colors if filt is None else self._colors[filt]
            sizes = self._size if filt is None else self._size[filt]
            fig.add_trace(
                go.Scatter3d(
                    x=data[:, 0], y=data[:, 1], z=data[:, 2],
                    mode="markers",
                    marker=dict(size=sizes, color=colors, colorscale="Viridis"),
                )
            )
        if self._red_points.shape[0] > 0:
            fig.add_trace(
                go.Scatter3d(
                    x=self._red_points[:, 0],
                    y=self._red_points[:, 1],
                    z=self._red_points[:, 2],
                    mode="markers",
                    marker=dict(size=self._red_size, color="red"),
                )
            )
        fig.update_layout(title=self._title)
        return fig

    def show(self) -> None:
        fig = self.get_fig()
        if fig is not None:
            fig.show()


# copied from pointcloudprocessing_tpu/toolkit/plotting.py::LinePlot
class LinePlot:
    """Dual-y line plot data model (reference custom_plotting.py:13-128)."""

    def __init__(self, title: str = "", print_func: Callable[[str], None] = print):
        self._title = title
        self._print = print_func
        self._series_y1: dict[str, np.ndarray] = {}
        self._series_y2: dict[str, np.ndarray] = {}

    def add(self, name: str, values, secondary_y: bool = False) -> None:
        target = self._series_y2 if secondary_y else self._series_y1
        target[name] = np.asarray(values)

    def remove(self, name: str) -> None:
        self._series_y1.pop(name, None)
        self._series_y2.pop(name, None)

    def clear(self) -> None:
        self._series_y1.clear()
        self._series_y2.clear()

    def get_series(self) -> tuple[dict, dict]:
        return dict(self._series_y1), dict(self._series_y2)

    def get_fig(self):
        go = _require_plotly(self._print)
        if go is None:
            return None
        from plotly.subplots import make_subplots

        fig = make_subplots(specs=[[{"secondary_y": True}]])
        for name, values in self._series_y1.items():
            fig.add_trace(
                go.Scatter(x=np.arange(1, len(values) + 1), y=values,
                           mode="lines", name=name),
                secondary_y=False,
            )
        for name, values in self._series_y2.items():
            fig.add_trace(
                go.Scatter(x=np.arange(1, len(values) + 1), y=values,
                           mode="lines", name=name),
                secondary_y=True,
            )
        fig.update_layout(title=self._title)
        return fig


# copied from pointcloudprocessing_tpu/toolkit/plotting.py::QuiverPlot
class QuiverPlot:
    """Position + normal vector field (reference custom_plotting.py:333-420)."""

    def __init__(self, title: str = "", print_func: Callable[[str], None] = print):
        self._title = title
        self._print = print_func
        self._positions = np.zeros((0, 3))
        self._vectors = np.zeros((0, 3))

    def add(self, positions: np.ndarray, vectors: np.ndarray) -> None:
        self._positions = np.concatenate((self._positions, positions), axis=0)
        self._vectors = np.concatenate((self._vectors, vectors), axis=0)

    def clear(self) -> None:
        self._positions = np.zeros((0, 3))
        self._vectors = np.zeros((0, 3))

    def get_data(self):
        return self._positions, self._vectors

    def get_fig(self):
        go = _require_plotly(self._print)
        if go is None:
            return None
        return go.Figure(
            data=go.Cone(
                x=self._positions[:, 0], y=self._positions[:, 1], z=self._positions[:, 2],
                u=self._vectors[:, 0], v=self._vectors[:, 1], w=self._vectors[:, 2],
            )
        )


# copied from pointcloudprocessing_tpu/toolkit/plotting.py::MatplotlibCanvas
class MatplotlibCanvas:
    """Qt-embedded matplotlib canvas (reference custom_plotting.py:4-11;
    requires matplotlib's Qt backend + PyQt6)."""

    def __new__(cls, *args, **kwargs):
        try:
            from matplotlib.backends.backend_qtagg import FigureCanvasQTAgg
            from matplotlib.figure import Figure
        except ImportError as e:
            raise ImportError(
                "MatplotlibCanvas requires matplotlib with a Qt backend "
                "(PyQt6). Headless plotting is available via the other "
                "plot classes' get_data()/get_fig()."
            ) from e

        fig = Figure(*args, **kwargs)
        canvas = FigureCanvasQTAgg(fig)
        canvas.axes = fig.add_subplot(111)
        return canvas


# copied from pointcloudprocessing_tpu/toolkit/plotting.py::LineCanvas
class LineCanvas:
    """2D line-segment figure (reference custom_plotting.py:422-469)."""

    def __init__(self, title: str = "", print_func: Callable[[str], None] = print):
        self._title = title
        self._print = print_func
        self._segments = np.zeros((0, 2, 2))
        self._colors = np.array([])

    def add(self, segments: np.ndarray, colors: np.ndarray) -> None:
        self._segments = np.concatenate((self._segments, segments), axis=0)
        self._colors = np.concatenate((self._colors, colors))

    def clear(self) -> None:
        self._segments = np.zeros((0, 2, 2))
        self._colors = np.array([])

    def get_data(self):
        return self._segments, self._colors

    def get_fig(self, x_lims=None, y_lims=None):
        go = _require_plotly(self._print)
        if go is None:
            return None
        fig = go.Figure()
        for seg, color in zip(self._segments, self._colors):
            fig.add_trace(
                go.Scatter(
                    x=[seg[0][0], seg[1][0]], y=[seg[0][1], seg[1][1]],
                    mode="lines", line=dict(color=str(color)), showlegend=False,
                )
            )
        if x_lims is not None:
            fig.update_xaxes(range=x_lims)
        if y_lims is not None:
            fig.update_yaxes(range=y_lims)
        fig.update_layout(title=self._title)
        return fig
