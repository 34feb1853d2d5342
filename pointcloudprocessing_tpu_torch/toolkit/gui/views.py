"""The five toolkit views (``pointcloudprocessing_tpu/toolkit/gui/views.py``;
API parity: point_cloud_toolkit/gui/*.py).

Each view is a thin Qt layer over the tested headless logic:

- RadarCalibrationView (gui/RadarCalibration.py:26-577): MCAP frame browser,
  truth lookup, radius/color filtering, centroid accumulation, Kabsch solve,
  corner-reflector RCS/ray-trace panel.
- RadarConversionView (gui/RadarConversion.py:26-230): MCAP -> AftrBurner
  frame export, single and batch (with progress), writing a consistent
  ``index.txt`` (the reference wrote ``__index.log`` for singles and
  ``index.txt`` for batches — quirk fixed, SURVEY §7 "known quirks").
- OptiTrackCalibrationView (gui/OptiTrackCalibration.py:25-356): pose-log
  time series + sensor offset sync (the reference's yaw<->roll accumulation
  swap at :342-350 is fixed here).
- SemanticMeshView (gui/SemanticMeshICP.py:10-48): OBJ mesh + vertex-normal
  quiver display.
- TrainingPerformanceView (gui/TrainingPerformance.py:15-99): history JSON
  browsing with dual-axis metric plots.
"""

from __future__ import annotations

import os

import numpy as np

from pointcloudprocessing_tpu_torch.toolkit.gui import require_qt

require_qt()

from PyQt6.QtWidgets import (  # noqa: E402
    QButtonGroup,
    QFileDialog,
    QCheckBox,
    QLabel,
    QLineEdit,
    QProgressBar,
    QPushButton,
    QRadioButton,
    QScrollArea,
    QSlider,
    QVBoxLayout,
    QWidget,
)
from PyQt6.QtCore import Qt  # noqa: E402

from pointcloudprocessing_tpu_torch.toolkit.conversion import (
    convert_all_frames,
    frame_color,
    frame_xyz,
    write_frame,
)
from pointcloudprocessing_tpu_torch.toolkit.optitrack import (
    OptiTrack,
    body_time_series,
    compute_sync_offsets,
)
from pointcloudprocessing_tpu_torch.toolkit.plotting import PointCloudPlot, LinePlot, LineCanvas
from pointcloudprocessing_tpu_torch.toolkit.provizio import Provizio
from pointcloudprocessing_tpu_torch.toolkit.radar_truth import (
    CalibrationAccumulator,
    compute_centroid,
    lookup_truth_position,
)
from pointcloudprocessing_tpu_torch.toolkit.reflector_analysis import (
    compute_rcs,
    reflector_pose,
    trace_reflections,
)
from pointcloudprocessing_tpu_torch.toolkit.training_history import (
    load_training_history,
    split_axes,
)
from pointcloudprocessing_tpu_torch.toolkit import globals as tk_globals


# copied from pointcloudprocessing_tpu/toolkit/gui/views.py::_html_view
def _html_view():
    """QWebEngineView when available (plotly HTML), else a QLabel stub."""
    try:
        from PyQt6.QtWebEngineWidgets import QWebEngineView

        return QWebEngineView()
    except ImportError:
        label = QLabel("QtWebEngine not installed — plots unavailable")
        label.setAlignment(Qt.AlignmentFlag.AlignCenter)
        return label


# copied from pointcloudprocessing_tpu/toolkit/gui/views.py::_set_html
def _set_html(view, fig) -> None:
    if fig is None or not hasattr(view, "setHtml"):
        return
    import plotly.io as pio

    view.setHtml(pio.to_html(fig, full_html=False, include_plotlyjs="cdn"))


# copied from pointcloudprocessing_tpu/toolkit/gui/views.py::_ViewBase
class _ViewBase(QWidget):
    def __init__(self, app):
        super().__init__()
        self.app = app
        self._notify = app.show_notification
        self._ask = app.show_yes_no_query

    def update_(self, *args) -> None:  # nav-protocol hook (MainApp.py:70-84)
        pass


# adapted from pointcloudprocessing_tpu/toolkit/gui/views.py::RadarCalibrationView:
# the Kabsch solve on the app's device
class RadarCalibrationView(_ViewBase):
    SLIDER_SCALE = 100

    def __init__(self, app):
        super().__init__(app)
        self._vizio = Provizio(print_func=self._notify)
        self._optitrack = OptiTrack(print_func=self._notify)
        self.loaded_frames: dict = {}
        self.truth_data: dict = {}
        self.current_frame = None
        self.current_centroid = None
        self.target_truth_position = None
        self.target_filter_center = None
        self.target_filter_radius = None
        self.pc_plot = PointCloudPlot("Radar Frame", self._notify)
        self.accumulator = CalibrationAccumulator(print_func=self._notify,
                                                  device=app.device)

        load_mcap_btn = QPushButton("Load MCAP")
        load_mcap_btn.clicked.connect(self.load_mcap_data)
        load_truth_btn = QPushButton("Load OptiTrack Log")
        load_truth_btn.clicked.connect(self.load_optitrack_data)
        centroid_btn = QPushButton("Compute Centroid")
        centroid_btn.clicked.connect(self.compute_centroid_clicked)
        add_btn = QPushButton("Add To Calibration Data")
        add_btn.clicked.connect(self.add_to_calibration_data)
        calibrate_btn = QPushButton("Calibrate")
        calibrate_btn.clicked.connect(self.calibrate)

        self.color_slider = QSlider(Qt.Orientation.Horizontal)
        self.color_slider.setRange(0, 100)
        self.color_slider.sliderMoved.connect(self.color_filter_changed)

        self.frames_area = QScrollArea()
        self.frames_container = QVBoxLayout()
        frames_widget = QWidget()
        frames_widget.setLayout(self.frames_container)
        self.frames_area.setWidget(frames_widget)
        self.frames_area.setWidgetResizable(True)
        self.frames_btn_group = QButtonGroup(self)

        self.plot_area = _html_view()
        layout = app.get_left_toolbar_layout(
            [
                load_mcap_btn,
                load_truth_btn,
                self.frames_area,
                QLabel("Color filter:"),
                self.color_slider,
                centroid_btn,
                add_btn,
                calibrate_btn,
            ],
            self.plot_area,
        )
        self.setLayout(layout)

    # -- data loading ------------------------------------------------------

    def load_mcap_data(self) -> None:
        path, _ = QFileDialog.getOpenFileName(
            self, "Select MCAP (ROS2) point cloud file", ""
        )
        if not os.path.isfile(path):
            return
        frames = self._vizio.parse_mcap(path)
        while self.frames_container.count():
            item = self.frames_container.takeAt(0)
            if item.widget():
                item.widget().deleteLater()
        self.loaded_frames.clear()
        for key, frame in frames.items():
            radio = QRadioButton(f"Frame {key}")
            self.frames_btn_group.addButton(radio)
            self.loaded_frames[key] = frame
            radio.toggled.connect(
                lambda checked, k=key: checked and self.show_frame(k)
            )
            self.frames_container.addWidget(radio)

    def load_optitrack_data(self) -> None:
        path, _ = QFileDialog.getOpenFileName(self, "Select OptiTrack log", "")
        if os.path.isfile(path):
            self.truth_data = self._optitrack.parse_log(path)

    # -- frame display + filtering ----------------------------------------

    def show_frame(self, key) -> None:
        frame = self.loaded_frames[key]
        if frame["sequence"] != self.current_frame:
            self.pc_plot.clear_red_points()
            self.pc_plot.clear_filter()
            self.current_frame = frame["sequence"]
        self.pc_plot.clear()
        self.pc_plot.add(
            frame_xyz(frame),
            frame_color(frame),
            f"{frame['name']}_{frame['sequence']}",
        )
        if self.truth_data:
            try:
                self.target_truth_position = lookup_truth_position(
                    self.truth_data, frame["log_time"]
                )
                if self.target_filter_center is None:
                    self.target_filter_center = self.target_truth_position
                self.pc_plot.add_red_point(self.target_truth_position, size=5)
            except Exception as e:
                self._notify(f"Unable to load truth position:\n\t{type(e)}: {e}")
        _set_html(self.plot_area, self.pc_plot.get_fig())

    def color_filter_changed(self, value: int) -> None:
        self.pc_plot.filter_by_color(value, True)
        _set_html(self.plot_area, self.pc_plot.get_fig())

    # -- calibration -------------------------------------------------------

    def compute_centroid_clicked(self) -> None:
        if self.target_truth_position is None:
            self._notify("Will not compute centroid without truth data.")
            return
        self.current_centroid = compute_centroid(
            self.pc_plot.get_points(), self.target_truth_position
        )
        m = self.current_centroid["measured"]
        self._notify(
            f"Centroid computed at ( {m[0]:.3f}, {m[1]:.3f}, {m[2]:.3f} ).\n"
            f"Error from truth: {self.current_centroid['error']}"
        )

    def add_to_calibration_data(self) -> None:
        if self.current_centroid is None:
            self._notify("Cannot add to calibration data until centroid is computed.")
            return
        count = self.accumulator.add(self.current_centroid)
        self._notify(f"Point added to dataset. Current dataset contains {count} samples")
        self.current_centroid = None

    def calibrate(self) -> None:
        result = self.accumulator.calibrate()
        if result is not None:
            self._notify(str(result))


# copied from pointcloudprocessing_tpu/toolkit/gui/views.py::RadarConversionView
class RadarConversionView(_ViewBase):
    def __init__(self, app):
        super().__init__(app)
        self._vizio = Provizio(print_func=self._notify)
        self.loaded_frames: dict = {}
        self.output_dir = ""

        load_btn = QPushButton("Load MCAP")
        load_btn.clicked.connect(self.load_mcap_data)
        out_btn = QPushButton("Select Output Directory")
        out_btn.clicked.connect(self.select_output_dir)
        convert_btn = QPushButton("Convert Selected Frame")
        convert_btn.clicked.connect(self.convert)
        convert_all_btn = QPushButton("Convert All Frames")
        convert_all_btn.clicked.connect(self.convert_all)
        self.progress = QProgressBar()

        self.frames_container = QVBoxLayout()
        frames_widget = QWidget()
        frames_widget.setLayout(self.frames_container)
        area = QScrollArea()
        area.setWidget(frames_widget)
        area.setWidgetResizable(True)
        self.frames_btn_group = QButtonGroup(self)
        self.selected_frame = None

        self.plot_area = _html_view()
        self.setLayout(
            app.get_left_toolbar_layout(
                [load_btn, out_btn, area, convert_btn, convert_all_btn, self.progress],
                self.plot_area,
            )
        )

    def load_mcap_data(self) -> None:
        path, _ = QFileDialog.getOpenFileName(self, "Select MCAP file", "")
        if not os.path.isfile(path):
            return
        frames = self._vizio.parse_mcap(path)
        self.loaded_frames = frames
        while self.frames_container.count():
            item = self.frames_container.takeAt(0)
            if item.widget():
                item.widget().deleteLater()
        for key in frames:
            radio = QRadioButton(f"Frame {key}")
            self.frames_btn_group.addButton(radio)
            radio.toggled.connect(
                lambda checked, k=key: checked and setattr(self, "selected_frame", k)
            )
            self.frames_container.addWidget(radio)

    def select_output_dir(self) -> None:
        self.output_dir = QFileDialog.getExistingDirectory(self, "Output directory")

    def convert(self) -> None:
        """Export one frame + append its metadata to index.txt (reference
        gui/RadarConversion.py:196-219)."""
        if self.selected_frame is None or not self.output_dir:
            self._notify("Select a frame and an output directory first.")
            return
        write_frame(
            self._vizio, self.loaded_frames[self.selected_frame], self.output_dir, 0
        )
        self._notify("Frame converted.")

    def convert_all(self) -> None:
        """Batch export with tqdm-driven progress (reference :221-230)."""
        if not self.output_dir:
            self._notify("Select an output directory first.")
            return
        convert_all_frames(
            self._vizio, self.loaded_frames, self.output_dir,
            progress_func=self.progress.setValue,
        )


# adapted from pointcloudprocessing_tpu/toolkit/gui/views.py::OptiTrackCalibrationView:
# the Euler angles on the app's device
class OptiTrackCalibrationView(_ViewBase):
    def __init__(self, app):
        super().__init__(app)
        self._optitrack = OptiTrack(print_func=self._notify)
        self.data: dict = {}
        self.sync_offsets: list[dict] = []

        load_btn = QPushButton("Load OptiTrack Log")
        load_btn.clicked.connect(self.load_optitrack_data)
        sync_btn = QPushButton("Sync")
        sync_btn.clicked.connect(self.sync)
        self.body_a = QLineEdit("mmwave")
        self.body_b = QLineEdit("corner_reflector")
        self.plot_area = _html_view()
        self.setLayout(
            app.get_left_toolbar_layout(
                [load_btn, QLabel("Body A:"), self.body_a,
                 QLabel("Body B:"), self.body_b, sync_btn],
                self.plot_area,
            )
        )

    def load_optitrack_data(self) -> None:
        path, _ = QFileDialog.getOpenFileName(self, "Select OptiTrack log", "")
        if not os.path.isfile(path):
            return
        self.data = self._optitrack.parse_log(path)
        self.plot_time_series()

    def plot_time_series(self) -> None:
        """Per-body x/y/z + roll/pitch/yaw series (reference
        gui/OptiTrackCalibration.py:143-189)."""
        from pointcloudprocessing_tpu_torch.toolkit import mat_ops

        plot = LinePlot("OptiTrack", self._notify)
        for name, arr in body_time_series(self.data).items():
            plot.add(f"{name}_x", arr[:, 0, 3])
            plot.add(f"{name}_y", arr[:, 1, 3])
            plot.add(f"{name}_z", arr[:, 2, 3])
            # one batched call for all samples (per-pose dispatch is seconds
            # of overhead on long logs)
            rpy = mat_ops.get_roll_pitch_yaw_deg(arr[:, :3, :3], self.app.device)
            plot.add(f"{name}_roll", np.asarray(rpy["roll"]), secondary_y=True)
            plot.add(f"{name}_pitch", np.asarray(rpy["pitch"]), secondary_y=True)
            plot.add(f"{name}_yaw", np.asarray(rpy["yaw"]), secondary_y=True)
        _set_html(self.plot_area, plot.get_fig())

    def sync(self) -> None:
        """Mean/variance offset between two tracked bodies (reference
        :320-356 — with its yaw/roll accumulation swap fixed)."""
        summary = compute_sync_offsets(self.data, self.body_a.text(),
                                       self.body_b.text(), self.app.device)
        if summary is None:
            self._notify("No overlapping samples for the selected bodies.")
            return
        self.sync_offsets.append(summary)
        self._notify(f"Sync offsets:\n{summary}")


# copied from pointcloudprocessing_tpu/toolkit/gui/views.py::SemanticMeshView
class SemanticMeshView(_ViewBase):
    """Mesh + vertex-normal display (reference gui/SemanticMeshICP.py)."""

    def __init__(self, app):
        super().__init__(app)
        load_btn = QPushButton("Load OBJ")
        load_btn.clicked.connect(self.load_obj)
        self.plot_area = _html_view()
        self.setLayout(app.get_left_toolbar_layout([load_btn], self.plot_area))

    def load_obj(self) -> None:
        from pointcloudprocessing_tpu_torch.synthesis.mesh import load_obj
        from pointcloudprocessing_tpu_torch.toolkit.plotting import QuiverPlot

        path, _ = QFileDialog.getOpenFileName(self, "Select OBJ mesh", "")
        if not os.path.isfile(path):
            return
        mesh = load_obj(path)
        quiver = QuiverPlot("Mesh Normals", self._notify)
        quiver.add(mesh.vertices, mesh.vertex_normals())
        _set_html(self.plot_area, quiver.get_fig())


# copied from pointcloudprocessing_tpu/toolkit/gui/views.py::TrainingPerformanceView
class TrainingPerformanceView(_ViewBase):
    def __init__(self, app):
        super().__init__(app)
        self.history: dict = {}
        self.checkboxes: dict[str, QCheckBox] = {}
        load_btn = QPushButton("Load Model Directory")
        load_btn.clicked.connect(self.load_training_history)
        self.metrics_container = QVBoxLayout()
        metrics_widget = QWidget()
        metrics_widget.setLayout(self.metrics_container)
        area = QScrollArea()
        area.setWidget(metrics_widget)
        area.setWidgetResizable(True)
        self.plot_area = _html_view()
        self.setLayout(
            app.get_left_toolbar_layout([load_btn, area], self.plot_area)
        )

    def load_training_history(self) -> None:
        path = QFileDialog.getExistingDirectory(self, "Model directory")
        if not path:
            return
        self.history = load_training_history(path)
        while self.metrics_container.count():
            item = self.metrics_container.takeAt(0)
            if item.widget():
                item.widget().deleteLater()
        self.checkboxes.clear()
        for key in self.history:
            box = QCheckBox(key)
            box.stateChanged.connect(self.update_)
            self.checkboxes[key] = box
            self.metrics_container.addWidget(box)

    def update_(self, *args) -> None:
        selected = {
            k: v for k, v in self.history.items()
            if k in self.checkboxes and self.checkboxes[k].isChecked()
        }
        y1, y2 = split_axes(selected)
        plot = LinePlot("Training Performance", self._notify)
        for name, series in y1.items():
            plot.add(name, series)
        for name, series in y2.items():
            plot.add(name, series, secondary_y=True)
        _set_html(self.plot_area, plot.get_fig())
