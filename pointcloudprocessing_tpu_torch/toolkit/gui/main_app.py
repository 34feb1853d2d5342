"""Main application window (``pointcloudprocessing_tpu/toolkit/gui/main_app.py``;
API parity: gui/MainApp.py:10-142).

Fullscreen QMainWindow holding a QStackedWidget of the five views with a
bottom navigation toolbar, the shared notification / yes-no dialog helpers,
and the 1/6-toolbar + 5/6-main layout factory every view uses.
"""

from __future__ import annotations

from pointcloudprocessing_tpu_torch.toolkit.gui import require_qt

require_qt()

from PyQt6.QtWidgets import (  # noqa: E402
    QHBoxLayout,
    QMainWindow,
    QMessageBox,
    QPushButton,
    QStackedWidget,
    QVBoxLayout,
    QWidget,
)


# adapted from pointcloudprocessing_tpu/toolkit/gui/main_app.py::MainApp:
# ``device`` for the views' geometry
class MainApp(QMainWindow):
    def __init__(self, device="cuda"):
        super().__init__()
        # where the views' geometry runs (CUDA unless the caller asks for
        # the CPU)
        self.device = device
        self.setWindowTitle("Point Cloud Toolkit (GPU)")
        self.showMaximized()

        from pointcloudprocessing_tpu_torch.toolkit.gui.views import (
            OptiTrackCalibrationView,
            RadarCalibrationView,
            RadarConversionView,
            SemanticMeshView,
            TrainingPerformanceView,
        )

        self.stack = QStackedWidget()
        self.views = [
            ("Radar Calibration", RadarCalibrationView(self)),
            ("Radar Conversion", RadarConversionView(self)),
            ("OptiTrack Calibration", OptiTrackCalibrationView(self)),
            ("Semantic Mesh", SemanticMeshView(self)),
            ("Training Performance", TrainingPerformanceView(self)),
        ]
        for _, view in self.views:
            self.stack.addWidget(view)

        nav_bar = QHBoxLayout()
        for i, (name, _) in enumerate(self.views):
            btn = QPushButton(name)
            btn.clicked.connect(lambda _, idx=i: self.change_page(idx))
            nav_bar.addWidget(btn)

        root = QVBoxLayout()
        root.addWidget(self.stack, stretch=1)
        root.addLayout(nav_bar)
        container = QWidget()
        container.setLayout(root)
        self.setCentralWidget(container)

    def change_page(self, index: int) -> None:
        self.stack.setCurrentIndex(index)
        view = self.views[index][1]
        if hasattr(view, "update_"):
            view.update_()

    # -- shared dialogs (reference MainApp.py:86-102) ----------------------

    def show_notification(self, message: str) -> None:
        box = QMessageBox(self)
        box.setWindowTitle("Notification")
        box.setText(message)
        box.exec()

    def show_yes_no_query(self, message: str):
        return QMessageBox.question(
            self,
            "Question",
            message,
            QMessageBox.StandardButton.Yes | QMessageBox.StandardButton.No,
        )

    # -- shared layout factory (reference MainApp.py:104-142) --------------

    @staticmethod
    def get_left_toolbar_layout(toolbar_widgets, main_widget) -> QHBoxLayout:
        """1/6-width toolbar column + 5/6-width main area."""
        toolbar = QVBoxLayout()
        for widget in toolbar_widgets:
            toolbar.addWidget(widget)
        toolbar.addStretch(1)

        layout = QHBoxLayout()
        toolbar_container = QWidget()
        toolbar_container.setLayout(toolbar)
        layout.addWidget(toolbar_container, stretch=1)
        layout.addWidget(main_widget, stretch=5)
        return layout
