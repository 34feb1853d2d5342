"""PyQt6 GUI shell (``pointcloudprocessing_tpu/toolkit/gui``; API parity:
point_cloud_toolkit/gui/ + main.py).

Requires PyQt6 (and plotly for the web-view plots); every module degrades
with a clear ImportError message when Qt is unavailable. All sensor/math
logic lives in the headless toolkit modules — the GUI is a thin view layer.
The geometry behind the views runs on ``device`` (CUDA unless the caller
asks for the CPU: ``python -m pointcloudprocessing_tpu_torch.toolkit.gui
--device cpu``).
"""


# copied from pointcloudprocessing_tpu/toolkit/gui/__init__.py::require_qt
def require_qt():
    try:
        import PyQt6  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "The toolkit GUI requires PyQt6 (pip install PyQt6 PyQt6-WebEngine). "
            "All underlying functionality is available headlessly in "
            "pointcloudprocessing_tpu_torch.toolkit.*"
        ) from e


# adapted from pointcloudprocessing_tpu/toolkit/gui/__init__.py::run_app:
# the views' device
def run_app(device="cuda") -> int:
    """Entry point (reference: point_cloud_toolkit/main.py:5-9)."""
    require_qt()
    from PyQt6.QtWidgets import QApplication
    from pointcloudprocessing_tpu_torch.toolkit.gui.main_app import MainApp

    import sys

    app = QApplication(sys.argv)
    window = MainApp(device=device)
    window.show()
    return app.exec()
