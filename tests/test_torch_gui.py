"""The port's toolkit GUI (``pointcloudprocessing_tpu_torch.toolkit.gui``):
the gating of ``tests/test_gui_gating.py`` (without PyQt6 the GUI raises the
advisory, the headless toolkit imports) and the Qt-test-double smoke of
``tests/test_gui_smoke.py`` (``tests/qt_stub.py``: layout assembly, signal
wiring, dialog flows and every handler body), the views' geometry on the
CPU (``MainApp(device="cpu")``).
"""

from __future__ import annotations

import importlib
import json
import sys
from datetime import datetime, timezone

import numpy as np
import pytest

import qt_stub


def _has_qt() -> bool:
    try:
        import PyQt6  # noqa: F401
    except ImportError:
        return False
    return True


def test_gui_requires_qt_message():
    gui = importlib.import_module("pointcloudprocessing_tpu_torch.toolkit.gui")
    if _has_qt():
        pytest.skip("PyQt6 installed; gating not exercised")
    with pytest.raises(ImportError, match="PyQt6"):
        gui.require_qt()
    with pytest.raises(ImportError, match="pointcloudprocessing_tpu_torch.toolkit"):
        gui.require_qt()
    for name in ("views", "main_app"):
        with pytest.raises(ImportError, match="headless"):
            importlib.import_module(f"pointcloudprocessing_tpu_torch.toolkit.gui.{name}")
    with pytest.raises(ImportError, match="PyQt6"):
        gui.run_app(device="cpu")


def test_headless_toolkit_importable_without_qt():
    import pointcloudprocessing_tpu_torch.toolkit as tk

    assert tk.solve_kabsch is not None
    assert tk.PointCloudPlot is not None


@pytest.fixture()
def qt(monkeypatch, tmp_path):
    for name, mod in qt_stub.install().items():
        monkeypatch.setitem(sys.modules, name, mod)
    # import the GUI fresh against the stub (and drop it again afterwards so
    # the gating tests still see a PyQt6-less world)
    for name in [m for m in sys.modules if ".toolkit.gui" in m]:
        monkeypatch.delitem(sys.modules, name)
    qt_stub.reset()
    monkeypatch.chdir(tmp_path)  # CalibrationAccumulator writes data/ in cwd
    yield qt_stub
    for name in [m for m in sys.modules if ".toolkit.gui" in m]:
        del sys.modules[name]


def _fake_frame(n=6, seq=0):
    data = np.zeros(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                              ("intensity", "<f4")])
    rng = np.random.default_rng(seq)
    data["x"] = rng.uniform(0.5, 2.0, n)
    data["y"] = rng.uniform(1.5, 3.0, n)
    data["z"] = rng.uniform(2.5, 4.0, n)
    data["intensity"] = rng.uniform(0, 10, n)
    return {
        "name": "radar", "sequence": seq,
        "log_time": datetime(2026, 1, 1, tzinfo=timezone.utc),
        "fields": ["intensity", "x", "y", "z"],
        "data": data,
    }


def _boot(qt):
    from pointcloudprocessing_tpu_torch.toolkit.gui.main_app import MainApp

    return MainApp(device="cpu")


def test_mainapp_boot_and_navigation(qt):
    app = _boot(qt)
    assert len(app.views) == 5
    names = [name for name, _ in app.views]
    assert names == [
        "Radar Calibration", "Radar Conversion", "OptiTrack Calibration",
        "Semantic Mesh", "Training Performance",
    ]
    # every view assembled a toolbar + main-area layout
    for _, view in app.views:
        assert view.layout() is not None
        assert qt_stub.iter_widgets(view.layout())
    # nav buttons drive the stack and fire the update_ hook
    nav_buttons = [
        w for w in qt_stub.iter_widgets(app._central.layout())
        if isinstance(w, qt.QPushButton)
    ]
    assert [b.text() for b in nav_buttons] == names
    nav_buttons[4].click()
    assert app.stack.currentIndex() == 4
    app.show_notification("hello")
    assert qt_stub.MESSAGE_LOG[-1] == "hello"
    assert app.show_yes_no_query("sure?") == qt.QMessageBox.StandardButton.Yes


def test_radar_conversion_flow(qt, tmp_path, monkeypatch):
    app = _boot(qt)
    view = dict(app.views)["Radar Conversion"]
    frames = {i: _fake_frame(5, seq=i) for i in range(3)}
    monkeypatch.setattr(view._vizio, "parse_mcap", lambda path: frames)

    mcap = tmp_path / "scan.mcap"
    mcap.write_bytes(b"\x00")
    qt_stub.queue_open_file(mcap)
    view.load_mcap_data()
    radios = view.frames_btn_group.buttons()
    assert [r.text() for r in radios] == ["Frame 0", "Frame 1", "Frame 2"]

    # no selection / no output dir -> advisory, no crash
    view.convert()
    assert "Select a frame" in qt_stub.MESSAGE_LOG[-1]

    radios[1].setChecked(True)
    assert view.selected_frame == 1
    out = tmp_path / "out"
    out.mkdir()
    qt_stub.queue_directory(out)
    view.select_output_dir()
    view.convert()
    assert (out / "frame_0.txt").exists()  # single convert writes index 0
    assert (out / "index.txt").read_text().startswith("frame_0.txt 2026-01-01")

    batch = tmp_path / "batch"
    batch.mkdir()
    qt_stub.queue_directory(batch)
    view.select_output_dir()
    view.convert_all()
    assert sorted(p.name for p in batch.iterdir()) == [
        "frame_0.txt", "frame_1.txt", "frame_2.txt", "index.txt",
    ]
    assert view.progress.value() == 100


def test_radar_calibration_flow(qt, tmp_path, monkeypatch):
    app = _boot(qt)
    view = dict(app.views)["Radar Calibration"]
    frames = {i: _fake_frame(8, seq=i) for i in range(3)}
    monkeypatch.setattr(view._vizio, "parse_mcap", lambda path: frames)

    mcap = tmp_path / "scan.mcap"
    mcap.write_bytes(b"\x00")
    qt_stub.queue_open_file(mcap)
    view.load_mcap_data()

    # truth log: radar at origin, reflector at (1, 2, 3)
    eye = " ".join(str(v) for v in np.eye(4).T.ravel())
    target = " ".join(
        str(v)
        for v in np.vstack(
            [np.hstack([np.eye(3), [[1.0], [2.0], [3.0]]]), [0, 0, 0, 1]]
        ).T.ravel()
    )
    log = tmp_path / "opti.log"
    log.write_text(f"2026.Jan.01_00.00.00.000000.UTC 2 mmwave {eye} corner_reflector {target}\n")
    qt_stub.queue_open_file(log)
    view.load_optitrack_data()
    assert view.truth_data

    view.frames_btn_group.buttons()[0].setChecked(True)
    assert view.current_frame == 0
    assert view.target_truth_position is not None

    view.color_slider.move_to(50)  # percentile filter handler

    # centroid of (possibly filtered) points vs truth, accumulated 3x
    for radio in view.frames_btn_group.buttons():
        radio.setChecked(True)
        view.compute_centroid_clicked()
        assert "Centroid computed" in qt_stub.MESSAGE_LOG[-1]
        view.add_to_calibration_data()
    assert "contains 3 samples" in qt_stub.MESSAGE_LOG[-1]

    view.calibrate()
    assert "rmse" in qt_stub.MESSAGE_LOG[-1] or "(" in qt_stub.MESSAGE_LOG[-1]

    # guard paths
    view.current_centroid = None
    view.add_to_calibration_data()
    assert "until centroid" in qt_stub.MESSAGE_LOG[-1]


def test_optitrack_calibration_flow(qt, tmp_path):
    app = _boot(qt)
    view = dict(app.views)["OptiTrack Calibration"]

    lines = []
    for sec in range(3):
        a = " ".join(str(v) for v in np.eye(4).T.ravel())
        b_pose = np.vstack(
            [np.hstack([np.eye(3), [[1.0 + sec], [2.0], [3.0]]]), [0, 0, 0, 1]]
        )
        b = " ".join(str(v) for v in b_pose.T.ravel())
        lines.append(
            f"2026.Jan.01_00.00.0{sec}.000000.UTC 2 mmwave {a} corner_reflector {b}"
        )
    log = tmp_path / "two_body.log"
    log.write_text("\n".join(lines) + "\n")

    qt_stub.queue_open_file(log)
    view.load_optitrack_data()  # also runs plot_time_series
    assert view.data

    assert view.body_a.text() == "mmwave"
    view.sync()
    assert view.sync_offsets
    assert "Sync offsets" in qt_stub.MESSAGE_LOG[-1]


def test_semantic_mesh_view(qt, tmp_path):
    app = _boot(qt)
    view = dict(app.views)["Semantic Mesh"]
    obj = tmp_path / "tri.obj"
    obj.write_text(
        "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\n"
        "f 1 2 3\nf 1 2 4\nf 1 3 4\nf 2 3 4\n"
    )
    qt_stub.queue_open_file(obj)
    view.load_obj()  # QuiverPlot.add over real vertex normals


def test_training_performance_view(qt, tmp_path):
    app = _boot(qt)
    view = dict(app.views)["Training Performance"]
    history = {
        "loss": [1.0, 0.5], "val_loss": [1.1, 0.6],
        "classification_output_accuracy": [0.5, 0.9],
    }
    model_dir = tmp_path / "model"
    model_dir.mkdir()
    (model_dir / "stage_history.json").write_text(json.dumps(history))

    qt_stub.queue_directory(model_dir)
    view.load_training_history()
    assert set(view.checkboxes) == set(history)

    view.checkboxes["loss"].setChecked(True)  # stateChanged -> update_
    view.checkboxes["classification_output_accuracy"].setChecked(True)
    view.update_()

    # empty dir -> empty selection does not crash the update hook
    app.change_page(4)



def test_views_geometry_runs_on_the_apps_device(qt):
    """The app's device reaches the calibration accumulator; the default is
    CUDA, which raises here when the solve runs."""
    from pointcloudprocessing_tpu_torch.toolkit.gui.main_app import MainApp

    assert dict(MainApp(device="cpu").views)["Radar Calibration"].accumulator.device == "cpu"
    view = dict(MainApp().views)["Radar Calibration"]
    view.accumulator.collected = {"measured": [np.zeros(3), np.ones(3), np.eye(3)[0]],
                                  "truth": [np.zeros(3), np.ones(3), np.eye(3)[0]]}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        view.calibrate()
