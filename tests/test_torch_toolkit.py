"""The port's sensor toolkit: every case of ``tests/test_toolkit.py``
through ``pointcloudprocessing_tpu_torch.toolkit`` (``device="cpu"`` where
a function reaches ``ops/mat_ops.py``), with the same bars, and each
device-reaching wrapper against the JAX package's on the same inputs
within 1e-5 (both compute in f32).

``tests/test_toolkit.py::test_reference_history_files_load`` reads the
reference tree from a fixed path outside the repository and is not
repeated here.
"""

import json
from datetime import datetime, timezone

import numpy as np
import pytest

from pointcloudprocessing_tpu import toolkit as jax_tk
from pointcloudprocessing_tpu.toolkit import mat_ops as jax_tk_mat_ops
from pointcloudprocessing_tpu.toolkit.optitrack import (
    compute_sync_offsets as jax_compute_sync_offsets,
)
from pointcloudprocessing_tpu_torch.toolkit import (
    CalibrationAccumulator,
    OptiTrack,
    PointCloudPlot,
    Provizio,
    ROS,
    TQDMCapture,
    compute_centroid,
    compute_rcs,
    get_reflection,
    load_training_history,
    lookup_truth_position,
    moller_trumbore,
    reflector_pose,
    solve_kabsch,
    trace_reflections,
)
from pointcloudprocessing_tpu_torch.toolkit import globals as tk_globals
from pointcloudprocessing_tpu_torch.toolkit import mat_ops as tk_mat_ops
from pointcloudprocessing_tpu_torch.toolkit.conversion import (
    convert_all_frames,
    frame_color,
    frame_xyz,
)
from pointcloudprocessing_tpu_torch.toolkit.optitrack import (
    body_time_series,
    compute_sync_offsets,
)
from pointcloudprocessing_tpu_torch.toolkit.training_history import split_axes

CPU = "cpu"
WRAPPER_TOL = 1e-5


# -- kabsch wrapper ---------------------------------------------------------

def test_solve_kabsch_wrapper(rng):
    r_true = tk_mat_ops.get_dcm(10, 20, 30, device=CPU)
    t_true = np.array([0.5, -1.0, 2.0])
    measured = rng.uniform(-3, 3, (40, 3))
    truth = measured @ r_true.T + t_true
    r, t, rmse = solve_kabsch(truth, measured, device=CPU)
    assert isinstance(r, np.ndarray) and isinstance(t, np.ndarray)
    np.testing.assert_allclose(r, r_true, atol=1e-5)
    assert rmse < 1e-6


def test_solve_kabsch_defaults_to_cuda():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        solve_kabsch(np.eye(3), np.eye(3))


# -- corner reflector -------------------------------------------------------

def test_moller_trumbore_hit_and_miss():
    tri = {"corners": np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], float)}
    d = moller_trumbore(np.array([0.2, 0.2, 1.0]), np.array([0.0, 0, -1.0]), tri)
    assert d == pytest.approx(1.0)
    assert moller_trumbore(np.array([2.0, 2.0, 1.0]), np.array([0.0, 0, -1.0]), tri) is None
    # behind the origin
    assert moller_trumbore(np.array([0.2, 0.2, -1.0]), np.array([0.0, 0, -1.0]), tri) is None


def test_get_reflection_input_validation(capsys):
    assert get_reflection(np.zeros(2), np.zeros(3), np.zeros((3, 3)), np.zeros(3)) == {}
    assert "ray_origin" in capsys.readouterr().out


def test_trihedral_retroreflection():
    """A ray into a trihedral reflector returns parallel to its source."""
    info = reflector_pose(edge_length=1.0, roll=0.0, pitch=0.0, yaw=0.0, device=CPU)
    result = trace_reflections(np.array([0.05, 0.02, 1.0]), info)
    assert result["returned_to_source"]
    assert result["rays"].shape[0] >= 3  # triple bounce
    assert result["total_distance"] == pytest.approx(
        2 * (1.0 - info["apex"][2]), rel=0.05
    )


def test_reflection_miss_escapes():
    info = reflector_pose(1.0, 0, 0, 0, device=CPU)
    result = trace_reflections(np.array([5.0, 5.0, 1.0]), info)
    assert not result["returned_to_source"]
    assert result["rays"].shape[0] == 1


def test_rcs_formula():
    lam = tk_globals.C / 77e9  # a = 0.3 m, 77 GHz
    rcs = compute_rcs(0.3, lam)
    assert rcs == pytest.approx(4 * np.pi * 0.3**4 / (3 * lam**2))


# -- OptiTrack --------------------------------------------------------------

OPTI_LINE = (
    "2026.Jan.05_12.30.45.1234567890.UTC 2 "
    "mmwave "
    + " ".join(str(v) for v in np.eye(4).T.ravel())
    + " corner_reflector "
    + " ".join(str(v) for v in np.vstack(
        [np.hstack([np.eye(3), [[1], [2], [3]]]), [0, 0, 0, 1]]).T.ravel())
)


def test_optitrack_parse_log(tmp_path):
    log = tmp_path / "opti.log"
    log.write_text("# comment line\n" + OPTI_LINE + "\n")
    data = OptiTrack().parse_log(str(log))
    assert len(data) == 1
    ts = next(iter(data))
    assert ts.tzinfo == timezone.utc
    assert ts.microsecond == 123456  # truncated to 6 digits
    assert set(data[ts]) == {"mmwave", "corner_reflector"}
    cr = data[ts]["corner_reflector"]
    np.testing.assert_allclose(cr[:3, 3], [1, 2, 3])
    # mounting correction applied: R = I @ object_R
    np.testing.assert_allclose(cr[:3, :3], np.array([[0, 1, 0], [0, 0, 1], [1, 0, 0]]))
    want = jax_tk.OptiTrack().parse_log(str(log))
    assert list(want) == list(data)
    for name in want[ts]:
        np.testing.assert_array_equal(data[ts][name], want[ts][name])


def test_optitrack_missing_file(capsys):
    assert OptiTrack().parse_log("/nonexistent.log") == {}
    assert "failed to load" in capsys.readouterr().out


# -- truth lookup + calibration accumulation --------------------------------

def test_lookup_truth_position():
    t0 = datetime(2026, 1, 5, tzinfo=timezone.utc)
    truth = {
        t0: {
            "mmwave": np.eye(4),
            "corner_reflector": np.vstack(
                [np.hstack([np.eye(3), [[2], [0], [1]]]), [0, 0, 0, 1]]
            ),
        }
    }
    pos = lookup_truth_position(truth, t0)
    np.testing.assert_allclose(pos, [2, 0, 1])


def test_centroid_and_accumulator(tmp_path, rng):
    pts = rng.normal(0, 0.01, (50, 3)) + np.array([1.0, 2.0, 3.0])
    cen = compute_centroid(pts, np.array([1.0, 2.0, 3.0]))
    assert cen["error"] < 0.05

    acc = CalibrationAccumulator(path=str(tmp_path / "data_bu.pkl"), device=CPU)
    r_true = tk_mat_ops.get_dcm(5, -10, 25, device=CPU)
    t_true = np.array([0.1, 0.2, -0.3])
    for i in range(10):
        measured = rng.uniform(-2, 2, 3)
        acc.add({"measured": measured, "truth": r_true @ measured + t_true})
    # fresh instance loads from disk (persistence across "sessions")
    acc2 = CalibrationAccumulator(path=str(tmp_path / "data_bu.pkl"), device=CPU)
    r, t, rmse = acc2.calibrate()
    np.testing.assert_allclose(r, r_true, atol=1e-6)
    np.testing.assert_allclose(t, t_true, atol=1e-6)
    # the JAX package's accumulator reads the same file to the same solve
    jr, jt, jrmse = jax_tk.CalibrationAccumulator(
        path=str(tmp_path / "data_bu.pkl")).calibrate()
    np.testing.assert_allclose(r, np.asarray(jr), rtol=0, atol=WRAPPER_TOL)
    np.testing.assert_allclose(t, np.asarray(jt), rtol=0, atol=WRAPPER_TOL)
    assert abs(rmse - jrmse) <= WRAPPER_TOL


def test_accumulator_no_data(tmp_path, capsys):
    acc = CalibrationAccumulator(path=str(tmp_path / "missing.pkl"), device=CPU)
    assert acc.calibrate() is None
    assert "No points available" in capsys.readouterr().out


# -- ROS dtype mapping ------------------------------------------------------

class FakeField:
    def __init__(self, name, offset, datatype, count=1):
        self.name, self.offset, self.datatype, self.count = name, offset, datatype, count

    def __repr__(self):
        return f"PointField(name={self.name})"


def test_ros_dtype_ordering():
    fields = [
        FakeField("z", 8, 7),
        FakeField("x", 0, 7),
        FakeField("y", 4, 7),
        FakeField("intensity", 12, 8),
    ]
    dt = ROS(print).create_np_dtype_from(fields, is_bigendian=False)
    assert dt.names == ("x", "y", "z", "intensity")
    assert dt["x"] == np.dtype("<f4")
    assert dt["intensity"] == np.dtype("<f8")
    dt_be = ROS(print).create_np_dtype_from(fields[:3], is_bigendian=True)
    assert dt_be["x"] == np.dtype(">f4")
    assert dt == jax_tk.ROS(print).create_np_dtype_from(fields, is_bigendian=False)
    with pytest.raises(ValueError, match="multiple values"):
        ROS(print).create_np_dtype_from([FakeField("x", 0, 7, count=2)], False)


def test_provizio_gated_without_mcap(capsys, tmp_path):
    p = Provizio()
    assert p.parse_mcap(str(tmp_path / "x.mcap")) == {}
    out = capsys.readouterr().out
    assert "mcap" in out


def test_provizio_to_aftr_frame(tmp_path):
    p = Provizio()
    path = str(tmp_path / "frame_0.txt")
    p.to_aftr_frame(path, np.array([[1.0, 2.0, 3.0]]), np.array([["kc-46", "wing"]]))
    assert open(path).read().startswith("(1.0, 2.0, 3.0) kc-46 wing")


# -- TQDMCapture ------------------------------------------------------------

def test_tqdm_capture_percent():
    cap = TQDMCapture()
    cap.write(" 45%|████      | 45/100")
    assert cap.get_percent() == 45
    cap.write("no percent here")
    assert cap.get_percent() is None
    cap.flush()


def test_tqdm_capture_with_real_tqdm():
    from tqdm import tqdm

    cap = TQDMCapture()
    for _ in tqdm(range(4), file=cap):
        pass
    assert cap.get_percent() == 100


# -- PointCloudPlot filters -------------------------------------------------

@pytest.fixture
def plot(rng):
    p = PointCloudPlot("test")
    pts = rng.uniform(-10, 10, (200, 3))
    colors = np.linspace(0, 1, 200)
    p.add(pts, colors, "cloud")
    return p, pts, colors


def test_plot_radius_filter(plot):
    p, pts, _ = plot
    p.filter_by_radius(np.zeros(3), 5.0)
    got = p.get_points()
    want = pts[np.sum(pts**2, axis=1) < 25.0]
    np.testing.assert_allclose(got, want)


def test_plot_color_filter_and_combination(plot):
    p, pts, colors = plot
    p.filter_by_color(50, True)
    got = p.get_points()
    assert got.shape[0] == (colors > 0.5).sum()
    p.filter_by_radius(np.zeros(3), 5.0)
    got = p.get_points()
    want_mask = (colors > 0.5) & (np.sum(pts**2, axis=1) < 25.0)
    assert got.shape[0] == want_mask.sum()


def test_plot_remove_tag(plot, rng):
    p, pts, _ = plot
    p.add(rng.uniform(-1, 1, (10, 3)), np.zeros(10), "other")
    p.remove("cloud")
    assert p.get_points().shape[0] == 10


def test_plot_max_radius(plot):
    p, pts, _ = plot
    want = np.max(np.linalg.norm(pts - np.ones(3), axis=1))
    assert p.get_max_radius_from(np.ones(3)) == pytest.approx(want)


def test_plot_fig_gated_without_plotly(plot, capsys):
    p, _, _ = plot
    assert p.get_fig() is None
    assert "plotly" in capsys.readouterr().out


# -- training history -------------------------------------------------------

def test_load_training_history(tmp_path):
    d1 = tmp_path / "stage1"
    d2 = tmp_path / "stage2"
    d1.mkdir(), d2.mkdir()
    (d1 / "m_stage1_history.json").write_text(
        json.dumps({"loss": [3, 2], "val_accuracy": [0.1, 0.2]})
    )
    (d2 / "m_stage2_history.json").write_text(
        json.dumps({"loss": [1.5], "val_accuracy": [0.5]})
    )
    hist = load_training_history(str(tmp_path))
    assert hist["loss"] == [3, 2, 1.5]
    y1, y2 = split_axes(hist)
    assert "val_accuracy" in y1 and "loss" in y2
    assert hist == jax_tk.load_training_history(str(tmp_path))


# -- headless conversion workflow (reference gui/RadarConversion.py) ---------

def _fake_frame(n=5, seq=0):
    data = np.zeros(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                              ("intensity", "<f4")])
    data["x"] = np.arange(n)
    data["y"] = np.arange(n) * 2
    data["z"] = np.arange(n) * 3
    data["intensity"] = np.arange(n) * 0.5
    return {
        "name": "radar", "sequence": seq,
        "log_time": datetime(2026, 1, 1, tzinfo=timezone.utc),
        "fields": ["intensity", "x", "y", "z"],
        "data": data,
    }


def test_frame_xyz_and_color():
    frame = _fake_frame(4)
    xyz = frame_xyz(frame)
    assert xyz.shape == (4, 3) and xyz.dtype == np.float32
    np.testing.assert_allclose(xyz[:, 1], [0, 2, 4, 6])
    np.testing.assert_allclose(frame_color(frame), [0, 0.5, 1.0, 1.5])


def test_convert_all_frames(tmp_path):
    frames = {i: _fake_frame(3, seq=i) for i in range(4)}
    seen_pcts = []
    count = convert_all_frames(
        Provizio(), frames, str(tmp_path), progress_func=seen_pcts.append
    )
    assert count == 4
    # one frame file per input + a single consistent index
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "frame_0.txt", "frame_1.txt", "frame_2.txt", "frame_3.txt", "index.txt",
    ]
    index_lines = (tmp_path / "index.txt").read_text().splitlines()
    assert len(index_lines) == 4
    assert index_lines[0].startswith("frame_0.txt 2026-01-01")
    assert seen_pcts[-1] == 100
    # the JAX package's workflow writes the same files
    jax_dir = tmp_path / "jax"
    jax_dir.mkdir()
    from pointcloudprocessing_tpu.toolkit.conversion import (
        convert_all_frames as jax_convert_all_frames,
    )

    jax_convert_all_frames(jax_tk.Provizio(), frames, str(jax_dir))
    for name in ("frame_0.txt", "frame_3.txt", "index.txt"):
        assert (tmp_path / name).read_text() == (jax_dir / name).read_text()


# -- headless OptiTrack analysis (reference gui/OptiTrackCalibration.py) ----

def _two_body_log():
    def pose(t, yaw_deg):
        c, s = np.cos(np.deg2rad(yaw_deg)), np.sin(np.deg2rad(yaw_deg))
        m = np.eye(4)
        m[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        m[:3, 3] = t
        return m

    data = {}
    for i in range(5):
        ts = datetime(2026, 1, 1, 0, 0, i, tzinfo=timezone.utc)
        data[ts] = {
            "a": pose([0, 0, 0], 0.0),
            "b": pose([1.0, 2.0, 3.0], 30.0),
        }
    return data


def test_body_time_series():
    series = body_time_series(_two_body_log())
    assert set(series) == {"a", "b"}
    assert series["a"].shape == (5, 4, 4)
    np.testing.assert_allclose(series["b"][:, 0, 3], 1.0)


def test_compute_sync_offsets():
    summary = compute_sync_offsets(_two_body_log(), "a", "b", device=CPU)
    assert summary is not None
    np.testing.assert_allclose(
        [summary["x"]["mean"], summary["y"]["mean"], summary["z"]["mean"]],
        [1.0, 2.0, 3.0], atol=1e-9,
    )
    # constant offset -> zero variance; the z-rotation lands on the YAW axis
    # (the reference accumulated it into roll —
    # gui/OptiTrackCalibration.py:342-350); sign follows mat_ops' convention
    assert abs(summary["yaw"]["mean"]) == pytest.approx(30.0)
    assert summary["roll"]["mean"] == pytest.approx(0.0)
    assert summary["x"]["var"] == 0.0
    assert compute_sync_offsets(_two_body_log(), "a", "missing", device=CPU) is None
    want = jax_compute_sync_offsets(_two_body_log(), "a", "b")
    for axis, stats in want.items():
        for key, value in stats.items():
            assert abs(summary[axis][key] - value) <= WRAPPER_TOL, (axis, key)


# -- the device-reaching wrappers against the JAX package's ------------------

def _wrapper_cases(rng):
    dcm = tk_mat_ops.get_dcm(12.0, -33.0, 71.0, device=CPU).astype(np.float64)
    noisy = dcm + rng.normal(0, 1e-3, (3, 3))
    batch = np.stack([tk_mat_ops.get_dcm(*a, device=CPU) for a in
                      rng.uniform(-80, 80, (6, 3))])
    measured = rng.uniform(-3, 3, (40, 3))
    truth = measured @ dcm.T + np.array([0.5, -1.0, 2.0]) + rng.normal(0, 1e-3, (40, 3))
    return {
        "get_dcm": ("get_dcm", (12.0, -33.0, 71.0)),
        "get_roll_pitch_yaw_deg": ("get_roll_pitch_yaw_deg", (batch,)),
        "get_DCM_positive_x_pointing_at_origin": (
            "get_DCM_positive_x_pointing_at_origin",
            (rng.uniform(-20, 20, (5, 3)), 15.0)),
        "reorthogonalize": ("reorthogonalize", (noisy,)),
        "convert_radar_to_global": (
            "convert_radar_to_global",
            (np.stack([rng.uniform(1, 50, 8), rng.uniform(-60, 60, 8),
                       rng.uniform(-20, 20, 8)], -1),
             np.array([1.0, -2.0, 0.5]), np.array([3.0, -5.0, 40.0]))),
        "_yaw": ("_yaw", (dcm, 0.7)),
        "_pitch": ("_pitch", (dcm, -0.4)),
        "_roll": ("_roll", (dcm, 1.3)),
        "solve_kabsch": (None, (truth, measured)),
        "reflector_pose": (None, (0.3, 10.0, -25.0, 140.0)),
    }


def _flatten(out):
    if isinstance(out, dict):
        return [np.asarray(out[k]) for k in sorted(out)]
    if isinstance(out, tuple):
        return [np.asarray(o) for o in out]
    return [np.asarray(out)]


@pytest.mark.parametrize("name", sorted(_wrapper_cases(np.random.default_rng(0))))
def test_wrapper_matches_jax(name):
    """Each numpy-facing wrapper over ``ops/mat_ops.py`` on the CPU against
    the JAX package's on the same inputs, within 1e-5."""
    attr, args = _wrapper_cases(np.random.default_rng(0))[name]
    if attr is not None:
        got = getattr(tk_mat_ops, attr)(*args, device=CPU)
        want = getattr(jax_tk_mat_ops, attr)(*args)
    elif name == "solve_kabsch":
        got, want = solve_kabsch(*args, device=CPU), jax_tk.solve_kabsch(*args)
    else:
        got, want = reflector_pose(*args, device=CPU), jax_tk.reflector_pose(*args)
    got, want = _flatten(got), _flatten(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=WRAPPER_TOL, err_msg=name)


def test_headless_toolkit_importable_without_qt():
    import pointcloudprocessing_tpu_torch.toolkit as tk

    assert tk.solve_kabsch is not None and tk.PointCloudPlot is not None
    assert sorted(tk.__all__) == sorted(jax_tk.__all__)
