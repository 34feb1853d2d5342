"""Smoke tests for the PyTorch port's example scripts (``examples/torch/``),
case for case with ``tests/test_examples.py``, on the CPU (``--device
cpu``; every script defaults to CUDA).

In-process where the script exposes functions, by subprocess where it is
argv-driven; training examples run one epoch in the slow lane, as in the
JAX file. ``build_reference_point_cloud.py`` and
``make_class_test_configs.py`` import neither package and have no twin.
Beyond the JAX file: the train example at a tiny width, reloading its
``.pt2`` program, with ``evaluate.evaluate_checkpoint`` on its stage; the
data synthesizers; and the flagship smoke at a tiny size (the card runs it
at full size from ``chip_smoke.py``).
"""

import glob
import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from helpers import make_collect

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples", "torch")


def load_example(name):
    """The script as a module; the ``sys.path`` entries it adds for its own
    imports are taken out again."""
    saved = list(sys.path)
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved
    return mod


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # the suite runs several workers: an oversubscribed torch thread pool
    # is many times slower
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def test_pose_computation(tmp_path, capsys):
    collect = make_collect(str(tmp_path), num_frames=4)
    log = next(
        os.path.join(collect, f)
        for f in os.listdir(collect)
        if f.startswith("_palindrome_state")
    )
    load_example("pose_computation").main(log, device="cpu")
    out = capsys.readouterr().out
    assert "frames: 4" in out
    assert re.search(r"frame \d+: t=\(.*\) m  rpy=\(.*\) deg", out)


def test_data_exploration(tmp_path):
    csv = tmp_path / "returns.csv"
    csv.write_text(
        "range_m,azimuth_deg,elevation_deg,strength\n"
        "10.0,0.0,0.0,1.0\n12.5,45.0,10.0,0.5\n"
    )
    out = tmp_path / "frame_0.txt"
    load_example("data_exploration").main(str(csv), str(out), device="cpu")
    assert out.exists()
    lines = out.read_text().strip().splitlines()
    assert len(lines) == 2
    # 10 m straight ahead of a radar mounted 1 m up
    xyz = [float(v) for v in lines[0].strip("()").split(",")]
    np.testing.assert_allclose(xyz, [10.0, 0.0, 1.0], atol=1e-5)


def test_evaluate_summarize(tmp_path, capsys):
    hist = {
        "loss": [1.0, 0.5, 0.7],
        "val_classification_output_accuracy": [0.3, 0.6, 0.5],
    }
    (tmp_path / "stage_history.json").write_text(json.dumps(hist))
    load_example("evaluate").summarize(str(tmp_path))
    out = capsys.readouterr().out
    assert "min 0.5000 @ epoch 2" in out
    assert "max 0.6000 @ epoch 2" in out


def test_build_from_aftr_script(tmp_path):
    # the script's label maps are the kc46 boom-operation set: the collect
    # must carry those labels or every frame is (correctly) rejected
    collect = make_collect(
        str(tmp_path / "in"), num_frames=6, class_name="kc46"
    )
    lidar = os.path.join(collect, "Lidar")
    for fname in os.listdir(lidar):
        p = os.path.join(lidar, fname)
        with open(p) as f:
            text = re.sub(r"\b(wing|fuselage|engine)\b", "left_wing", f.read())
        with open(p, "w") as f:
            f.write(text)
    res = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES, "build_from_aftr.py"), collect,
         str(tmp_path / "out"), "--device", "cpu"],
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    name = os.path.basename(collect)
    assert os.path.exists(tmp_path / "out" / name / "pc_set.joblib"), res.stdout
    assert "count" in res.stdout.lower()


def test_scripts_refuse_cuda_without_it(tmp_path):
    """Every script defaults to CUDA and raises without it (no CPU
    fallback)."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    res = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES, "build_from_aftr.py"),
         str(tmp_path), str(tmp_path / "out")],
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode != 0 and "CUDA is not available" in res.stderr
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_example("hyperparameter_tuning").main(1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_example("flagship_smoke").main()


def test_train_example_reloads_its_program(tmp_path, capsys):
    """The train example at a tiny width: the stage trains, its ``.pt2``
    program reloads and classifies; ``evaluate.evaluate_checkpoint`` runs
    the stage's checkpoint over the set's test split."""
    work = str(tmp_path / "work")
    agreement = load_example("train_example").main(work, device="cpu", width=32,
                                                   epochs=2, frames=12)
    assert 0.0 <= agreement <= 1.0
    stage = os.path.join(work, "models", "example", "final")
    assert os.path.isfile(os.path.join(stage, "example_final.pt2"))
    out = capsys.readouterr().out
    assert "final val classification accuracy" in out
    assert "exported-artifact small-cube agreement" in out

    logs = load_example("evaluate").evaluate_checkpoint(
        stage, os.path.join(work, "data", "example_final"), device="cpu")
    assert np.isfinite(float(logs["loss"]))
    assert float(logs["classification_total"]) > 0
    assert "test classification accuracy" in capsys.readouterr().out


def test_make_class_test_data(tmp_path):
    collects = load_example("make_class_test_data").synthesize_class_collects(
        str(tmp_path), 2, frames_per_class=2, sample_points=128, pad=256,
        device="cpu")
    assert [os.path.basename(c) for c in collects] == ["collect_a-10", "collect_b-1b"]
    for c in collects:
        frames = glob.glob(os.path.join(c, "Lidar", "frame_*.txt"))
        assert len(frames) == 2
        with open(frames[0]) as f:
            assert len(f.read().splitlines()) == 256


def test_make_kc46_and_f15_like_data(tmp_path):
    kc46 = load_example("make_kc46_like_data").make_collects(
        str(tmp_path / "kc46"), 2, pad=128, dense_points=500, device="cpu")
    f15 = load_example("make_f15_like_data").make_f15_collects(
        str(tmp_path / "f15"), 2, pad=128, dense_points=500, device="cpu")
    for collects, count in ((kc46, 4), (f15, 5)):
        assert len(collects) == count
        for c in collects:
            assert len(glob.glob(os.path.join(c, "Lidar", "frame_*.txt"))) == 2


def test_flagship_smoke_tiny():
    """The flagship path end to end at a tiny size: two bf16 stages, each
    with its artifacts, and serve over one collect."""
    result = load_example("flagship_smoke").main(
        "cpu", frames_per_class=6, sample_points=64, width=128, epochs=1, batch=4)
    assert result["served"] == 6
    assert set(result["seconds"]) == {"synthesis", "ingest", "training", "serve"}
    assert len(result["histories"]) == 2
    for stage, files in result["artifacts"].items():
        assert len(files) == 3, (stage, files)
    for history in result["histories"].values():
        assert all(np.isfinite(v).all() for v in history.values())


@pytest.mark.slow
def test_classifier_example_one_epoch(capsys):
    mod = load_example("classifier_example")
    mod.train_classifier(1, device="cpu")
    mod.pretrain_tnet(1, device="cpu")
    out = capsys.readouterr().out
    assert "accuracy" in out.lower() or "MSE" in out


@pytest.mark.slow
def test_modelnet_example_procedural_fallback():
    acc = load_example("modelnet_example").main(None, epochs=1, device="cpu")
    assert 0.0 <= float(acc) <= 1.0


@pytest.mark.slow
def test_hyperparameter_tuning_one_epoch(capsys):
    load_example("hyperparameter_tuning").main(1, device="cpu")
    out = capsys.readouterr().out
    assert "tabular" in out or "best" in out.lower()
