"""The port's staged trainer on the CPU (``device="cpu"``): a
two-stage curriculum from AFTR frames to checkpoints, chaining, the skip of
a completed stage, ``continue_training_model``, the guards, a kill and
resume equal to the uninterrupted run bit for bit, the callbacks against
the JAX package's decisions, the CLI and serving the trainer's checkpoint.
Sizes: 64 points, batch 4, 2 epochs (the resume case 3)."""

import json
import logging
import math
import os
import re
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from helpers import CLASS_LABELS, PART_LABELS, make_collect
from pointcloudprocessing_tpu.train import callbacks as jax_callbacks
from pointcloudprocessing_tpu.train import profile as jax_profile
from pointcloudprocessing_tpu_torch.data.frames import write_aftr_frame
from pointcloudprocessing_tpu_torch.train import callbacks
from pointcloudprocessing_tpu_torch.train import cli
from pointcloudprocessing_tpu_torch.train import profile
from pointcloudprocessing_tpu_torch.train.profile import HISTORY_KEYS, TrainProfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH = 64
TRAINABLE = {
    "classification_pretrain": {"shared_network": True, "input_transform": True,
                                "classification_head": True, "segmentation_head": False},
    "final": {"shared_network": True, "input_transform": True,
              "classification_head": False, "segmentation_head": True},
}
LOSS_WEIGHTS = {
    "classification_pretrain": {"classification": 1.0, "segmentation": 0.0, "rotation": 0.0},
    "final": {"classification": 0.0, "segmentation": 1.0, "rotation": 0.0},
}
MONITOR = {"classification_pretrain": "val_classification_output_loss",
           "final": "val_segmentation_output_loss"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers, and torch's
    thread pool, oversubscribed, slows these many small steps by tens of
    times (the results do not depend on it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_config(tmp_path, epochs=2, stages=("classification_pretrain", "final"),
                name="tiny", **params):
    """A miniature kc46-shaped config over two synthetic collects."""
    in_dir = tmp_path / "input"
    if not in_dir.exists():
        make_collect(str(in_dir), num_frames=16, points_per_frame=70, seed=0,
                     name="collect_A")
        make_collect(str(in_dir), num_frames=16, points_per_frame=70, seed=1,
                     class_name="f-15_model", name="collect_B")
    for sub in ("models", "data"):
        os.makedirs(tmp_path / sub, exist_ok=True)
    config = {
        "info": {
            "name": name,
            "class_labels": {str(i): c for i, c in enumerate(CLASS_LABELS)},
            "part_labels": {str(i): p for i, p in enumerate(PART_LABELS)},
            "training_profiles": {s: {
                "datasets": {"0": "collect_A", "1": "collect_B"},
                "noise": {"x_stdev_m": 0.01, "y_stdev_m": 0.01, "z_stdev_m": 0.01},
                "trainable": TRAINABLE[s], "loss_weights": LOSS_WEIGHTS[s],
                "monitor": MONITOR[s]} for s in stages},
            "continue_training_model": "",
        },
        "params": {"input_width": WIDTH, "epochs": epochs, "patience": 30,
                   "batch_size": 4, "random_seed": 42, "vanilla": True,
                   "learning": {"rate": 1e-3, "decay_steps": 100, "decay_rate": 0.9},
                   **params},
        "file_system": {"model_path": str(tmp_path / "models") + "/",
                        "input_path": str(tmp_path / "input") + "/",
                        "data_path": str(tmp_path / "data") + "/"},
    }
    path = str(tmp_path / f"{name}_config.json")
    with open(path, "w") as f:
        json.dump(config, f)
    return path


@pytest.fixture(scope="module")
def curriculum(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("curriculum")
    path = make_config(tmp)
    tp = TrainProfile(path, log_to_file=False, device="cpu")
    histories = tp.train()
    return tmp, path, tp, histories


def stage_dir(tmp, stage, name="tiny"):
    return str(tmp / "models" / name / stage)


def test_history_keys_and_artifacts(curriculum):
    tmp, _, _, histories = curriculum
    assert set(histories) == {"classification_pretrain", "final"}
    keys = set(HISTORY_KEYS) | {f"val_{k}" for k in HISTORY_KEYS}
    assert len(keys) == 14
    for stage, history in histories.items():
        assert set(history) == keys
        assert all(len(v) == 2 and all(math.isfinite(x) for x in v)
                   for v in history.values())
        d = stage_dir(tmp, stage)
        assert os.path.isfile(f"{d}/best/model.pt")
        assert os.path.isfile(f"{d}/tiny_config.json")
        assert not os.path.exists(f"{d}/resume")
        with open(f"{d}/tiny_{stage}_history.json") as f:
            assert json.load(f) == history


def test_stage_two_starts_from_stage_one_best(curriculum):
    """``final`` freezes the classification head, so its best weights keep
    the head of ``classification_pretrain``'s best checkpoint exactly."""
    tmp, _, _, _ = curriculum
    first = callbacks.load_checkpoint(stage_dir(tmp, "classification_pretrain"))
    second = callbacks.load_checkpoint(stage_dir(tmp, "final"))
    head = [k for k in first if k.startswith("mlp_cls")]
    assert head
    for k in head:
        assert torch.equal(first[k], second[k]), k
    assert not torch.equal(first["mlp_seg_1.conv.weight"], second["mlp_seg_1.conv.weight"])


def test_rerun_skips_completed_stages(curriculum):
    tmp, path, _, histories = curriculum
    mtime = os.path.getmtime(f"{stage_dir(tmp, 'final')}/best/model.pt")
    messages = []
    recorder = logging.Handler()
    recorder.emit = lambda record: messages.append(record.getMessage())
    logging.getLogger("train.tiny").addHandler(recorder)
    try:
        assert TrainProfile(path, log_to_file=False, device="cpu").train() == histories
    finally:
        logging.getLogger("train.tiny").removeHandler(recorder)
    assert os.path.getmtime(f"{stage_dir(tmp, 'final')}/best/model.pt") == mtime
    assert sum("already completed" in m for m in messages) == 2
    assert sum("already exists. Using existing profile" in m for m in messages) == 2
    assert not any(m.startswith("Adding data set") for m in messages)


def test_epoch_line_carries_the_loop_seconds(tmp_path):
    """Each epoch's log line gives its train and val loops' seconds, which
    add up to the epoch's (``chip_smoke.py`` reads its rates from them)."""
    path = make_config(tmp_path, epochs=2, stages=("final",), name="clock")
    messages = []
    recorder = logging.Handler()
    recorder.emit = lambda record: messages.append(record.getMessage())
    logging.getLogger("train.clock").addHandler(recorder)
    try:
        TrainProfile(path, log_to_file=False, device="cpu").train()
    finally:
        logging.getLogger("train.clock").removeHandler(recorder)
    line = re.compile(r"^Epoch (\d)/2 \[final\] ([\d.]+)s "
                      r"\(train loop ([\d.]+)s, val loop ([\d.]+)s\) - loss: ")
    hits = [m for m in map(line.match, messages) if m]
    assert [int(m[1]) for m in hits] == [1, 2]
    for m in hits:
        epoch_s, train_s, val_s = float(m[2]), float(m[3]), float(m[4])
        assert train_s > 0 and val_s > 0
        assert abs(train_s + val_s - epoch_s) <= 0.05 + 1e-4  # epoch_s has 1 decimal


def test_continue_training_model(curriculum):
    tmp, path, _, _ = curriculum
    config = json.load(open(path))
    config["info"]["name"] = "tiny2"
    config["info"]["continue_training_model"] = "tiny/final/"
    path2 = str(tmp / "tiny2_config.json")
    json.dump(config, open(path2, "w"))
    tp = TrainProfile(path2, log_to_file=False, device="cpu")
    model, _, _, _ = tp._build_state(tp.config.stages[0])
    want = callbacks.load_checkpoint(stage_dir(tmp, "final"))
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    config["info"]["continue_training_model"] = "does/not/exist"
    json.dump(config, open(path2, "w"))
    with pytest.raises(FileNotFoundError):
        TrainProfile(path2, log_to_file=False, device="cpu")


def test_guards(tmp_path):
    path = make_config(tmp_path, stages=("final",))
    config = json.load(open(path))
    bad = json.loads(json.dumps(config))
    bad["file_system"]["input_path"] = str(tmp_path / "nope") + "/"
    bad_path = str(tmp_path / "bad_config.json")
    json.dump(bad, open(bad_path, "w"))
    with pytest.raises(FileNotFoundError, match="input_path"):
        TrainProfile(bad_path, log_to_file=False, device="cpu")
    # an empty stage: a collect with no frames
    os.makedirs(tmp_path / "input" / "empty" / "Lidar")
    open(tmp_path / "input" / "empty" / "_palindrome_state__x.log", "w").write(
        "Time   Frame   Sensor Pose   Tanker Pose\n")
    config["info"]["training_profiles"]["final"]["datasets"] = {"0": "empty"}
    json.dump(config, open(path, "w"))
    with pytest.raises(RuntimeError, match="has no data"):
        TrainProfile(path, log_to_file=False, device="cpu").train()
    # the dtype keys take the JAX package's names (bf16 configs train:
    # tests/test_torch_bf16_train.py); any other name raises
    for key in ("compute_dtype", "optimizer_moment_dtype"):
        with pytest.raises(ValueError, match=key):
            TrainProfile(make_config(tmp_path, stages=("final",), name=key,
                                     **{key: "float16"}), log_to_file=False,
                         device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TrainProfile(path, log_to_file=False)


def test_training_over_the_ram_cap_streams(tmp_path):
    """``max_in_memory_bytes`` 1: every split streams (tests/test_streaming.py's
    ``test_train_over_ram_cap``)."""
    from pointcloudprocessing_tpu_torch.data.loader import StreamingLoader

    tp = TrainProfile(make_config(tmp_path, stages=("final",)), log_to_file=False,
                      device="cpu")
    tp._pc_sets["final"].max_in_memory_bytes = 1
    assert isinstance(tp._pc_sets["final"].get_train_set(), StreamingLoader)
    history = tp.train()["final"]
    assert len(history["loss"]) == 2 and np.isfinite(history["loss"]).all()


def test_profile_dir_traces_the_second_epoch(tmp_path):
    tp = TrainProfile(make_config(tmp_path, stages=("final",)), log_to_file=False,
                      device="cpu")
    tp.profile_dir = str(tmp_path / "prof")
    tp.train()
    with open(tmp_path / "prof" / "final" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert events
    # the step's spans on its thread, the loader's staging on its own
    tids = {}
    for e in events:
        if str(e.get("name", "")).startswith("pcp."):
            tids.setdefault(e["name"], set()).add(e["tid"])
    assert {"pcp.train.step", "pcp.train.forward", "pcp.train.backward",
            "pcp.train.metrics", "pcp.train.optimizer", "pcp.loader.wait",
            "pcp.loader.stage"} <= set(tids)
    assert tids["pcp.loader.stage"].isdisjoint(tids["pcp.train.step"])


def _killed_after(epoch):
    def hook(stage, e, logs):
        if e == epoch:
            raise KeyboardInterrupt("killed")
    return hook


def test_kill_and_resume_equals_uninterrupted(tmp_path):
    """Killed in epoch 2 (before its checkpoints), then resumed: the history
    and the best weights equal an uninterrupted run's bit for bit."""
    runs = {}
    for label in ("straight", "resumed"):
        root = tmp_path / label
        root.mkdir()
        path = make_config(root, epochs=3, stages=("final",))
        if label == "resumed":
            tp = TrainProfile(path, log_to_file=False, device="cpu")
            tp.epoch_callbacks.append(_killed_after(1))
            with pytest.raises(KeyboardInterrupt):
                tp.train()
            meta = json.load(open(f"{stage_dir(root, 'final')}/resume/meta.json"))
            assert meta["next_epoch"] == 1
            assert sorted(os.listdir(f"{stage_dir(root, 'final')}/resume")) == [
                "meta.json", "state_1.pt"]
        seen = []
        tp = TrainProfile(path, log_to_file=False, device="cpu")
        tp.epoch_callbacks.append(lambda stage, e, logs: seen.append(e))
        runs[label] = (tp.train()["final"],
                       callbacks.load_checkpoint(stage_dir(root, "final")), seen)
    (h_a, w_a, seen_a), (h_b, w_b, seen_b) = runs["straight"], runs["resumed"]
    assert seen_a == [0, 1, 2] and seen_b == [1, 2]
    assert h_a == h_b
    assert w_a.keys() == w_b.keys()
    for k in w_a:
        assert torch.equal(w_a[k], w_b[k]), k


def test_resume_refuses_a_jax_checkpoint(tmp_path):
    os.makedirs(tmp_path / "best")
    open(tmp_path / "best" / "_CHECKPOINT_METADATA", "w").write("{}")
    with pytest.raises(FileNotFoundError, match="convert_stage_to_torch"):
        callbacks.load_checkpoint(str(tmp_path))
    os.makedirs(tmp_path / "resume" / "state_3")
    json.dump({"next_epoch": 3, "state_dir": "state_3", "history": {},
               "early": {"best": 1.0, "best_epoch": 0, "wait": 0}},
              open(tmp_path / "resume" / "meta.json", "w"))
    with pytest.raises(FileNotFoundError, match="convert_stage_to_torch"):
        callbacks.ResumeCheckpoint.load(str(tmp_path), None)


def test_interrupt_handler():
    messages = []
    before = signal.getsignal(signal.SIGINT)
    handler = callbacks.CtrlCInterruptHandler(print_func=messages.append)
    handler.install()
    try:
        assert signal.getsignal(signal.SIGINT) == handler._on_signal
        handler._on_signal(signal.SIGINT, None)
        assert handler.stop_requested
        assert any("INTERRUPT INITIATED" in m for m in messages)
        with pytest.raises(SystemExit):
            handler._on_signal(signal.SIGINT, None)
        assert any("FORCE QUIT" in m for m in messages)
    finally:
        handler.uninstall()
    assert signal.getsignal(signal.SIGINT) == before


@pytest.mark.parametrize("stacked", [False, True])
def test_epoch_metrics_equal_jax(stacked):
    rng = np.random.default_rng(int(stacked))
    keys = ["loss", "classification_output_loss", "segmentation_output_loss",
            "se3_loss", "classification_correct", "classification_total",
            "segmentation_correct", "segmentation_total", "se3_sq_sum", "se3_count"]
    shape = (3,) if stacked else ()
    logs = [{k: rng.uniform(0, 10, shape).astype(np.float32) for k in keys}
            for _ in range(5)]
    assert profile._epoch_metrics(logs) == jax_profile._epoch_metrics(logs)
    tensors = [{k: torch.from_numpy(np.asarray(v)) for k, v in d.items()} for d in logs]
    if not stacked:
        assert profile._epoch_metrics(profile._host_logs(tensors)) == \
            jax_profile._epoch_metrics(logs)


class _State:
    def __init__(self, value):
        self.model = torch.nn.Linear(2, 2)
        with torch.no_grad():
            self.model.weight.fill_(value)
        self.params = {"w": np.full(2, value)}
        self.batch_stats = {}


@pytest.mark.parametrize("values,patience", [
    ([3.0, 2.0, 2.5, 1.0, 1.0, 0.5], 2),
    ([1.0, 1.5, 1.5, 1.2, 0.9], 3),
    ([5.0, 4.0, 4.0, 4.0, 4.0], 1),
])
def test_early_stopping_and_best_checkpoint_decide_like_jax(tmp_path, monkeypatch,
                                                           values, patience):
    saved, jax_saved = [], []
    monkeypatch.setattr(callbacks, "_atomic_save",
                        lambda sd, path: saved.append(float(sd["weight"][0, 0])))
    early = callbacks.EarlyStopping(patience, lambda m: None)
    best = callbacks.BestCheckpoint(str(tmp_path), lambda m: None)
    jax_early = jax_callbacks.EarlyStopping(patience, lambda m: None)
    jax_best = jax_callbacks.BestCheckpoint(str(tmp_path / "jax"), lambda m: None)
    monkeypatch.setattr(jax_best, "_ckptr", type("Recorder", (), {
        "save": lambda self, path, payload, force: jax_saved.append(
            float(payload["params"]["w"][0]))})())
    for epoch, v in enumerate(values):
        state = _State(v)
        best.update(epoch, v, state)
        jax_best.update(epoch, v, state)
        stop, jax_stop = early.update(epoch, v, state), jax_early.update(epoch, v, state)
        assert stop == jax_stop
        assert (early.best, early.best_epoch, early.wait) == (
            jax_early.best, jax_early.best_epoch, jax_early.wait)
        if stop:
            break
    assert saved == jax_saved
    assert float(early.best_state["weight"][0, 0]) == early.best


def test_cli_exit_codes_and_device(tmp_path, capsys):
    assert cli.main([]) == 1
    assert "Model training failed." in capsys.readouterr().out
    path = make_config(tmp_path, epochs=1, stages=("final",))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main([path])
    # a fresh process trains from frames with --device cpu and loads no JAX
    code = ("import runpy, sys\n"
            f"sys.argv = ['cli', {path!r}, '--device', 'cpu']\n"
            "try:\n"
            "    runpy.run_module('pointcloudprocessing_tpu_torch.train.cli', "
            "run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "bad = [m for m in sys.modules if m in ('jax', 'flax', 'optax', 'orbax') or "
            "m.split('.')[0] == 'pointcloudprocessing_tpu']\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert "Model training completed successfully." in out.stdout
    assert os.path.isfile(f"{stage_dir(tmp_path, 'final')}/best/model.pt")


def test_serve_reads_the_trainer_checkpoint(curriculum, tmp_path):
    from pointcloudprocessing_tpu_torch import serve

    tmp, _, _, _ = curriculum
    out = tmp_path / "pred.jsonl"
    assert serve.main(["--model", stage_dir(tmp, "final"),
                       "--input", str(tmp / "input" / "collect_A"),
                       "--output", str(out), "--batch", "8", "--device", "cpu"]) == 0
    records = [json.loads(line) for line in open(out)]
    assert len(records) == 16
    assert {r["class"] for r in records} <= set(CLASS_LABELS)
    assert all(sum(r["part_counts"].values()) == WIDTH for r in records)


SHAPES = {  # per-axis scale of a class's clouds: rod, plate, ball, slab
    "kc-46": (4.0, 0.3, 0.3), "f-15_model": (2.5, 2.5, 0.2),
    "c-5": (1.2, 1.2, 1.2), "b-2": (0.4, 3.0, 1.5)}


def _shape_collect(root, class_name, frames, seed):
    rng = np.random.default_rng(seed)
    collect = os.path.join(root, f"collect_{class_name}")
    os.makedirs(os.path.join(collect, "Lidar"))
    lines = ["Time   Frame   Sensor Pose   Tanker Pose"]
    for i in range(frames):
        pose = " ".join(str(v) for v in np.eye(4).T.ravel())
        lines.append(f"t{i} {i} {pose} {pose}")
        pts = rng.normal(size=(WIDTH, 3)) * SHAPES[class_name]
        labels = np.array([f"{class_name} {PART_LABELS[int(np.argmax(np.abs(p)))]}"
                           for p in pts])
        write_aftr_frame(os.path.join(collect, "Lidar", f"frame_{i}.txt"), pts, labels)
    with open(os.path.join(collect, "_palindrome_state__x.log"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return os.path.basename(collect)


def test_four_way_pointnet_learns(tmp_path):
    """Four classes of distinct shapes, 16 frames each, 12 epochs of a
    vanilla PointNet's classification stage (72 steps). The floor is on the
    final epoch's train accuracy, 0.8 (chance 0.25), as
    ``tests/test_class_test.py`` sets it (measured on the CPU: 0.875-1.0
    over epochs 6-12, 1.0 at the last); it fails a step, freeze or loader
    regression that costs real accuracy. Validation runs on the BatchNorm
    running averages, whose momentum-0.99 time constant (~100 steps) this
    short run does not reach, so its accuracy is not held to a floor."""
    classes = list(SHAPES)
    os.makedirs(tmp_path / "input")
    datasets = {str(k): _shape_collect(str(tmp_path / "input"), c, 16, k)
                for k, c in enumerate(classes)}
    path = make_config(tmp_path, epochs=12, stages=("classification_pretrain",),
                       name="four", batch_size=8,
                       learning={"rate": 3e-3, "decay_steps": 1000, "decay_rate": 0.9})
    config = json.load(open(path))
    config["info"]["class_labels"] = {str(i): c for i, c in enumerate(classes)}
    config["info"]["training_profiles"]["classification_pretrain"]["datasets"] = datasets
    json.dump(config, open(path, "w"))
    history = TrainProfile(path, log_to_file=False, device="cpu").train()[
        "classification_pretrain"]
    acc = history["classification_output_sparse_categorical_accuracy"]
    val_acc = history["val_classification_output_sparse_categorical_accuracy"]
    assert acc[-1] > 0.8, acc
    assert all(np.isfinite(val_acc))
