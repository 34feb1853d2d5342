"""The staged trainer (``TrainProfile``) on a 2-rank gloo group on the CPU,
the JAX package's ``_parallel_plan`` rule, and the CLI under ``torchrun``.

One spawn runs three one-stage runs (64 points, 2 epochs, the kc46-shaped
config of ``tests/test_torch_train_profile.py``): the global mode
("gspmd") and the shard_map mode at batch 4, and shard_map asked for at
batch 3, which the world does not divide: the JAX plan then wants a data x
points mesh and falls back to GSPMD, and the port splits the rows [1, 2].
Each run: finite histories with the 14 Keras keys, rank 0 alone writes
(the history, ``best/``, ``resume/``, the exports), and ``best/model.pt``
equals the model both ranks hold at the stage's end; the log carries the
JAX trainer's plan lines.
"""

import json
import math
import os
import socket
import subprocess
import sys
from types import SimpleNamespace

import jax
import pytest
import torch

import torch_parallel_worker as tpw
from pointcloudprocessing_tpu.train import profile as jax_profile
from pointcloudprocessing_tpu_torch.train import profile
from pointcloudprocessing_tpu_torch.train.profile import HISTORY_KEYS
from test_torch_train_profile import REPO, make_config, stage_dir

RUNS = {  # name: (parallel_mode, batch_size)
    "gspmd": ("gspmd", 4),
    "shardmap": ("shard_map", 4),
    "uneven": ("shard_map", 3),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    inputs = {}
    for name, (mode, batch) in RUNS.items():
        tmp = tmp_path_factory.mktemp(name)
        inputs[name] = {"config": make_config(tmp, epochs=2, stages=("final",),
                                              name=name, batch_size=batch),
                        "parallel_mode": mode, "tmp": tmp}
    work = str(tmp_path_factory.mktemp("trainer"))
    torch.save(inputs, os.path.join(work, "inputs.pt"))
    return inputs, tpw.spawn(2, work, "trainer", timeout=400)


@pytest.mark.parametrize("name", list(RUNS))
def test_histories_finite_and_rank0_alone_writes(runs, name):
    inputs, results = runs
    keys = set(HISTORY_KEYS) | {f"val_{k}" for k in HISTORY_KEYS}
    for res in results:
        history = res[name]["histories"]["final"]
        assert set(history) == keys
        assert all(len(v) == 2 and all(math.isfinite(x) for x in v)
                   for v in history.values())
    assert results[0][name]["histories"] == results[1][name]["histories"]
    assert results[1][name]["writes"] == []
    written = results[0][name]["writes"]
    d = stage_dir(inputs[name]["tmp"], "final", name=name)
    assert any(w.endswith("best/model.pt") for w in written)
    assert any("resume" in w for w in written)
    assert any(w.endswith(f"{name}_final") for w in written)  # the exports
    with open(f"{d}/{name}_final_history.json") as f:
        assert json.load(f) == results[0][name]["histories"]["final"]
    assert not os.path.exists(f"{d}/resume")


@pytest.mark.parametrize("name", list(RUNS))
def test_best_checkpoint_is_what_every_rank_holds(runs, name):
    inputs, results = runs
    best = torch.load(f"{stage_dir(inputs[name]['tmp'], 'final', name=name)}/best/model.pt",
                      weights_only=True)
    for res in results:
        (model,) = res[name]["models"]
        assert set(model) == set(best)
        for k, v in best.items():
            assert torch.equal(torch.from_numpy(model[k]), v), k


def test_plan_log_lines(runs):
    _, results = runs
    log = {name: results[0][name]["log"] for name in RUNS}
    assert "Parallel mesh {'data': 2} over 2 devices" in log["gspmd"]
    assert "Parallel mesh {'data': 2} over 2 devices" in log["shardmap"]
    assert "Parallel mesh {'data': 1, 'points': 2} over 2 devices" in log["uneven"]
    assert any("split [1, 2] over 2 ranks" in m for m in log["uneven"])
    fallback = ("parallel_mode='shard_map' needs a pure data mesh; the points axis "
                "is in play — falling back to GSPMD.")
    assert fallback in log["uneven"] and fallback not in log["shardmap"]
    assert results[1]["gspmd"]["log"] == []  # rank 0 speaks for the group


@pytest.mark.parametrize("mode", ["gspmd", "shard_map"])
@pytest.mark.parametrize("world", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("batch,width", [(3, 64), (4, 64), (6, 64), (8, 63), (12, 64)])
def test_parallel_plan_is_the_jax_plan(monkeypatch, mode, world, batch, width):
    cfg = SimpleNamespace(batch_size=batch, input_width=width)
    port = SimpleNamespace(config=cfg, parallel_mode=mode,
                           mesh=None if world == 1 else SimpleNamespace(world=world))
    monkeypatch.setattr(jax, "devices", lambda: list(range(world)))
    jax_self = SimpleNamespace(config=cfg, parallel_mode=mode)
    assert (profile.TrainProfile._parallel_plan(port)
            == jax_profile.TrainProfile._parallel_plan(jax_self))


def test_cli_under_torchrun_trains_on_two_ranks(tmp_path):
    path = make_config(tmp_path, epochs=1, stages=("final",), name="run2")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
         "--master-addr", "127.0.0.1", "--master-port", str(free_port()),
         "-m", "pointcloudprocessing_tpu_torch.train.cli", path, "--device", "cpu",
         "--backend", "gloo"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("Model training completed successfully.") == 2
    d = stage_dir(tmp_path, "final", name="run2")
    assert os.path.isfile(f"{d}/best/model.pt")
    assert os.path.isfile(f"{d}/run2_final_history.json")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
