"""Ranks of a gloo process group for the port's multi-device tests, and
the numpy bars the tests hold their results to.

``spawn(world, workdir, suite)`` starts ``world`` processes of this file,
joined in a gloo group on a free 127.0.0.1 port; each reads
``<workdir>/inputs.pt`` (written by the test), runs every scenario of the
suite, and writes ``<workdir>/rank<r>.pt``. The processes import torch and
the port only (no JAX), with one intra-op thread each.

Suites:
- ``steps``: train and eval steps. A scenario names the model (``family``,
  constructor kwargs, a ``state_dict``), the mode ("global", "shard_map"
  or "eval"), the global batch and which rows a rank takes ("split": its
  share by ``shard_batch``; "local": its share cut here and placed by
  ``make_global_batch``; "all": the whole batch, identical shards), and
  records the logs,
  the state after the steps and the gradients.
- ``trainer``: ``TrainProfile`` runs, one a scenario (config path,
  ``parallel_mode``), recording the histories, the model's state and the
  writes each rank made.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def spawn(world: int, workdir: str, suite: str, timeout: float = 240) -> list[dict]:
    """Run the suite on ``world`` ranks; returns each rank's results."""
    import torch

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world), str(port),
         workdir, suite], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{outs[r][0][-3000:]}\n{outs[r][1][-6000:]}"
    results = [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
               for r in range(world)]
    for r, res in enumerate(results):
        res["stdout"] = outs[r][0]
    return results


# ----------------------------------------------------------------- the ranks

def _build(family: str, kwargs: dict):
    from pointcloudprocessing_tpu_torch.models import pointnet2
    from pointcloudprocessing_tpu_torch.models.dgcnn import DGCNN
    from pointcloudprocessing_tpu_torch.models.pointnet import PointNet

    if family == "dgcnn":
        return DGCNN(**kwargs)
    if family == "pointnet2":
        return pointnet2.pointnet2_for_width(**kwargs, device="cpu")
    return PointNet(**kwargs)


def _numpy(tree):
    import torch

    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return tree.detach().cpu().clone().numpy()
    return tree


def run_step_scenario(sc: dict, mesh) -> dict:
    """One scenario of the ``steps`` suite on this rank."""
    import torch

    from pointcloudprocessing_tpu_torch.core.config import LearningConfig
    from pointcloudprocessing_tpu_torch.models.pointnet import FreezeFlags
    from pointcloudprocessing_tpu_torch.parallel import mesh as mesh_lib
    from pointcloudprocessing_tpu_torch.train import steps

    model = _build(sc["family"], sc["kwargs"])
    model.load_state_dict(sc["state"])
    freeze = FreezeFlags(*sc.get("freeze", (False,) * 4))
    state, optimizer = steps.init_train_state(model, LearningConfig(*sc["learning"]),
                                              freeze)
    mesh_lib.shard_train_state(state, mesh)
    x, targets = sc["x"], sc["targets"]
    if sc["rows"] == "split":
        x, targets = mesh_lib.shard_batch((x, targets), mesh)
    elif sc["rows"] == "local":  # the multi-process contract: own rows only
        rows = mesh.rows(len(x))
        x, targets = mesh_lib.make_global_batch(
            (x[rows], {k: v[rows] for k, v in targets.items()}), mesh)
    else:
        x, targets = torch.as_tensor(x), {k: torch.as_tensor(v) for k, v in targets.items()}
    jitter = sc.get("jitter", (0.0, 0.0, 0.0))
    if sc["mode"] == "eval":
        step = steps.make_eval_step(model, sc["loss_weights"], jitter, mesh=mesh)
        return {"logs": _numpy(step(state, x, targets, sc.get("seed", 0)))}
    if sc["mode"] == "global":
        mesh_lib.sync_batch_stats(model, mesh)
        step = steps.make_train_step(model, optimizer, sc["loss_weights"], freeze,
                                     jitter, mesh)
    else:
        step = steps.make_shardmap_train_step(model, optimizer, sc["loss_weights"],
                                              freeze, jitter, mesh)
    history = []
    for _ in range(sc.get("steps", 1)):
        state, logs = step(state, x, targets, sc.get("seed", 0))
        history.append(_numpy(logs))
    return {"logs": history[0], "history": history, "rows": int(x.shape[0]),
            "state": _numpy(model.state_dict()),
            "grads": {n: p.grad.clone().numpy() for n, p in model.named_parameters()
                      if p.grad is not None}}


def run_trainer_scenario(sc: dict, mesh) -> dict:
    """One ``TrainProfile`` run on this rank, counting the files it writes."""
    import json
    import logging

    import torch

    from pointcloudprocessing_tpu_torch.train import callbacks, profile

    writes = []
    real_save, real_dump, real_export = (callbacks._atomic_save, json.dump,
                                         profile.TrainProfile._export)
    callbacks._atomic_save = lambda obj, path: (writes.append(path), real_save(obj, path))[1]
    profile.json.dump = lambda obj, f, **kw: (writes.append(f.name), real_dump(obj, f, **kw))[1]

    def export(self, model, prefix):
        writes.append(prefix)
        return real_export(self, model, prefix)

    profile.TrainProfile._export = export
    lines = []
    handler = logging.Handler()
    handler.emit = lambda record: lines.append(record.getMessage())
    try:
        tp = profile.TrainProfile(sc["config"], log_to_file=False, device="cpu")
        tp.parallel_mode = sc["parallel_mode"]
        tp._log.addHandler(handler)
        models = []
        real_train_stage = tp._train_stage

        def train_stage(stage, model, *args):
            out = real_train_stage(stage, model, *args)
            models.append(_numpy(model.state_dict()))
            return out

        tp._train_stage = train_stage
        histories = tp.train()
    finally:
        callbacks._atomic_save, profile.json.dump = real_save, real_dump
        profile.TrainProfile._export = real_export
    return {"histories": histories, "writes": writes, "log": lines,
            "models": models, "device": str(tp.device)}


def _main(rank: int, world: int, port: int, workdir: str, suite: str) -> None:
    import torch
    import torch.distributed as dist

    from pointcloudprocessing_tpu_torch.parallel import mesh as mesh_lib

    torch.set_num_threads(1)
    mesh_lib.initialize_multihost(f"127.0.0.1:{port}", world, rank, backend="gloo")
    try:
        mesh = mesh_lib.data_parallel_mesh("cpu")
        inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
        run = run_step_scenario if suite == "steps" else run_trainer_scenario
        results = {name: run(sc, mesh) for name, sc in inputs.items()}
        torch.save(results, os.path.join(workdir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


# -------------------------------------------------------------------- bars

def within_step_bars(got: dict, want: dict, ulp: dict, grads: dict, sens: dict,
                     lr: float, grad_factor: float = 8.0,
                     base: dict | None = None) -> list[str]:
    """Faults of a step against a reference step, by the reference's own
    one-ulp sensitivity (``tests/test_torch_train_step.py``'s bars):
    - losses within 8x the one-ulp change + 1e-6 |loss| + 1e-7, counts equal;
    - each gradient leaf in ``got["grads"]`` within ``grad_factor`` x its
      one-ulp change (``sens``, max norm) + 1e-5 max |g|;
    - new parameters within 1e-3 lr plus one ulp of the parameter where
      |g| > 10x the leaf's one-ulp change, within 2 lr elsewhere;
    - new running statistics within 8x the one-ulp change + 1e-6 + 1e-5 |stat|.
    ``got``/``want``/``ulp``: {"logs", "params", "stats"} (flat name ->
    array); ``grads``: the reference's gradients (decides where a sign is
    certain); ``base``: the step whose one-ulp change ``ulp`` measures
    (``want`` by default; the f32 step where ``want`` is a float64 one).
    Returns the faults found (empty: within every bar)."""
    base = want if base is None else base
    faults = []
    for key in ("loss", "classification_output_loss", "segmentation_output_loss",
                "se3_loss"):
        g, w, b, u = (float(t["logs"][key]) for t in (got, want, base, ulp))
        if abs(g - w) > 8 * abs(b - u) + 1e-6 * abs(w) + 1e-7:
            faults.append(f"{key}: {g} vs {w} (one-ulp change {abs(b - u):.3e})")
    for key in ("classification_correct", "classification_total",
                "segmentation_correct", "segmentation_total", "se3_count"):
        if float(got["logs"][key]) != float(want["logs"][key]):
            faults.append(f"{key}: {got['logs'][key]} vs {want['logs'][key]}")
    for name, g in got.get("grads", {}).items():
        w = grads[name]
        bound = grad_factor * sens[name] + 1e-5 * np.abs(w).max()
        err = np.abs(g - w).max()
        if err > bound:
            faults.append(f"grad {name}: {err:.3e} > {bound:.3e}")
    for name, w in want["params"].items():
        g = got["params"][name]
        err = np.abs(g - w)
        certain = np.abs(grads[name]) > 10 * sens[name] if name in grads else None
        if certain is not None and (err[certain] > 1e-3 * lr
                                    + np.spacing(np.abs(w[certain]))).any():
            faults.append(f"param {name}: {err[certain].max():.3e} where the sign is certain")
        if err.max() > 2 * lr * (1 + 1e-3):
            faults.append(f"param {name}: {err.max():.3e} > 2 lr")
    for name, w in want["stats"].items():
        bound = (8 * np.abs(base["stats"][name] - ulp["stats"][name]).max() + 1e-6
                 + 1e-5 * np.abs(w))
        if (np.abs(got["stats"][name] - w) > bound).any():
            faults.append(f"stat {name}: {np.abs(got['stats'][name] - w).max():.3e}")
    return faults


def split_state(state: dict) -> tuple[dict, dict]:
    """(parameters, running statistics) of a flat ``state_dict``."""
    stats = {k: v for k, v in state.items() if k.endswith(("running_mean", "running_var"))}
    return {k: v for k, v in state.items() if k not in stats}, stats


if __name__ == "__main__":
    _main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
