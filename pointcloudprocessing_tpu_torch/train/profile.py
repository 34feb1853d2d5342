"""TrainProfile: the JSON-config staged (curriculum) trainer
(``pointcloudprocessing_tpu/train/profile.py``).

- Consumes the ``*_config.json`` schema (``core.config``).
- Per stage: build or load a PointCloudSet named ``{name}_{stage}`` (joblib
  cache), ingest any missing collects, train with the stage's freeze flags
  and loss weights, early stopping on the stage's monitor (restoring the
  best weights) and save-best checkpointing, write a history JSON with the
  Keras metric names, then chain: each stage's best weights seed the next.
- ``continue_training_model`` starts the first stage from an earlier stage
  directory's best checkpoint.
- Artifacts per stage directory: ``best/model.pt`` (the model's
  ``state_dict``), ``{name}_{stage}_history.json``, a copy of the config,
  and the best weights exported as ``{name}_{stage}.pt2`` (a
  ``torch.export`` program on the trainer's device, ``export/pt2.py``) and
  ``{name}_{stage}.onnx`` (opset 13, ``export/onnx_native.py``); a failed
  export is logged and does not fail the stage; ``resume/`` while the
  stage runs (``train/callbacks.py``).
- A completed stage (history JSON and ``best/`` on disk, no ``resume/``) is
  skipped on a rerun; a killed stage resumes from its last epoch.

Every model family that ``model_from_config`` builds trains through the
port's step (``train/steps.py``) on ``device``: CUDA unless the caller asks
for the CPU, and without CUDA the default raises. ``params.compute_dtype``
and ``params.optimizer_moment_dtype`` (``bfloat16``/``bf16`` or
``float32``/``f32``/empty; anything else raises) set the model's compute
dtype and Adam's stored moments, as in the JAX driver; the checkpoints hold
f32 parameters either way. Every random draw comes
from an explicit generator seeded from the config: the model's weights,
the steps' jitter and dropout (from the seed and the step count), each
validation batch's jitter (from the seed and
``epoch * validation_steps + i``) and the loaders' order.

Several devices: under a process group (``torchrun``; the CLI joins it,
``parallel/mesh.py``) each rank trains on its device (``cuda:LOCAL_RANK``,
or the device named) and stages its rows of every batch that
single-device training would take, so an epoch's composition is the
single-device one. Rank 0's initial state is broadcast; rank 0 alone
ingests the collects first and alone writes the history JSON, ``best/``,
``resume/``, the config copy and the exports, with barriers around each
write; a resumed run reads the same files on every rank.
``parallel_mode`` picks the step: "gspmd" (default, the global mode:
the whole batch's step, group BatchNorm statistics) or "shard_map"
(per-replica statistics, averaged gradients); :meth:`_parallel_plan` is
the JAX package's, from the world size, with its log lines. Where the JAX
plan needs a data x points mesh (a batch the world does not divide), the
port splits rows unevenly in the global mode and logs the mesh it stands
in for.

Not ported here (``ROADMAP.md``): the scanned multi-step form and
``steps_per_dispatch``.
"""

from __future__ import annotations

import contextlib
import datetime
import json
import logging
import os
import shutil
import time
from collections import defaultdict
from contextlib import nullcontext
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from pointcloudprocessing_tpu_torch.core.config import StageConfig, TrainConfig, load_config
from pointcloudprocessing_tpu_torch.data.frames import get_dir_contents
from pointcloudprocessing_tpu_torch.data.pointcloudset import PointCloudSet, load_from_file
from pointcloudprocessing_tpu_torch.models.pointnet import (
    freeze_flags_from_trainable,
    layer_trainability,
)
from pointcloudprocessing_tpu_torch.parallel.mesh import (
    data_parallel_mesh,
    replicate_from_local,
    sync_batch_stats,
)
from pointcloudprocessing_tpu_torch.train import steps as steps_lib
from pointcloudprocessing_tpu_torch.train.callbacks import (
    BestCheckpoint,
    CtrlCInterruptHandler,
    EarlyStopping,
    ResumeCheckpoint,
    load_checkpoint,
)
from pointcloudprocessing_tpu_torch.utils.profiling import trace
from pointcloudprocessing_tpu_torch.utils.device import require_device

# copied from pointcloudprocessing_tpu/train/profile.py::HISTORY_KEYS
HISTORY_KEYS = [
    "classification_output_loss",
    "classification_output_sparse_categorical_accuracy",
    "loss",
    "se3_loss",
    "se3_root_mean_squared_error",
    "segmentation_output_loss",
    "segmentation_output_sparse_categorical_accuracy",
]

# copied from pointcloudprocessing_tpu/train/profile.py::_epoch_metrics
def _epoch_metrics(batch_logs: list[dict]) -> dict[str, float]:
    """Reduce per-batch logs to Keras-named streaming epoch metrics.

    Accepts both per-step logs (scalar leaves) and stacked logs (leaves
    (k,) — one entry per step)."""
    sums: dict[str, float] = defaultdict(float)
    n = 0
    for logs in batch_logs:
        counted = False
        for k, v in logs.items():
            arr = np.asarray(v, dtype=np.float64)
            sums[k] += float(arr.sum())
            if not counted:
                n += max(arr.size, 1)
                counted = True
    n = max(n, 1)
    return {
        "loss": sums["loss"] / n,
        "classification_output_loss": sums["classification_output_loss"] / n,
        "segmentation_output_loss": sums["segmentation_output_loss"] / n,
        "se3_loss": sums["se3_loss"] / n,
        "classification_output_sparse_categorical_accuracy": (
            sums["classification_correct"] / max(sums["classification_total"], 1.0)
        ),
        "segmentation_output_sparse_categorical_accuracy": (
            sums["segmentation_correct"] / max(sums["segmentation_total"], 1.0)
        ),
        "se3_root_mean_squared_error": float(
            np.sqrt(sums["se3_sq_sum"] / max(sums["se3_count"], 1.0))
        ),
    }


def _host_logs(batch_logs: list[dict[str, torch.Tensor]]) -> list[dict[str, np.ndarray]]:
    """Per-batch device logs -> host arrays in one copy (one sync an epoch)."""
    if not batch_logs:
        return []
    keys = list(batch_logs[0])
    table = torch.stack([torch.stack([logs[k].float() for k in keys])
                         for logs in batch_logs]).cpu().numpy()
    return [dict(zip(keys, row)) for row in table]


def val_seed(seed: int, index: int) -> int:
    """The jitter seed of validation batch ``index`` (``epoch *
    validation_steps + i``), drawn from (config seed, index) as the JAX
    package folds the index into its key."""
    return int(np.random.SeedSequence([seed, index]).generate_state(1)[0])


class TrainProfile:
    def __init__(self, config_file: str | TrainConfig, log_to_file: bool = True,
                 device="cuda"):
        self.device = require_device(device)
        # one rank a device under a process group of more than one rank
        self.mesh = None
        if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
            self.mesh = data_parallel_mesh(self.device)
            self.device = self.mesh.device
        rank0 = self.mesh is None or self.mesh.rank == 0
        if isinstance(config_file, TrainConfig):
            self.config = config_file
            self._config_file = None
        else:
            self._config_file = config_file
            self.config = load_config(config_file)
        cfg = self.config
        from pointcloudprocessing_tpu_torch.models.factory import (
            compute_dtype_of,
            moment_dtype_of,
        )

        self._compute_dtype = compute_dtype_of(cfg)  # an unknown name raises
        self._moment_dtype = moment_dtype_of(cfg)

        # -- path validation (pointnet_train.py:115-122) -------------------
        for path, what in [
            (cfg.model_path, "model_path"),
            (cfg.input_path, "input_path"),
            (cfg.data_path, "data_path"),
        ]:
            if path and not os.path.isdir(path):
                raise FileNotFoundError(f"{what} {path} does not exist")
        for stage in cfg.stages:
            for ds in stage.datasets:
                if not os.path.isdir(f"{cfg.input_path}{ds}"):
                    raise FileNotFoundError(f"{cfg.input_path}{ds} does not exist")
        if cfg.continue_training_model:
            ckpt = f"{cfg.model_path}{cfg.continue_training_model}"
            if not os.path.isdir(ckpt):
                raise FileNotFoundError(f"{ckpt} does not exist")

        self._specific_model_path = f"{cfg.name}/"
        os.makedirs(f"{cfg.model_path}{self._specific_model_path}", exist_ok=True)

        self._log = logging.getLogger(f"train.{cfg.name}")
        # rank 0 speaks for the group
        self._log.setLevel(logging.DEBUG if rank0 else logging.WARNING)
        self._log.propagate = False
        if not self._log.handlers:
            console = logging.StreamHandler()
            console.setFormatter(
                logging.Formatter("%(name)s - %(levelname)s - %(message)s")
            )
            self._log.addHandler(console)
            if log_to_file and rank0:
                ts = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
                fh = logging.FileHandler(
                    f"{cfg.model_path}{self._specific_model_path}log_{ts}.log"
                )
                fh.setFormatter(
                    logging.Formatter(
                        "%(asctime)s - %(name)s - %(levelname)s - %(message)s"
                    )
                )
                self._log.addHandler(fh)

        # -- per-stage datasets (pointnet_train.py:144-172) ----------------
        self._pc_sets: dict[str, PointCloudSet] = {}
        self._stage_paths: dict[str, str] = {}
        with self._rank0_first():  # the others load what rank 0 ingested
            for stage in cfg.stages:
                set_name = f"{cfg.name}_{stage.name}"
                set_dir = f"{cfg.data_path}{set_name}"
                if os.path.isdir(set_dir) and os.path.exists(f"{set_dir}/pc_set.joblib"):
                    self._log.info(
                        f"Training profile {set_name} already exists. Using existing profile..."
                    )
                    pc = load_from_file(f"{set_dir}/pc_set.joblib")
                    pc._print = self._log.info
                else:
                    pc = PointCloudSet(
                        name=set_name,
                        class_labels=list(cfg.class_labels),
                        part_labels=list(cfg.part_labels),
                        network_input_width=cfg.input_width,
                        jitter_stdev_m=np.array(stage.noise.as_tuple()),
                        batch_size=cfg.batch_size,
                        rand_seed=42,
                        description=stage.name,
                        print_func=self._log.info,
                        data_path=cfg.data_path,
                    )
                self._pc_sets[stage.name] = pc
                self._profile_datasets(stage, pc)

                stage_path = f"{self._specific_model_path}{stage.name}/"
                os.makedirs(f"{cfg.model_path}{stage_path}", exist_ok=True)
                self._stage_paths[stage.name] = stage_path

        self._pretrained_model = cfg.continue_training_model
        # epoch-end hooks for testing/observability: fn(stage, epoch, logs)
        self.epoch_callbacks: list[Callable] = []
        # set to a directory to capture a torch.profiler trace of each
        # stage's second epoch (the first builds the kernels)
        self.profile_dir: str | None = None
        # mid-stage resume: pick up a killed stage from its last resume
        # checkpoint (whole train state + epoch + history + early-stop state)
        self.resume: bool = True
        self.resume_every: int = 1  # epochs between resume checkpoints
        # multi-device strategy: "gspmd" (the global mode: the whole
        # batch's step, BatchNorm statistics over the group) or "shard_map"
        # (per-replica statistics, averaged gradients; equal row shares)
        self.parallel_mode: str = "gspmd"

    # ------------------------------------------------------------------

    @contextlib.contextmanager
    def _rank0_first(self):
        """Rank 0 runs the block first, the other ranks after it (one
        barrier each); without a group the block just runs."""
        first = self.mesh is None or self.mesh.rank == 0
        if not first:
            dist.barrier(group=self.mesh.group)
        yield
        if first and self.mesh is not None:
            dist.barrier(group=self.mesh.group)

    def _rank0_writes(self, write: Callable[[], None]) -> None:
        """``write`` on rank 0 alone, then a barrier, so no rank reads
        before the write ends."""
        if self.mesh is None:
            write()
            return
        dist.barrier(group=self.mesh.group)
        if self.mesh.rank == 0:
            write()
        dist.barrier(group=self.mesh.group)

    # copied from pointcloudprocessing_tpu/train/profile.py::TrainProfile._parallel_plan
    def _parallel_plan(self) -> tuple[int, bool, bool]:
        """(points_axis, use_mesh, use_shardmap) from the config and the
        world size (the JAX package's rule on its visible devices). Pure
        batch DP when the batch divides the device count; otherwise a 2-D
        data x points mesh soaks up the remainder. shard_map mode applies
        only to pure data meshes."""
        cfg = self.config
        n_dev = 1 if self.mesh is None else self.mesh.world
        if n_dev <= 1:
            return 1, False, False
        points_axis = 1
        if cfg.batch_size % n_dev != 0:
            for pa in (2, 4, 8):
                data_axis = n_dev // pa
                if (
                    n_dev % pa == 0
                    and data_axis > 0
                    and cfg.batch_size % data_axis == 0
                    and cfg.input_width % pa == 0
                ):
                    points_axis = pa
                    break
        use_mesh = cfg.batch_size % (n_dev // points_axis) == 0
        use_shardmap = (
            use_mesh and self.parallel_mode == "shard_map" and points_axis == 1
        )
        return points_axis, use_mesh, use_shardmap

    def _parallel_steps(self, model, optimizer, weights, freeze, jitter_stdev):
        """(train step, eval step, this rank's rows of a batch) under the
        JAX plan: the shard_map step where the plan takes it, else the
        global mode, whose uneven row shares stand in for a points axis.
        Logs the plan as the JAX trainer does."""
        cfg, mesh = self.config, self.mesh
        points_axis, use_mesh, use_shardmap = self._parallel_plan()
        if cfg.batch_size < mesh.world:
            raise ValueError(
                f"batch_size {cfg.batch_size} is smaller than the {mesh.world} "
                "ranks: every rank needs at least one row of each batch")
        shares = [rows.stop - rows.start for rows in
                  (mesh.rows(cfg.batch_size, r) for r in range(mesh.world))]
        if use_mesh:
            plan = ({"data": mesh.world // points_axis, "points": points_axis}
                    if points_axis > 1 else {"data": mesh.world})
            self._log.info(f"Parallel mesh {plan} over {mesh.world} devices")
        if points_axis > 1 or not use_mesh:
            self._log.info(
                f"Rows of each batch of {cfg.batch_size} split {shares} over "
                f"{mesh.world} ranks in the global mode, in place of "
                + ("the JAX plan's points axis" if use_mesh
                   else "the JAX plan, which takes no mesh here"))
        if self.parallel_mode == "shard_map" and use_mesh and not use_shardmap:
            self._log.info(
                "parallel_mode='shard_map' needs a pure data mesh; the "
                "points axis is in play — falling back to GSPMD."
            )
        if use_shardmap:
            train_step = steps_lib.make_shardmap_train_step(
                model, optimizer, weights, freeze, jitter_stdev, mesh)
        else:
            sync_batch_stats(model, mesh)  # the global mode's group statistics
            train_step = steps_lib.make_train_step(
                model, optimizer, weights, freeze, jitter_stdev, mesh)
        eval_step = steps_lib.make_eval_step(model, weights, jitter_stdev, mesh=mesh)
        return train_step, eval_step, mesh.rows(cfg.batch_size)

    # copied from pointcloudprocessing_tpu/train/profile.py::TrainProfile._profile_datasets
    def _profile_datasets(self, stage: StageConfig, pc: PointCloudSet) -> None:
        """Ingest any collects not already in the stage's dataset
        (pointnet_train.py:259-274)."""
        cfg = self.config
        existing = get_dir_contents(f"{cfg.data_path}{cfg.name}_{stage.name}", self._log.info)
        for i, set_name in enumerate(stage.datasets):
            if set_name not in existing:
                self._log.info(
                    f"Adding data set {i + 1} of {len(stage.datasets)}"
                )
                pc.add_from_aftr_output(
                    dir_path=f"{cfg.input_path}{set_name}", shuffle_points=True
                )
        self._log.info("\nDatasets added successfully:\n")
        self._log.info(pc.get_info())

    # ------------------------------------------------------------------

    def _build_state(self, stage: StageConfig):
        """Model + TrainState for a stage, loading the previous stage's (or
        ``continue_training_model``'s) best weights when chaining."""
        from pointcloudprocessing_tpu_torch.models.factory import model_from_config

        cfg = self.config
        model = model_from_config(
            cfg, training=True,
            generator=torch.Generator().manual_seed(cfg.random_seed),
            device=self.device, dtype=self._compute_dtype,
        )
        freeze = freeze_flags_from_trainable(stage.trainable)
        if self._pretrained_model:
            ckpt_dir = f"{cfg.model_path}{self._pretrained_model}"
            self._log.info(f"Continuing training on model {self._pretrained_model}")
            model.load_state_dict(load_checkpoint(ckpt_dir, self.device))
        state, optimizer = steps_lib.init_train_state(
            model, cfg.learning, freeze, self._moment_dtype)
        if self.mesh is not None:  # every rank starts from rank 0's state
            replicate_from_local(state, self.mesh)
        return model, state, optimizer, freeze

    def train(self) -> dict[str, dict]:
        """Run every stage; returns {stage: history} (pointnet_train.py:174-257)."""
        cfg = self.config
        histories: dict[str, dict] = {}
        anomaly = torch.autograd.detect_anomaly() if cfg.debugging else nullcontext()
        with anomaly:
            for stage in cfg.stages:
                model, state, optimizer, freeze = self._build_state(stage)
                if cfg.model == "pointnet2":
                    from pointcloudprocessing_tpu_torch.models.pointnet2 import (
                        layer_trainability_pointnet2,
                    )

                    self._log.info("PointNet2 Build")
                    report = layer_trainability_pointnet2(freeze)
                elif cfg.model == "dgcnn":
                    from pointcloudprocessing_tpu_torch.models.dgcnn import (
                        layer_trainability_dgcnn,
                    )

                    self._log.info("DGCNN Build")
                    report = layer_trainability_dgcnn(freeze)
                elif cfg.model == "point_transformer":
                    from pointcloudprocessing_tpu_torch.models.point_transformer import (
                        layer_trainability_point_transformer,
                    )

                    self._log.info("Point Transformer Build")
                    report = layer_trainability_point_transformer(freeze)
                else:
                    self._log.info("PointNet Build")
                    report = layer_trainability(freeze, cfg.vanilla)
                self._log.info("\tTrainable Layers")
                for layer, trainable in report.items():
                    self._log.info(f"\t\t-> {layer}: {trainable}")

                histories[stage.name] = self._train_stage(
                    stage, model, state, optimizer, freeze)

                # chain: this stage's best checkpoint seeds the next stage
                self._pretrained_model = self._stage_paths[stage.name]
        return histories

    def _train_stage(self, stage, model, state, optimizer, freeze) -> dict:
        cfg = self.config
        pc = self._pc_sets[stage.name]
        stage_dir = f"{cfg.model_path}{self._stage_paths[stage.name]}"

        # completed-stage skip: a stage with its history JSON and best
        # checkpoint on disk and no resume dir is done — reuse its
        # artifacts and let chaining proceed. Delete the stage directory
        # to force a retrain.
        history_path = f"{stage_dir}{cfg.name}_{stage.name}_history.json"
        if (
            self.resume
            and not ResumeCheckpoint.exists(stage_dir)
            and os.path.isfile(history_path)
            and os.path.isdir(os.path.join(stage_dir, "best"))
        ):
            self._log.info(
                f"Stage '{stage.name}' already completed "
                f"(artifacts in {stage_dir}) — skipping; delete the stage "
                "directory to retrain."
            )
            with open(history_path) as f:
                return json.load(f)

        if pc.split_count("train") == 0 or pc.split_count("val") == 0:
            raise RuntimeError(
                f"Stage '{stage.name}' has no data (train="
                f"{pc.split_count('train')}, val={pc.split_count('val')}). "
                f"Ingest collects into the '{cfg.name}_{stage.name}' dataset or "
                "list them under training_profiles.<stage>.datasets."
            )

        weights = (
            stage.loss_weights.classification,
            stage.loss_weights.segmentation,
            stage.loss_weights.rotation,
        )
        jitter_stdev = stage.noise.as_tuple()
        if self.mesh is None:
            train_step = steps_lib.make_train_step(
                model, optimizer, weights, freeze, jitter_stdev)
            eval_step = steps_lib.make_eval_step(model, weights, jitter_stdev)
            rows = slice(None)
        else:
            train_step, eval_step, rows = self._parallel_steps(
                model, optimizer, weights, freeze, jitter_stdev)

        train_loader = pc.get_train_set()
        val_loader = pc.get_val_set()
        steps_per_epoch = max(pc.split_count("train") // cfg.batch_size, 1)
        validation_steps = max(pc.split_count("val") // cfg.batch_size, 1)

        early = EarlyStopping(cfg.patience, self._log.info)
        ckpt = BestCheckpoint(stage_dir, self._log.info)
        resume_ckpt = ResumeCheckpoint(stage_dir, self.resume_every, self._log.info)
        interrupt = CtrlCInterruptHandler(self._log.info)
        interrupt.install()

        history: dict[str, list] = defaultdict(list)
        start_epoch = 0

        if self.resume and ResumeCheckpoint.exists(stage_dir):
            state, meta = ResumeCheckpoint.load(stage_dir, state)
            start_epoch = meta["next_epoch"]
            history = defaultdict(list, {k: list(v) for k, v in meta["history"].items()})
            early.best = meta["early"]["best"]
            early.best_epoch = meta["early"]["best_epoch"]
            early.wait = meta["early"]["wait"]
            try:  # the restore-best-at-end contract needs the best weights
                early.best_state = load_checkpoint(stage_dir)
                ckpt.best = early.best
            except (FileNotFoundError, RuntimeError, OSError):
                # best/ may not have finished writing before the crash that
                # triggered this resume: leave ckpt.best at +inf so the
                # next epoch rewrites best/
                self._log.info(
                    "Best checkpoint unreadable on resume; it will be "
                    "rewritten at the next epoch."
                )
            self._log.info(
                f"Resuming stage '{stage.name}' from epoch {start_epoch + 1} "
                f"(best {early.best:.6f} @ epoch {early.best_epoch + 1})"
            )

        try:
            for epoch in range(start_epoch, cfg.epochs):
                profiling = (self.profile_dir is not None and epoch == 1
                             and (self.mesh is None or self.mesh.rank == 0))
                t0 = time.perf_counter()
                batch_logs = []
                with trace(f"{self.profile_dir}/{stage.name}") if profiling else nullcontext():
                    for x, targets in train_loader.batches(
                        num_steps=steps_per_epoch, device=self.device, epoch=epoch,
                        rows=rows,
                    ):
                        state, logs = train_step(state, x, targets, cfg.random_seed)
                        batch_logs.append(logs)
                if not batch_logs:
                    # zero batches means the loader found nothing — surface
                    # it instead of logging loss 0.0 epochs
                    raise RuntimeError(
                        f"Stage '{stage.name}' epoch {epoch + 1} produced "
                        "zero training batches — the train loader is empty "
                        "(check data_path / split contents)."
                    )
                train_metrics = _epoch_metrics(_host_logs(batch_logs))
                train_s = time.perf_counter() - t0

                val_logs = []
                for i, (x, targets) in enumerate(
                    val_loader.batches(
                        num_steps=validation_steps, device=self.device, epoch=epoch,
                        rows=rows,
                    )
                ):
                    # fresh jitter noise per validation batch/epoch
                    seed = val_seed(cfg.random_seed, epoch * validation_steps + i)
                    val_logs.append(eval_step(state, x, targets, seed))
                val_metrics = {
                    f"val_{k}": v
                    for k, v in _epoch_metrics(_host_logs(val_logs)).items()
                }

                epoch_metrics = {**train_metrics, **val_metrics}
                for key in HISTORY_KEYS:
                    history[key].append(epoch_metrics[key])
                    history[f"val_{key}"].append(epoch_metrics[f"val_{key}"])

                dt = time.perf_counter() - t0
                monitor_value = epoch_metrics[stage.monitor]
                self._log.info(
                    f"Epoch {epoch + 1}/{cfg.epochs} [{stage.name}] {dt:.1f}s "
                    f"(train loop {train_s:.4f}s, val loop {dt - train_s:.4f}s) - "
                    f"loss: {epoch_metrics['loss']:.4f} - "
                    f"val_loss: {epoch_metrics['val_loss']:.4f} - "
                    f"{stage.monitor}: {monitor_value:.4f}"
                )
                for hook in self.epoch_callbacks:
                    hook(stage.name, epoch, epoch_metrics)

                self._rank0_writes(lambda: ckpt.update(epoch, monitor_value, state))
                stop = early.update(epoch, monitor_value, state)
                self._rank0_writes(lambda: resume_ckpt.save(epoch, state, history, early))
                if stop:
                    break
                if interrupt.stop_requested:
                    self._log.info("User stop received.")
                    break
        finally:
            interrupt.uninstall()

        # EarlyStopping(restore_best_weights=True) semantics
        if early.best_state is not None:
            model.load_state_dict(early.best_state)
        sync_batch_stats(model, None)  # the stage's model is one device's again

        history = dict(history)

        def finish() -> None:
            with open(history_path, "w") as f:
                json.dump(history, f)
            # the stage finished (early-stop, epoch budget, or user stop) — a
            # later rerun should start fresh, not resume stale state
            resume_ckpt.clear()
            # config copy for provenance (pointnet_train.py:251)
            if self._config_file and os.path.isfile(self._config_file):
                shutil.copy(self._config_file, stage_dir)
            self._export(model, f"{stage_dir}{cfg.name}_{stage.name}")

        self._rank0_writes(finish)
        return history

    def _export(self, model, prefix: str) -> None:
        """The stage's artifacts, as the JAX trainer writes its StableHLO and
        ONNX files: ``{prefix}.pt2`` (``export/pt2.py``, placed on the
        trainer's device) and ``{prefix}.onnx`` (the native opset-13
        writer). A failed export is logged and never kills a finished
        run."""
        cfg = self.config
        try:
            from pointcloudprocessing_tpu_torch.export.pt2 import export_pointnet

            t0 = time.perf_counter()
            path = export_pointnet(model, cfg.input_width, prefix, device=self.device)
            self._log.info(f"Exported {path} in {time.perf_counter() - t0:.2f} s")
        except Exception as e:  # export must never kill a finished run
            self._log.info(f".pt2 export skipped: {type(e).__name__}: {e}")
        try:
            from pointcloudprocessing_tpu_torch.export.onnx_bridge import export_onnx

            # opset-13 ONNX like the reference (pointnet_train.py:237-248)
            t0 = time.perf_counter()
            if export_onnx(model, cfg.input_width, f"{prefix}.onnx",
                           print_func=self._log.info):
                self._log.info(f"Exported {prefix}.onnx in "
                               f"{time.perf_counter() - t0:.2f} s")
        except Exception as e:
            self._log.info(f"ONNX export skipped: {type(e).__name__}: {e}")


def train_pointnet(argv: list[str], device="cuda") -> bool:
    """CLI entry (reference: pointnet_train.py:364-402)."""
    configs = [a for a in argv if a.endswith(".json")]
    if not configs:
        print_help()
        return False

    device = require_device(device)
    if device.type == "cuda":
        print(f"Devices available: {torch.cuda.device_count()} x "
              f"{torch.cuda.get_device_name(device)}")
    else:
        print(f"Devices available: {device}")

    for cf in configs:
        tp = TrainProfile(cf, device=device)
        tp.train()
    return True


def print_help() -> None:
    print(
        "PointNet training module (PyTorch port).\n"
        "Usage: python -m pointcloudprocessing_tpu_torch.train.cli "
        "<name>_config.json [--device cuda|cpu]\n"
        "The config follows the reference schema (see core/config.py):\n"
        "  info{name, class_labels, part_labels, training_profiles{...},\n"
        "       continue_training_model}\n"
        "  params{input_width, epochs, patience, batch_size, learning{...},\n"
        "         random_seed, debugging, vanilla, regularize_*_transform, model}\n"
        "  file_system{model_path, input_path, data_path}"
    )
