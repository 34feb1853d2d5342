"""Train, eval and predict steps with freeze-masked Adam
(``pointcloudprocessing_tpu/train/steps.py``), for every model family that
``model_from_config`` builds: PointNet, PointNet++ and DGCNN.

- Optimizer: Adam with Keras's epsilon 1e-7 on a continuous exponential
  learning-rate decay, in optax's operation order (``optax.adam`` and
  ``optax.exponential_decay``, non-staircase; the rate is taken at the step
  count before its increment, so the first step uses ``rate``). With a
  ``moment_dtype`` (bf16) both moments are stored in it, as the JAX
  package's ``scale_by_adam_moments`` stores them: the update runs in f32
  from the upcast moments and only the stored moments are rounded. A bf16
  nu can stall: with b2 = 0.999 an EMA step (~1e-3 of nu) is under half a
  bf16 ulp (~4e-3), so nu may stick and follow a decaying gradient scale
  poorly; keep nu in f32 if a run's quality drops.
- The hyperparameter grid's optimizers: :func:`sgd`, :func:`adagrad` and
  :func:`adam` are optax's at a constant rate, over every parameter with
  ``requires_grad``, with the same ``init`` / ``update_`` interface.
- Freeze/thaw: a stage's switches label each top-level submodule "train" or
  "freeze" by its name (``input_transform``, ``feature_transform``,
  ``mlp_cls*``, ``mlp_seg*``; everything else, ``mlp_1_*``, ``sa*``,
  ``ec*``, ``emb``, is the shared trunk); frozen parameters get no update
  and no moment state, and frozen BatchNorms use their running statistics inside the model. Frozen
  parameters also take ``requires_grad=False``, so the backward skips
  their gradients (the JAX package computes them and masks the update;
  the updates are the same).
- Randomness: the jitter noise and the dropout masks of step ``s`` come from
  two ``torch.Generator``s seeded from ``(seed, s)``, as the JAX package
  folds the step into its key. The streams differ from JAX's.
- State: the model holds the parameters and the running statistics, and
  the step updates both, and the Adam moments, in place; it returns the
  same state object with ``step`` advanced. After a step each trained
  parameter's ``.grad`` holds that step's gradient; a frozen one's is None.
- Regularizers: PointNet's T-Net terms come from ``forward_with_reg``;
  PointNet++ and DGCNN add none, as their JAX ``reg_losses`` collection is
  empty.
- Metrics: per-batch correct counts and sums, so a host can rebuild Keras's
  streaming epoch metrics exactly.

- Several devices (``parallel/mesh.py``; one process a device, each
  passing its rows of the batch): the global mode,
  ``make_train_step(..., mesh=)``, computes the single-device step on the
  whole batch (group batch statistics, which the caller switches on with
  ``sync_batch_stats(model, mesh)``; global-count means, whole-batch
  draws, summed gradients), as the JAX package's GSPMD step does; the
  shard_map mode, :func:`make_shardmap_train_step`, is its non-sync
  BatchNorm data parallelism (per-replica statistics and draws, averaged
  gradients and running statistics). Parameters stay bit-identical across
  ranks in both.

The scanned multi-step forms (K steps per dispatch) are not ported
(ROADMAP, "Do not port").
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable, Mapping
from functools import partial

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from pointcloudprocessing_tpu_torch.core.config import LearningConfig
from pointcloudprocessing_tpu_torch.models.pointnet import (
    NOTHING_FROZEN,
    FreezeFlags,
)
from pointcloudprocessing_tpu_torch.ops.augment import jitter
from pointcloudprocessing_tpu_torch.parallel.mesh import DataParallelMesh, RowDraws
from pointcloudprocessing_tpu_torch.train.losses import multi_head_loss
from pointcloudprocessing_tpu_torch.utils.profiling import span

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-7  # Keras's epsilon


def freeze_label_tree(params: Mapping[str, object], freeze: FreezeFlags) -> dict[str, str]:
    """Label each parameter 'train' or 'freeze' by its top-level submodule,
    per the stage's switches, in the reference's application order
    (``pointnet_train.py:322-332``)."""

    def label_for(name: str) -> str:
        top = name.split(".", 1)[0]
        if top == "input_transform":
            frozen = freeze.input_transform
        elif top == "feature_transform":
            frozen = freeze.shared_network
        elif top.startswith("mlp_cls"):
            frozen = freeze.classification_head
        elif top.startswith("mlp_seg"):
            frozen = freeze.segmentation_head
        else:  # mlp_1_*, mlp_2_*: the shared trunk
            frozen = freeze.shared_network
        return "freeze" if frozen else "train"

    return {name: label_for(name) for name in params}


@dataclasses.dataclass
class AdamState:
    """Adam's step count and first and second moments, for the trained
    parameters only, stored in the optimizer's moment dtype."""

    count: int
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


class Optimizer:
    """``optax.multi_transform({"train": adam(schedule, eps=1e-7),
    "freeze": set_to_zero()}, labels)`` over named parameters, in f32; with
    ``moment_dtype`` the JAX package's ``scale_by_adam_moments`` chained
    with the same schedule (moments stored in that dtype)."""

    def __init__(self, learning: LearningConfig, labels: Mapping[str, str],
                 moment_dtype: torch.dtype | None = None):
        self.learning = learning
        self.labels = dict(labels)
        self.moment_dtype = moment_dtype

    def init(self, params: Mapping[str, torch.Tensor]) -> AdamState:
        trained = [n for n in params if self.labels[n] == "train"]
        zeros = {n: torch.zeros_like(params[n], dtype=self.moment_dtype)
                 for n in trained}
        return AdamState(0, zeros, {n: z.clone() for n, z in zeros.items()})

    def learning_rate(self, count: int) -> np.float32:
        """``optax.exponential_decay`` (non-staircase) at ``count``, in f32."""
        rate = np.float32(self.learning.rate)
        if count <= 0:
            return rate
        p = np.float32(count) / np.float32(self.learning.decay_steps)
        return rate * np.power(np.float32(self.learning.decay_rate), p)

    @torch.no_grad()
    def update_(self, params: Mapping[str, torch.Tensor], state: AdamState) -> None:
        """One Adam step from each trained parameter's ``.grad``, in place:
        ``p - lr * mu_hat / (sqrt(nu_hat) + eps)``, with optax's operations
        in its order. Multi-tensor ``_foreach`` ops update every parameter
        in a dozen launches, where a loop over ~70 tensors took ~1,000 and
        bound the step on the host."""
        lr = float(self.learning_rate(state.count))
        state.count += 1
        names = list(state.mu)
        if not names:
            return
        ps = [params[n] for n in names]
        mus = [state.mu[n] for n in names]
        nus = [state.nu[n] for n in names]
        stored = None
        if self.moment_dtype is not None:  # the math in f32 from upcasts
            stored = mus, nus
            mus, nus = [m.float() for m in mus], [v.float() for v in nus]
        _adam_step_(ps, mus, nus, state.count, lr)
        if stored is not None:  # only the stored moments are rounded
            torch._foreach_copy_(stored[0], mus)
            torch._foreach_copy_(stored[1], nus)


@torch.no_grad()
def _adam_step_(ps: list, mus: list, nus: list, count: int, lr: float) -> None:
    """``p += -lr * (mu_hat / (sqrt(nu_hat) + eps))`` from each ``p.grad``,
    with the moments updated in place, in optax's operations and order
    (``count`` is the step count after its increment)."""
    bc1 = float(np.float32(1) - np.float32(ADAM_B1) ** np.float32(count))
    bc2 = float(np.float32(1) - np.float32(ADAM_B2) ** np.float32(count))
    grads = [p.grad for p in ps]
    # mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu
    torch._foreach_mul_(mus, ADAM_B1)
    torch._foreach_add_(mus, torch._foreach_mul(grads, 1.0 - ADAM_B1))
    sq = torch._foreach_mul(grads, grads)
    torch._foreach_mul_(sq, 1.0 - ADAM_B2)
    torch._foreach_mul_(nus, ADAM_B2)
    torch._foreach_add_(nus, sq)
    # p += -lr * (mu / bc1) / (sqrt(nu / bc2) + eps)
    denom = torch._foreach_div(nus, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, ADAM_EPS)
    upd = torch._foreach_div(mus, bc1)
    torch._foreach_div_(upd, denom)
    torch._foreach_mul_(upd, -lr)
    torch._foreach_add_(ps, upd)


def make_optimizer(learning: LearningConfig, params: Mapping[str, torch.Tensor],
                   freeze: FreezeFlags = NOTHING_FROZEN,
                   moment_dtype: torch.dtype | None = None) -> Optimizer:
    return Optimizer(learning, freeze_label_tree(params, freeze), moment_dtype)


# ---- optax's plain optimizers at a constant rate (the hyperparameter grid's)

ADAGRAD_INITIAL_ACCUMULATOR, ADAGRAD_EPS = 0.1, 1e-7  # optax.adagrad's defaults


@dataclasses.dataclass
class PlainState:
    """A constant-rate optimizer's step count and its per-parameter slots
    (``slots[k][name]``: Adagrad's sum of squares, Adam's two moments)."""

    count: int
    slots: tuple[dict[str, torch.Tensor], ...]


class _ConstantRate:
    """An optax optimizer at a constant rate over every parameter that has
    ``requires_grad`` (``init_train_state`` sets it on the trained ones),
    with ``Optimizer``'s interface: ``init(params)`` and ``update_(params,
    state)`` from each parameter's ``.grad``, in ``_foreach`` ops."""

    initial_slots: tuple[float, ...] = ()

    def __init__(self, lr: float):
        self.lr = float(lr)

    def init(self, params: Mapping[str, torch.Tensor]) -> PlainState:
        trained = [n for n, p in params.items() if p.requires_grad]
        return PlainState(0, tuple(
            {n: torch.full_like(params[n], v) for n in trained}
            for v in self.initial_slots))

    @torch.no_grad()
    def update_(self, params: Mapping[str, torch.Tensor], state: PlainState) -> None:
        state.count += 1
        names = [n for n, p in params.items() if p.requires_grad]
        if names:
            ps = [params[n] for n in names]
            self._step_(ps, [[slot[n] for n in names] for slot in state.slots],
                        state.count)

    def _step_(self, ps: list, slots: list, count: int) -> None:
        raise NotImplementedError


class SGD(_ConstantRate):
    """``optax.sgd(lr)`` with no momentum: ``p += g * -lr``."""

    def _step_(self, ps, slots, count):
        torch._foreach_add_(ps, torch._foreach_mul([p.grad for p in ps], -self.lr))


class Adagrad(_ConstantRate):
    """``optax.adagrad(lr)``: the sum of squares starts at 0.1, and the
    update is ``g / sqrt(sum + 1e-7)`` where ``sum > 0``, 0 elsewhere
    (``scale_by_rss``), times ``-lr``. Not ``torch.optim.Adagrad``, which
    starts at 0 and adds eps outside the root."""

    initial_slots = (ADAGRAD_INITIAL_ACCUMULATOR,)

    def _step_(self, ps, slots, count):
        (sums,) = slots
        grads = [p.grad for p in ps]
        torch._foreach_add_(sums, torch._foreach_mul(grads, grads))
        inv = torch._foreach_add(sums, ADAGRAD_EPS)
        torch._foreach_sqrt_(inv)
        torch._foreach_reciprocal_(inv)
        torch._foreach_mul_(inv, torch._foreach_sign(sums))  # 0 where sum == 0
        upd = torch._foreach_mul(inv, grads)
        torch._foreach_mul_(upd, -self.lr)
        torch._foreach_add_(ps, upd)


class Adam(_ConstantRate):
    """``optax.adam(lr, eps=1e-7)``: Keras's epsilon, no decay schedule."""

    initial_slots = (0.0, 0.0)

    def _step_(self, ps, slots, count):
        _adam_step_(ps, slots[0], slots[1], count, self.lr)


# optax's names: ``sgd(lr)``, ``adagrad(lr)``, ``adam(lr)``
sgd, adagrad, adam = SGD, Adagrad, Adam


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module  # parameters and running statistics
    opt_state: AdamState


def init_train_state(
    model: nn.Module,
    learning: LearningConfig,
    freeze: FreezeFlags = NOTHING_FROZEN,
    moment_dtype: torch.dtype | None = None,
) -> tuple[TrainState, Optimizer]:
    """Wrap a built model (its weights seeded or loaded) into a TrainState,
    with ``requires_grad`` on exactly the trained parameters and Adam's
    moments in ``moment_dtype`` (None: f32)."""
    params = dict(model.named_parameters())
    optimizer = make_optimizer(learning, params, freeze, moment_dtype)
    for name, p in params.items():
        p.requires_grad_(optimizer.labels[name] == "train")
    return TrainState(0, model, optimizer.init(params)), optimizer


def step_generators(seed: int, step: int, device: torch.device,
                    replica: int = 0) -> tuple[torch.Generator, torch.Generator]:
    """(jitter, dropout) generators of one step, seeded from (seed, step),
    with a shard_map replica's index folded in as the JAX package folds
    ``axis_index``: replica r > 0 draws from (seed, step, r), so replicas
    draw distinct noise and masks, and replica 0 the single-device step's
    (a group of one trains as one device does)."""
    entropy = [seed, step] + ([replica] if replica else [])
    jitter_seed, dropout_seed = np.random.SeedSequence(entropy).generate_state(2)
    return (torch.Generator(device=device).manual_seed(int(jitter_seed)),
            torch.Generator(device=device).manual_seed(int(dropout_seed)))


def _metric_sums(outputs, targets) -> dict[str, torch.Tensor]:
    """Per-batch sufficient statistics for Keras streaming metrics."""
    cls_pred = outputs["classification_output"].argmax(dim=-1)
    seg_pred = outputs["segmentation_output"].argmax(dim=-1)
    se3_err = outputs["se3"] - targets["se3"]

    def count(v: int) -> torch.Tensor:
        return torch.tensor(float(v), device=se3_err.device)

    return {
        "classification_correct": (
            cls_pred == targets["classification_output"]).float().sum(),
        "classification_total": count(cls_pred.shape[0]),
        "segmentation_correct": (
            seg_pred == targets["segmentation_output"]).float().sum(),
        "segmentation_total": count(seg_pred.shape[0] * seg_pred.shape[1]),
        "se3_sq_sum": torch.square(se3_err).sum(),
        "se3_count": count(se3_err.numel()),
    }


def forward_with_reg(model: nn.Module, x: torch.Tensor, **kwargs):
    """(outputs, regularizer sum) of any family: PointNet's T-Net terms,
    or 0 for a model with no regularizer (PointNet++, DGCNN)."""
    if hasattr(model, "forward_with_reg"):
        return model.forward_with_reg(x, **kwargs)
    return model(x, **kwargs), 0.0


def _forward_backward(model, loss_weights, freeze, jitter_stdev, x, targets,
                      jitter_g, dropout_g, batch_size=None) -> dict[str, torch.Tensor]:
    """Jitter, the train-mode forward, the loss and its backward (each
    trained parameter's ``.grad``); returns the step's logs."""
    with span("pcp.train.forward"):
        x = jitter(x, jitter_g, jitter_stdev)
        model.zero_grad(set_to_none=True)
        with torch.enable_grad():
            outputs, reg = forward_with_reg(
                model, x, train=True, freeze=freeze, generator=dropout_g)
            total, head_losses = multi_head_loss(outputs, targets, loss_weights, reg,
                                                 batch_size)
    if total.requires_grad:  # False only when every parameter is frozen
        with torch.enable_grad(), span("pcp.train.backward"):
            total.backward()
    with torch.no_grad(), span("pcp.train.metrics"):
        return {"loss": total.detach(),
                **{k: v.detach() for k, v in head_losses.items()},
                **_metric_sums(outputs, targets)}


def _train_step_impl(
    model: nn.Module,
    optimizer: Optimizer,
    loss_weights: tuple[float, float, float],
    freeze: FreezeFlags,
    jitter_stdev: tuple[float, float, float],
    state: TrainState,
    x: torch.Tensor,
    targets: dict[str, torch.Tensor],
    seed: int,
) -> tuple[TrainState, dict[str, torch.Tensor]]:
    if state.model is not model:
        raise ValueError("the train step was built for another model")
    with span("pcp.train.step"):
        jitter_g, dropout_g = step_generators(seed, state.step, x.device)
        logs = _forward_backward(model, loss_weights, freeze, jitter_stdev, x,
                                 targets, jitter_g, dropout_g)
        with span("pcp.train.optimizer"):
            optimizer.update_(dict(model.named_parameters()), state.opt_state)
    state.step += 1
    return state, logs


def make_train_step(
    model: nn.Module,
    optimizer: Optimizer,
    loss_weights: tuple[float, float, float],
    freeze: FreezeFlags,
    jitter_stdev: tuple[float, float, float],
    mesh: DataParallelMesh | None = None,
) -> Callable:
    """The train step: (state, x, targets, seed) -> (state, logs).

    With a process-group ``mesh`` it is the global mode, the counterpart
    of the JAX package's GSPMD step: each rank passes its rows of the
    batch, and the result is the single-device step on the whole batch.
    The model's BatchNorms must take their statistics over the group:
    the caller switches them with ``sync_batch_stats(model, mesh)`` first.
    Every batch mean is a sum over the rank's rows over the global count,
    jitter and dropout are the whole batch's draws (:class:`RowDraws`),
    gradients are summed over the ranks and the logs are global sums; the
    global count and this rank's rows come from the ranks' row counts,
    read each step. Without a mesh the model's BatchNorms must take local
    statistics.
    """
    if mesh is None:
        _require_stats_group(model, None)
        return partial(_train_step_impl, model, optimizer, loss_weights, freeze,
                       jitter_stdev)
    _require_group(mesh)
    _require_stats_group(model, mesh.group)
    return partial(_global_train_step, model, optimizer, loss_weights, freeze,
                   jitter_stdev, mesh)


def _require_group(mesh: DataParallelMesh) -> None:
    if mesh.group is None:
        raise ValueError("a multi-device train or eval step needs the "
                         "process-group form of the mesh (one rank a device)")


def _require_stats_group(model: nn.Module, group) -> None:
    """Every batch-statistics BatchNorm of ``model`` takes its statistics
    over ``group`` (None: locally), as ``sync_batch_stats`` sets them."""
    if any(m.stats_group is not group for m in model.modules()
           if hasattr(m, "stats_group")):
        raise ValueError(
            "the model's BatchNorms take their statistics "
            + ("over a group; call sync_batch_stats(model, None) first"
               if group is None else
               "locally; call sync_batch_stats(model, mesh) first"))


def _global_rows(local: int, mesh: DataParallelMesh, device) -> tuple[int, slice]:
    """(global batch size, this rank's rows) from every rank's row count
    (one all-reduce and a host read)."""
    counts = torch.zeros(mesh.world, dtype=torch.float64, device=device)
    counts[mesh.rank] = local
    dist.all_reduce(counts, group=mesh.group)
    counts = [int(c) for c in counts.tolist()]
    start = sum(counts[: mesh.rank])
    return sum(counts), slice(start, start + local)


def _all_reduce_grads(model: nn.Module, mesh: DataParallelMesh, average: bool) -> None:
    """Sum (or average) every parameter's ``.grad`` over the group, in one
    flat all-reduce."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.group)
    if average:
        flat /= mesh.world
    torch._foreach_copy_(grads, [f.view_as(g) for f, g in zip(
        flat.split([g.numel() for g in grads]), grads)])


def _reduce_logs(logs: dict[str, torch.Tensor], mesh: DataParallelMesh,
                 mean_keys=()) -> dict[str, torch.Tensor]:
    """Logs summed over the group (``mean_keys`` averaged), one all-reduce."""
    keys = list(logs)
    flat = torch.stack([logs[k].float() for k in keys])
    dist.all_reduce(flat, group=mesh.group)
    return {k: flat[i] / mesh.world if k in mean_keys else flat[i]
            for i, k in enumerate(keys)}


def _global_train_step(model, optimizer, loss_weights, freeze, jitter_stdev,
                       mesh, state, x, targets, seed):
    if state.model is not model:
        raise ValueError("the train step was built for another model")
    with span("pcp.train.step"):
        batch, rows = _global_rows(x.shape[0], mesh, x.device)
        jitter_g, dropout_g = step_generators(seed, state.step, x.device)
        logs = _forward_backward(
            model, loss_weights, freeze, jitter_stdev, x, targets,
            RowDraws(jitter_g, batch, rows), RowDraws(dropout_g, batch, rows), batch)
        _all_reduce_grads(model, mesh, average=False)
        with span("pcp.train.optimizer"):
            optimizer.update_(dict(model.named_parameters()), state.opt_state)
        logs = _reduce_logs(logs, mesh)
    state.step += 1
    return state, logs


def make_shardmap_train_step(
    model: nn.Module,
    optimizer: Optimizer,
    loss_weights: tuple[float, float, float],
    freeze: FreezeFlags,
    jitter_stdev: tuple[float, float, float],
    mesh: DataParallelMesh,
) -> Callable:
    """The shard_map data-parallel step (``make_shardmap_train_multi_step``
    for one step): (state, x, targets, seed) -> (state, logs), x this
    rank's rows. Each replica normalizes by its own batch statistics (the
    non-sync BatchNorm of DDP), and draws its own jitter and dropout
    (:func:`step_generators` with its rank); the gradients and the running
    statistics of the trained BatchNorms are averaged over the group, so
    the replicated state stays bit-identical; the metric sums are summed
    and the losses averaged over the replicas. On identical shards with
    jitter and dropout off it is the single-device step exactly. The
    model's BatchNorms must take local statistics.
    """
    _require_group(mesh)
    _require_stats_group(model, None)
    # a trained BatchNorm's running statistics move every step; a frozen
    # one's never do, and an average would round them
    stats = [t for m in model.modules()
             if hasattr(m, "stats_group") and m.weight.requires_grad
             for t in (m.running_mean, m.running_var)]

    def step(state, x, targets, seed):
        if state.model is not model:
            raise ValueError("the train step was built for another model")
        with span("pcp.train.step"):
            jitter_g, dropout_g = step_generators(seed, state.step, x.device, mesh.rank)
            logs = _forward_backward(model, loss_weights, freeze, jitter_stdev, x,
                                     targets, jitter_g, dropout_g)
            _all_reduce_grads(model, mesh, average=True)
            if stats:
                with torch.no_grad():
                    flat = torch.cat(stats)
                    dist.all_reduce(flat, group=mesh.group)
                    flat /= mesh.world
                    torch._foreach_copy_(stats, list(flat.split(
                        [t.numel() for t in stats])))
            with span("pcp.train.optimizer"):
                optimizer.update_(dict(model.named_parameters()), state.opt_state)
            logs = _reduce_logs(logs, mesh, mean_keys=(
                "loss", "classification_output_loss", "segmentation_output_loss",
                "se3_loss"))
        state.step += 1
        return state, logs

    return step


@torch.no_grad()
def _eval_step_impl(model, loss_weights, jitter_stdev, apply_jitter, mesh,
                    state, x, targets, seed):
    if state.model is not model:
        raise ValueError("the eval step was built for another model")
    batch = None
    if mesh is not None:
        batch, rows = _global_rows(x.shape[0], mesh, x.device)
    if apply_jitter:
        generator = torch.Generator(device=x.device).manual_seed(seed)
        if mesh is not None:
            generator = RowDraws(generator, batch, rows)
        x = jitter(x, generator, jitter_stdev)
    outputs, reg = forward_with_reg(model, x, train=False)
    total, head_losses = multi_head_loss(outputs, targets, loss_weights, reg,
                                         batch)
    logs = {"loss": total, **head_losses, **_metric_sums(outputs, targets)}
    return logs if mesh is None else _reduce_logs(logs, mesh)


def make_eval_step(
    model: nn.Module,
    loss_weights: tuple[float, float, float],
    jitter_stdev: tuple[float, float, float] = (0.0, 0.0, 0.0),
    apply_jitter: bool = True,
    mesh: DataParallelMesh | None = None,
) -> Callable:
    """The eval step: (state, x, targets, seed) -> logs; mutates nothing.

    Jitter applies to validation too (the reference parses every split
    alike), from a generator seeded with ``seed``: pass a fresh seed per
    batch, or ``apply_jitter=False`` for clean evaluation. The T-Net
    regularizers count in the total, as Keras adds ``model.losses`` in
    ``test_step``. With a process-group ``mesh`` each rank passes its rows
    and the logs are the whole batch's (global sums; the jitter the whole
    batch's draw), as the JAX package's eval step over a mesh.
    """
    if mesh is not None:
        _require_group(mesh)
    return partial(_eval_step_impl, model, loss_weights, jitter_stdev,
                   apply_jitter, mesh)


def make_predict_fn(model: nn.Module) -> Callable:
    """Inference entry: x -> outputs dict (running statistics, no dropout)."""

    @torch.inference_mode()
    def predict(x: torch.Tensor) -> dict[str, torch.Tensor]:
        return model(x, train=False)

    return predict
