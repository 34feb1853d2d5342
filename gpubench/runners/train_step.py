"""Runner of the training mixes (``"kind": "train_step"``): the program's
train step fed by its ``DeviceLoader``, as ``train/profile.py`` feeds it.

Set-up builds one training state (the model with the benchmark's weights,
Adam's state) and drives it through its first steps with the window's own
step and feed; the first ``compared_steps`` are recorded for the
comparison: each step's loss, the first gradient as Adam holds it after
step 1 (its first moment over 1 - b1), and the parameters' change after the
last of them. The same state then trains through the window. The clouds
per second count every step enqueued in the window over the window and the
wait for its last step. Once the window has closed and the program is
freed, the reference runs the same steps from the same weights and frames.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from gpubench.harness import check, frames, trace
from gpubench.harness.session import Outcome, Reading, fixed_precision, program_with_weights
from gpubench.reference import train as reference_train


def reference_steps(cell, seed: int, params0: dict, buffers: dict, pool: frames.Pool,
                    device, steps: int, rows: slice = slice(None)):
    """The reference over the first ``steps`` batches: (losses, first
    gradients, change of every parameter). ``rows`` plants the fault of
    leaving the rest of each batch out."""
    mix = cell.traffic
    b = mix["batch"]
    params = {n: p.clone() for n, p in params0.items()}
    adam = reference_train.Adam(mix["learning_rate"], mix["decay_steps"], mix["decay_rate"])
    losses, first = [], None
    for s in range(steps):
        frame = slice(s * b, (s + 1) * b)
        x = torch.from_numpy(pool.points[frame]).to(device)
        targets = {"classification_output": torch.from_numpy(pool.class_label[frame]).to(device),
                   "segmentation_output": torch.from_numpy(pool.part_labels[frame]).to(device),
                   "se3": torch.from_numpy(pool.se3[frame]).to(device)}
        loss, grads = reference_train.train_step(
            params, buffers, adam, x, targets, seed, s, tuple(mix["loss_weights"]),
            tuple(mix["jitter_stdev"]), cell.config["dropout_rate"], rows)
        losses.append(loss)
        if first is None:
            first = grads
    return losses, first, {n: params[n] - params0[n] for n in params}


def gaps(program: tuple, reference: tuple) -> dict[str, float]:
    """The numbers that can be compared: the first step's and the worst
    step's relative loss gap, and the worst and the median moved leaf's gap
    of norms of the first gradient and of the parameters' change."""
    (p_losses, p_first, p_change), (r_losses, r_first, r_change) = program, reference
    counted = check.moved_leaves(r_first)
    loss = [abs(p - r) / abs(r) for p, r in zip(p_losses, r_losses)]
    return {
        "first_loss_gap": loss[0],
        "loss_gap": float(np.max(loss)),
        "grad_norm_gap": check.norm_gaps(p_first, r_first, counted),
        "grad_norm_gap_median": check.norm_gaps(p_first, r_first, counted, np.median),
        "change_norm_gap": check.norm_gaps(p_change, r_change, counted),
        "change_norm_gap_median": check.norm_gaps(p_change, r_change, counted, np.median),
    }


def run(cell, seed: int, seconds: float, traced: bool, device, started: float) -> Outcome:
    from pointcloudprocessing_tpu_torch.core.config import LearningConfig
    from pointcloudprocessing_tpu_torch.data.loader import DeviceLoader
    from pointcloudprocessing_tpu_torch.models.pointnet import FreezeFlags
    from pointcloudprocessing_tpu_torch.train import steps

    fixed_precision()
    device = torch.device(device)
    mix = cell.traffic
    b = mix["batch"]
    model, weights = program_with_weights(cell, seed, device, train=True)
    learning = LearningConfig(rate=mix["learning_rate"], decay_steps=mix["decay_steps"],
                              decay_rate=mix["decay_rate"])
    freeze = FreezeFlags()
    state, optimizer = steps.init_train_state(model, learning, freeze)
    step = steps.make_train_step(model, optimizer, tuple(mix["loss_weights"]), freeze,
                                 tuple(mix["jitter_stdev"]))
    pool = frames.make_pool(mix["frames"], seed, device)
    loader = DeviceLoader(pool.arrays(), batch_size=b, shuffle=False, seed=seed)
    feed = loader.batches(device=device, prefetch=mix["prefetch"])
    params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    buffers = {n: t.clone() for n, t in model.named_buffers()}

    def one():
        nonlocal state
        x, targets = next(feed)
        state, logs = step(state, x, targets, seed)
        return logs

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    losses, first = [], None
    for s in range(mix["compared_steps"]):
        losses.append(one()["loss"])
        if s == 0:  # Adam's first moment after one step is (1 - b1) g
            first = {n: m / (1.0 - steps.ADAM_B1) for n, m in state.opt_state.mu.items()}
    change = {n: p.detach() - params0[n] for n, p in model.named_parameters()}
    for _ in range(mix["warmup_steps"] - mix["compared_steps"]):
        one()
    sync()
    setup_peak = 0
    if device.type == "cuda":
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.time() - started
    stretches: list[int] = []
    stretch = None
    done = 0
    t_start = time.perf_counter()
    t_end = t_start + seconds
    while time.perf_counter() < t_end:
        if traced and stretch is None and time.perf_counter() >= t_start + seconds / 3:
            sync()
            time.sleep(0.05)  # the loader's thread settles before the pre-roll

            def stretch_fn():
                for _ in range(mix["trace_steps"]):
                    one()
                stretches.append(mix["trace_steps"])

            stretch = trace.device_trace(stretch_fn)
            done += sum(stretches)
            continue
        one()
        done += 1
    sync()
    t_stop = time.perf_counter()
    window_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    feed.close()
    outcome = Outcome(attempted=done * b, failed=0, compared=[],
                      memory_peak_bytes=max(window_peak, setup_peak))
    if not traced:
        outcome.metrics = {
            "train_clouds_per_s": done * b / (t_stop - t_start),
            "peak_mem_gib": window_peak / 2**30,
            "setup_s": setup_s,
        }
    elif stretch is not None:
        units = stretches[stretch.attempt]
        outcome.reading = Reading(cell.traffic["kind"], stretch, units, units * b, cell)

    program = ([float(v) for v in losses], first, change)
    del state, step, optimizer, model, feed, loader
    if device.type == "cuda":
        torch.cuda.empty_cache()
    reference = reference_steps(cell, seed, params0, buffers, pool, device,
                                mix["compared_steps"])
    outcome.numbers = gaps(program, reference)
    outcome.compared = check.held(outcome.numbers, cell.limits)
    return outcome
