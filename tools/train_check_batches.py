#!/usr/bin/env python3
"""Read ``chip_smoke.py`` phase 6's check of one PointNet train step (the
kernels' step against the plain step, phase 6's bars) on more of case B's
batches than phase 6 draws.

The batches come from ``numpy.random.default_rng(seed)`` after case A's
batch, as phase 6 (seed 0) and phase 14 (a) (seed 14) draw them: batch 1
of seed 0 is phase 6's first case-B batch, batch 1 of seed 14 phase 14
(a)'s. On each batch it runs ``chip_smoke.check_step_against_plain``:

- as phase 6 runs it: three models, the kernels' step, the plain step and
  the plain step on the batch one ulp up, whose change sets the bars;
- with a fourth model, the plain step one ulp down, the larger move
  setting the bars (as ``tests/test_torch_train_step.py`` takes it).

For each it prints the worst share of a bar, or the bar it misses; then
how far the plain step moves under the one-ulp-down batch, as a share of
the gradient bars that the one-ulp-up move alone sets (over 1: the bar's
own estimate of the rounding is short on this batch); then the kernels'
gradients against gradient bars set by another plain step whose pooled
chains sum their GEMM in another order (the input channels in two halves,
each an f32 GEMM, added): a rounding as valid as the plain one, at the
place where the kernels round otherwise. Last, each pooled-chain call of
the kernels' step (forward: the pooled values; backward: dx and dk)
against its float64 value on the same inputs, beside the plain version's
error there: the largest and the root-mean-square error of each. It reads
and does not fail on a miss; it exits non-zero only on an error of its
own.

Needs CUDA; exits non-zero without it.

Usage: python tools/train_check_batches.py [--seeds 14 0] [--batches 6]
"""

from __future__ import annotations

import argparse
import copy
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def own_move(models) -> tuple[float, str]:
    """The plain step's change under the one-ulp-down batch (models[3])
    over the gradient bars of the one-ulp-up change (models[2]) alone, as
    phase 6 sets them; the worst share and its parameter."""
    named = [dict(m.named_parameters()) for m in models]
    worst, where = 0.0, ""
    for name, pp in named[1].items():
        gp = pp.grad
        if gp is None:
            continue
        bound = 8 * (gp - named[2][name].grad).abs().max() + 1e-5 * gp.abs().max() + 1e-12
        share = ((gp - named[3][name].grad).abs().max() / bound).item()
        if share > worst:
            worst, where = share, name
    return worst, where


def split_gemm_forward(x, w, a, c_row):
    """The plain pooled forward with its GEMM summed in another order: the
    input channels in two halves, each an f32 GEMM, then added."""
    import torch

    h = x.shape[-1] // 2
    y = (torch.matmul(x[..., :h], w[:, :h].t())
         + torch.matmul(x[..., h:], w[:, h:].t()))
    r = torch.relu(y * a + c_row)
    return r.amax(dim=1), r.argmax(dim=1).int()


def reordered_share(torch, cs, steps, pristine, cfg, freeze, weights, jitter_m,
                    x, targets, models) -> tuple[float, str]:
    """The kernels' gradients (models[0]) against the plain step's
    (models[1]) over phase 6's gradient bar with the split-GEMM plain step
    as the sensitivity; the worst share and its parameter."""
    from pointcloudprocessing_tpu_torch.ops.cuda.pooled_chain import (
        pooled_chain_backward_reference,
    )

    model = copy.deepcopy(pristine)
    state, optimizer = steps.init_train_state(model, cfg.learning, freeze)
    with cs.route_pooled(split_gemm_forward, pooled_chain_backward_reference):
        steps.make_train_step(model, optimizer, weights, freeze, jitter_m)(
            state, x, targets, 0)
    torch.cuda.synchronize()
    named = [dict(m.named_parameters()) for m in (models[0], models[1], model)]
    worst, where = 0.0, ""
    for name, pp in named[1].items():
        gp = pp.grad
        if gp is None:
            continue
        bound = 8 * (gp - named[2][name].grad).abs().max() + 1e-5 * gp.abs().max() + 1e-12
        share = ((named[0][name].grad - gp).abs().max() / bound).item()
        if share > worst:
            worst, where = share, name
    return worst, where


def backward64(torch, x, w, coef, argmax, m_small, const_row):
    """The pooled backward (the plain version's formula) in float64."""
    xd = x.double()
    points = torch.arange(x.shape[1], device=x.device)[None, :, None]
    a_mat = torch.where(points == argmax[:, None, :].long(),
                        coef.double()[:, None, :], 0.0)
    dx = a_mat @ w.double() + xd @ m_small.double() + const_row.double()
    return dx, torch.einsum("bnd,bnc->dc", xd, a_mat)


def call_errors(torch, cs, steps, pristine, cfg, freeze, weights, jitter_m,
                x, targets) -> str:
    """Each pooled-chain call of one kernels' step against float64: the
    kernels' and the plain version's largest and RMS errors, worst over
    the calls, for the pooled values, dx and dk."""
    from pointcloudprocessing_tpu_torch.ops.cuda.pooled_chain import (
        pooled_chain_backward,
        pooled_chain_backward_reference,
        pooled_chain_forward,
        pooled_chain_forward_reference,
    )

    calls = {"fwd": [], "bwd": []}

    def fwd(*args):
        out = pooled_chain_forward(*args)
        calls["fwd"].append(tuple(t.clone() for t in (*args, *out)))
        return out

    def bwd(*args):
        out = pooled_chain_backward(*args)
        calls["bwd"].append(tuple(t.clone() for t in (*args, *out)))
        return out

    model = copy.deepcopy(pristine)
    state, optimizer = steps.init_train_state(model, cfg.learning, freeze)
    with cs.route_pooled(fwd, bwd):
        steps.make_train_step(model, optimizer, weights, freeze, jitter_m)(
            state, x, targets, 0)
    torch.cuda.synchronize()
    worst = {}

    def note(key, kernel, plain, exact):
        ek, ep = (t.double() - exact for t in (kernel, plain))
        for stat, fn in (("max", lambda e: e.abs().max()),
                         ("rms", lambda e: e.square().mean().sqrt())):
            k, p = fn(ek).item(), fn(ep).item()
            old = worst.get((key, stat), (0.0, 0.0))
            worst[(key, stat)] = (max(old[0], k), max(old[1], p))

    for x_, w, a, c_row, pooled, _ in calls["fwd"]:
        r = torch.relu((x_.double() @ w.double().t()) * a.double() + c_row.double())
        note("pooled", pooled, pooled_chain_forward_reference(x_, w, a, c_row)[0],
             r.amax(dim=1))
    for *args, dx, dk in calls["bwd"]:
        dx64, dk64 = backward64(torch, *args)
        pdx, pdk = pooled_chain_backward_reference(*args)
        note("dx", dx, pdx, dx64)
        note("dk", dk, pdk, dk64)
    return "; ".join(f"{key} {stat} kernels {k:.3e} plain {p:.3e} ({k / max(p, 1e-300):.2f}x)"
                     for (key, stat), (k, p) in worst.items())


def read_seed(torch, cs, steps, pristine, cases, seed: int, batches: int) -> None:
    """The check on ``batches`` case-B batches of ``seed``."""
    cfg_a = cases["A"][0]
    cfg, freeze, weights, jitter_m, _ = cases["B"]
    b, n = cfg.batch_size, cfg.input_width
    rng = np.random.default_rng(seed)
    cs.train_batch(torch, rng, cfg_a.batch_size, cfg_a.input_width,
                   cfg_a.num_classes, cfg_a.num_parts)  # case A's draw
    misses = {3: 0, 4: 0}
    for k in range(batches):
        x, targets = cs.train_batch(torch, rng, b, n, cfg.num_classes, cfg.num_parts)
        cs.log(f"[train check] seed {seed} B batch {k + 1}: pooled-chain calls of the "
               "kernels' step against float64, worst over the calls: " + call_errors(
                   torch, cs, steps, pristine, cfg, freeze, weights, jitter_m, x,
                   targets))
        for count in (3, 4):
            models = [copy.deepcopy(pristine) for _ in range(count)]
            runs = []
            for m in models:
                state, optimizer = steps.init_train_state(m, cfg.learning, freeze)
                runs.append((state, steps.make_train_step(m, optimizer, weights,
                                                          freeze, jitter_m)))
            lr = float(optimizer.learning_rate(0))

            def run_step(i, points, runs=runs, targets=targets):
                state, step = runs[i]
                _, logs = step(state, points, targets, 0)
                torch.cuda.synchronize()
                return logs

            label = f"seed {seed} B batch {k + 1}, {count} models"
            try:
                worst = cs.check_step_against_plain(torch, label, models, run_step,
                                                    x, lr)
                reading = (f"within: worst over its bar losses {worst['loss']:.3f}, "
                           f"grads {worst['grad']:.3f}, running statistics "
                           f"{worst['stat']:.3f}; param {worst['param']:.3f} lr; "
                           f"argmax flips {worst['ties']}")
            except AssertionError as e:
                misses[count] += 1
                reading = f"MISSED: {e}"
            extra = ""
            if count == 4:
                share, name = own_move(models)
                split, at = reordered_share(torch, cs, steps, pristine, cfg, freeze,
                                            weights, jitter_m, x, targets, models)
                extra = (f"; the plain step one ulp down moves {share:.3f} of the "
                         f"one-ulp-up grad bar ({name}); the kernels' grads are "
                         f"{split:.3f} of the split-GEMM grad bar ({at})")
            cs.log(f"[train check] {label} ({b}x{n}): {reading}{extra}")
    cs.log(f"[train check] seed {seed}: {batches} batches; missed with 3 "
           f"models {misses[3]}, with 4 models {misses[4]}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[14])
    parser.add_argument("--batches", type=int, default=6)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("train_check_batches: needs CUDA", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    from pointcloudprocessing_tpu_torch.models.factory import model_from_config
    from pointcloudprocessing_tpu_torch.train import steps

    cs.phase_device(torch)
    cs.phase_build()
    cases = cs.train_cases()
    pristine = model_from_config(cases["B"][0], training=True, dropout_rate=0.3,
                                 generator=torch.Generator().manual_seed(0),
                                 device="cuda")
    for seed in args.seeds:
        read_seed(torch, cs, steps, pristine, cases, seed, args.batches)
    return 0


if __name__ == "__main__":
    sys.exit(main())
