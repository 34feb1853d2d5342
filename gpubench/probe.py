#!/usr/bin/env python3
"""Readings that a cell's limits are set from, on the card, in one process:

- sound: the cell's own run (a short window) on each of ``--seeds``: every
  number the runner works out, program against reference;
- control: on each of ``--control-seeds``, the reference computed with TF32
  on (the precision below the configurations' float32 with TF32 off) in the
  program's place, against the reference;
- faults (training cells): the reference with half of each batch left out,
  the loss a mean over the rest, in the program's place.

    python3 gpubench/probe.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--seconds 2] [--out <file.json>]

Prints one JSON line of every reading and, per number, the largest sound
reading and the smallest control and fault readings.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _tf32(on: bool) -> None:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def control_serve(cell, seed: int, device) -> dict:
    """The reference in TF32 against the reference, on the first
    ``compare_batches`` batches of the seed's pool."""
    import numpy as np
    import torch

    from gpubench.harness import check, frames
    from gpubench.harness.session import program_with_weights
    from gpubench.reference import pipeline

    mix = cell.traffic
    model, weights = program_with_weights(cell, seed, device)
    del model
    pool = frames.make_pool(mix["frames"], seed, device)
    forward = cell.model.reference_forward(cell.config, weights)
    gaps: dict[str, list] = {}
    b = mix["batch"]
    with torch.no_grad():
        for i in range(mix["compare_batches"]):
            scans = torch.from_numpy(pool.points[i * b:(i + 1) * b]).to(device)
            _tf32(False)
            expected = pipeline.serve(forward, scans, mix["voxel_size"], mix["model_width"])
            _tf32(True)
            lower = pipeline.serve(forward, scans, mix["voxel_size"], mix["model_width"])
            _tf32(False)
            for name, gap in check.head_gaps(lower, expected).items():
                gaps.setdefault(name, []).append(gap)
    return {k: float(np.max(v)) for k, v in gaps.items()}


def control_train(cell, seed: int, device) -> tuple[dict, dict]:
    """(the reference in TF32, the reference on half of each batch), each
    against the reference over the compared steps."""
    from gpubench.runners import train_step
    from gpubench.harness import frames
    from gpubench.harness.session import program_with_weights

    mix = cell.traffic
    model, weights = program_with_weights(cell, seed, device, train=True)
    params0 = {n: weights[n] for n, _ in model.named_parameters()}
    buffers = {n: weights[n] for n, _ in model.named_buffers()}
    del model
    pool = frames.make_pool(mix["frames"], seed, device)
    steps = mix["compared_steps"]
    _tf32(False)
    expected = train_step.reference_steps(cell, seed, params0, buffers, pool, device, steps)
    half = train_step.reference_steps(cell, seed, params0, buffers, pool, device, steps,
                                      rows=slice(0, mix["batch"] // 2))
    _tf32(True)
    lower = train_step.reference_steps(cell, seed, params0, buffers, pool, device, steps)
    _tf32(False)
    return train_step.gaps(lower, expected), train_step.gaps(half, expected)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", required=True)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--out")
    args = parser.parse_args(argv)

    import torch

    from gpubench.harness.registry import find_cell

    if not torch.cuda.is_available():
        print("the probe runs on a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    with open(ROOT / "BENCHMARK.json") as f:
        cell = find_cell(json.load(f), args.workload, ROOT)
    out: dict = {"workload": args.workload, "card": torch.cuda.get_device_name(0),
                 "sound": {}, "control": {}, "fault_half_batch": {}}
    for seed in map(int, args.seeds.split(",")):
        t0 = time.time()
        outcome = cell.runner.run(cell, seed, args.seconds, False, device, time.time())
        out["sound"][seed] = outcome.numbers
        print(f"sound {seed} ({time.time() - t0:.1f} s): {outcome.numbers}", file=sys.stderr)
        torch.cuda.empty_cache()
    for seed in map(int, args.control_seeds.split(",")):
        t0 = time.time()
        if cell.traffic["kind"] == "train_step":
            out["control"][seed], out["fault_half_batch"][seed] = control_train(cell, seed, device)
        else:
            out["control"][seed] = control_serve(cell, seed, device)
        print(f"control {seed} ({time.time() - t0:.1f} s): {out['control'][seed]} "
              f"{out['fault_half_batch'].get(seed, '')}", file=sys.stderr)
        torch.cuda.empty_cache()
    names = next(iter(out["sound"].values())).keys()
    out["summary"] = {n: {
        "lower": max(r[n] for r in out["sound"].values()),
        "upper_control": min(r[n] for r in out["control"].values()),
        "upper_fault": (min(r[n] for r in out["fault_half_batch"].values())
                        if out["fault_half_batch"] else None)} for n in names}
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
