#!/usr/bin/env python3
"""Time the port's windowed moment-sum kernel on the normals path's inputs,
for comparing checkouts on one card.

Each checkout given with ``--root`` (default: the one this file is in) runs
in a process of its own, in the order given, so ``--root A --root B --root
B --root A`` times A, B, B, A on one card. A process imports
``pointcloudprocessing_tpu_torch`` from its checkout (building that
checkout's kernels), makes the same inputs from a fixed seed, checks the
kernel's counts against the plain version (identical), and prints the time
a call of ``windowed_moment_sums`` (CUDA events around 20 back-to-back
calls, median of 5) for the Morton-ordered voxel output of:

- config 2: 8x8192 uniform(-30, 30) scans, voxel 0.5, k 16, Q 256, W 256;
- config 5: 256x2048 uniform(-20, 20) scans, voxel 0.4, k 16, Q 256, W 128.

Needs CUDA; exits non-zero without it.

Usage: python tools/window_bench.py [--root DIR]...
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_checkout(root: str) -> None:
    sys.path.insert(0, root)
    import torch

    from pointcloudprocessing_tpu_torch.ops.cuda.window_normals import (
        windowed_moment_sums,
        windowed_moment_sums_reference,
    )
    from pointcloudprocessing_tpu_torch.ops.normals import window_arguments
    from pointcloudprocessing_tpu_torch.ops.voxel import voxel_downsample_batch

    if not torch.cuda.is_available():
        raise SystemExit("window_bench: needs CUDA")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    k = 16
    cases = []
    for label, b, n, scale, voxel, window in (
            ("config 2: 8x8192, voxel 0.5, W 256", 8, 8192, 30.0, 0.5, 256),
            ("config 5: 256x2048, voxel 0.4, W 128", 256, 2048, 20.0, 0.4, 128)):
        scans = rng.uniform(-scale, scale, (b, n, 3)).astype(np.float32)
        vox, mask = voxel_downsample_batch(torch.from_numpy(scans).to(dev), voxel,
                                           layout="bcn")
        cases.append((label, window_arguments(vox, mask, window)[1:]))

    for label, (centered, mask, window, q_block) in cases:
        args = (centered, mask, k, window, q_block, "bcn")
        got = windowed_moment_sums(*args)[0]
        want = windowed_moment_sums_reference(*args)[0]
        mismatched = int((got != want).sum())
        times = []
        for _ in range(5):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(20):
                windowed_moment_sums(*args)
            t1.record()
            t1.synchronize()
            times.append(t0.elapsed_time(t1) / 20)
        ms = float(np.median(times))
        print(f"{label}, k {k}, Q {q_block}: {ms:.4f} ms a call (spread "
              f"{min(times):.4f}-{max(times):.4f}), counts "
              f"{'identical' if not mismatched else f'{mismatched} DIFFER'}",
              flush=True)
        if mismatched:
            raise SystemExit(f"window_bench: {label} differs from the plain version")
        del got, want
        torch.cuda.empty_cache()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", action="append", help="a checkout (repeatable)")
    parser.add_argument("--child", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child:
        run_checkout(args.child)
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    for root in args.root or [HERE]:
        root = os.path.abspath(root)
        print(f"== {root}", flush=True)
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--child", root])
        if proc.returncode:
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
