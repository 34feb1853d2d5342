#!/usr/bin/env python3
"""Time the port's FPS kernel on the serving path's inputs, for comparing
checkouts on one card.

Each checkout given with ``--root`` (default: the one this file is in) runs
in a process of its own, in the order given, so ``--root A --root B --root
B --root A`` times A, B, B, A on one card. A process imports
``pointcloudprocessing_tpu_torch`` from its checkout (building that
checkout's kernels), makes the same inputs from a fixed seed, checks the
kernel's picks and coordinates against the plain version (bit for bit),
and prints the time a call of ``fps_with_points`` (CUDA events around 10
back-to-back calls, median of 5) for:

- 256x2048 -> 1024, bcn: the plane-major voxel output (0.4) of uniform,
  zero-padded and dense scans (the slice's FPS input), and uniform points
  in random order;
- PointNet++'s two calls: 256x1024 -> 512 and 256x512 -> 128, bnc,
  normal(0, 1) points;
- 4x65,536 -> 1024, bcn, uniform points in random order.

Needs CUDA; exits non-zero without it.

Usage: python tools/fps_bench.py [--root DIR]...
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def scans(rng, kind: str, b: int = 256, n: int = 2048) -> np.ndarray:
    """chip_smoke.py's scan batches: uniform(-20, 20), the same with the
    last three quarters zero, or LiDAR-like (range log-uniform in [1, 40] m,
    elevation within 15 degrees of the horizon)."""
    if kind == "dense":
        r = np.exp(rng.uniform(0.0, np.log(40.0), (b, n)))
        az = rng.uniform(-np.pi, np.pi, (b, n))
        el = rng.uniform(-np.pi / 12, np.pi / 12, (b, n))
        return np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                         r * np.sin(el)], axis=-1).astype(np.float32)
    out = rng.uniform(-20, 20, (b, n, 3)).astype(np.float32)
    if kind == "padded":
        out[b // 4:] = 0.0
    return out


def run_checkout(root: str) -> None:
    sys.path.insert(0, root)
    import torch

    from pointcloudprocessing_tpu_torch.ops.cuda.fps import (
        fps_with_points,
        fps_with_points_reference,
    )
    from pointcloudprocessing_tpu_torch.ops.fps import _seed_indices
    from pointcloudprocessing_tpu_torch.ops.voxel import voxel_downsample_batch

    if not torch.cuda.is_available():
        raise SystemExit("fps_bench: needs CUDA")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    cases = []
    for kind in ("uniform", "padded", "dense"):
        x = torch.from_numpy(scans(rng, kind)).to(dev)
        vox, mask = voxel_downsample_batch(x, 0.4, layout="bcn")
        cases.append((f"256x2048->1024 bcn {kind} voxel output", vox, mask, 1024, "bcn"))
    pts = torch.from_numpy(rng.uniform(-20, 20, (256, 3, 2048)).astype(np.float32))
    cases.append(("256x2048->1024 bcn random order", pts.to(dev), None, 1024, "bcn"))
    for b, n, k in ((256, 1024, 512), (256, 512, 128)):
        pts = torch.from_numpy(rng.normal(size=(b, n, 3)).astype(np.float32))
        cases.append((f"{b}x{n}->{k} bnc PointNet++", pts.to(dev), None, k, "bnc"))
    pts = torch.from_numpy(rng.uniform(-20, 20, (4, 3, 65536)).astype(np.float32))
    cases.append(("4x65536->1024 bcn random order", pts.to(dev), None, 1024, "bcn"))

    for label, pts, mask, k, layout in cases:
        b = pts.shape[0]
        n = pts.shape[2] if layout == "bcn" else pts.shape[1]
        if mask is None:
            mask = torch.ones((b, n), dtype=torch.bool, device=dev)
        start = _seed_indices(mask, 0)
        idx, sampled = fps_with_points(pts, k, mask, start, layout=layout)
        ridx, rsampled = fps_with_points_reference(pts, k, mask, start, layout)
        exact = torch.equal(idx, ridx) and torch.equal(
            sampled.view(torch.int32), rsampled.view(torch.int32))
        reps = 10 if n <= 8192 else 2
        times = []
        for _ in range(5):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(reps):
                fps_with_points(pts, k, mask, start, layout=layout)
            t1.record()
            t1.synchronize()
            times.append(t0.elapsed_time(t1) / reps)
        ms = float(np.median(times))
        print(f"{label}: {ms:.4f} ms a call ({ms / (k - 1) * 1e3:.3f} us a "
              f"selection step), {'exact' if exact else 'NOT EXACT'}", flush=True)
        if not exact:
            raise SystemExit(f"fps_bench: {label} differs from the plain version")


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
