#!/usr/bin/env python3
"""Time the port's neighbour max/min kernel (kernel 7) and its monotone
segment-sum kernel (kernel 1) on their paths' inputs, for comparing checkouts
on one card.

Each checkout given with ``--root`` (default: the one this file is in) runs
in a process of its own, in the order given, so ``--root A --root B --root
B --root A`` times A, B, B, A on one card. A process imports
``pointcloudprocessing_tpu_torch`` (building that checkout's kernels) and
that checkout's ``chip_smoke.py`` (for its scan and rank makers), makes the
same inputs from a fixed seed, checks each kernel against its plain version,
and prints the time a call: CUDA events around 20 back-to-back calls, median
of 5 (which includes the host's launch overhead where the host is slower
than the card), and the device time from a torch.profiler trace of 20
calls:

- kernel 7 at 64x1024, k 20, w 64 / 128 / 256 (DGCNN's edge widths), and
  16x1024 at w 64, on the ``knn_graph`` of normal(0, 1) clouds,
  bit-identical to the plain version; where the checkout has
  ``gather_form``, also every other form that fits;
- kernel 1 on the ranks the slice builds (the voxel downsample at 0.4 and
  the stride sampler to 1,024 over its output) from 256x2048 uniform,
  zero-padded and dense scans, and on the synthetic long-run ranks (256x
  2048x4, 256x2048x5 stride, 64x8192x4), within ``chip_smoke.py``'s bar,
  beside ``index_add_`` on the uniform voxel ranks.

Needs CUDA; exits non-zero without it.

Usage: python tools/gather_bench.py [--root DIR]...
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def event_ms(torch, fn, calls: int = 20, repeats: int = 5) -> tuple[float, list]:
    """Median ms a call of ``fn`` over ``repeats`` runs of ``calls``
    back-to-back calls, timed by CUDA events, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(calls):
            fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1) / calls)
    return float(np.median(times)), times


def device_ms(torch, fn, calls: int = 20) -> float | None:
    """Device ms a call of ``fn``: the summed durations of the device rows
    (kernels, copies, memsets) of a torch.profiler trace over ``calls``
    calls, after a warm-up; None if the trace has no device rows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not rows:
        return None
    return sum(e.time_range.elapsed_us() for e in rows) / calls / 1e3


def line(torch, label: str, fn, check: str) -> None:
    """Time ``fn`` by events and by device rows, and print one line."""
    ms, times = event_ms(torch, fn)
    dev = device_ms(torch, fn)
    print(f"{label}: {ms:.4f} ms a call by events (spread {min(times):.4f}-"
          f"{max(times):.4f}), device "
          + ("not traced" if dev is None else f"{dev:.4f}") + f" ms; {check}",
          flush=True)


def gather_cases(torch, rng, dev) -> None:
    from pointcloudprocessing_tpu_torch.models.dgcnn import knn_graph
    from pointcloudprocessing_tpu_torch.ops.cuda import gather_maxmin as gm

    n, k = 1024, 20
    pts = torch.from_numpy(rng.normal(size=(64, n, 3)).astype(np.float32)).to(dev)
    graph = knn_graph(pts, k)
    for b, w in ((64, 64), (64, 128), (64, 256), (16, 64)):
        idx = graph[:b]
        q = torch.from_numpy(rng.normal(size=(b, n, w)).astype(np.float32)).to(dev)
        want = gm.gather_maxmin_reference(q, idx)
        forms = [None]
        if hasattr(gm, "gather_form"):
            chosen = gm.gather_form(b, n, w)
            forms = [chosen] + [("shared", s) for s in gm.SLICES
                                if ("shared", s) != chosen
                                and n * s * 4 <= gm.SHARED_BYTES] + [("l2", 0)]
        for form in forms:
            if form is None:
                def fn():
                    return gm.gather_maxmin(q, idx)
                name = "gather_maxmin"
            else:
                def fn(form=form):
                    return gm.launch(q, idx, form)
                name = f"form {form[0]} {form[1]}" + (
                    " (gather_form's)" if form == forms[0] else "")
            got = fn()
            same = all(torch.equal(g, wt) for g, wt in zip(got, want))
            line(torch, f"kernel 7 {b}x{n}x{w} k{k}, {name}", fn,
                 "bit-identical" if same else "NOT IDENTICAL")
            if not same:
                raise SystemExit(f"gather_bench: kernel 7 w {w} {name} differs "
                                 "from the plain version")
        del q, want
        torch.cuda.empty_cache()


def segment_cases(torch, rng, dev, smoke) -> None:
    from pointcloudprocessing_tpu_torch.ops import fps as fps_mod
    from pointcloudprocessing_tpu_torch.ops.cuda.voxel_reduce import (
        sorted_segment_reduce,
        sorted_segment_reduce_reference,
    )
    from pointcloudprocessing_tpu_torch.ops.fps import stride_sample_and_gather
    from pointcloudprocessing_tpu_torch.ops.voxel import voxel_downsample_batch

    cases = []
    for kind in ("uniform", "padded", "dense"):
        captured = []

        def record(data, rank):
            captured.append((data.clone(), rank.clone()))
            return sorted_segment_reduce_reference(data, rank)

        with smoke.route_kernels(record, fps_mod.fps_with_points):
            x = torch.from_numpy(smoke.scan_batch(rng, kind)).to(dev)
            vox, vmask = voxel_downsample_batch(x, 0.4)
            stride_sample_and_gather(vox, 1024, vmask)
        cases += [(f"main-path {kind} voxel", *captured[0]),
                  (f"main-path {kind} stride", *captured[1])]
    for b, n, d, kind in ((256, 2048, 4, "voxel"), (256, 2048, 5, "stride"),
                          (64, 8192, 4, "voxel")):
        data, rank = smoke.segment_case(rng, b, n, d, kind)
        cases.append((f"{kind} long-run", torch.from_numpy(data).to(dev),
                      torch.from_numpy(rank).to(dev)))
    for label, data, rank in cases:
        b, n, d = data.shape
        got = sorted_segment_reduce(data, rank)
        want = sorted_segment_reduce_reference(data, rank)
        ok = bool(((got - want).abs()
                   <= 1e-5 * data.abs().max() + 1e-6 * want.abs()).all())
        line(torch, f"kernel 1 {b}x{n}x{d} {label}",
             lambda: sorted_segment_reduce(data, rank),
             "within the bar" if ok else "BEYOND THE BAR")
        if not ok:
            raise SystemExit(f"gather_bench: kernel 1 {label} disagrees")
        if label == "main-path uniform voxel":
            flat = (rank.long() + n * torch.arange(b, device=dev)[:, None]).reshape(-1)
            rows = data.reshape(-1, d)
            line(torch, f"index_add_ {b}x{n}x{d} {label}",
                 lambda: torch.zeros_like(rows).index_add_(0, flat, rows),
                 "the library call (with its zero fill)")


def run_checkout(root: str) -> None:
    sys.path.insert(0, root)
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        raise SystemExit("gather_bench: needs CUDA")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    gather_cases(torch, rng, dev)
    segment_cases(torch, rng, dev, chip_smoke)


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
