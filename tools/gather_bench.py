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
  ``gather_form``, also every other f32 form that fits;
- kernel 7's bf16 form (7-bf16) at the same shapes and at 8x8192 w 64 /
  128 / 256 (the kc46 DGCNN stage) and 4x16384 w 64 (the L2 form), on the
  same kind of graph, bit-identical to the plain version, each beside its
  bound (q and idx read once, both outputs written once, at 3.35 TB/s);
  with ``--plans``, where the checkout has ``gather_plan``, also its ring
  launches cut into other point ranges and ``gather_form``'s launch;
- kernel 1 on the ranks the slice builds (the voxel downsample at 0.4 and
  the stride sampler to 1,024 over its output) from 256x2048 uniform,
  zero-padded and dense scans, and on the synthetic long-run ranks (256x
  2048x4, 256x2048x5 stride, 64x8192x4), within ``chip_smoke.py``'s bar,
  beside ``index_add_`` on the uniform voxel ranks.

Needs CUDA; exits non-zero without it.

Usage: python tools/gather_bench.py [--root DIR]... [--plans] [--only bf16|f32|segment]...
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


def _graph(torch, rng, dev, b, n, k):
    from pointcloudprocessing_tpu_torch.models.dgcnn import knn_graph

    pts = torch.from_numpy(rng.normal(size=(b, n, 3)).astype(np.float32)).to(dev)
    return knn_graph(pts, k)


def _timed_identical(torch, label, fn, want, note="") -> None:
    got = fn()
    same = all(torch.equal(torch.isnan(g), torch.isnan(wt))
               and torch.equal(g[~torch.isnan(wt)], wt[~torch.isnan(wt)])
               for g, wt in zip(got, want))
    line(torch, label, fn, ("bit-identical" if same else "NOT IDENTICAL") + note)
    if not same:
        raise SystemExit(f"gather_bench: {label} differs from the plain version")


def gather_cases(torch, rng, dev) -> None:
    from pointcloudprocessing_tpu_torch.ops.cuda import gather_maxmin as gm

    n, k = 1024, 20
    graph = _graph(torch, rng, dev, 64, n, k)
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
            elif hasattr(gm, "gather_plan"):
                step = (gm.Launch("l2", 0, 0, 0, 1, 0) if form[0] == "l2" else
                        gm.Launch("shared", form[1], 0, -(-w // form[1]), 1, 0))

                def fn(plan=(step,)):
                    return gm.launch(q, idx, plan)
            else:
                def fn(form=form):
                    return gm.launch(q, idx, form)
            if form is not None:
                name = f"form {form[0]} {form[1]}" + (
                    " (gather_form's)" if form == forms[0] else "")
            _timed_identical(torch, f"kernel 7 {b}x{n}x{w} k{k}, {name}", fn, want)
        del q, want
        torch.cuda.empty_cache()


#: 7-bf16's shapes: DGCNN at 64x1024 (its four launches take w 64, 64, 128,
#: 256), 16 clouds, the kc46 DGCNN stage's 8x8192 and the L2 form's 4x16384
BF16_SHAPES = ((64, 1024, 64), (64, 1024, 128), (64, 1024, 256), (16, 1024, 64),
               (8, 8192, 64), (8, 8192, 128), (8, 8192, 256), (4, 16384, 64))


def bf16_cases(torch, rng, dev, plans: bool) -> None:
    from pointcloudprocessing_tpu_torch.ops.cuda import gather_maxmin as gm

    k = 20
    graphs = {}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for b, n, w in BF16_SHAPES:
        if n not in graphs:
            graphs = {n: _graph(torch, rng, dev, max(s[0] for s in BF16_SHAPES
                                                  if s[1] == n), n, k)}
            torch.cuda.empty_cache()
        idx = graphs[n][:b].contiguous()
        q = torch.from_numpy(rng.normal(size=(b, n, w)).astype(np.float32)).to(
            dev).to(torch.bfloat16)
        want = gm.gather_maxmin_reference(q, idx)
        bound = (q.numel() * 2 * 3 + idx.numel() * 4) / 3.35e12 * 1e3
        note = f"; bound {bound:.4f} ms (bytes)"
        if hasattr(gm, "gather_plan"):
            note += "; plan " + " + ".join(
                f"{s.form} S {s.slice}" + (f" from c {s.c_begin}, {s.tiles(b)} tiles "
                                           f"({s.parts} a slab) on {s.blocks} blocks"
                                           if s.form == "ring" else "")
                for s in gm.gather_plan(b, n, w, 2, sms))
        elif hasattr(gm, "gather_form"):
            form = gm.gather_form(b, n, w, 2)
            note += f"; form {form[0]} {form[1]}"
        _timed_identical(torch, f"7-bf16 {b}x{n}x{w} k{k}, gather_maxmin",
                         lambda: gm.gather_maxmin(q, idx), want, note)
        if plans and hasattr(gm, "gather_plan"):
            chosen = gm.gather_plan(b, n, w, 2, sms)
            others = []
            for parts in (1, 2, 4, 8, 16):
                alt = tuple(s._replace(parts=parts, blocks=min(b * s.slices * parts, sms))
                            if s.form == "ring" else s for s in chosen)
                if alt != chosen and all(s.parts <= n for s in alt) and alt not in others:
                    others.append(alt)
            form, sl = gm.gather_form(b, n, w, 2)
            others.append((gm.Launch(form, sl, 0, -(-w // sl) if sl else 0, 1, 0),))
            for alt in others:
                name = " + ".join(f"{s.form} S {s.slice} parts {s.parts}" for s in alt)
                _timed_identical(torch, f"7-bf16 {b}x{n}x{w} k{k}, plan {name}",
                                 lambda alt=alt: gm.launch(q, idx, alt), want)
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


def run_checkout(root: str, only: tuple, plans: bool) -> None:
    sys.path.insert(0, root)
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        raise SystemExit("gather_bench: needs CUDA")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    if "f32" in only:
        gather_cases(torch, rng, dev)
    if "bf16" in only:
        bf16_cases(torch, np.random.default_rng(1), dev, plans)
    if "segment" in only:
        segment_cases(torch, rng, dev, chip_smoke)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", action="append", help="a checkout (repeatable)")
    parser.add_argument("--plans", action="store_true",
                        help="also time 7-bf16's other plans (where the checkout has them)")
    parser.add_argument("--only", action="append", choices=("f32", "bf16", "segment"),
                        help="run only these groups (repeatable; default all)")
    parser.add_argument("--child", help=argparse.SUPPRESS)
    args = parser.parse_args()
    only = tuple(args.only or ("f32", "bf16", "segment"))
    if args.child:
        run_checkout(args.child, only, args.plans)
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    for root in args.root or [HERE]:
        root = os.path.abspath(root)
        print(f"== {root}", flush=True)
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--child", root]
                              + [f"--only={g}" for g in only]
                              + (["--plans"] if args.plans else []))
        if proc.returncode:
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
