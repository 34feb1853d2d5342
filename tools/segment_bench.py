#!/usr/bin/env python3
"""Time the port's any-rank segment-sum kernel (kernel 3) on checkouts, for
comparing them on one card.

Each checkout given with ``--root`` (default: the one this file is in) runs
in a process of its own, in the order given, so ``--root A --root B --root
B --root A`` times A, B, B, A on one card. A process imports that
checkout's ``pointcloudprocessing_tpu_torch`` (building its kernels) and
makes its inputs with this checkout's ``chip_smoke.py`` (its scan, frame
and path-capture helpers, loaded by path), from a fixed seed, so every
checkout gets the same inputs. Each case is held bit for bit against the
plain version run on a CPU copy, then timed: device ms of the kernel and of
``scatter_add_`` (one PyTorch call for the same function, with its zero
fill) from torch.profiler device rows over 20 calls, CUDA events a call
(with the host's launch), and the bound (each row and rank read once, each
output row written once, over 3.35 TB/s). Cases:

- the main path's ranks at 256x2000 (a voxel step at 0.4 and a stride
  sample to 1,024 over uniform and zero-padded scans) and any order at
  256x2000 (d 4 and 5): the one-block shared-memory form;
- 8x8000 and 4x40000 in any order, sorted and in one segment, and the
  ranks of the 64x8000 path (uniform scans, and frames of 6,000-8,000
  points zero-padded to 8,000);
- each form edge: n 5,120 / 5,121 / 40,960 / 40,961, any order and sorted.

It prints the clusters of 2, 4 and 8 blocks the card holds at once
(``cudaOccupancyMaxActiveClusters``, the numbers behind
``voxel_reduce.CLUSTERS_A_WAVE``). Then the 64x8000 serving path: ``PointCloudPipeline`` (PointNet 23/12 f32,
seeded; scan width 8,000, voxel 0.4, FPS to 1,024) through ``stream()`` on
64-cloud batches, uniform and padded: clouds/s over 3 windows of 6
batches, and kernel 3's launches a batch.

Needs CUDA; exits non-zero without it.

Usage: python tools/segment_bench.py [--root DIR]...
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_smoke():
    """This checkout's chip_smoke.py, under a name of its own (its input
    helpers import the port lazily, so they use the checkout on sys.path)."""
    spec = importlib.util.spec_from_file_location(
        "segment_bench_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def cases(torch, rng, smoke) -> list:
    dev = torch.device("cuda")

    def gen(b, n, d, order="any"):
        data = torch.from_numpy((rng.normal(size=(b, n, d)) * 30)
                                .astype(np.float32)).to(dev)
        rank = torch.from_numpy(rng.integers(0, n, (b, n)).astype(np.int32)).to(dev)
        if order == "sorted":
            rank = rank.sort(dim=1).values
        elif order == "one segment":
            rank = torch.full_like(rank, n - 1)
        return (f"{order}", data, rank)

    out = smoke.path_segment_cases(torch, rng, {
        "uniform": smoke.scan_batch(rng, "uniform", 256, 2000),
        "padded": smoke.scan_batch(rng, "padded", 256, 2000)})
    out += [gen(256, 2000, 4), gen(256, 2000, 5)]
    for order in ("any", "sorted", "one segment"):
        out += [gen(8, 8000, 4, order), gen(4, 40000, 4, order)]
    out += smoke.path_segment_cases(torch, rng, {
        "64x8000 uniform": smoke.scan_batch(rng, "uniform", 64, 8000),
        "64x8000 padded": smoke.frame_batch(rng, 64, 8000, 6000, 8000)})
    for b, n in ((16, 5120), (16, 5121), (4, 40960), (4, 40961)):
        out += [gen(b, n, 4), gen(b, n, 4, "sorted")]
    return out


def time_cases(torch, rng, smoke) -> None:
    from pointcloudprocessing_tpu_torch.ops.cuda import voxel_reduce as vr

    for label, data, rank in cases(torch, rng, smoke):
        b, n, d = data.shape
        got = vr.segment_reduce(data, rank)
        want = vr.segment_reduce_reference(data.cpu(), rank.cpu())
        same = smoke.check_bit_identical(torch, got.cpu(), want)
        index = rank.long()[..., None].expand(-1, -1, d)
        kernel = functools.partial(vr.segment_reduce, data, rank)

        def library():
            return torch.zeros_like(data).scatter_add_(1, index, data)

        ms = smoke.device_ms(torch, kernel, 20)
        lib_ms = smoke.device_ms(torch, library, 20)
        call = smoke.call_ms(torch, kernel, 20)
        bound = smoke.roofline(smoke.nbytes(data, rank, got), data.numel())
        form = "?"
        if hasattr(vr, "segment_sum_form"):  # (n) in earlier checkouts
            try:
                form = vr.segment_sum_form(b, n)
            except TypeError:
                form = vr.segment_sum_form(n)
        print(f"kernel 3 {b}x{n}x{d} {label} [{form}]: device ms kernel "
              f"{smoke.fmt(ms)}, scatter_add_ {smoke.fmt(lib_ms)}, bound "
              f"{bound[0]:.4f} ({bound[1]}); events a call {call:.4f}; "
              + ("bit-identical" if same else "NOT IDENTICAL"), flush=True)
        if not same:
            raise SystemExit(f"segment_bench: {b}x{n}x{d} {label} differs "
                             "from the plain version")
        del got, want, index
    torch.cuda.empty_cache()


def serve_path(torch, rng, smoke) -> None:
    from pointcloudprocessing_tpu_torch.models.pipeline import PointCloudPipeline
    from pointcloudprocessing_tpu_torch.models.pointnet import PointNet
    from pointcloudprocessing_tpu_torch.ops.cuda import build

    model = PointNet(smoke.NUM_CLASSES, smoke.NUM_PARTS,
                     generator=torch.Generator().manual_seed(0), device="cuda")
    model.eval()
    pipe = PointCloudPipeline(model, scan_width=8000, model_width=1024,
                              voxel_size=0.4, sampler="fps")
    b, window = 64, 6
    for kind in ("uniform", "padded"):
        pool = [smoke.scan_batch(rng, "uniform", b, 8000) if kind == "uniform"
                else smoke.frame_batch(rng, b, 8000, 6000, 8000)
                for _ in range(3)]

        def feed(count):
            return (pool[i % len(pool)] for i in range(count))

        list(pipe.stream(feed(2)))
        build.reset("segment_reduce", "sorted_segment_sum")
        rates = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = list(pipe.stream(feed(window)))
            torch.cuda.synchronize()
            rates.append(b * len(outs) / (time.perf_counter() - t0))
            smoke.check_outputs(torch, outs[-1], b, 1024)
        batches = 3 * window
        print(f"64x8000 {kind} -> voxel 0.4 -> fps -> 1024 -> PointNet 23/12: "
              f"clouds/s " + ", ".join(f"{r:.1f}" for r in rates)
              + f"; median {float(np.median(rates)):.1f}; kernel 3 launches a "
              f"batch {build.LAUNCHES['segment_reduce'] / batches:.2f}, kernel 1 "
              f"{build.LAUNCHES['sorted_segment_sum'] / batches:.2f}", flush=True)


def run_checkout(root: str) -> None:
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("segment_bench: needs CUDA")
    smoke = load_smoke()
    from pointcloudprocessing_tpu_torch.ops.cuda import build

    lib = build.load("voxel_reduce")
    if hasattr(lib, "pcp_segment_clusters_a_wave"):  # not in earlier checkouts
        print("clusters the card holds at once (cluster form, one 1,024-thread "
              "block an SM): " + ", ".join(
                  f"{c} blocks: {lib.pcp_segment_clusters_a_wave(c)}"
                  for c in (2, 4, 8)), flush=True)
    rng = np.random.default_rng(0)
    time_cases(torch, rng, smoke)
    serve_path(torch, rng, smoke)


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
