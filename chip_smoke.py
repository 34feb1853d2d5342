#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``pointcloudprocessing_tpu_torch``) on one
NVIDIA GPU: the serving slice voxel -> FPS / stride -> multi-head PointNet.

Phases, one line each (any failure exits non-zero, and no result is printed):

1. device: requires CUDA; prints the card's name and power limit as
   ``nvidia-smi`` reports them; TF32 off for matmul and cuDNN.
2. build: builds both CUDA kernels from ``pointcloudprocessing_tpu_torch/csrc``.
3. kernels: each kernel against its plain PyTorch version on the card, at
   the serving path's shapes (the segment sum on the ranks the slice builds
   from uniform, zero-padded and LiDAR-like dense scans, and on synthetic
   long runs), with its device time (torch.profiler) and its time per call
   beside the plain version's.
4. slice: a full-width PointNet (23 classes, 12 parts, random seeded init)
   serves streamed 256x2048 scans through voxel 0.4 -> FPS -> 1024 points
   (clouds/s over three timed windows after a stream warm-up), then a
   zero-padded batch, a stride-sampler batch and a 64x8192 batch; both
   kernels' launch counters must rise, and batches must agree with the
   plain versions. Also the device's busy share over a stream and each
   stage's device time.
5. serve: the serving CLI over a collect of written frames, its last batch
   zero-padded.

The second-to-last line is a JSON object with each kernel's launches,
error and times; the last line is ``{"ok": true, "device": {...}}``.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
NUM_CLASSES, NUM_PARTS = 23, 12
SEG_SUM_SRC = "pointcloudprocessing_tpu_torch/csrc/voxel_reduce.cu"
FPS_SRC = "pointcloudprocessing_tpu_torch/csrc/fps.cu"
SEG_SUM_TPU = "pointcloudprocessing_tpu/ops/pallas/voxel_reduce.py:138"
FPS_TPU = "pointcloudprocessing_tpu/ops/pallas/fps.py:110"


def log(msg: str) -> None:
    print(msg, flush=True)


def call_ms(torch, fn, reps: int, repeats: int = 5) -> float:
    """Time per call of ``fn``: CUDA events around ``reps`` back-to-back
    calls, median of ``repeats``, after one warm-up call. This includes the
    host's launch overhead whenever the host is slower than the device."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def device_trace(torch, fn) -> tuple[list, float]:
    """Run ``fn`` once under ``torch.profiler`` with CUDA activity only.
    Returns the device events it recorded (kernels, copies, memsets: the
    rows whose device type is CUDA, so no host op that launched them is
    counted a second time) and the host wall time of the call in us."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        raise RuntimeError("torch.profiler recorded no device activity")
    return events, wall_us


def device_ms(torch, fn, reps: int) -> float:
    """Device time per call of ``fn``: the summed durations of the kernels,
    copies and memsets it runs, over ``reps`` calls after one warm-up."""
    fn()

    def calls():
        for _ in range(reps):
            fn()

    events, _ = device_trace(torch, calls)
    return sum(e.time_range.elapsed_us() for e in events) / reps / 1e3


def busy_share(torch, fn) -> tuple[float, float]:
    """(busy share, wall ms) of one call of ``fn``: the time in which at
    least one device activity ran (the union of their intervals, so work
    overlapped on two streams counts once) over the host wall time."""
    events, wall_us = device_trace(torch, fn)
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy += hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    busy += hi - lo
    return busy / wall_us, wall_us / 1e3


def kernel_breakdown(torch, fn) -> dict:
    """Device ms of one call of ``fn`` by kind of kernel (kernel names as
    CUPTI reports them)."""
    events, _ = device_trace(torch, fn)
    kinds = {"gemm": 0.0, "elementwise": 0.0, "reduce": 0.0, "other": 0.0}
    for e in events:
        name = e.name.lower()
        kind = ("gemm" if "gemm" in name else
                "elementwise" if "elementwise" in name else
                "reduce" if "reduce" in name else "other")
        kinds[kind] += e.time_range.elapsed_us() / 1e3
    return kinds


# ---------------------------------------------------------------- phase 3 data

def segment_case(rng, b: int, n: int, d: int, kind: str):
    """Monotone ranks as the callers build them, with their data rows.

    'voxel': runs of 1-5 rows per occupied voxel (d = 4: xyz*w, w), the
    invalid rows (a long run on every fourth cloud) parked in bucket n - 1
    with zero weight. 'stride': valid row j in bucket floor(j*k/nv), k=1024,
    with nv < k on some clouds (d = 5: xyz*w, j*w, w)."""
    data = np.zeros((b, n, d), np.float32)
    rank = np.full((b, n), n - 1, np.int32)
    for c in range(b):
        n_invalid = n // 2 if c % 4 == 0 else int(rng.integers(0, n // 8))
        nv = n - n_invalid
        xyz = rng.uniform(-20, 20, (nv, 3)).astype(np.float32)
        if kind == "voxel":
            is_new = rng.uniform(size=nv) < 0.6
            is_new[0] = True
            rank[c, :nv] = np.cumsum(is_new) - 1
            data[c, :nv, :3] = xyz
            data[c, :nv, 3] = 1.0
        else:
            k = 1024
            nv = min(nv, int(rng.integers(k // 2, n + 1)))
            bucket = np.minimum(np.arange(nv) * k // nv, k - 1)
            first = np.concatenate([[True], bucket[1:] != bucket[:-1]])
            rank[c, :nv] = bucket
            w = first.astype(np.float32)
            data[c, :nv, :3] = xyz[:nv] * w[:, None]
            data[c, :nv, 3] = np.arange(nv) * w
            data[c, :nv, 4] = w
    return data, rank


def scan_batch(rng, kind: str, b: int = 256, n: int = 2048) -> np.ndarray:
    """A (b, n, 3) batch of scans as the serving path meets them.

    'uniform': uniform(-20, 20), the JAX package's bench traffic; at voxel
    0.4 nearly every point is its own voxel. 'padded': the same with the
    last three quarters of the clouds all-zero, as serve.py pads a short
    last batch (each zero scan is one voxel: one run of n rows). 'dense':
    LiDAR-like, range log-uniform in [1, 40] m, elevation within 15 degrees
    of the horizon, so the voxels near the sensor hold many points."""
    if kind == "dense":
        r = np.exp(rng.uniform(0.0, np.log(40.0), (b, n)))
        az = rng.uniform(-np.pi, np.pi, (b, n))
        el = rng.uniform(-np.pi / 12, np.pi / 12, (b, n))
        return np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                         r * np.sin(el)], axis=-1).astype(np.float32)
    scans = rng.uniform(-20, 20, (b, n, 3)).astype(np.float32)
    if kind == "padded":
        scans[b // 4:] = 0.0
    return scans


def fps_case(rng, b: int, n: int, k: int):
    """Clouds as the voxel output leaves them (valid rows packed first, some
    with fewer than k), one fully invalid, one with scattered holes."""
    pts = rng.uniform(-20, 20, (b, n, 3)).astype(np.float32)
    nv = rng.integers(k // 2, n + 1, b)
    mask = np.arange(n)[None, :] < nv[:, None]
    mask[1] = False
    mask[2] = rng.uniform(size=n) > 0.5
    return pts, mask


# -------------------------------------------------------------------- phases

def phase_device(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    log(card)  # name, power limit: every time below is taken at this limit
    log(f"[1 device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}"
        f" cuda {torch.version.cuda}; TF32 off for matmul and cuDNN")
    return card


def phase_build() -> None:
    from pointcloudprocessing_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    build.build_all()
    seconds = time.perf_counter() - t0
    usage = []
    for name in build.KERNELS:
        log_path = build.BUILD_DIR / f"{name}.log"
        if log_path.exists():
            usage += [line.strip() for line in log_path.read_text().splitlines()
                      if "Used" in line or "spill" in line]
    log(f"[2 build] {', '.join(build.KERNELS)} built and loaded in "
        f"{seconds:.2f} s")
    for line in usage:
        log(f"    ptxas: {line}")


def phase_kernels(torch, rng) -> dict:
    from pointcloudprocessing_tpu_torch.ops.cuda.fps import (
        fps_with_points,
        fps_with_points_reference,
    )
    from pointcloudprocessing_tpu_torch.ops.cuda.voxel_reduce import (
        sorted_segment_reduce,
        sorted_segment_reduce_reference,
    )
    from pointcloudprocessing_tpu_torch.ops.fps import (
        _seed_indices,
        stride_sample_and_gather,
    )
    from pointcloudprocessing_tpu_torch.ops.voxel import voxel_downsample_batch

    dev = torch.device("cuda")
    results = {"seg_err": 0.0, "fps_err": 0.0}
    # the segment sum's inputs exactly as the slice builds them: a voxel
    # downsample of 256x2048 scans at 0.4 (d = 4) and the stride sampler over
    # its output (d = 5), for each kind of scan batch
    cases = []
    for kind in ("uniform", "padded", "dense"):
        captured = []

        def record(data, rank):
            captured.append((data.clone(), rank.clone()))
            return sorted_segment_reduce_reference(data, rank)

        with route_kernels(record, fps_with_points_reference):
            x = torch.from_numpy(scan_batch(rng, kind)).to(dev)
            vox, vmask = voxel_downsample_batch(x, 0.4)
            stride_sample_and_gather(vox, 1024, vmask)
        cases += [(f"main-path {kind} voxel", *captured[0]),
                  (f"main-path {kind} stride", *captured[1])]
    # synthetic ranks with long runs (invalid rows parked in bucket n - 1)
    for b, n, d, kind in ((256, 2048, 4, "voxel"), (256, 2048, 5, "stride"),
                          (64, 8192, 4, "voxel")):
        data_np, rank_np = segment_case(rng, b, n, d, kind)
        cases.append((f"{kind} long-run", torch.from_numpy(data_np).to(dev),
                      torch.from_numpy(rank_np).to(dev)))
    for label, data, rank in cases:
        b, n, d = data.shape
        got = sorted_segment_reduce(data, rank)
        want = sorted_segment_reduce_reference(data, rank)
        torch.cuda.synchronize()
        err = (got - want).abs()
        bound = 1e-5 * data.abs().max() + 1e-6 * want.abs()
        if not bool((err <= bound).all()):
            raise AssertionError(
                f"segment sum {b}x{n}x{d} ({label}) disagrees with its plain "
                f"version: max abs err {err.max().item():.3e}")
        max_err = err.max().item()
        results["seg_err"] = max(results["seg_err"], max_err)
        kernel = functools.partial(sorted_segment_reduce, data, rank)
        plain = functools.partial(sorted_segment_reduce_reference, data, rank)
        ms, plain_ms = device_ms(torch, kernel, 20), device_ms(torch, plain, 20)
        per_call = (call_ms(torch, kernel, 20), call_ms(torch, plain, 20))
        longest = max(int(np.bincount(r).max()) for r in rank.cpu().numpy())
        log(f"[3 kernels] segment sum {b}x{n}x{d} {label} (longest run "
            f"{longest}): max abs err {max_err:.3e}; device ms kernel "
            f"{ms:.4f}, plain {plain_ms:.4f}; per call with launch "
            f"kernel {per_call[0]:.4f}, plain {per_call[1]:.4f}")
        if label == "main-path uniform voxel":
            results["seg_ms"], results["seg_plain_ms"] = ms, plain_ms

    for b, n, k, layout in ((256, 2048, 1024, "bcn"), (256, 2048, 1024, "bnc"),
                            (64, 8192, 1024, "bcn")):
        pts_np, mask_np = fps_case(rng, b, n, k)
        if layout == "bcn":
            pts_np = np.ascontiguousarray(pts_np.transpose(0, 2, 1))
        pts = torch.from_numpy(pts_np).to(dev)
        mask = torch.from_numpy(mask_np).to(dev)
        start = _seed_indices(mask, 0)
        idx, sampled = fps_with_points(pts, k, mask, start, layout=layout)
        ridx, rsampled = fps_with_points_reference(pts, k, mask, start, layout)
        torch.cuda.synchronize()
        if not torch.equal(idx, ridx):
            bad = (idx != ridx).nonzero()[0].tolist()
            raise AssertionError(
                f"FPS {b}x{n}->{k} {layout}: indices differ from the plain "
                f"version first at (cloud, step) {bad}")
        if not torch.equal(sampled, rsampled):
            raise AssertionError(
                f"FPS {b}x{n}->{k} {layout}: coordinates not bit-identical")
        results["fps_err"] = max(
            results["fps_err"], (sampled - rsampled).abs().max().item())
        kernel = functools.partial(
            fps_with_points, pts, k, mask, start, layout=layout)
        plain = functools.partial(
            fps_with_points_reference, pts, k, mask, start, layout)
        ms, plain_ms = device_ms(torch, kernel, 10), device_ms(torch, plain, 2)
        per_call = (call_ms(torch, kernel, 10), call_ms(torch, plain, 1, 3))
        log(f"[3 kernels] FPS {b}x{n}->{k} {layout}: indices identical, "
            f"coordinates bit-identical; device ms kernel {ms:.4f}, plain "
            f"{plain_ms:.4f}; per call with launch kernel {per_call[0]:.4f}, "
            f"plain {per_call[1]:.4f}")
        if (b, n, layout) == (256, 2048, "bcn"):
            results["fps_ms"], results["fps_plain_ms"] = ms, plain_ms
    return results


@contextlib.contextmanager
def route_kernels(segment_sum, fps_with_points):
    """Point the slice's kernel wrappers at other functions (the plain
    versions, or a recorder) while the block runs; for comparisons on the
    card only. The ops modules look the wrappers up at call time."""
    from pointcloudprocessing_tpu_torch.ops import fps as fps_mod
    from pointcloudprocessing_tpu_torch.ops import voxel as voxel_mod

    saved = (voxel_mod.sorted_segment_reduce, fps_mod.sorted_segment_reduce,
             fps_mod.fps_with_points)
    voxel_mod.sorted_segment_reduce = segment_sum
    fps_mod.sorted_segment_reduce = segment_sum
    fps_mod.fps_with_points = fps_with_points
    try:
        yield
    finally:
        (voxel_mod.sorted_segment_reduce, fps_mod.sorted_segment_reduce,
         fps_mod.fps_with_points) = saved


def check_outputs(torch, out: dict, b: int, k: int) -> None:
    cls = out["classification_output"]
    seg = out["segmentation_output"]
    se3 = out["se3"]
    if cls.shape != (b, NUM_CLASSES) or seg.shape != (b, k, NUM_PARTS) \
            or se3.shape != (b, 3, 3):
        raise AssertionError(
            f"output shapes {tuple(cls.shape)}, {tuple(seg.shape)}, "
            f"{tuple(se3.shape)}")
    for name, t in out.items():
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name} has non-finite values")
    for name, t in (("classification", cls), ("segmentation", seg)):
        dev = (t.sum(-1) - 1.0).abs().max().item()
        if dev > 1e-5:
            raise AssertionError(f"{name} rows sum to 1 only within {dev:.2e}")


def max_diff(a: dict, b: dict) -> float:
    return max((a[k] - b[k]).abs().max().item() for k in a)


def phase_slice(torch, rng, model) -> dict:
    from pointcloudprocessing_tpu_torch.models.pipeline import PointCloudPipeline
    from pointcloudprocessing_tpu_torch.ops.cuda.fps import (
        fps_with_points,
        fps_with_points_reference,
    )
    from pointcloudprocessing_tpu_torch.ops.cuda.voxel_reduce import (
        sorted_segment_reduce,
        sorted_segment_reduce_reference,
    )
    from pointcloudprocessing_tpu_torch.ops.fps import (
        farthest_point_sample_and_gather,
    )
    from pointcloudprocessing_tpu_torch.ops.voxel import voxel_downsample_batch

    b, scan, k = 256, 2048, 1024
    window, windows = 48, 3  # batches per timed window; windows per run
    pool = [scan_batch(rng, "uniform") for _ in range(8)]
    padded_batch = scan_batch(rng, "padded")
    stride_batch = scan_batch(rng, "uniform")
    wide_batch = scan_batch(rng, "uniform", 64, 8192)
    fps_pipe = PointCloudPipeline(model, scan_width=scan, model_width=k,
                                  voxel_size=0.4, sampler="fps")
    stride_pipe = PointCloudPipeline(model, scan_width=scan, model_width=k,
                                     voxel_size=0.4, sampler="stride")
    wide_pipe = PointCloudPipeline(model, scan_width=8192, model_width=k,
                                   voxel_size=0.4, sampler="fps")

    def feed(count: int):
        return (pool[i % len(pool)] for i in range(count))

    sorted_segment_reduce.launches = 0
    fps_with_points.launches = 0
    # ---- the main path: counted launches start here
    first = fps_pipe(pool[0])  # warm-up (cuBLAS handles, allocator)
    # warm-up of stream() itself: its first side stream builds CUDA's
    # stream pool, and its first pinned buffers are allocated here
    warm = list(fps_pipe.stream(feed(2)))
    rates, lasts = [], []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        count, last = 0, None
        for last in fps_pipe.stream(feed(window)):
            count += 1
        torch.cuda.synchronize()
        rates.append(b * count / (time.perf_counter() - t0))
        lasts.append(last)
        if count != window:
            raise AssertionError(f"stream yielded {count} of {window} batches")
    padded_out = fps_pipe(padded_batch)
    stride_out = stride_pipe(stride_batch)
    wide_out = wide_pipe(wide_batch)
    torch.cuda.synchronize()
    launches = {"seg": sorted_segment_reduce.launches,
                "fps": fps_with_points.launches}
    # ---- the main path ends here
    if launches["seg"] == 0 or launches["fps"] == 0:
        raise AssertionError(f"a kernel was not launched by the slice: {launches}")
    for out in [first, *warm, *lasts, padded_out, stride_out]:
        check_outputs(torch, out, b, k)
    check_outputs(torch, wide_out, 64, k)
    rate = float(np.median(rates))
    log(f"[4 slice] PointNet 23/12 f32, voxel 0.4 -> fps, {b}x{scan}->{k}: "
        f"streamed clouds/s over {windows} windows of {window} batches "
        f"(after a 2-batch stream warm-up): "
        + ", ".join(f"{r:.1f}" for r in rates)
        + f"; median {rate:.1f}; padded, stride and 64x8192->{k} batches ok; "
        f"launches {launches}")

    share, wall = busy_share(torch, lambda: list(fps_pipe.stream(feed(16))))
    log(f"[4 slice] device busy share over a profiled 16-batch stream: "
        f"{share:.4f} of {wall:.1f} ms wall (union of device activity "
        f"intervals / host wall time)")

    # per-stage time of one fps batch
    x = torch.from_numpy(pool[0]).cuda()
    vox, vmask = voxel_downsample_batch(x, 0.4, layout="bcn")
    _, sampled = farthest_point_sample_and_gather(vox, k, vmask, layout="bcn")
    stages = {
        "voxel": lambda: voxel_downsample_batch(x, 0.4, layout="bcn"),
        "fps": lambda: farthest_point_sample_and_gather(
            vox, k, vmask, layout="bcn"),
        "pointnet": lambda: model(sampled),
        "pipeline": lambda: fps_pipe._run(x),
    }
    with torch.inference_mode():
        stage_ms = {name: (device_ms(torch, fn, 5), call_ms(torch, fn, 5))
                    for name, fn in stages.items()}
        kinds = kernel_breakdown(torch, stages["pointnet"])
    log(f"[4 slice] ms per {b}x{scan}->{k} batch, device time / per call with "
        "launch (CUDA events): " + ", ".join(
            f"{name} {dev:.4f} / {call:.4f}"
            for name, (dev, call) in stage_ms.items()))
    log("[4 slice] PointNet forward device ms by kernel kind: " + ", ".join(
        f"{kind} {ms:.4f}" for kind, ms in kinds.items()))

    with route_kernels(sorted_segment_reduce_reference,
                       fps_with_points_reference):
        plain_first = fps_pipe(pool[0])
        plain_padded = fps_pipe(padded_batch)
        plain_stride = stride_pipe(stride_batch)
    diffs = (max_diff(first, plain_first), max_diff(padded_out, plain_padded),
             max_diff(stride_out, plain_stride))
    if max(diffs) > 1e-4:
        raise AssertionError(
            f"slice through the kernels differs from the plain versions by "
            f"{max(diffs):.3e} (fps, padded fps, stride: {diffs})")
    log(f"[4 slice] kernels vs plain versions on the card: max abs diff "
        f"fps {diffs[0]:.3e}, padded fps {diffs[1]:.3e}, stride "
        f"{diffs[2]:.3e} (bar 1e-4)")
    return {"launches": launches, "clouds_per_s": rate, "stage_ms": stage_ms}


def phase_serve(torch, rng, model) -> None:
    from pointcloudprocessing_tpu_torch import serve
    from pointcloudprocessing_tpu_torch.data.frames import write_aftr_frame

    classes = [f"class_{i}" for i in range(NUM_CLASSES)]
    parts = [f"part_{i}" for i in range(NUM_PARTS)]
    num_frames = 8
    with tempfile.TemporaryDirectory() as tmp:
        lidar = os.path.join(tmp, "collect", "Lidar")
        os.makedirs(lidar)
        for i in range(num_frames):
            n = int(rng.integers(1900, 2200))
            pts = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
            labels = np.stack([np.full(n, classes[i % NUM_CLASSES]),
                               rng.choice(parts, n)], axis=1)
            write_aftr_frame(os.path.join(lidar, f"frame_{i}.txt"), pts, labels)
        stage = os.path.join(tmp, "stage")
        os.makedirs(os.path.join(stage, "torch"))
        config = {
            "info": {"name": "smoke",
                     "class_labels": {str(i): c for i, c in enumerate(classes)},
                     "part_labels": {str(i): p for i, p in enumerate(parts)}},
            "params": {"input_width": 2048, "epochs": 1, "patience": 1,
                       "batch_size": 4},
        }
        with open(os.path.join(stage, "smoke_config.json"), "w") as f:
            json.dump(config, f)
        torch.save(model.state_dict(), os.path.join(stage, serve.WEIGHTS))
        out_path = os.path.join(tmp, "pred.jsonl")
        rc = serve.main([
            "--model", stage, "--input", os.path.join(tmp, "collect"),
            "--output", out_path, "--batch", "3", "--device", "cuda",
            "--voxel-size", "0.4", "--scan-width", "2048",
            "--model-width", "1024",
        ])
        with open(out_path) as f:
            records = [json.loads(line) for line in f]
    if rc != 0 or len(records) != num_frames:
        raise AssertionError(f"serve rc {rc}, {len(records)} of {num_frames} records")
    for r in records:
        if r["class"] not in classes or sum(r["part_counts"].values()) != 1024 \
                or np.asarray(r["se3"]).shape != (3, 3):
            raise AssertionError(f"bad record {r['frame']}")
    log(f"[5 serve] {len(records)} frames served through serve.main "
        f"(voxel 0.4, 2048 -> 1024, batch 3: the last batch zero-padded, cuda)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check runs only on a GPU",
              file=sys.stderr)
        return 1
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    try:
        import pointcloudprocessing_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}",
              file=sys.stderr)
        return 1
    from pointcloudprocessing_tpu_torch.models.pointnet import PointNet

    phase_device(torch)
    phase_build()
    rng = np.random.default_rng(0)
    kernels = phase_kernels(torch, rng)
    model = PointNet(NUM_CLASSES, NUM_PARTS,
                     generator=torch.Generator().manual_seed(0), device="cuda")
    model.eval()
    sliced = phase_slice(torch, rng, model)
    phase_serve(torch, rng, model)

    log(json.dumps({"kernels": [
        {"name": "sorted_segment_sum", "route": "cuda", "source": SEG_SUM_SRC,
         "replaces": SEG_SUM_TPU, "launches": sliced["launches"]["seg"],
         "max_abs_err": kernels["seg_err"], "ms": kernels["seg_ms"],
         "plain_ms": kernels["seg_plain_ms"]},
        {"name": "fps_with_points", "route": "cuda", "source": FPS_SRC,
         "replaces": FPS_TPU, "launches": sliced["launches"]["fps"],
         "max_abs_err": kernels["fps_err"], "ms": kernels["fps_ms"],
         "plain_ms": kernels["fps_plain_ms"]},
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
