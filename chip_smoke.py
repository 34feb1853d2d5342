#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``pointcloudprocessing_tpu_torch``) on one
NVIDIA GPU: the serving slice voxel -> FPS / stride -> multi-head PointNet,
the PointNet training step, the preprocess with windowed PCA normals, DGCNN
inference, and PointNet++ inference and serving at a scan width that takes
the any-rank segment sum.

Phases, one line each (any failure exits non-zero, and no result is printed):

1. device: requires CUDA; prints the card's name and power limit as
   ``nvidia-smi`` reports them; TF32 off for matmul and cuDNN.
2. build: builds every CUDA kernel library from
   ``pointcloudprocessing_tpu_torch/csrc`` (the two segment sums, FPS,
   pooled chain, window moments, gather max/min), one ``nvcc`` a source,
   all at once.
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main paths' shapes (the segment sum on the ranks the slice builds
   from uniform, zero-padded and LiDAR-like dense scans, on synthetic
   long runs and on ranks that leave most buckets empty, each into a pool
   filled with NaN first, beside ``index_add_``; the pooled-chain forward
   and backward at 8x8192 and 32x1024 points, 128 -> 1024 channels, with all-zero
   channels and with many channels winning one point, at ragged n (1000,
   100, 8191), one cloud, c_in 64 / 192 / 256 and c 64 / 192 / 4096, the
   backward with a non-symmetric m, beside the GEMM alone (``torch.matmul``
   in f32, TF32 off) as a yardstick; the forward on clouds built of 16
   repeated rows (exact ties: argmax equal to the plain version's) and on
   NaN inputs; the backward's winner-only form through the running-statistics
   chain's autograd Function; the window moments on Morton-ordered voxel
   output at the config-2 and config-5 shapes, on the JAX tests' edge
   cases and on every form of the kernel (a window of 14,592 candidates in
   streamed tiles, q_block 512, k 1 to 48, a tie-heavy integer grid,
   65,536 clouds), counting count mismatches, the sums' error over their
   absolute terms, the normals' angle and the launches; gather max/min at DGCNN's four widths,
   at widths no multiple of 32 or of its slice, with NaN, with k 1 and on
   clouds of 16,384 points (the L2 form), bit-identical, each with the form
   it took), with its
   device time (torch.profiler) and its time per call beside the plain
   version's; the pooled forward's argmax flips are counted. FPS on the
   path's own input (the plane-major voxel output of the uniform, padded
   and dense 256x2048 scans, captured as the segment sums' are; the
   uniform one gives fps_ms), on clouds in random order with holes
   (256x2048 both layouts, 64x8192), PointNet++'s two calls (256x1024 ->
   512, 256x512 -> 128), one cloud, k above the valid rows, a NaN
   coordinate in a valid row, an invalid row and the seed row (8x2048 and,
   in the cluster form, 2x16,385; both layouts), past one block's reach (the cluster form: 4 clouds of
   16,385, 32,768 and 65,536 points) and past the cluster's (the
   device-memory form: 3 clouds of 65,537), both layouts, each launch counted,
   indices identical and coordinates bit-identical, with the kernel form,
   its cluster size and the device time a selection step.
4. slice: a full-width PointNet (23 classes, 12 parts, random seeded init)
   serves streamed 256x2048 scans through voxel 0.4 -> FPS -> 1024 points
   (clouds/s over three timed windows after a stream warm-up), then a
   zero-padded batch, a stride-sampler batch and a 64x8192 batch; both
   kernels' launch counters must rise, and batches must agree with the
   plain versions. Also the device's busy share over a stream and each
   stage's device time.
5. serve: the serving CLI over a collect of written frames, its last batch
   zero-padded.
6. train: the training step at full width through ``model_from_config
   (training=True)``, ``init_train_state`` and ``make_train_step``, in two
   cases: A, the kc46 config's ``final`` stage (vanilla 23/12, head
   frozen, 8 x 8192 points, jitter 0.1 m, dropout 0.3; one pooled chain)
   and B, the JAX bench's train row (full model, both regularizers,
   32 x 1024 points, jitter 0.01; three chains). Each case: one step
   through the kernels against one through the plain versions from the same
   state, batch and generators; 30 steps on one batch (the loss must fall,
   and each pooled kernel launches chains x steps times); train steps/s and
   clouds/s over three timed windows, the device busy share, and device ms
   per step by kind of kernel.
7. normals: the config-2 preprocess (8x8192 scans -> voxel 0.5 -> window
   normals k 16, plane-major) in Mpts/s and the config-5 composition
   (256x2048 -> voxel 0.4 -> window normals k 16, W 128 -> FPS 1024 ->
   PointNet classification and se3) in clouds/s, three windows each, with
   busy share and device ms by kind; kernel 6 launches once a batch; window
   against exact normals on an offset surface (median < 1, p95 < 5 deg).
8. dgcnn: DGCNN 23/12 at full width (k 20, f32, seeded) from a config with
   ``"model": "dgcnn"``, 64x1024 normal(0, 1) clouds, dynamic and static
   graph: the factored edge block through kernel 7 against the same
   through its plain version (bit-identical) and against the literal edge
   dataflow; clouds/s over three windows, busy share, device ms by kind
   (distance GEMM, topk, kernel 7, the rest); kernel 7 launches four times
   a forward; one ``PointCloudPipeline.stream()`` with the DGCNN model.
9. pointnet2: (a) the any-rank segment sum (kernel 3) against its plain
   version: bit-identical to it on a CPU copy and within a summation-order
   bar of it on the card, on the path's voxel and stride ranks at 256x2000,
   random ranks at 256x2000 (d 4, 5) and 8x8000, n 1, n 490 at d 1 and 8,
   one segment, empty segments, a NaN row, one cloud (b 1), and past the
   shared-memory form at 4x40000 (any order, sorted, one segment), timed
   beside scatter_add_; a rank outside [0, n) traps (a child process). (b) the route: 256x2000
   runs kernel 3, 256x2048 kernel 1. (c) PointNet++ 23/12 at full width
   (``pointnet2_for_width(23, 12, 1024)``, f32, seeded) from a config with
   ``"model": "pointnet2"`` on 256x1024 normal(0, 1) clouds: through the
   FPS kernel against its plain version (picks identical), a CPU twin on 2
   clouds, clouds/s over three windows, busy share, device ms by kind; FPS
   launches twice a forward. (d) ``PointCloudPipeline`` at 256x2000 ->
   voxel 0.4 -> FPS or stride -> 1024 -> PointNet++ through ``stream()``:
   clouds/s, busy share, launches a batch. (e) ``serve.main`` over a
   PointNet++ stage at scan width 2000.

The second-to-last line is a JSON object with each of the seven kernels'
launches on its paths, error against its plain version, times and bound: ``ms``,
``plain_ms`` and ``library_ms`` (a single PyTorch call computing the same
function, where there is one) are device times from ``torch.profiler``, or
null with ``"ms_source": "not traced"`` if every trace came back without
device rows (never another clock's time); ``bound_ms`` is the larger of
the bytes the function must move over 3.35 TB/s and its operations: f32
ones over 67 TFLOP/s, plus the pooled chain's GEMM products on the tensor
cores over 495 TFLOP/s of dense TF32, three a product in 3xTF32
(``bound_by`` says which). The last line is ``{"ok": true,
"device": {...}}``.

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
POOLED_SRC = "pointcloudprocessing_tpu_torch/csrc/pooled_chain.cu"
POOLED_FWD_TPU = "pointcloudprocessing_tpu/ops/pallas/pooled_chain.py:106"
POOLED_BWD_TPU = "pointcloudprocessing_tpu/ops/pallas/pooled_chain.py:193"
WINDOW_SRC = "pointcloudprocessing_tpu_torch/csrc/window_normals.cu"
WINDOW_TPU = "pointcloudprocessing_tpu/ops/pallas/window_normals.py:387"
GATHER_SRC = "pointcloudprocessing_tpu_torch/csrc/gather_maxmin.cu"
GATHER_TPU = "pointcloudprocessing_tpu/ops/pallas/gather_maxmin.py:132"
SEG_ANY_TPU = "pointcloudprocessing_tpu/ops/pallas/voxel_reduce.py:65"
KC46_CONFIG = "configs/kc46_lidar_config.json"
# the H100 SXM's published peaks (NVIDIA's data sheet): HBM3 bandwidth, f32
# outside the tensor cores, and dense TF32 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12


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


def device_trace(torch, fn) -> tuple[list, float] | None:
    """Run ``fn`` once under ``torch.profiler``. Returns the device events it
    recorded (kernels, copies, memsets: the rows whose device type is CUDA,
    so no host op that launched them is counted a second time) and the host
    wall time of the call in us; None if no trace recorded device rows.

    On the H100 machine a trace has come back without device rows partway
    through this script (once at its first trace), while 60 traces in a row
    came back whole in a fresh process; so an empty trace is retried, once
    with CUDA activity only and once with CPU activity too, and the caller
    reports the metric as not traced (None) instead of failing the run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    tries = ([ProfilerActivity.CUDA], [ProfilerActivity.CUDA],
             [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    seen = []
    for activities in tries:
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        rows = prof.events()
        events = [e for e in rows if e.device_type == DeviceType.CUDA]
        if events:
            if seen:
                log(f"    (torch.profiler: {len(seen)} trace(s) without device "
                    f"rows before this one: {seen})")
            return events, wall_us
        seen.append(f"{len(rows)} rows")
    log(f"    (torch.profiler recorded no device rows in {len(tries)} traces: "
        f"{seen})")
    return None


def device_ms(torch, fn, reps: int) -> float | None:
    """Device time per call of ``fn``: the summed durations of the kernels,
    copies and memsets it runs, over ``reps`` calls after one warm-up; None
    if the profiler recorded nothing."""
    fn()

    def calls():
        for _ in range(reps):
            fn()

    traced = device_trace(torch, calls)
    if traced is None:
        return None
    return sum(e.time_range.elapsed_us() for e in traced[0]) / reps / 1e3


def fmt(ms: float | None) -> str:
    return "not traced" if ms is None else f"{ms:.4f}"


def busy_share(torch, fn) -> str:
    """The busy share of one call of ``fn``, with its wall ms, as a log
    phrase: the time in which at least one device activity ran (the union
    of their intervals, so work overlapped on two streams counts once) over
    the host wall time; "not traced" if the profiler recorded nothing."""
    traced = device_trace(torch, fn)
    if traced is None:
        return "not traced"
    events, wall_us = traced
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy += hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    busy += hi - lo
    return f"{busy / wall_us:.4f} of {wall_us / 1e3:.1f} ms wall"


#: kinds of kernel by name, first match wins: (kind, substrings of the
#: kernel name as CUPTI reports it)
TRAIN_KINDS = (("pooled_fwd", ("pooled_forward", "pooled_combine")),
               ("pooled_bwd", ("pooled_backward",)), ("gemm", ("gemm",)),
               ("elementwise", ("elementwise",)), ("reduce", ("reduce",)))
NORMALS_KINDS = (("window_moments", ("window_moments",)),
                 ("segment_sum", ("sorted_segment_sum",)), ("fps", ("fps_kernel",)),
                 ("sort", ("sort", "radix")), ("gemm", ("gemm",)),
                 ("elementwise", ("elementwise",)), ("reduce", ("reduce",)))
DGCNN_KINDS = (("gather_maxmin", ("gather_maxmin",)), ("topk", ("topk", "sort")),
               ("gemm", ("gemm",)), ("elementwise", ("elementwise",)),
               ("reduce", ("reduce",)))


def kernel_breakdown(torch, fn, calls: int = 1, kinds=TRAIN_KINDS) -> dict:
    """Device ms per call of ``fn`` (which makes ``calls`` calls) by kind of
    kernel, from the kernel names as CUPTI reports them; empty if the
    profiler recorded nothing."""
    traced = device_trace(torch, fn)
    if traced is None:
        return {}
    out = {kind: 0.0 for kind, _ in kinds}
    out["other"] = 0.0
    for e in traced[0]:
        name = e.name.lower()
        kind = next((k for k, keys in kinds if any(key in name for key in keys)),
                    "other")
        out[kind] += e.time_range.elapsed_us() / 1e3 / calls
    return out


def kernels_per_call(torch, fn, calls: int) -> str:
    """Device activities (kernels, copies, memsets) per call of ``fn``,
    which makes ``calls`` calls, from one trace; "not traced" without one."""
    traced = device_trace(torch, fn)
    return "not traced" if traced is None else f"{len(traced[0]) / calls:.1f}"


def roofline(bytes_moved: float, operations: float,
             tf32_operations: float = 0.0) -> tuple[float, str]:
    """The least time in ms the H100 could take for a kernel's work: the
    larger of its bytes (each input read once, each output written once)
    over 3.35 TB/s and its operations, f32 ones over 67 TFLOP/s plus
    tensor-core ones over 495 TFLOP/s of dense TF32 (an f32-accurate
    product in 3xTF32 is three), and which of the two binds."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = (operations / F32_OPS_PER_S + tf32_operations / TF32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ---------------------------------------------------------------- phase 3 data

def segment_case(rng, b: int, n: int, d: int, kind: str):
    """Monotone ranks as the callers build them, with their data rows.

    'voxel': runs of 1-5 rows per occupied voxel (d = 4: xyz*w, w), the
    invalid rows (a long run on every fourth cloud) parked in bucket n - 1
    with zero weight. 'sparse': a quarter of the rows valid, their runs a
    random 1-8 buckets apart, so most buckets stay empty. 'stride': valid
    row j in bucket floor(j*k/nv), k=1024, with nv < k on some clouds (d =
    5: xyz*w, j*w, w)."""
    data = np.zeros((b, n, d), np.float32)
    rank = np.full((b, n), n - 1, np.int32)
    for c in range(b):
        n_invalid = n // 2 if c % 4 == 0 else int(rng.integers(0, n // 8))
        if kind == "sparse":
            n_invalid = 3 * n // 4
        nv = n - n_invalid
        xyz = rng.uniform(-20, 20, (nv, 3)).astype(np.float32)
        if kind in ("voxel", "sparse"):
            is_new = rng.uniform(size=nv) < 0.6
            is_new[0] = True
            step = rng.integers(1, 9, nv) if kind == "sparse" else is_new
            rank[c, :nv] = np.minimum(np.cumsum(step * is_new) - step[0], n - 1)
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
    from pointcloudprocessing_tpu_torch.ops.cuda.fps import kernel_form
    from pointcloudprocessing_tpu_torch.ops.fps import (
        _seed_indices,
        farthest_point_sample_and_gather,
        stride_sample_and_gather,
    )
    from pointcloudprocessing_tpu_torch.ops.voxel import voxel_downsample_batch

    dev = torch.device("cuda")
    results = {"seg_err": 0.0, "fps_err": 0.0}
    # the segment sum's inputs exactly as the slice builds them: a voxel
    # downsample of 256x2048 scans at 0.4 (d = 4) and the stride sampler over
    # its output (d = 5), for each kind of scan batch; and FPS's: the
    # plane-major voxel output of the same scans
    cases, fps_inputs = [], {}
    for kind in ("uniform", "padded", "dense"):
        captured = []

        def record(data, rank):
            captured.append((data.clone(), rank.clone()))
            return sorted_segment_reduce_reference(data, rank)

        def record_fps(points, k, mask, start, layout="bnc", kind=kind):
            fps_inputs[kind] = (points.clone(), k, mask.clone(), start.clone(), layout)
            return fps_with_points_reference(points, k, mask, start, layout)

        with route_kernels(record, record_fps):
            x = torch.from_numpy(scan_batch(rng, kind)).to(dev)
            vox, vmask = voxel_downsample_batch(x, 0.4)
            stride_sample_and_gather(vox, 1024, vmask)
            vox, vmask = voxel_downsample_batch(x, 0.4, layout="bcn")
            farthest_point_sample_and_gather(vox, 1024, vmask, layout="bcn")
        cases += [(f"main-path {kind} voxel", *captured[0]),
                  (f"main-path {kind} stride", *captured[1])]
    # synthetic ranks with long runs (invalid rows parked in bucket n - 1),
    # and ranks that leave many empty buckets
    for b, n, d, kind in ((256, 2048, 4, "voxel"), (256, 2048, 5, "stride"),
                          (64, 8192, 4, "voxel"), (256, 2048, 4, "sparse")):
        data_np, rank_np = segment_case(rng, b, n, d, kind)
        label = "empty buckets" if kind == "sparse" else f"{kind} long-run"
        cases.append((label, torch.from_numpy(data_np).to(dev),
                      torch.from_numpy(rank_np).to(dev)))
    for label, data, rank in cases:
        b, n, d = data.shape
        # the kernel writes every output row into uninitialised memory: fill
        # the block the allocator hands out next with NaN, so that a row it
        # left unwritten shows
        torch.full_like(data, float("nan"))
        got = sorted_segment_reduce(data, rank)
        want = sorted_segment_reduce_reference(data, rank)
        torch.cuda.synchronize()
        err = (got - want).abs()
        bound = 1e-5 * data.abs().max() + 1e-6 * want.abs()
        empty = torch.ones(b, n, dtype=torch.bool, device=dev).scatter_(
            1, rank.long(), False)
        if not bool((err <= bound).all()) or bool((got[empty] != 0).any()):
            raise AssertionError(
                f"segment sum {b}x{n}x{d} ({label}) disagrees with its plain "
                f"version: max abs err {err.max().item():.3e}, "
                f"{int((got[empty] != 0).sum())} nonzero values in its "
                f"{int(empty.sum())} empty rows")
        max_err = err.max().item()
        results["seg_err"] = max(results["seg_err"], max_err)
        kernel = functools.partial(sorted_segment_reduce, data, rank)
        plain = functools.partial(sorted_segment_reduce_reference, data, rank)
        ms, plain_ms = device_ms(torch, kernel, 20), device_ms(torch, plain, 20)
        per_call = (call_ms(torch, kernel, 20), call_ms(torch, plain, 20))
        longest = max(int(np.bincount(r).max()) for r in rank.cpu().numpy())
        log(f"[3 kernels] segment sum {b}x{n}x{d} {label} (longest run "
            f"{longest}; {int(empty.sum())} empty rows, all zero, in a pool "
            f"filled with NaN): max abs err {max_err:.3e}; device ms kernel "
            f"{fmt(ms)}, plain {fmt(plain_ms)}; per call with launch "
            f"kernel {per_call[0]:.4f}, plain {per_call[1]:.4f}")
        if label == "main-path uniform voxel":
            results["seg_ms"], results["seg_plain_ms"] = ms, plain_ms
            # each row read once with its rank, each output row written once;
            # one add a value
            results["seg_bound"] = roofline(nbytes(data, rank, want), data.numel())
            # the one PyTorch call for the same sums: index_add_ over the
            # cloud-offset ranks (computed outside the timed call)
            flat = (rank.long() + n * torch.arange(b, device=dev)[:, None]).reshape(-1)
            rows = data.reshape(-1, d)

            def library():
                return torch.zeros_like(rows).index_add_(0, flat, rows)

            lib_err = (library().reshape(b, n, d) - want).abs()
            if not bool((lib_err <= bound).all()):
                raise AssertionError("index_add_ disagrees with the plain segment sum")
            results["seg_library_ms"] = device_ms(torch, library, 20)
            log(f"[3 kernels] segment sum {b}x{n}x{d} {label}: index_add_ device ms "
                f"{fmt(results['seg_library_ms'])}; bound "
                f"{results['seg_bound'][0]:.4f} ms ({results['seg_bound'][1]})")

    def fps_against_plain(label, pts, k, mask, start, layout):
        """Indices identical and coordinates bit-identical (NaN included);
        returns the largest coordinate difference."""
        idx, sampled = fps_with_points(pts, k, mask, start, layout=layout)
        ridx, rsampled = fps_with_points_reference(pts, k, mask, start, layout)
        torch.cuda.synchronize()
        if not torch.equal(idx, ridx):
            bad = (idx != ridx).nonzero()[0].tolist()
            raise AssertionError(
                f"FPS {label} {layout}: indices differ from the plain version "
                f"first at (cloud, step) {bad}")
        if not check_bit_identical(torch, sampled, rsampled):
            raise AssertionError(f"FPS {label} {layout}: coordinates not "
                                 "bit-identical")
        return idx, sampled, (sampled - rsampled).nan_to_num().abs().max().item()

    def fps_case_line(label, pts, k, mask, start, layout, reps=10):
        """One FPS case: the kernel launched once against the plain version,
        then its device ms; logs the kernel form, its cluster size and the
        time a selection step. Returns (device ms, indices, sampled)."""
        b = pts.shape[0]
        n = pts.shape[2] if layout == "bcn" else pts.shape[1]
        before = fps_with_points.launches
        idx, sampled, err = fps_against_plain(f"{b}x{n}->{k} {label}", pts, k,
                                              mask, start, layout)
        if fps_with_points.launches != before + 1:
            raise AssertionError(f"FPS {b}x{n} {label}: the kernel did not launch")
        results["fps_err"] = max(results["fps_err"], err)
        ms = device_ms(torch, functools.partial(
            fps_with_points, pts, k, mask, start, layout=layout), reps)
        form, cluster = kernel_form(b, n)
        per_step = "not traced" if ms is None else f"{ms / max(k - 1, 1) * 1e3:.3f}"
        log(f"[3 kernels] FPS {b}x{n}->{k} {layout} {label} ({form} form, "
            f"cluster {cluster}): indices identical, coordinates bit-identical; "
            f"device ms kernel {fmt(ms)}, {per_step} us a selection step")
        return ms, idx, sampled

    # the path's own input: the voxel output of the scans above, Morton
    # ordered, valid rows packed first; the uniform one sets fps_ms
    for kind in ("uniform", "padded", "dense"):
        pts, k, mask, start, layout = fps_inputs[kind]
        ms, idx, sampled = fps_case_line(f"main-path {kind} voxel output", pts,
                                         k, mask, start, layout)
        if kind == "uniform":
            plain = functools.partial(
                fps_with_points_reference, pts, k, mask, start, layout)
            plain_ms = device_ms(torch, plain, 2)
            kernel = functools.partial(
                fps_with_points, pts, k, mask, start, layout=layout)
            per_call = (call_ms(torch, kernel, 10), call_ms(torch, plain, 1, 3))
            log(f"[3 kernels] FPS fps_ms is this input's (256x2048 uniform scans "
                f"-> voxel 0.4, bcn): device ms kernel {fmt(ms)}, plain "
                f"{fmt(plain_ms)}; per call with launch kernel {per_call[0]:.4f}, "
                f"plain {per_call[1]:.4f}")
            results["fps_ms"], results["fps_plain_ms"] = ms, plain_ms
            # k - 1 steps over every valid point: 3 sub, 3 mul, 2 add, 1 min
            results["fps_bound"] = roofline(
                nbytes(pts, mask, start, idx, sampled),
                (k - 1) * int(mask.sum()) * 9)
    # clouds in random order with holes (phase 3's synthetic case)
    for b, n, k, layout in ((256, 2048, 1024, "bcn"), (256, 2048, 1024, "bnc"),
                            (64, 8192, 1024, "bcn")):
        pts_np, mask_np = fps_case(rng, b, n, k)
        if layout == "bcn":
            pts_np = np.ascontiguousarray(pts_np.transpose(0, 2, 1))
        pts = torch.from_numpy(pts_np).to(dev)
        mask = torch.from_numpy(mask_np).to(dev)
        start = _seed_indices(mask, 0)
        fps_case_line("random order", pts, k, mask, start, layout)
    # PointNet++'s two FPS calls (all rows valid, bnc), one cloud, and k
    # above the valid rows (300 a cloud, and a cloud with none)
    for b, n, k in ((256, 1024, 512), (256, 512, 128)):
        pts = torch.from_numpy(rng.normal(size=(b, n, 3)).astype(np.float32)).to(dev)
        mask = torch.ones((b, n), dtype=torch.bool, device=dev)
        fps_case_line("PointNet++ normal(0, 1)", pts, k, mask,
                      _seed_indices(mask, 0), "bnc")
    pts, k, mask, start, layout = fps_inputs["uniform"]
    fps_case_line("one cloud (b 1), uniform voxel output", pts[:1].contiguous(),
                  k, mask[:1].contiguous(), start[:1].contiguous(), layout)
    pts = torch.from_numpy(rng.uniform(-20, 20, (4, 3, 2048)).astype(np.float32)).to(dev)
    mask = torch.zeros((4, 2048), dtype=torch.bool, device=dev)
    mask[:3, :300] = True
    fps_case_line("300 valid rows, k above them; one cloud with none", pts,
                  1024, mask, _seed_indices(mask, 0), "bcn", reps=3)

    # NaN coordinates (the JAX kernel's jnp.minimum / jnp.argmax rules): in a
    # valid row it wins the next pick, then every distance is NaN and the
    # first valid row wins each pick; in an invalid row it is never picked;
    # in the seed row every distance is NaN from the first step. One block a
    # cloud, and a cluster with the NaN row in another block than row 0's
    k = 1024
    for b, n, valid_row, invalid_row in ((8, 2048, 5, 8), (2, 16385, 5000, 7008)):
        for where in ("valid row", "invalid row", "seed row"):
            for layout in ("bcn", "bnc"):
                pts_np = rng.uniform(-20, 20, (b, n, 3)).astype(np.float32)
                mask_np = np.ones((b, n), bool)
                mask_np[:, 1::7] = False
                row = {"valid row": valid_row, "invalid row": invalid_row,
                       "seed row": 0}[where]
                pts_np[:, row, 1] = np.nan
                if layout == "bcn":
                    pts_np = np.ascontiguousarray(pts_np.transpose(0, 2, 1))
                mask = torch.from_numpy(mask_np).to(dev)
                idx, _, _ = fps_against_plain(
                    f"{b}x{n}->{k} NaN in the {where}",
                    torch.from_numpy(pts_np).to(dev), k, mask,
                    _seed_indices(mask, 0), layout)
                picks = idx.cpu().numpy()
                expect = {"valid row": [0, row, 0], "seed row": [0, 0, 0]}.get(where)
                if (expect is not None and (picks[:, :3] != expect).any()) or (
                        where == "invalid row" and (picks == row).any()):
                    raise AssertionError(f"FPS {b}x{n} NaN in the {where}: picks "
                                         f"{picks[0, :4].tolist()}")
        form, cluster = kernel_form(b, n)
        log(f"[3 kernels] FPS {b}x{n}->{k} ({form} form, cluster {cluster}) with "
            "a NaN coordinate in a valid row, an invalid row and the seed row, "
            "bcn and bnc: indices identical, coordinates bit-identical to the "
            f"plain version (picks 0, {valid_row}, 0, ...; never the invalid "
            "row; 0, 0, ...)")

    # past one block's reach: the cluster form (kernel_form), 4 clouds; past
    # the cluster's: the device-memory form, 3 clouds
    k = 1024
    for b, n in ((4, 16385), (4, 32768), (4, 65536), (3, 65537)):
        for layout in ("bcn", "bnc"):
            pts_np, mask_np = fps_case(rng, b, n, k)
            if layout == "bcn":
                pts_np = np.ascontiguousarray(pts_np.transpose(0, 2, 1))
            pts = torch.from_numpy(pts_np).to(dev)
            mask = torch.from_numpy(mask_np).to(dev)
            fps_case_line("random order", pts, k, mask, _seed_indices(mask, 0),
                          layout, reps=3)
    return results


def phase_pooled_kernels(torch) -> dict:
    """The pooled-chain kernels against their plain versions at the training
    step's shapes (c_in 128 -> c 1024): case A's 8x8192 and case B's 32x1024
    points, inputs drawn like the chain's (relu'd activations)."""
    from pointcloudprocessing_tpu_torch.ops.cuda.pooled_chain import (
        pooled_chain_backward,
        pooled_chain_backward_reference,
        pooled_chain_forward,
        pooled_chain_forward_reference,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    c_in, c = 128, 1024
    results = {"fwd_err": 0.0, "bwd_err": 0.0}
    # the wrappers refuse what the kernels do not take, before any launch
    x0 = torch.zeros(2, 64, c_in, device=dev)
    w0, v0 = torch.zeros(c, c_in, device=dev), torch.zeros(c, device=dev)
    refused = 0
    for bad in ((x0.double(), w0, v0, v0), (x0.transpose(1, 2).contiguous()
                .transpose(1, 2), w0, v0, v0), (x0, w0[:96], v0[:96], v0[:96])):
        try:
            pooled_chain_forward(*bad)
        except (TypeError, ValueError):
            refused += 1
    if refused != 3 or pooled_chain_forward.launches:
        raise AssertionError("pooled forward took an f64, strided or 96-wide call")
    log("[3 kernels] pooled forward refuses f64, strided and 96-wide inputs "
        "before any launch")
    # (b, n, c_in, c, label, timed): the training step's shapes first, then
    # ragged n, one cloud, and the widths' edges
    cases = [(8, 8192, 128, 1024, "some dead channels", True),
             (32, 1024, 128, 1024, "some dead channels", True),
             (8, 8192, 128, 1024, "all channels dead", True),
             (1, 1000, 128, 1024, "ragged n, one cloud", False),
             (4, 100, 64, 64, "ragged n, c_in 64, c 64", False),
             (3, 8191, 192, 192, "ragged n, c_in 192, c 192", False),
             (2, 1000, 256, 4096, "c_in 256, c 4096", False)]
    for b, n, c_in, c, label, timed in cases:
        x = torch.relu(torch.randn(b, n, c_in, device=dev, generator=gen))
        w = torch.randn(c, c_in, device=dev, generator=gen) * 0.1
        a = torch.rand(c, device=dev, generator=gen) + 0.5
        c_row = torch.randn(c, device=dev, generator=gen) * 0.5
        c_row[:16] = -1e4  # 0 at every point after relu
        if label == "all channels dead":
            c_row[:] = -1e4
        pooled, argmax = pooled_chain_forward(x, w, a, c_row)
        want, want_arg = pooled_chain_forward_reference(x, w, a, c_row)
        torch.cuda.synchronize()
        # f32 GEMM rounding of each pre-activation: c_in ulps of the sum of
        # |x_k w_k|, times the affine's |a|
        bound = c_in * 2.0 ** -23 * torch.matmul(x.abs(), w.abs().t()) * a.abs()
        r = torch.relu(torch.matmul(x, w.t()) * a + c_row)
        got_r = r.gather(1, argmax.long()[:, None, :]).squeeze(1)
        slack = (bound.gather(1, argmax.long()[:, None, :]).squeeze(1)
                 + bound.gather(1, want_arg.long()[:, None, :]).squeeze(1))
        err = (pooled - want).abs()
        if not bool((err <= slack).all()) or not bool((want - got_r <= slack).all()):
            raise AssertionError(
                f"pooled forward {b}x{n}x{c_in}->{c} ({label}): max abs err "
                f"{err.max().item():.3e} beyond the GEMM rounding bound, or a "
                f"winner off the max")
        if not bool(((argmax >= 0) & (argmax < n)).all()):
            raise AssertionError("pooled forward: argmax outside [0, n)")
        dead = c_row < -1e3
        if not (bool((pooled[:, dead] == 0).all()) and bool((argmax[:, dead] == 0).all())):
            raise AssertionError("pooled forward: a dead channel is not 0 at argmax 0")
        flips = int((argmax != want_arg).sum())
        results["fwd_err"] = max(results["fwd_err"], err.max().item())
        timing = ""
        if timed:
            fwd = functools.partial(pooled_chain_forward, x, w, a, c_row)
            fwd_plain = functools.partial(pooled_chain_forward_reference, x, w, a, c_row)
            ms, plain_ms = device_ms(torch, fwd, 10), device_ms(torch, fwd_plain, 10)
            per_call = (call_ms(torch, fwd, 10), call_ms(torch, fwd_plain, 10))
            timing = (f"; device ms kernel {fmt(ms)}, plain {fmt(plain_ms)}; per "
                      f"call with launch kernel {per_call[0]:.4f}, plain "
                      f"{per_call[1]:.4f}")
        log(f"[3 kernels] pooled forward {b}x{n}x{c_in}->{c} ({label}): max abs "
            f"err {err.max().item():.3e}; argmax flips {flips} of {b * c} (each "
            f"within GEMM rounding of the max){timing}")
        if (b, n, label) == (8, 8192, "some dead channels"):
            results["fwd_ms"], results["fwd_plain_ms"] = ms, plain_ms
            # the GEMM's products on the tensor cores (three a product in
            # 3xTF32), then affine, relu and max per pre-activation
            results["fwd_bound"] = roofline(
                nbytes(x, w, a, c_row, pooled, argmax), 3 * b * n * c,
                3 * 2 * b * n * c_in * c)
            # yardstick, not a library time for the kernel: the GEMM alone
            # in full f32 (TF32 is off), without affine, relu or max
            if torch.backends.cuda.matmul.allow_tf32:
                raise AssertionError("TF32 matmul is on")
            gemm = functools.partial(torch.matmul, x, w.t())
            results["gemm_ms"] = device_ms(torch, gemm, 10)
            log(f"[3 kernels] yardstick: the GEMM alone, torch.matmul "
                f"{b}x{n}x{c_in} @ {c_in}x{c} in f32 with TF32 off: device ms "
                f"{fmt(results['gemm_ms'])}, per call with launch "
                f"{call_ms(torch, gemm, 10):.4f} (kernel {fmt(ms)})")

        coef = torch.randn(b, c, device=dev, generator=gen)
        m_small = torch.randn(c_in, c_in, device=dev, generator=gen) * 0.01
        if not bool(((m_small - m_small.t()).abs() > 1e-3).any()):
            raise AssertionError("the backward's m must not be symmetric")
        const_row = torch.randn(c_in, device=dev, generator=gen) * 0.01
        crowded = argmax.clone()
        crowded[:, ::2] = 5  # half the channels win point 5 of every cloud
        for winners, am in (("forward's winners", argmax), ("512 channels on one point", crowded)):
            dx, dk = pooled_chain_backward(x, w, coef, am, m_small, const_row)
            want_dx, want_dk = pooled_chain_backward_reference(
                x, w, coef, am, m_small, const_row)
            dx2, dk2 = pooled_chain_backward(x, w, coef, am, m_small, const_row)
            torch.cuda.synchronize()
            if not (torch.equal(dx, dx2) and torch.equal(dk, dk2)):
                raise AssertionError("pooled backward is not deterministic")
            e_dx = (dx - want_dx).abs().max().item()
            e_dk = (dk - want_dk).abs().max().item()
            # f32 sums in another order: 1e-5 of the largest term's scale
            bar_dx = 1e-5 * (1 + want_dx.abs().max().item())
            bar_dk = 1e-5 * (1 + want_dk.abs().max().item())
            if e_dx > bar_dx or e_dk > bar_dk:
                raise AssertionError(
                    f"pooled backward {b}x{n}x{c_in}<-{c} ({winners}): dx err "
                    f"{e_dx:.3e} (bar {bar_dx:.3e}), dk err {e_dk:.3e} (bar "
                    f"{bar_dk:.3e})")
            results["bwd_err"] = max(results["bwd_err"], e_dx, e_dk)
            timing = ""
            if timed and label != "all channels dead":
                bwd = functools.partial(pooled_chain_backward, x, w, coef, am,
                                        m_small, const_row)
                bwd_plain = functools.partial(pooled_chain_backward_reference, x, w,
                                              coef, am, m_small, const_row)
                ms, plain_ms = device_ms(torch, bwd, 10), device_ms(torch, bwd_plain, 5)
                per_call = (call_ms(torch, bwd, 10), call_ms(torch, bwd_plain, 5))
                timing = (f"; device ms kernel {fmt(ms)}, plain {fmt(plain_ms)}; "
                          f"per call with launch kernel {per_call[0]:.4f}, plain "
                          f"{per_call[1]:.4f}")
            log(f"[3 kernels] pooled backward {b}x{n}x{c_in}<-{c} ({winners}, "
                f"non-symmetric m): max abs err dx {e_dx:.3e}, dk {e_dk:.3e} "
                f"(bars {bar_dx:.1e}, {bar_dk:.1e}); bit-identical on a rerun"
                f"{timing}")
            if (b, n, label, winners) == (8, 8192, "some dead channels",
                                          "forward's winners"):
                results["bwd_ms"], results["bwd_plain_ms"] = ms, plain_ms
                # x@M on the tensor cores (three products each in 3xTF32) and
                # the row, plus one coef*W row into dx and one x row into dk
                # per (cloud, channel) winner
                results["bwd_bound"] = roofline(
                    nbytes(x, w, coef, am, m_small, const_row, dx, dk),
                    b * n * c_in + 4 * b * c * c_in, 3 * 2 * b * n * c_in * c_in)

    # exact ties: clouds built of 16 distinct rows, each repeated at many
    # indices, so every channel's max is attained at several points and the
    # argmax must be the first of them, as the plain version's
    b, n, c_in, c = 8, 8192, 128, 1024
    pool = torch.relu(torch.randn(16, c_in, device=dev, generator=gen))
    pick = torch.randint(0, 16, (b, n), device=dev, generator=gen)
    x = pool[pick].contiguous()
    w = torch.randn(c, c_in, device=dev, generator=gen) * 0.1
    a = torch.rand(c, device=dev, generator=gen) + 0.5
    c_row = torch.randn(c, device=dev, generator=gen) * 0.5
    pooled, argmax = pooled_chain_forward(x, w, a, c_row)
    want, want_arg = pooled_chain_forward_reference(x, w, a, c_row)
    torch.cuda.synchronize()
    bound = (c_in * 2.0 ** -23 * torch.matmul(x.abs(), w.abs().t()) * a.abs()).amax(1)
    err = (pooled - want).abs()
    if not torch.equal(argmax, want_arg) or not bool((err <= 2 * bound).all()):
        raise AssertionError(
            f"pooled forward on repeated rows: {int((argmax != want_arg).sum())} "
            f"argmax differ from the plain version's, max abs err "
            f"{err.max().item():.3e}")
    results["fwd_err"] = max(results["fwd_err"], err.max().item())
    log(f"[3 kernels] pooled forward {b}x{n}x{c_in}->{c} on clouds of 16 "
        f"repeated rows (exact ties): argmax equal to the plain version's at all "
        f"{b * c}; max abs err {err.max().item():.3e}")

    # NaN propagates as in torch.relu / amax / argmax: one NaN value in a
    # point (every channel of that cloud), and NaN BatchNorm factors (an
    # unclamped variance below -eps) on four channels
    b, n = 32, 1024
    x = torch.relu(torch.randn(b, n, c_in, device=dev, generator=gen))
    w = torch.randn(c, c_in, device=dev, generator=gen) * 0.1
    a = torch.rand(c, device=dev, generator=gen) + 0.5
    c_row = torch.randn(c, device=dev, generator=gen) * 0.5
    x[1, 77, 3] = float("nan")
    a[40:44] = float("nan")
    pooled, argmax = pooled_chain_forward(x, w, a, c_row)
    want, want_arg = pooled_chain_forward_reference(x, w, a, c_row)
    torch.cuda.synchronize()
    nan_want = torch.isnan(want)
    finite = ~nan_want
    bound = (c_in * 2.0 ** -23 * torch.matmul(x.abs(), w.abs().t()) * a.abs()).amax(1)
    err = (pooled - want).abs()
    if not (torch.equal(torch.isnan(pooled), nan_want)
            and int(nan_want.sum()) == c + 4 * (b - 1)
            and torch.equal(argmax[nan_want], want_arg[nan_want])
            and bool((err[finite] <= 2 * bound[finite]).all())):
        raise AssertionError("pooled forward on NaN inputs disagrees with its "
                             "plain version")
    results["fwd_err"] = max(results["fwd_err"], err[finite].max().item())
    log(f"[3 kernels] pooled forward {b}x{n}x{c_in}->{c} with NaN inputs: NaN "
        f"at the plain version's {int(nan_want.sum())} entries, at its argmax "
        f"(the first NaN); finite entries max abs err "
        f"{err[finite].max().item():.3e}")

    # the winner-only backward (m = 0, row = 0) through the running-
    # statistics chain's autograd Function, against the same Function
    # routed to the plain versions
    from pointcloudprocessing_tpu_torch.models.fused_pool import dense_bn_relu_max

    b, n = 8, 8192
    x = torch.relu(torch.randn(b, n, c_in, device=dev, generator=gen))
    w = torch.randn(c, c_in, device=dev, generator=gen) * 0.1
    scale = torch.rand(c, device=dev, generator=gen) + 0.5
    bias = torch.randn(c, device=dev, generator=gen) * 0.5
    r_mean = torch.randn(c, device=dev, generator=gen) * 0.5
    r_var = torch.rand(c, device=dev, generator=gen) * 4 + 1
    g_out = torch.randn(b, c, device=dev, generator=gen)

    def running_chain():
        leaves = [t.clone().requires_grad_() for t in (x, w, scale, bias)]
        pooled, _, _ = dense_bn_relu_max(*leaves, r_mean, r_var, 1e-3,
                                         use_running=True)
        (pooled * g_out).sum().backward()
        return pooled.detach(), [t.grad for t in leaves]

    launched = pooled_chain_backward.launches
    got_p, got_g = running_chain()
    launched = pooled_chain_backward.launches - launched
    with route_pooled(pooled_chain_forward_reference, pooled_chain_backward_reference):
        want_p, want_g = running_chain()
    torch.cuda.synchronize()
    errs = [(gk - gp).abs().max().item() for gk, gp in zip(got_g, want_g)]
    bars = [1e-5 * (1 + gp.abs().max().item()) for gp in want_g]
    if launched != 1 or not torch.equal(got_p, want_p) or any(
            e > bar for e, bar in zip(errs, bars)):
        raise AssertionError(
            f"running-statistics chain backward: {launched} kernel launches, "
            f"grad errs {errs} (bars {bars})")
    results["bwd_err"] = max(results["bwd_err"], *errs)
    log(f"[3 kernels] pooled backward, winner-only form (running-statistics "
        f"chain, {b}x{n}x{c_in}<-{c}): one kernel launch; max abs err dx "
        f"{errs[0]:.3e}, dweight {errs[1]:.3e}, dscale {errs[2]:.3e}, dbias "
        f"{errs[3]:.3e} (bars 1e-5 x (1 + max |grad|))")
    return results


@contextlib.contextmanager
def route_kernels(segment_sum, fps_with_points):
    """Point the slice's segment sum (the route between kernels 1 and 3) and
    FPS kernel wrapper at other functions (the plain versions, one kernel,
    or a recorder) while the block runs; for comparisons on the card only.
    The ops modules look them up at call time."""
    from pointcloudprocessing_tpu_torch.ops import fps as fps_mod
    from pointcloudprocessing_tpu_torch.ops import voxel as voxel_mod

    saved = (voxel_mod.monotone_segment_sum, fps_mod.monotone_segment_sum,
             fps_mod.fps_with_points)
    voxel_mod.monotone_segment_sum = segment_sum
    fps_mod.monotone_segment_sum = segment_sum
    fps_mod.fps_with_points = fps_with_points
    try:
        yield
    finally:
        (voxel_mod.monotone_segment_sum, fps_mod.monotone_segment_sum,
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

    share = busy_share(torch, lambda: list(fps_pipe.stream(feed(16))))
    log(f"[4 slice] device busy share over a profiled 16-batch stream: "
        f"{share} (union of device activity intervals / host wall time)")

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
            f"{name} {fmt(dev)} / {call:.4f}"
            for name, (dev, call) in stage_ms.items()))
    log("[4 slice] PointNet forward device ms by kernel kind: " + (", ".join(
        f"{kind} {ms:.4f}" for kind, ms in kinds.items()) or "not traced"))

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


def phase_serve(torch, rng, model, family: str = "pointnet",
                scan_width: int = 2048) -> None:
    """``serve.main`` over a stage of ``family`` holding ``model``'s weights:
    frames of 1900-2200 points at ``scan_width``, voxel 0.4, 1024 points."""
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
            "params": {"input_width": 1024, "epochs": 1, "patience": 1,
                       "batch_size": 4, "model": family},
        }
        with open(os.path.join(stage, "smoke_config.json"), "w") as f:
            json.dump(config, f)
        torch.save(model.state_dict(), os.path.join(stage, serve.WEIGHTS))
        out_path = os.path.join(tmp, "pred.jsonl")
        rc = serve.main([
            "--model", stage, "--input", os.path.join(tmp, "collect"),
            "--output", out_path, "--batch", "3", "--device", "cuda",
            "--voxel-size", "0.4", "--scan-width", str(scan_width),
        ])
        with open(out_path) as f:
            records = [json.loads(line) for line in f]
    if rc != 0 or len(records) != num_frames:
        raise AssertionError(f"serve rc {rc}, {len(records)} of {num_frames} records")
    for r in records:
        # the JAX serving CLI's record keys
        if set(r) != {"frame", "class", "part_counts", "se3"} \
                or r["class"] not in classes \
                or sum(r["part_counts"].values()) != 1024 \
                or np.asarray(r["se3"]).shape != (3, 3):
            raise AssertionError(f"bad record {r['frame']}")
    return (f"{len(records)} frames of a {family} stage served through "
            f"serve.main (voxel 0.4, {scan_width} -> 1024, batch 3: the last "
            "batch zero-padded, cuda)")


# ------------------------------------------------------------------ phase 6

@contextlib.contextmanager
def route_pooled(forward, backward):
    """Point the pooled chain's kernel wrappers at other functions (the
    plain versions) while the block runs; for comparisons on the card
    only. ``models/fused_pool.py`` looks them up at call time."""
    from pointcloudprocessing_tpu_torch.models import fused_pool

    saved = (fused_pool.pooled_chain_forward, fused_pool.pooled_chain_backward)
    fused_pool.pooled_chain_forward = forward
    fused_pool.pooled_chain_backward = backward
    try:
        yield
    finally:
        fused_pool.pooled_chain_forward, fused_pool.pooled_chain_backward = saved


def train_batch(torch, rng, b: int, n: int, classes: int, parts: int):
    """(b, n, 3) clouds in metres, each stretched along its own axes, with a
    part label per point that follows from its position (the azimuth
    sector), a random class per cloud and identity SE(3) targets."""
    x = rng.normal(size=(b, n, 3)) * rng.uniform(1.0, 15.0, (b, 1, 3))
    sector = (np.arctan2(x[..., 1], x[..., 0]) + np.pi) / (2 * np.pi) * parts
    dev = torch.device("cuda")
    targets = {
        "classification_output": torch.from_numpy(
            rng.integers(0, classes, b).astype(np.int64)).to(dev),
        "segmentation_output": torch.from_numpy(
            np.minimum(sector.astype(np.int64), parts - 1)).to(dev),
        "se3": torch.eye(3, device=dev).expand(b, 3, 3).contiguous(),
    }
    return torch.from_numpy(x.astype(np.float32)).to(dev), targets


def check_step_against_plain(torch, label, models, run_step, x, lr) -> dict:
    """One step of ``models[0]`` through the kernels and one of
    ``models[1]`` (a copy) through the plain versions, from the same state,
    batch and seed; ``models[2]``, a third copy, takes the plain step on
    the batch moved by one f32 ulp, which measures how far the step itself
    moves under rounding. Bars: each loss, gradient leaf, parameter and
    running statistic within 8x that one-ulp change plus a floor (a
    parameter whose gradient sign the one-ulp step leaves uncertain may
    differ by Adam's 2 lr)."""
    from pointcloudprocessing_tpu_torch.ops.cuda.pooled_chain import (
        pooled_chain_backward_reference,
        pooled_chain_forward_reference,
    )

    logs_k = run_step(0, x)
    with route_pooled(pooled_chain_forward_reference,
                      pooled_chain_backward_reference):
        logs_p = run_step(1, x)
        logs_u = run_step(2, torch.nextafter(x, torch.full_like(x, float("inf"))))
    worst = {"loss": 0.0, "grad": 0.0, "param": 0.0, "stat": 0.0}
    for key in ("loss", "classification_output_loss", "segmentation_output_loss",
                "se3_loss"):
        k, p, u = (float(logs[key]) for logs in (logs_k, logs_p, logs_u))
        bound = 8 * abs(p - u) + 1e-6 * abs(p) + 1e-7
        if abs(k - p) > bound:
            raise AssertionError(f"train {label}: {key} {k} through the kernels, "
                                 f"{p} plain (bar {bound:.3e})")
        worst["loss"] = max(worst["loss"], abs(k - p) / bound)
    named = [dict(m.named_parameters()) for m in models]
    for name, pk in named[0].items():
        pp, pu = named[1][name], named[2][name]
        gk, gp, gu = pk.grad, pp.grad, pu.grad
        if gp is None:  # frozen: no gradient, no update
            if gk is not None or gu is not None or not torch.equal(pk, pp):
                raise AssertionError(f"train {label}: frozen {name} took a "
                                     f"gradient or moved")
            continue
        sens = (gp - gu).abs().max()
        bound = 8 * sens + 1e-5 * gp.abs().max() + 1e-12
        err = (gk - gp).abs().max()
        if err > bound:
            raise AssertionError(f"train {label}: grad {name} differs by "
                                 f"{err.item():.3e} (bar {bound.item():.3e})")
        worst["grad"] = max(worst["grad"], (err / bound).item())
        certain = gp.abs() > 10 * sens
        perr = (pk - pp).abs()
        certain_err = perr[certain].max().item() if bool(certain.any()) else 0.0
        if certain_err > 1e-3 * lr or perr.max().item() > 2 * lr * (1 + 1e-3):
            raise AssertionError(f"train {label}: new {name} differs by "
                                 f"{perr.max().item():.3e}")
        worst["param"] = max(worst["param"], perr.max().item() / lr)
    buffers = [dict(m.named_buffers()) for m in models]
    for name, sk in buffers[0].items():
        sp, su = buffers[1][name], buffers[2][name]
        bound = 8 * (sp - su).abs().max() + 1e-6 + 1e-5 * sp.abs()
        if not bool(((sk - sp).abs() <= bound).all()):
            raise AssertionError(f"train {label}: running statistic {name} differs")
        worst["stat"] = max(worst["stat"], ((sk - sp).abs() / bound).max().item())
    return worst


def train_case(torch, rng, label: str, cfg, freeze, loss_weights, jitter_m,
               chains: int) -> dict:
    import copy

    from pointcloudprocessing_tpu_torch.models.factory import model_from_config
    from pointcloudprocessing_tpu_torch.ops.cuda.pooled_chain import (
        pooled_chain_backward,
        pooled_chain_forward,
    )
    from pointcloudprocessing_tpu_torch.train import steps

    b, n = cfg.batch_size, cfg.input_width
    seed = 0
    model = model_from_config(cfg, training=True, dropout_rate=0.3,
                              generator=torch.Generator().manual_seed(0),
                              device="cuda")
    models = [model, copy.deepcopy(model), copy.deepcopy(model)]
    runs = []
    for m in models:
        state, optimizer = steps.init_train_state(m, cfg.learning, freeze)
        runs.append((state, steps.make_train_step(
            m, optimizer, loss_weights, freeze, jitter_m)))
    lr = float(optimizer.learning_rate(0))
    x, targets = train_batch(torch, rng, b, n, cfg.num_classes, cfg.num_parts)

    def run_step(i, points):
        state, step = runs[i]
        _, logs = step(state, points, targets, seed)
        torch.cuda.synchronize()
        return logs

    worst = check_step_against_plain(torch, label, models, run_step, x, lr)
    log(f"[6 train] {label}: one step through the kernels vs the plain "
        f"versions (same state, batch, generators): worst error over its "
        f"bar: losses {worst['loss']:.3f}, grads {worst['grad']:.3f}, running "
        f"statistics {worst['stat']:.3f}; largest param difference "
        f"{worst['param']:.3f} lr (bars: 8x the plain step's own one-ulp "
        f"change + floors; params 1e-3 lr where the gradient sign is certain, "
        f"else 2 lr)")

    state, step = runs[0]
    num_steps = 30
    pooled_chain_forward.launches = 0
    pooled_chain_backward.launches = 0
    # ---- the main path: counted launches start here
    losses = []
    for _ in range(num_steps):
        state, logs = step(state, x, targets, seed)
        losses.append(logs["loss"])
    torch.cuda.synchronize()
    launches = {"fwd": pooled_chain_forward.launches,
                "bwd": pooled_chain_backward.launches}
    # ---- the main path ends here
    losses = [float(v) for v in losses]
    if launches != {"fwd": chains * num_steps, "bwd": chains * num_steps}:
        raise AssertionError(f"train {label}: pooled launches {launches}, want "
                             f"{chains} x {num_steps} each")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"train {label}: loss {losses[0]} -> {losses[-1]}")
    log(f"[6 train] {label}: {num_steps} steps on one batch: loss "
        f"{losses[0]:.5f} -> {losses[-1]:.5f}; pooled launches {launches} "
        f"({chains} chains x {num_steps} steps)")

    window, windows = 10, 3
    rates = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(window):
            state, logs = step(state, x, targets, seed)
        torch.cuda.synchronize()
        rates.append(window / (time.perf_counter() - t0))
    rate = float(np.median(rates))

    def steps_fn(count):
        def run():
            nonlocal state
            for _ in range(count):
                state, _ = step(state, x, targets, seed)
        return run

    share = busy_share(torch, steps_fn(5))
    kinds = kernel_breakdown(torch, steps_fn(3), calls=3)
    log(f"[6 train] {label}: train steps/s over {windows} windows of {window} "
        f"steps: " + ", ".join(f"{r:.3f}" for r in rates)
        + f"; median {rate:.3f} ({rate * b:.1f} clouds/s, spread "
        f"{(max(rates) - min(rates)) / rate:.4f}); device busy share "
        f"{share} over 5 steps")
    log(f"[6 train] {label}: device ms per step by kind: " + (", ".join(
        f"{kind} {ms:.4f}" for kind, ms in kinds.items())
        + f"; total {sum(kinds.values()):.4f}" if kinds else "not traced"))
    return {"launches": launches, "steps_per_s": rate, "kinds": kinds}


def phase_train(torch, rng) -> dict:
    from pointcloudprocessing_tpu_torch.core.config import (
        LearningConfig,
        load_config,
        parse_config,
    )
    from pointcloudprocessing_tpu_torch.models.pointnet import (
        FreezeFlags,
        freeze_flags_from_trainable,
    )

    # A: the users' configuration, kc46 `final` (seeded init, no checkpoint)
    cfg = load_config(os.path.join(REPO, KC46_CONFIG))
    stage = next(st for st in cfg.stages if st.name == "final")
    lw = stage.loss_weights
    a = train_case(
        torch, rng, f"A kc46 final ({'vanilla' if cfg.vanilla else 'full'} "
        f"{cfg.num_classes}/{cfg.num_parts}, {cfg.batch_size}x{cfg.input_width})",
        cfg, freeze_flags_from_trainable(stage.trainable),
        (lw.classification, lw.segmentation, lw.rotation), stage.noise.as_tuple(),
        chains=1)
    # B: the JAX bench's train-step row (bench.py:357-395)
    config_b = {
        "info": {"name": "bench_train",
                 "class_labels": {str(i): f"c{i}" for i in range(NUM_CLASSES)},
                 "part_labels": {str(i): f"p{i}" for i in range(NUM_PARTS)}},
        "params": {"input_width": 1024, "epochs": 1, "patience": 1,
                   "batch_size": 32, "regularize_input_transform": True,
                   "regularize_feature_transform": True},
    }
    cfg_b = parse_config(config_b)
    if cfg_b.learning != LearningConfig(rate=1e-4):
        raise AssertionError(f"case B's learning config {cfg_b.learning}")
    b = train_case(torch, rng, "B bench train (full 23/12, both regularizers, 32x1024)",
                   cfg_b, FreezeFlags(), (1.0, 1.0, 0.1), (0.01, 0.01, 0.01),
                   chains=3)
    return {"A": a, "B": b}


# ------------------------------------------------- phase 3: the slice's kernels

def surface_scans(rng, b: int = 2, n: int = 2048) -> np.ndarray:
    """The paraboloid of tests/test_preprocess_ops.py:364, offset to (50,
    -30, 5) m (f32 cancellation), as (b, n, 3) scans."""
    xy = rng.uniform(-10, 10, (b, n, 2)).astype(np.float32)
    z = 0.05 * (xy[..., 0] ** 2 + xy[..., 1] ** 2)
    pts = np.concatenate([xy, z[..., None]], axis=-1).astype(np.float32)
    return pts + np.array([50.0, -30.0, 5.0], np.float32)


def phase_window_kernel(torch, rng) -> dict:
    """Kernel 6 against its plain version on Morton-ordered voxel output at
    the two shapes the normals phase runs, on the JAX tests' edge cases, and
    on the inputs the PR 3 kernel refused or that reach each of its forms:
    a window past 14,336 candidates (streamed tiles), q_block 512, k from 1
    to 48 (every register bound, and the counting search above 32), a
    tie-heavy integer grid and 65,536 clouds (compared on slices of
    clouds). Count mismatches, the sums' error over the sum of their
    absolute terms, the normals' angle between the two, and launches."""
    from pointcloudprocessing_tpu_torch.ops.cuda.window_normals import (
        kernel_form,
        window_selection,
        windowed_moment_sums,
        windowed_moment_sums_reference,
    )
    from pointcloudprocessing_tpu_torch.ops.normals import (
        _covariance_normals,
        window_arguments,
    )
    from pointcloudprocessing_tpu_torch.ops.voxel import voxel_downsample_batch

    dev = torch.device("cuda")

    def voxel_case(scans, voxel, window):
        vox, mask = voxel_downsample_batch(torch.from_numpy(scans).to(dev), voxel,
                                           layout="bcn")
        return window_arguments(vox, mask, window)[1:]

    few = np.zeros((4, 256, 3), np.float32)
    few[:, :5, :2] = rng.uniform(-1, 1, (4, 5, 2))
    few[:, 5:] = 1e6
    few_mask = np.zeros((4, 256), bool)
    few_mask[:, :5] = True
    one = (rng.normal(size=(1, 512, 3)) * 50).astype(np.float32)
    one_mask = np.zeros((1, 512), bool)
    one_mask[0, 0] = True
    odd = rng.normal(size=(4, 490, 3)).astype(np.float32)
    grid = rng.integers(-6, 7, (4, 2048, 3)).astype(np.float32)
    grid_mask = rng.uniform(size=(4, 2048)) > 0.1
    small = rng.uniform(-1, 1, (65536, 384, 3)).astype(np.float32)

    def raw_case(pts, mask, window):
        planes = torch.from_numpy(np.ascontiguousarray(pts.transpose(0, 2, 1))).to(dev)
        return window_arguments(planes, torch.from_numpy(mask).to(dev), window)[1:]

    config2 = voxel_case(rng.uniform(-30, 30, (8, 8192, 3)).astype(np.float32), 0.5,
                         256)
    cases = [
        ("config 2: 8x8192 uniform(-30, 30), voxel 0.5, W 256", config2, 16),
        ("config 5: 256x2048 uniform(-20, 20), voxel 0.4, W 128",
         voxel_case(rng.uniform(-20, 20, (256, 2048, 3)).astype(np.float32), 0.4,
                    128), 16),
        ("surface offset to (50, -30, 5), voxel 0.5, W 256",
         voxel_case(surface_scans(rng), 0.5, 256), 16),
        ("5 valid points (< k) among 1e6 rows", raw_case(few, few_mask, 256), 16),
        ("one valid point", raw_case(one, one_mask, 128), 16),
        ("n = 490, padded to 512", raw_case(odd, np.ones((4, 490), bool), 256), 16),
        ("C 14,592 > 14,336: 2x16384 uniform(-30, 30), voxel 0.5, W 7168",
         voxel_case(rng.uniform(-30, 30, (2, 16384, 3)).astype(np.float32), 0.5,
                    7168), 16),
        ("q_block 512: config 2's voxel output", config2[:2] + (256, 512), 16),
        *((f"k {k}: config 2's voxel output", config2, k) for k in (1, 4, 8, 32, 48)),
        ("integer grid [-6, 6]^3, 10% invalid (ties at m * 2^s)",
         raw_case(grid, grid_mask, 256), 16),
        ("65,536 clouds of 384, uniform(-1, 1), W 128",
         raw_case(small, np.ones(small.shape[:2], bool), 128), 16),
    ]
    del small
    results = {"err": 0.0}
    for label, (centered, mask, window, q_block), k in cases:
        args = (centered, mask, k, window, q_block, "bcn")
        windowed_moment_sums.launches = 0
        got = torch.stack(windowed_moment_sums(*args))
        torch.cuda.synchronize()
        if windowed_moment_sums.launches != 1:
            raise AssertionError(f"window moments ({label}): "
                                 f"{windowed_moment_sums.launches} launches")
        b, _, n = centered.shape
        # the plain version's memory is b x blocks x Q x C: compare the
        # 65,536-cloud case on its first and last 256 clouds
        part = [slice(0, b)] if b <= 256 else [slice(0, 256), slice(b - 256, b)]
        mismatched = bad = 0
        rel = med = worst = 0.0
        for sl in part:
            sub = (centered[sl], mask[sl], k, window, q_block, "bcn")
            want = torch.stack(windowed_moment_sums_reference(*sub))
            gsub = got[:, sl]
            sel, feats = window_selection(*sub[:-1])
            abs_sums = torch.matmul(sel, feats.abs()).reshape(
                want.shape[1], n, 10).permute(2, 0, 1)
            del sel
            mismatched += int((gsub[0] != want[0]).sum())
            rel = max(rel, ((gsub - want).abs() / (abs_sums + 1e-30)).max().item())
            bad += int(((gsub - want).abs() > 2.0 ** -16 * abs_sums + 1e-6).sum())
            ng = torch.stack(_covariance_normals(gsub.unbind(0)), dim=-1)
            nw = torch.stack(_covariance_normals(want.unbind(0)), dim=-1)
            chord = torch.minimum((ng - nw).norm(dim=-1), (ng + nw).norm(dim=-1))
            ang = torch.rad2deg(2 * torch.asin(torch.clamp(chord.double() / 2,
                                                           max=1.0)))[mask[sl]]
            med, worst = max(med, ang.median().item()), max(worst, ang.max().item())
            results["err"] = max(results["err"], (gsub - want).abs().max().item())
            del want, abs_sums
        if mismatched or bad or med > 0.01:
            raise AssertionError(
                f"window moments ({label}): {mismatched} counts differ, {bad} sums "
                f"beyond 2^-16 of their absolute terms (worst {rel:.3e}), normals "
                f"median angle {med:.4f} deg")
        kernel = functools.partial(windowed_moment_sums, *args)
        ms = device_ms(torch, kernel, 10)
        kmax, tile = kernel_form(k, q_block, window)
        form = (f"registers {kmax}" if kmax else "counting search") + (
            f", one tile of {q_block + 2 * window}" if tile >= q_block + 2 * window
            else f", streamed tiles of {tile}")
        timing = f"; device ms kernel {fmt(ms)}"
        if label.startswith("config"):
            plain = functools.partial(windowed_moment_sums_reference, *args)
            plain_ms = device_ms(torch, plain, 3)
            per_call = (call_ms(torch, kernel, 10), call_ms(torch, plain, 3, 3))
            # what the function needs per query and candidate: the distance
            # once (8 flops), a compare for m, one for the k-th distance and
            # one for the selection; then 19 flops per selected candidate
            # (shift, 6 products, 10 sums)
            c = q_block + 2 * window
            bound = roofline(nbytes(centered, mask, got),
                             b * n * c * 11 + 19 * got[0].sum().item())
            timing += (f", plain {fmt(plain_ms)}; per call with launch kernel "
                       f"{per_call[0]:.4f}, plain {per_call[1]:.4f}; bound "
                       f"{bound[0]:.4f} ms ({bound[1]})")
            results["config 2" if label.startswith("config 2") else "config 5"] = (
                ms, plain_ms, bound)
        log(f"[3 kernels] window moments {b}x{n} k{k} Q{q_block} W{window} "
            f"({label}; {form}): counts identical ({int(mask.sum())} valid "
            f"queries" + (", 512 clouds compared" if len(part) > 1 else "")
            + f"), sums within {rel:.3e} of their absolute terms (bar 2^-16), "
            f"normals angle median {med:.2e} max {worst:.2e} deg, 1 launch"
            + timing)
        del got
    results["ms"], results["plain_ms"], results["bound"] = results["config 2"]
    return results


def check_bit_identical(torch, got, want) -> bool:
    """Equal values, and NaN exactly where the plain version has NaN."""
    nan = torch.isnan(want)
    return bool(torch.equal(torch.isnan(got), nan)
                and torch.equal(got[~nan], want[~nan]))


def phase_gather_kernel(torch, rng) -> dict:
    """Kernel 7 against its plain version at DGCNN's four edge widths (64x1024
    clouds, k 20, the graph of normal(0, 1) clouds), at w 3, 40 and 96 (no
    multiple of 32, or of the slice), with NaN in q, with k 1, and on clouds
    of 16,384 points (the L2 form): bit-identical, with the form each took."""
    from pointcloudprocessing_tpu_torch.models.dgcnn import knn_graph
    from pointcloudprocessing_tpu_torch.ops.cuda.gather_maxmin import (
        gather_form,
        gather_maxmin,
        gather_maxmin_reference,
    )

    dev = torch.device("cuda")
    b, n, k = 64, 1024, 20
    pts = torch.from_numpy(rng.normal(size=(b, n, 3)).astype(np.float32)).to(dev)
    graph = knn_graph(pts, k)
    big = 16384  # past the shared form's 14,528 points at S 4
    big_idx = torch.from_numpy(
        rng.integers(0, big, (4, big, k)).astype(np.int32)).to(dev)
    results = {"err": 0.0}
    for w, label in ((64, "layers 1-2"), (128, "layer 3"), (256, "layer 4"),
                     (3, "w 3"), (40, "w 40"), (96, "w 96"), (64, "NaN in q"),
                     (64, "k 1"), (64, "L2 form")):
        idx = {"k 1": graph[..., :1].contiguous(), "L2 form": big_idx}.get(label, graph)
        shape = (idx.shape[0], idx.shape[1], w)
        q = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
        if label == "NaN in q":
            q[0, idx[0, :8, 3].long(), 7] = float("nan")
        got = gather_maxmin(q, idx)
        want = gather_maxmin_reference(q, idx)
        torch.cuda.synchronize()
        cb, cn, ck = idx.shape
        name = f"{cb}x{cn}x{w} k{ck} ({label})"
        if not all(check_bit_identical(torch, g, wt) for g, wt in zip(got, want)):
            raise AssertionError(f"gather_maxmin {name} is not bit-identical to "
                                 "its plain version")
        for g, wt in zip(got, want):
            finite = ~torch.isnan(wt)
            results["err"] = max(results["err"],
                                 (g[finite] - wt[finite]).abs().max().item())
        kernel = functools.partial(gather_maxmin, q, idx)
        plain = functools.partial(gather_maxmin_reference, q, idx)
        reps = 3 if label == "L2 form" else 20
        ms, plain_ms = device_ms(torch, kernel, reps), device_ms(torch, plain, 3)
        per_call = (call_ms(torch, kernel, reps), call_ms(torch, plain, 3))
        # idx and q read once, both outputs written once; a compare per
        # gathered value for the max and one for the min
        bound = roofline(nbytes(q, idx, *got), 2 * cb * cn * ck * w)
        nans = int(torch.isnan(got[0]).sum())
        form, slice_ = gather_form(cb, cn, w)
        log(f"[3 kernels] gather_maxmin {name}, {form} form"
            + (f" S {slice_}" if slice_ else "") + ": bit-identical"
            + (f", NaN at the plain version's {nans} entries" if nans else "")
            + f"; device ms kernel {fmt(ms)}, plain {fmt(plain_ms)}; per call "
            f"with launch kernel {per_call[0]:.4f}, plain {per_call[1]:.4f}; "
            f"bound {bound[0]:.4f} ms ({bound[1]})")
        if label == "layer 4":
            results["ms"], results["plain_ms"], results["bound"] = ms, plain_ms, bound
        del q, got, want
    return results


# ----------------------------------------------------------- phase 7: normals

def phase_normals(torch, rng, model) -> dict:
    """The port's preprocess with normals: the config-2 shape through
    voxel_downsample_batch and the windowed normals (Mpts/s), the config-5
    composition of bench.py:470-482 (clouds/s), the normals' quality on the
    card, and kernel 6's launches (one a batch)."""
    from pointcloudprocessing_tpu_torch.ops.cuda.window_normals import (
        windowed_moment_sums,
    )
    from pointcloudprocessing_tpu_torch.ops.fps import (
        farthest_point_sample_and_gather,
    )
    from pointcloudprocessing_tpu_torch.ops.normals import estimate_normals_batch
    from pointcloudprocessing_tpu_torch.ops.voxel import voxel_downsample_batch

    dev = torch.device("cuda")
    b2, n2 = 8, 8192
    pool2 = [torch.from_numpy(rng.uniform(-30, 30, (b2, n2, 3)).astype(np.float32))
             .to(dev) for _ in range(4)]
    b5, n5, k5 = 256, 2048, 1024
    pool5 = [torch.from_numpy(rng.uniform(-20, 20, (b5, n5, 3)).astype(np.float32))
             .to(dev) for _ in range(2)]
    heads = ("classification_output", "se3")

    def preprocess(x):
        vox, mask = voxel_downsample_batch(x, 0.5, layout="bcn")
        return estimate_normals_batch(vox, k=16, valid_mask=mask, method="window",
                                      layout="bcn")

    def config5(x):
        vox, mask = voxel_downsample_batch(x, 0.4, layout="bcn")
        normals = estimate_normals_batch(vox, k=16, valid_mask=mask,
                                         method="window", window=128, layout="bcn")
        _, sampled = farthest_point_sample_and_gather(vox, k5, mask, layout="bcn")
        return model(sampled, heads=heads), normals

    def windows(fn, pool, count, size) -> list[float]:
        """Per-second rates of ``size`` units over three windows of
        ``count`` calls (host clock, ending in a synchronize)."""
        rates = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(count):
                fn(pool[i % len(pool)])
            torch.cuda.synchronize()
            rates.append(size * count / (time.perf_counter() - t0))
        return rates

    def spread(rates):
        return (max(rates) - min(rates)) / float(np.median(rates))

    results = {}
    with torch.inference_mode():
        normals = preprocess(pool2[0])  # warm-up
        out5, normals5 = config5(pool5[0])
        torch.cuda.synchronize()
        if normals.shape != (b2, 3, n2) or not bool(torch.isfinite(normals).all()):
            raise AssertionError("config-2 normals: wrong shape or non-finite")
        check_outputs_heads(torch, out5, b5, heads)
        if normals5.shape != (b5, 3, n5) or not bool(torch.isfinite(normals5).all()):
            raise AssertionError("config-5 normals: wrong shape or non-finite")

        count2, count5 = 60, 8
        windowed_moment_sums.launches = 0
        # ---- the normals path: counted launches start here
        rates2 = windows(preprocess, pool2, count2, b2 * n2 / 1e6)
        rates5 = windows(config5, pool5, count5, b5)
        torch.cuda.synchronize()
        launches = windowed_moment_sums.launches
        # ---- the normals path ends here
        if launches != 3 * (count2 + count5):
            raise AssertionError(f"kernel 6 launched {launches} times for "
                                 f"{3 * (count2 + count5)} batches")
        results["launches"] = launches
        share2 = busy_share(torch, lambda: [preprocess(pool2[i % 4]) for i in range(20)])
        kinds2 = kernel_breakdown(torch, lambda: [preprocess(pool2[i % 4])
                                                  for i in range(10)],
                                  calls=10, kinds=NORMALS_KINDS)
        per_batch2 = kernels_per_call(
            torch, lambda: [preprocess(pool2[i % 4]) for i in range(10)], 10)
        share5 = busy_share(torch, lambda: [config5(pool5[i % 2]) for i in range(4)])
        kinds5 = kernel_breakdown(torch, lambda: [config5(pool5[i % 2])
                                                  for i in range(2)],
                                  calls=2, kinds=NORMALS_KINDS)
    med2, med5 = float(np.median(rates2)), float(np.median(rates5))
    log(f"[7 normals] config 2, {b2}x{n2} uniform(-30, 30) -> voxel 0.5 -> window "
        f"normals k16 W256 (bcn): Mpts/s over 3 windows of {count2} batches: "
        + ", ".join(f"{r:.3f}" for r in rates2)
        + f"; median {med2:.3f}, spread {spread(rates2):.4f}; busy share {share2}"
        " over 20 batches")
    log("[7 normals] config 2 device ms per batch by kind: " + (", ".join(
        f"{kind} {ms:.4f}" for kind, ms in kinds2.items())
        + f"; total {sum(kinds2.values()):.4f}" if kinds2 else "not traced")
        + f"; device activities a batch: {per_batch2}")
    log(f"[7 normals] config 5, {b5}x{n5} uniform(-20, 20) -> voxel 0.4 -> window "
        f"normals k16 W128 -> FPS {k5} -> PointNet 23/12 (classification, se3): "
        f"clouds/s over 3 windows of {count5} batches: "
        + ", ".join(f"{r:.1f}" for r in rates5)
        + f"; median {med5:.1f}, spread {spread(rates5):.4f}; busy share {share5}"
        " over 4 batches")
    log("[7 normals] config 5 device ms per batch by kind: " + (", ".join(
        f"{kind} {ms:.4f}" for kind, ms in kinds5.items())
        + f"; total {sum(kinds5.values()):.4f}" if kinds5 else "not traced"))
    log(f"[7 normals] kernel 6 launches over the {3 * (count2 + count5)} timed "
        f"batches: {launches} (one a batch)")

    # quality on the card: window against exact normals on the offset surface
    scans = torch.from_numpy(surface_scans(rng)).to(dev)
    vox, mask = voxel_downsample_batch(scans, 0.5)
    vp = torch.tensor([[50.0, -30.0, 500.0]] * 2, device=dev)
    with torch.inference_mode():
        nw = estimate_normals_batch(vox, 16, mask, vp, method="window")
        ne = estimate_normals_batch(vox, 16, mask, vp, method="exact")
    chord = torch.minimum((nw - ne).norm(dim=-1), (nw + ne).norm(dim=-1))
    ang = torch.rad2deg(2 * torch.asin(torch.clamp(chord.double() / 2, max=1.0)))[mask]
    med, p95 = ang.median().item(), torch.quantile(ang, 0.95).item()
    if not (med < 1.0 and p95 < 5.0):
        raise AssertionError(f"window vs exact normals: median {med:.3f}, p95 "
                             f"{p95:.3f} deg (bars 1 and 5)")
    log(f"[7 normals] window vs exact normals on the offset surface "
        f"({int(mask.sum())} points): median {med:.4f} deg, p95 {p95:.4f} deg "
        "(bars 1, 5)")
    results.update(mpts_per_s=med2, clouds_per_s=med5)
    return results


def check_outputs_heads(torch, out: dict, b: int, heads) -> None:
    if set(out) != set(heads):
        raise AssertionError(f"heads {sorted(out)} != {sorted(heads)}")
    for name, t in out.items():
        if t.shape[0] != b or not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name}: batch {t.shape[0]} or non-finite values")


# ------------------------------------------------------------- phase 8: DGCNN

@contextlib.contextmanager
def route_gather(fn):
    """Point the DGCNN edge block's gather_maxmin at another function (the
    plain version) while the block runs; for comparisons on the card only."""
    from pointcloudprocessing_tpu_torch.models import dgcnn as dgcnn_mod

    saved = dgcnn_mod.gather_maxmin
    dgcnn_mod.gather_maxmin = fn
    try:
        yield
    finally:
        dgcnn_mod.gather_maxmin = saved


@contextlib.contextmanager
def record_knn():
    """Record (features, graph) of every DGCNN kNN graph built in the block."""
    from pointcloudprocessing_tpu_torch.models import dgcnn as dgcnn_mod

    real, met = dgcnn_mod.knn_graph, []

    def recording(feats, k):
        idx = real(feats, k)
        met.append((feats, idx))
        return idx

    dgcnn_mod.knn_graph = recording
    try:
        yield met
    finally:
        dgcnn_mod.knn_graph = real


def phase_dgcnn(torch, rng) -> dict:
    """DGCNN 23/12 at full width (edge widths 64, 64, 128, 256, embedding
    1024, k 20, f32, seeded init) built by model_from_config from a config
    with "model": "dgcnn", at bench.py:135-165's shape (64x1024 normal(0, 1)
    clouds), dynamic and static graph: kernel 7 against the plain version and
    the literal edge dataflow, rates, busy share, device ms by kind, and one
    PointCloudPipeline stream."""
    from pointcloudprocessing_tpu_torch.core.config import parse_config
    from pointcloudprocessing_tpu_torch.models import dgcnn as dgcnn_mod
    from pointcloudprocessing_tpu_torch.models.factory import model_from_config
    from pointcloudprocessing_tpu_torch.models.pipeline import PointCloudPipeline
    from pointcloudprocessing_tpu_torch.ops.cuda.gather_maxmin import (
        gather_maxmin,
        gather_maxmin_reference,
    )

    dev = torch.device("cuda")
    b, n = 64, 1024
    x = torch.from_numpy(rng.normal(size=(b, n, 3)).astype(np.float32)).to(dev)
    results = {"launches": 0}
    for graph in ("dynamic", "static"):
        cfg = parse_config({
            "info": {"name": "smoke_dgcnn",
                     "class_labels": {str(i): f"c{i}" for i in range(NUM_CLASSES)},
                     "part_labels": {str(i): f"p{i}" for i in range(NUM_PARTS)}},
            "params": {"input_width": n, "epochs": 1, "patience": 1,
                       "batch_size": b, "model": "dgcnn",
                       "model_options": {"graph": graph}},
        })
        # the same seed gives both graph modes the same weights
        model = model_from_config(cfg, generator=torch.Generator().manual_seed(0))
        model.eval()
        edges = [m for m in model.modules() if isinstance(m, dgcnn_mod.EdgeConv)]
        if next(model.parameters()).device.type != "cuda" or len(edges) != 4:
            raise AssertionError("model_from_config did not build DGCNN on the card")
        with torch.inference_mode():
            model(x)  # warm-up
            count = 10
            gather_maxmin.launches = 0
            # ---- the DGCNN path: counted launches start here
            rates = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(count):
                    out = model(x)
                torch.cuda.synchronize()
                rates.append(b * count / (time.perf_counter() - t0))
            launches = gather_maxmin.launches
            # ---- the DGCNN path ends here
            if launches != 4 * 3 * count:
                raise AssertionError(f"DGCNN {graph}: kernel 7 launched {launches} "
                                     f"times in {3 * count} forwards (4 each)")
            results["launches"] += launches
            check_outputs(torch, out, b, n)
            with route_gather(gather_maxmin_reference):
                plain = model(x)
            with record_knn() as met:
                model(x)
            for e in edges:
                e.impl = "reference"
            with record_knn() as met_literal:
                literal = model(x)
            for e in edges:
                e.impl = "auto"
            torch.cuda.synchronize()
            same = all(torch.equal(out[key], plain[key]) for key in out)
            diffs = {key: (out[key] - literal[key]).abs().max().item() for key in out}
            seg_rows = ((out["segmentation_output"] - literal["segmentation_output"])
                        .abs().amax(-1) > 1e-4).float().mean().item()
            # rows whose neighbour set differs between the two dataflows' graphs
            swaps = [int((a.sort(-1).values != c.sort(-1).values).any(-1).sum())
                     for (_, a), (_, c) in zip(met, met_literal)]
            if not same:
                raise AssertionError(f"DGCNN {graph}: factored path through kernel 7 "
                                     "differs from the one through its plain version")
            # static: one graph, so every head within the parity bar. Dynamic:
            # each layer's graph is rebuilt from features the two dataflows
            # round differently, so a near-tie can swap a neighbour (counted
            # in `swaps`), which moves that point's segmentation row; the
            # pooled classification stays within the bar
            if diffs["classification_output"] > 1e-4 or (
                    graph == "static" and max(diffs.values()) > 1e-4) or (
                    seg_rows > 1e-3):
                raise AssertionError(f"DGCNN {graph}: factored vs literal edge "
                                     f"dataflow differ by {diffs}, {seg_rows:.5f} "
                                     "of the segmentation rows beyond 1e-4")
            share = busy_share(torch, lambda: [model(x) for _ in range(3)])
            kinds = kernel_breakdown(torch, lambda: [model(x) for _ in range(2)],
                                     calls=2, kinds=DGCNN_KINDS)
            per_forward = kernels_per_call(torch, lambda: [model(x) for _ in range(2)], 2)
            # the distance GEMMs alone: each EdgeConv's kNN matmul on the
            # features it met
            feats = [f.float() for f, _ in met]
            dist_ms = device_ms(torch, lambda: [torch.matmul(f, f.transpose(1, 2))
                                                for f in feats], 3)
        rate = float(np.median(rates))
        log(f"[8 dgcnn] DGCNN 23/12 f32 k20 {graph} graph, {b}x{n} normal(0, 1): "
            f"clouds/s over 3 windows of {count} forwards: "
            + ", ".join(f"{r:.1f}" for r in rates)
            + f"; median {rate:.1f}, spread {(max(rates) - min(rates)) / rate:.4f}; "
            f"busy share {share} over 3 forwards; kernel 7 launches {launches} "
            f"(4 a forward)")
        log(f"[8 dgcnn] {graph}: through kernel 7 vs its plain version: "
            f"bit-identical; vs the literal edge dataflow: max abs diff "
            + ", ".join(f"{k} {v:.3e}" for k, v in diffs.items())
            + f"; segmentation rows beyond 1e-4: {seg_rows:.5f}; kNN rows with "
            f"another neighbour set, by layer: {swaps}")
        if kinds:
            gemm_rest = kinds["gemm"] - (dist_ms or 0.0)
            log(f"[8 dgcnn] {graph}: device ms per forward by kind: distance GEMM "
                f"{fmt(dist_ms)} ({len(feats)} kNN graphs), other GEMM "
                f"{gemm_rest:.4f}, " + ", ".join(
                    f"{kind} {ms:.4f}" for kind, ms in kinds.items() if kind != "gemm")
                + f"; total {sum(kinds.values()):.4f}; device activities a "
                f"forward: {per_forward}")
        else:
            log(f"[8 dgcnn] {graph}: device ms by kind: not traced")
        results[graph] = rate

    # one stream through the pipeline: voxel 0.4 -> FPS -> 1024 -> DGCNN
    pipe = PointCloudPipeline(model, scan_width=2048, model_width=n, voxel_size=0.4)
    batches = [rng.uniform(-20, 20, (b, 2048, 3)).astype(np.float32) for _ in range(3)]
    before = gather_maxmin.launches
    outs = list(pipe.stream(iter(batches)))
    torch.cuda.synchronize()
    streamed = gather_maxmin.launches - before
    results["launches"] += streamed
    if len(outs) != 3 or streamed != 12:
        raise AssertionError(f"DGCNN stream: {len(outs)} batches, {streamed} launches")
    for o in outs:
        check_outputs(torch, o, b, n)
    log(f"[8 dgcnn] PointCloudPipeline.stream over 3 batches of {b}x2048 "
        f"(voxel 0.4 -> FPS -> {n} -> DGCNN, static graph): outputs ok, kernel 7 "
        f"launches {streamed}")
    return results


# ------------------------------------- phase 9: PointNet++ and kernel 3

PN2_KINDS = (("fps", ("fps_kernel",)), ("topk", ("topk", "sort", "radix")),
             ("gather", ("gather", "scatter", "index")), ("gemm", ("gemm",)),
             ("argmin/reduce", ("reduce", "argmin")),
             ("elementwise", ("elementwise",)))

#: a rank outside [0, n) must trap in the any-rank kernel; run in a child
#: process, since a trap loses the CUDA context
TRAP_PROBE = """
import sys
import torch
sys.path.insert(0, REPO)
from pointcloudprocessing_tpu_torch.ops.cuda.voxel_reduce import segment_reduce
data = torch.ones(2, 200, 4, device="cuda")
rank = torch.zeros(2, 200, dtype=torch.int32, device="cuda")
rank[1, 17] = 200
try:
    segment_reduce(data, rank)
    torch.cuda.synchronize()
except RuntimeError as e:
    print("raised:", str(e).splitlines()[0])
    sys.exit(0)
print("no error")
sys.exit(3)
"""


def segment_bar(torch, data, rank):
    """The bar between two f32 sums of the same segments in other orders:
    2^-20 of the sum of the absolute terms, or, for a segment of k > 9 rows,
    the recursive-summation bound 2 (k - 1) 2^-24 of it."""
    from pointcloudprocessing_tpu_torch.ops.cuda.voxel_reduce import (
        segment_reduce_reference,
    )

    terms = segment_reduce_reference(data.abs(), rank)
    rows = segment_reduce_reference(torch.ones_like(data[..., :1]), rank)
    return torch.clamp(2 * (rows - 1) * 2.0 ** -24, min=2.0 ** -20) * terms


def phase_any_rank_kernel(torch, rng) -> dict:
    """Kernel 3 against its plain version: bit-identical to the plain version
    run on a CPU copy (both add a segment's rows in row order), and within
    segment_bar of the CUDA plain version (atomics, any order); the trap
    probe in a child process."""
    from pointcloudprocessing_tpu_torch.ops.cuda.fps import fps_with_points_reference
    from pointcloudprocessing_tpu_torch.ops.cuda.voxel_reduce import (
        segment_reduce,
        segment_reduce_reference,
    )
    from pointcloudprocessing_tpu_torch.ops.fps import stride_sample_and_gather
    from pointcloudprocessing_tpu_torch.ops.voxel import voxel_downsample_batch

    dev = torch.device("cuda")

    def gen(b, n, d, scale=30.0, high=None):
        data = torch.from_numpy((rng.normal(size=(b, n, d)) * scale)
                                .astype(np.float32)).to(dev)
        rank = torch.from_numpy(rng.integers(0, high or n, (b, n))
                                .astype(np.int32)).to(dev)
        return data, rank

    cases = []
    # the segment sums of the path at 256x2000, captured as phase 3 does
    for kind in ("uniform", "padded"):
        captured = []

        def record(data, rank):
            captured.append((data.clone(), rank.clone()))
            return segment_reduce_reference(data, rank)

        with route_kernels(record, fps_with_points_reference):
            x = torch.from_numpy(scan_batch(rng, kind, 256, 2000)).to(dev)
            vox, vmask = voxel_downsample_batch(x, 0.4)
            stride_sample_and_gather(vox, 1024, vmask)
        cases += [(f"main-path {kind} voxel", *captured[0]),
                  (f"main-path {kind} stride", *captured[1])]
    cases += [("any order, 30x", *gen(256, 2000, 4)),
              ("any order, 30x", *gen(256, 2000, 5)),
              ("any order, 30x", *gen(8, 8000, 4)),
              ("n = 1", *gen(4, 1, 4)), ("n = 490, d = 1", *gen(4, 490, 1)),
              ("n = 490, d = 8", *gen(4, 490, 8))]
    data, _ = gen(8, 2000, 4)
    cases.append(("all rows in one segment", data,
                  torch.full((8, 2000), 7, dtype=torch.int32, device=dev)))
    data, rank = gen(8, 2000, 4, high=500)
    cases.append(("three quarters of the segments empty", data, rank * 4))
    data, rank = gen(8, 2000, 4)
    data[3, 777, 2] = float("nan")
    cases.append(("one NaN row", data, rank))
    # one cloud; and past the shared-memory form (segment_sum_form)
    cases.append(("b = 1, any order", *gen(1, 2000, 4)))
    cases.append(("any order, device-memory form", *gen(4, 40000, 4)))
    data, rank = gen(4, 40000, 4)
    cases.append(("sorted, device-memory form", data, rank.sort(dim=1).values))
    data, _ = gen(4, 40000, 4)
    cases.append(("all rows in one segment, device-memory form", data,
                  torch.full((4, 40000), 39999, dtype=torch.int32, device=dev)))

    results = {"err": 0.0}
    for label, data, rank in cases:
        b, n, d = data.shape
        got = segment_reduce(data, rank)
        want_cpu = segment_reduce_reference(data.cpu(), rank.cpu())
        want = segment_reduce_reference(data, rank)
        bar = segment_bar(torch, data, rank)
        torch.cuda.synchronize()
        nan = torch.isnan(want)
        ok = (check_bit_identical(torch, got.cpu(), want_cpu)
              and torch.equal(torch.isnan(got), nan)
              and bool(((got - want).abs()[~nan] <= bar[~nan]).all()))
        if label == "one NaN row":
            ok = ok and int(nan.any(-1).sum()) == 1
        if not ok:
            raise AssertionError(
                f"segment_reduce {b}x{n}x{d} ({label}) is not bit-identical to "
                "its plain version on a CPU copy, or beyond the bar of the "
                "CUDA plain version")
        err = (got - want).abs()[~nan].max().item()
        results["err"] = max(results["err"], (got.cpu() - want_cpu).abs()[
            ~torch.isnan(want_cpu)].max().item())
        line = (f"[9 pointnet2] segment_reduce {b}x{n}x{d} ({label}): "
                f"bit-identical to the plain version on a CPU copy; vs the CUDA "
                f"plain version max abs diff {err:.3e} (bar segment_bar)")
        if b * n >= 64000:
            kernel = functools.partial(segment_reduce, data, rank)
            plain = functools.partial(segment_reduce_reference, data, rank)
            index = rank.long()[..., None].expand(-1, -1, d)

            def library():
                return torch.zeros_like(data).scatter_add_(1, index, data)

            ms, plain_ms = device_ms(torch, kernel, 20), device_ms(torch, plain, 20)
            lib_ms = device_ms(torch, library, 20)
            per_call = (call_ms(torch, kernel, 20), call_ms(torch, plain, 20))
            # each row read once with its rank, each output row written once;
            # one add a value
            bound = roofline(nbytes(data, rank, got), data.numel())
            line += (f"; device ms kernel {fmt(ms)}, plain {fmt(plain_ms)}, "
                     f"scatter_add_ {fmt(lib_ms)}, bound {bound[0]:.4f} "
                     f"({bound[1]}); per call with launch kernel "
                     f"{per_call[0]:.4f}, plain {per_call[1]:.4f}")
            if label == "main-path uniform voxel":
                results.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                               bound=bound)
        log(line)
    probe = subprocess.run([sys.executable, "-c", f"REPO = {REPO!r}\n" + TRAP_PROBE],
                           capture_output=True, text=True, timeout=300)
    if probe.returncode != 0:
        raise AssertionError(f"trap probe: rc {probe.returncode}, "
                             f"{probe.stdout.strip()} {probe.stderr[-500:]}")
    log(f"[9 pointnet2] segment_reduce with a rank outside [0, n), in a child "
        f"process: {probe.stdout.strip()}; ranks in any order never trapped")
    return results


@contextlib.contextmanager
def pointnet2_fps(method: str, picks: list):
    """Route PointNet++'s FPS through ``farthest_point_sample_batch(...,
    method=method)`` ('auto': the kernel on the card; 'stream': the plain
    version) and record its picks, while the block runs."""
    from pointcloudprocessing_tpu_torch.models import pointnet2 as pn2_mod

    real = pn2_mod.farthest_point_sample_batch

    def recording(xyz, m):
        idx = real(xyz, m, method=method)
        picks.append(idx)
        return idx

    pn2_mod.farthest_point_sample_batch = recording
    try:
        yield
    finally:
        pn2_mod.farthest_point_sample_batch = real


def close_heads(torch, got: dict, want: dict) -> tuple[dict, float]:
    """Max abs difference per head, and the share of segmentation rows
    beyond 1e-4 (moved by a kNN or radius-mask flip)."""
    diffs = {k: (got[k].cpu() - want[k].cpu()).abs().max().item() for k in got}
    rows = ((got["segmentation_output"].cpu() - want["segmentation_output"].cpu())
            .abs().amax(-1) > 1e-4).float().mean().item()
    return diffs, rows


def phase_pointnet2(torch, rng) -> dict:
    """PointNet++ 23/12 at full width (the canonical SSG model of
    ``pointnet2_for_width(23, 12, 1024)``, f32, seeded) from a config with
    "model": "pointnet2": (b) the segment-sum route at 256x2000 and
    256x2048; (c) 256x1024 normal(0, 1) clouds (bench.py:118-120) through
    the FPS kernel against the same through its plain version, and a CPU
    twin on 2 clouds; rates, busy share, device ms by kind; (d) the serving
    pipeline at 256x2000 (no multiple of 128) with both samplers; (e) the
    serve CLI over a PointNet++ stage at scan width 2000."""
    from pointcloudprocessing_tpu_torch.core.config import parse_config
    from pointcloudprocessing_tpu_torch.models.factory import model_from_config
    from pointcloudprocessing_tpu_torch.models.pipeline import PointCloudPipeline
    from pointcloudprocessing_tpu_torch.models.pointnet2 import (
        PointNet2,
        pointnet2_for_width,
    )
    from pointcloudprocessing_tpu_torch.ops.cuda.fps import fps_with_points
    from pointcloudprocessing_tpu_torch.ops.cuda.voxel_reduce import (
        segment_reduce,
        sorted_segment_reduce,
    )
    from pointcloudprocessing_tpu_torch.ops.fps import stride_sample_and_gather
    from pointcloudprocessing_tpu_torch.ops.voxel import voxel_downsample_batch

    dev = torch.device("cuda")
    results = {}

    def counts():
        return {"any": segment_reduce.launches, "sorted": sorted_segment_reduce.launches,
                "fps": fps_with_points.launches}

    def zero_counts():
        segment_reduce.launches = sorted_segment_reduce.launches = 0
        fps_with_points.launches = 0

    # (b) the route: a voxel step and a stride sample per width
    for n, want in ((2000, {"any": 2, "sorted": 0}), (2048, {"any": 0, "sorted": 2})):
        x = torch.from_numpy(scan_batch(rng, "uniform", 256, n)).to(dev)
        zero_counts()
        vox, vmask = voxel_downsample_batch(x, 0.4)
        stride_sample_and_gather(vox, 1024, vmask)
        torch.cuda.synchronize()
        got = {k: v for k, v in counts().items() if k != "fps"}
        if got != want:
            raise AssertionError(f"route at 256x{n}: launches {got}, want {want}")
        if n == 2000:
            with route_kernels(sorted_segment_reduce, fps_with_points):
                forced, fmask = voxel_downsample_batch(x, 0.4)
            if not torch.equal(vmask, fmask) or not bool(
                    ((vox - forced).abs() <= 1e-6 * forced.abs()).all()):
                raise AssertionError("voxel output at 256x2000 through kernel 3 "
                                     "differs from the same through kernel 1")
    log("[9 pointnet2] route: a voxel step + a stride sample launch kernel 3 "
        "twice and kernel 1 never at 256x2000, the reverse at 256x2048; at "
        "256x2000 the voxel output through kernel 3 equals the same through "
        "kernel 1 forced (masks identical, centroids within 1e-6 relative)")

    # (c) PointNet++ at 256x1024
    cfg = parse_config({
        "info": {"name": "smoke_pointnet2",
                 "class_labels": {str(i): f"c{i}" for i in range(NUM_CLASSES)},
                 "part_labels": {str(i): f"p{i}" for i in range(NUM_PARTS)}},
        "params": {"input_width": 1024, "epochs": 1, "patience": 1,
                   "batch_size": 256, "model": "pointnet2"},
    })
    model = model_from_config(cfg, generator=torch.Generator().manual_seed(0))
    model.eval()
    if not isinstance(model, PointNet2) or next(model.parameters()).device.type != "cuda" \
            or (model.sa1.num_centroids, model.sa1.k, model.sa2.num_centroids,
                model.sa2.k) != (512, 32, 128, 64):
        raise AssertionError("model_from_config did not build the canonical "
                             "PointNet++ on the card")
    b, n = 256, 1024
    x = torch.from_numpy(rng.normal(size=(b, n, 3)).astype(np.float32)).to(dev)
    count = 6
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        model(x)  # warm-up
        fps_with_points.launches = 0
        # ---- the PointNet++ path: counted launches start here
        rates = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(count):
                out = model(x)
            torch.cuda.synchronize()
            rates.append(b * count / (time.perf_counter() - t0))
        launches = fps_with_points.launches
        # ---- the PointNet++ path ends here
        if launches != 2 * 3 * count:
            raise AssertionError(f"PointNet++: FPS launched {launches} times in "
                                 f"{3 * count} forwards (2 each)")
        results["fps_launches"] = launches
        check_outputs(torch, out, b, n)
        picks_k, picks_p = [], []
        with pointnet2_fps("auto", picks_k):
            through = model(x)
        with pointnet2_fps("stream", picks_p):
            plain = model(x)
        torch.cuda.synchronize()
        if len(picks_k) != 2 or not all(torch.equal(a, c) for a, c in
                                        zip(picks_k, picks_p)):
            raise AssertionError("PointNet++: FPS picks through the kernel differ "
                                 "from the plain version's")
        diffs, _ = close_heads(torch, through, plain)
        bitwise = all(torch.equal(through[k], plain[k]) for k in through)
        if max(diffs.values()) > 1e-6:
            raise AssertionError(f"PointNet++ through the FPS kernel vs its plain "
                                 f"version: {diffs}")
        # a CPU twin on two clouds, both with the plain FPS (the CPU's default
        # distance-matrix FPS rounds distances another way)
        twin = pointnet2_for_width(NUM_CLASSES, NUM_PARTS, n, device="cpu")
        twin.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        twin.eval()
        with pointnet2_fps("stream", []):
            small_gpu = model(x[:2])
            small_cpu = twin(x[:2].cpu())
        cpu_diffs, cpu_rows = close_heads(torch, small_gpu, small_cpu)
        if cpu_diffs["classification_output"] > 1e-4 or cpu_rows > 1e-3:
            raise AssertionError(f"PointNet++ on the card vs its CPU twin: "
                                 f"{cpu_diffs}, {cpu_rows:.5f} of the rows beyond 1e-4")
        share = busy_share(torch, lambda: [model(x) for _ in range(3)])
        kinds = kernel_breakdown(torch, lambda: [model(x) for _ in range(2)],
                                 calls=2, kinds=PN2_KINDS)
        per_forward = kernels_per_call(torch, lambda: [model(x) for _ in range(2)], 2)
        peak = torch.cuda.max_memory_allocated() / 2**30
    rate = float(np.median(rates))
    results["clouds_per_s"] = rate
    log(f"[9 pointnet2] PointNet++ 23/12 f32 SSG (512/32/0.2, 128/64/0.4), "
        f"{b}x{n} normal(0, 1): clouds/s over 3 windows of {count} forwards: "
        + ", ".join(f"{r:.1f}" for r in rates)
        + f"; median {rate:.1f}, spread {(max(rates) - min(rates)) / rate:.4f}; "
        f"busy share {share} over 3 forwards; FPS launches {launches} (2 a "
        f"forward); peak allocated {peak:.2f} GiB")
    log(f"[9 pointnet2] through the FPS kernel vs its plain version: picks "
        f"identical, heads {'bit-identical' if bitwise else 'max abs diff ' + str(diffs)}"
        f"; card vs CPU twin on 2 clouds: " + ", ".join(
            f"{k} {v:.3e}" for k, v in cpu_diffs.items())
        + f", segmentation rows beyond 1e-4: {cpu_rows:.5f}")
    log("[9 pointnet2] device ms per forward by kind: " + (", ".join(
        f"{kind} {ms:.4f}" for kind, ms in kinds.items())
        + f"; total {sum(kinds.values()):.4f}; device activities a forward: "
        f"{per_forward}" if kinds else "not traced"))

    # (d) serving at a width that does not tile: 2000 = 15 * 128 + 80
    scan = 2000
    pool = [scan_batch(rng, "uniform", b, scan) for _ in range(3)]
    pool.append(scan_batch(rng, "padded", b, scan))
    window = 6

    def feed(count: int):
        return (pool[i % len(pool)] for i in range(count))

    any_launches = 0
    for sampler, per_batch in (("fps", {"any": 1, "sorted": 0, "fps": 3}),
                               ("stride", {"any": 2, "sorted": 0, "fps": 2})):
        pipe = PointCloudPipeline(model, scan_width=scan, model_width=n,
                                  voxel_size=0.4, sampler=sampler)
        warm = list(pipe.stream(feed(2)))
        zero_counts()
        # ---- the serving path: counted launches start here
        rates, outs = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = list(pipe.stream(feed(window)))
            torch.cuda.synchronize()
            rates.append(b * len(got) / (time.perf_counter() - t0))
            outs += got
        launched = counts()
        # ---- the serving path ends here
        want = {k: v * 3 * window for k, v in per_batch.items()}
        if launched != want or len(outs) != 3 * window:
            raise AssertionError(f"PointNet++ serving ({sampler}): launches "
                                 f"{launched} over {len(outs)} batches, want {want}")
        any_launches += launched["any"]
        results["fps_launches"] += launched["fps"]
        for o in [*warm, *outs]:
            check_outputs(torch, o, b, n)
        share = busy_share(torch, lambda: list(pipe.stream(feed(4))))
        rate = float(np.median(rates))
        results[f"serve_{sampler}"] = rate
        log(f"[9 pointnet2] serving {b}x{scan} -> voxel 0.4 -> {sampler} -> {n} "
            f"-> PointNet++ (uniform and padded batches): clouds/s over 3 "
            f"windows of {window} batches: " + ", ".join(f"{r:.1f}" for r in rates)
            + f"; median {rate:.1f}, spread {(max(rates) - min(rates)) / rate:.4f}"
            f"; busy share {share} over 4 batches; launches a batch: kernel 3 "
            f"{per_batch['any']}, kernel 1 0, FPS {per_batch['fps']}")
    results["any_launches"] = any_launches

    # (e) the serve CLI over a PointNet++ stage at scan width 2000
    log(f"[9 pointnet2] {phase_serve(torch, rng, model, 'pointnet2', scan)}")
    return results


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
    pooled = phase_pooled_kernels(torch)
    window = phase_window_kernel(torch, rng)
    gather = phase_gather_kernel(torch, rng)
    model = PointNet(NUM_CLASSES, NUM_PARTS,
                     generator=torch.Generator().manual_seed(0), device="cuda")
    model.eval()
    sliced = phase_slice(torch, rng, model)
    log(f"[5 serve] {phase_serve(torch, rng, model)}")
    trained = phase_train(torch, rng)
    normals = phase_normals(torch, rng, model)
    dgcnn = phase_dgcnn(torch, rng)
    any_rank = phase_any_rank_kernel(torch, rng)
    pn2 = phase_pointnet2(torch, rng)
    pooled_launches = {
        k: trained["A"]["launches"][k] + trained["B"]["launches"][k]
        for k in ("fwd", "bwd")}

    def entry(name, source, replaces, launches, err, ms, plain_ms, bound,
              library_ms=None) -> dict:
        traced = ms is not None and plain_ms is not None
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches, "max_abs_err": err,
                "ms": ms if traced else None,
                "plain_ms": plain_ms if traced else None,
                "ms_source": "torch.profiler device rows" if traced else "not traced",
                "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": library_ms}

    log(json.dumps({"kernels": [
        entry("sorted_segment_sum", SEG_SUM_SRC, SEG_SUM_TPU,
              sliced["launches"]["seg"], kernels["seg_err"], kernels["seg_ms"],
              kernels["seg_plain_ms"], kernels["seg_bound"],
              kernels["seg_library_ms"]),
        entry("fps_with_points", FPS_SRC, FPS_TPU,
              sliced["launches"]["fps"] + pn2["fps_launches"],
              kernels["fps_err"], kernels["fps_ms"], kernels["fps_plain_ms"],
              kernels["fps_bound"]),
        entry("pooled_chain_forward", POOLED_SRC, POOLED_FWD_TPU,
              pooled_launches["fwd"], pooled["fwd_err"], pooled["fwd_ms"],
              pooled["fwd_plain_ms"], pooled["fwd_bound"]),
        entry("pooled_chain_backward", POOLED_SRC, POOLED_BWD_TPU,
              pooled_launches["bwd"], pooled["bwd_err"], pooled["bwd_ms"],
              pooled["bwd_plain_ms"], pooled["bwd_bound"]),
        entry("windowed_moment_sums", WINDOW_SRC, WINDOW_TPU, normals["launches"],
              window["err"], window["ms"], window["plain_ms"], window["bound"]),
        entry("gather_maxmin", GATHER_SRC, GATHER_TPU, dgcnn["launches"],
              gather["err"], gather["ms"], gather["plain_ms"], gather["bound"]),
        entry("segment_reduce", SEG_SUM_SRC, SEG_ANY_TPU, pn2["any_launches"],
              any_rank["err"], any_rank["ms"], any_rank["plain_ms"],
              any_rank["bound"], any_rank["library_ms"]),
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
