"""Hardware acceptance checks of the PyTorch port, run on an NVIDIA GPU.

The card's twin of ``tools/tpu_acceptance.py``: the same physical bars
(millimetres, degrees, probabilities) and seeds, held by the port's kernels
on the card. The CPU tests hold each kernel against its plain version, and
so does ``chip_smoke.py`` on the card; neither catches a fault that both
forms share, or a precision mode a user turns on (TF32, through
``torch.set_float32_matmul_precision("high")``). The JAX tool's docstring
names that class: a reduced-precision distance expansion (7.6 deg median
normal error at 25 m offsets) and segment-sum contraction (6 cm centroid
error). Its one-hot gather check has no twin: the port has no such gather.

Every check runs at PyTorch's default float32 settings (matmul precision
"highest", cuDNN TF32 on), except where it names another mode. Each check
takes ``device`` (CUDA unless the caller asks for the CPU, as the CPU tests
do) and returns its results; :func:`main` runs them all on the card. On
the card a check that holds a kernel fails unless the kernel's launch
counter (``build.LAUNCHES``) rose in it (:func:`launching`).

Run: ``python tools/gpu_acceptance.py``. Prints one PASS/FAIL line per
check (a crashed check is a FAIL); exit code 1 if any check fails.
"""

from __future__ import annotations

import contextlib
import copy
import os
import socket
import sys
from typing import Callable, NamedTuple

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from pointcloudprocessing_tpu_torch.ops.cuda import build  # noqa: E402


class Result(NamedTuple):
    name: str
    value: float
    bound: float
    unit: str

    @property
    def ok(self) -> bool:
        return bool(self.value <= self.bound)  # NaN fails

    def line(self) -> str:
        tag = "PASS" if self.ok else "FAIL"
        return f"[{tag}] {self.name}: {self.value:.3g} {self.unit} (bound {self.bound:g})"


@contextlib.contextmanager
def matmul_precision(mode: str):
    """``torch.set_float32_matmul_precision(mode)`` inside the block."""
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(mode)
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved)


@contextlib.contextmanager
def pytorch_defaults():
    """PyTorch's default float32 settings inside the block (matmul precision
    "highest", cuDNN TF32 on), whatever the caller set; restored after."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with matmul_precision("highest"):
            yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


@contextlib.contextmanager
def plain_pooled_chain():
    """The pooled chain through its plain PyTorch versions inside the block
    (``models/fused_pool.py`` looks its kernels up at call time)."""
    from pointcloudprocessing_tpu_torch.models import fused_pool
    from pointcloudprocessing_tpu_torch.ops.cuda import pooled_chain

    saved = (fused_pool.pooled_chain_forward, fused_pool.pooled_chain_backward)
    fused_pool.pooled_chain_forward = pooled_chain.pooled_chain_forward_reference
    fused_pool.pooled_chain_backward = pooled_chain.pooled_chain_backward_reference
    try:
        yield
    finally:
        fused_pool.pooled_chain_forward, fused_pool.pooled_chain_backward = saved


@contextlib.contextmanager
def launching(device, *counters):
    """On the card, the block must launch each kernel named by a counter of
    ``build.LAUNCHES`` at least once; else the check would hold the plain
    version against itself, and it fails. On the CPU the wrappers run their
    plain versions, and nothing is asserted."""
    if torch.device(device).type != "cuda":
        yield
        return
    before = [build.LAUNCHES[name] for name in counters]
    yield
    idle = [name for name, n in zip(counters, before) if build.LAUNCHES[name] <= n]
    if idle:
        raise AssertionError(f"kernels that did not launch on the card: {idle}")


def _max_head_diff(a: dict, b: dict) -> float:
    return max(float((a[k].float() - b[k].float()).abs().max())
               for k in ("classification_output", "segmentation_output"))


def check_voxel_centroids(device="cuda") -> list[Result]:
    """Voxel centroids on ``device`` (kernel 1 on the card) against the
    plain version on the CPU: <= 1 mm at a 30 m uniform scene (the bound
    on the segment sum's precision)."""
    from pointcloudprocessing_tpu_torch.ops import voxel_downsample_batch

    rng = np.random.default_rng(5)
    pts = torch.from_numpy(rng.uniform(-30, 30, (4, 2048, 3)).astype(np.float32))
    with launching(device, "sorted_segment_sum"):
        vox_d, mask_d = voxel_downsample_batch(pts.to(device), 0.4)
    vox_c, mask_c = voxel_downsample_batch(pts, 0.4)
    err = float("inf")
    if torch.equal(mask_d.cpu(), mask_c):
        err = float((vox_d.cpu() - vox_c).abs()[mask_c].max())
    return [Result("voxel centroid error vs exact", err * 1e3, 1.0, "mm")]


def _sphere_scene(n: int = 8192, b: int = 4, offset: float = 25.0) -> torch.Tensor:
    """The JAX tool's offset sphere: a radius of 10 m at 8,192 points,
    scaled with sqrt(n) below that so that the spacing stays the same."""
    rng = np.random.default_rng(3)
    th = rng.uniform(0, np.pi, (b, n))
    ph = rng.uniform(0, 2 * np.pi, (b, n))
    radius = 10.0 * min(1.0, np.sqrt(n / 8192))
    pts = np.stack(
        [np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph), np.cos(th)], -1
    ) * radius
    pts = (pts + rng.normal(0, 0.01, pts.shape)).astype(np.float32)
    return torch.from_numpy(pts) + offset


def _angles(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor) -> np.ndarray:
    """Degrees between unit normals, up to sign, at the valid rows (float64
    dot: an f32 arccos near 1 cannot resolve 0.03 deg)."""
    a = a.cpu().double()[mask]
    b = b.cpu().double()[mask]
    d = np.clip(np.abs((a * b).sum(-1).numpy()), 0.0, 1.0)
    return np.degrees(np.arccos(d))


def check_normals(device="cuda", n: int = 8192, b: int = 4) -> list[Result]:
    """Windowed and exact normals on an offset sphere: the windowed kernel
    against the exact path (quality), and exact on ``device`` against exact
    on the CPU (the distance expansion's precision), also under matmul
    precision "high" (TF32 on the card): the kNN guard
    (``ops/knn.py::full_f32_matmul``) must hold it to the same bar."""
    from pointcloudprocessing_tpu_torch.ops import (
        estimate_normals_batch,
        voxel_downsample_batch,
    )

    vox, mask = voxel_downsample_batch(_sphere_scene(n, b).to(device), 0.25)
    with launching(device, "windowed_moment_sums"):
        nw = estimate_normals_batch(vox, k=16, valid_mask=mask, method="window")
    ne = estimate_normals_batch(vox, k=16, valid_mask=mask, method="exact")
    with matmul_precision("high"):
        ne_high = estimate_normals_batch(vox, k=16, valid_mask=mask, method="exact")
    m = mask.cpu()
    ne_c = estimate_normals_batch(vox.cpu(), k=16, valid_mask=m, method="exact")
    a_we = _angles(nw, ne, m)
    return [
        Result("window-vs-exact normals median", float(np.median(a_we)), 1.0, "deg"),
        Result("window-vs-exact normals p95", float(np.percentile(a_we, 95)), 5.0,
               "deg"),
        Result("exact normals device-vs-CPU median",
               float(np.median(_angles(ne, ne_c, m))), 0.1, "deg"),
        Result("exact normals device-vs-CPU median, precision 'high'",
               float(np.median(_angles(ne_high, ne_c, m))), 0.1, "deg"),
    ]


def check_rigid_alignment(device="cuda") -> list[Result]:
    """Kabsch and ICP must recover a known small transform at 30 m offsets
    to sub-mm RMSE (the transform application's precision)."""
    from pointcloudprocessing_tpu_torch.ops import icp
    from pointcloudprocessing_tpu_torch.ops.mat_ops import solve_kabsch

    rng = np.random.default_rng(1)
    src = rng.normal(size=(400, 3)).astype(np.float32) * 5 + 30
    a = 0.05
    rot = np.array(
        [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]],
        np.float32,
    )
    tgt = src @ rot.T + np.array([0.3, -0.2, 0.4], np.float32)
    _, _, rmse_k = solve_kabsch(tgt, src, device=device)
    _, _, rmse_i = icp(src, tgt, iterations=10, device=device)
    return [Result("kabsch recovery rmse", float(rmse_k) * 1e3, 0.1, "mm"),
            Result("icp recovery rmse", float(rmse_i) * 1e3, 1.0, "mm")]


def check_fps_selection(device="cuda") -> list[Result]:
    """FPS (kernel 2 on the card) must select the same points as the plain
    'stream' version (both use exact squared differences)."""
    from pointcloudprocessing_tpu_torch.ops import farthest_point_sample_batch

    rng = np.random.default_rng(2)
    pts = torch.from_numpy(rng.normal(size=(4, 512, 3)).astype(np.float32)).to(device)
    with launching(device, "fps_with_points"):
        got = farthest_point_sample_batch(pts, 64)
    ref = farthest_point_sample_batch(pts, 64, method="stream")
    return [Result("kernel-vs-stream FPS selection mismatches",
                   float((got != ref).sum()), 0.0, "indices")]


def check_inference_precision_drift(device="cuda", b: int = 16,
                                    n: int = 1024) -> list[Result]:
    """Logits at matmul precision "high" (TF32 on the card) against
    "highest" on the 23/12 PointNet: the drift must stay within the serving
    tolerance, 1e-2 on the softmax outputs. Its three pooled chains take
    kernel 4 (3xTF32 in either mode) on the card."""
    from pointcloudprocessing_tpu_torch.models import PointNet

    model = PointNet(23, 12, generator=torch.Generator().manual_seed(0),
                     device=device).eval()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(b, n, 3)).astype(np.float32)).to(device)
    with torch.no_grad(), launching(device, "pooled_chain_forward"):
        with matmul_precision("high"):
            o_high = model(x)
        with matmul_precision("highest"):
            o_exact = model(x)
    return [Result("inference 'high'-vs-'highest' drift",
                   _max_head_diff(o_high, o_exact), 1e-2, "prob")]


def check_gather_maxmin_kernel(device="cuda") -> list[Result]:
    """Neighbour max/min (kernel 7 and its bf16 form on the card) against
    a gather in PyTorch: exact in bf16 and f32 (selection and max/min
    create no new values)."""
    from pointcloudprocessing_tpu_torch.ops.cuda.gather_maxmin import gather_maxmin

    rng = np.random.default_rng(13)
    idx = torch.from_numpy(rng.integers(0, 512, (4, 512, 20)).astype(np.int32)).to(device)
    results = []
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.from_numpy(
            rng.normal(size=(4, 512, 64)).astype(np.float32) * 17.0
        ).to(device, dtype)
        counter = "gather_maxmin_bf16" if dtype == torch.bfloat16 else "gather_maxmin"
        with launching(device, counter):
            got_mx, got_mn = gather_maxmin(q, idx)
        g = torch.take_along_dim(
            q.float(), idx.reshape(4, -1)[..., None].long(), dim=1
        ).reshape(4, 512, 20, 64)
        err = max(float((got_mx.float() - g.amax(dim=2)).abs().max()),
                  float((got_mn.float() - g.amin(dim=2)).abs().max()))
        name = str(dtype).removeprefix("torch.")
        results.append(Result(f"gather_maxmin kernel {name} exactness", err, 0.0,
                              "abs"))
    return results


def check_dgcnn_factored_edge(device="cuda", b: int = 8, n: int = 256) -> list[Result]:
    """DGCNN's factored edge block (kernel 7's bf16 form on the card)
    against the literal edge-tensor dataflow, bf16 (the serving
    configuration), exact kNN, the same weights: <= 5e-3 on each head."""
    from pointcloudprocessing_tpu_torch.models.dgcnn import dgcnn_for_width

    rng = np.random.default_rng(11)
    pts = torch.from_numpy(rng.normal(size=(b, n, 3)).astype(np.float32)).to(device)
    outs = {}
    for impl in ("reference", "factored"):
        model = dgcnn_for_width(23, 12, n, dtype=torch.bfloat16, edge_impl=impl,
                                generator=torch.Generator().manual_seed(0),
                                device=device).eval()
        counters = ["gather_maxmin_bf16"] if impl == "factored" else []
        with torch.no_grad(), launching(device, *counters):
            outs[impl] = model(pts)
    return [Result(f"dgcnn factored {head} max |d|",
                   float((outs["reference"][head] - outs["factored"][head])
                         .abs().max()), 5e-3, "abs")
            for head in ("classification_output", "segmentation_output")]


def check_shardmap_pipeline(device="cuda") -> list[Result]:
    """The serving pipeline (voxel -> FPS -> PointNet, kernels 1, 2 and 4
    on the card) over a one-device mesh must match the plain pipeline bit
    for bit (one shard: there is nothing to gather)."""
    from pointcloudprocessing_tpu_torch.models import PointCloudPipeline, PointNet

    model = PointNet(23, 12, generator=torch.Generator().manual_seed(0),
                     device=device).eval()
    rng = np.random.default_rng(7)
    scans = rng.uniform(-12, 12, (8, 2048, 3)).astype(np.float32)
    kwargs = dict(scan_width=2048, model_width=1024, voxel_size=0.4, sampler="fps")
    plain = PointCloudPipeline(model, **kwargs)
    sharded = PointCloudPipeline(model, mesh=[device], **kwargs)
    kernels = ("sorted_segment_sum", "fps_with_points", "pooled_chain_forward")
    with launching(device, *kernels):
        want = plain(scans)
    with launching(device, *kernels):
        got = sharded(scans)
    return [Result("one-device mesh vs plain pipeline drift",
                   _max_head_diff(want, got), 0.0, "prob")]


def check_pooled_chain_training(device="cuda", b: int = 8,
                                n: int = 1024) -> list[Result]:
    """The bf16 pooled chain's gradients (kernels 4 and 5's bf16 forms on
    the card) against the plain bf16 chain and the plain f32 chain,
    128 -> 1024 channels, in relative Frobenius distance: the kernels may
    land no farther from f32 than the plain bf16 chain does (+0.05), and
    within 0.25 of it (the bf16 rounding of the winners)."""
    from pointcloudprocessing_tpu_torch.core.constants import KERAS_BN_EPSILON
    from pointcloudprocessing_tpu_torch.models.fused_pool import dense_bn_relu_max

    rng = np.random.default_rng(3)
    cin, c = 128, 1024
    x = torch.from_numpy(rng.normal(size=(b, n, cin)).astype(np.float32)).to(device)
    kernel = rng.normal(size=(cin, c)).astype(np.float32) * 0.1
    weight = torch.from_numpy(kernel.T.copy()).to(device)
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)).to(device)
    bias = torch.from_numpy((rng.normal(size=c) * 0.2).astype(np.float32)).to(device)
    zeros, ones = torch.zeros(c, device=device), torch.ones(c, device=device)

    def grads(dtype):
        params = [t.clone().requires_grad_() for t in (weight, scale, bias)]
        out, _, _ = dense_bn_relu_max(x, *params, zeros, ones, KERAS_BN_EPSILON,
                                      use_running=False, dtype=dtype)
        torch.square(out).mean().backward()
        return [p.grad.cpu().double() for p in params]

    with launching(device, "pooled_chain_forward_bf16", "pooled_chain_backward_bf16"):
        got = grads(torch.bfloat16)
    with plain_pooled_chain():
        ref = grads(torch.bfloat16)
        want = grads(None)

    def fro(a, w):
        return float(torch.linalg.norm(a - w) / (torch.linalg.norm(w) + 1e-6))

    return [
        Result("pooled-chain kernel-vs-f32 grad excess over plain bf16",
               max(fro(g, w) - fro(r, w) for g, r, w in zip(got, ref, want)),
               0.05, "rel"),
        Result("pooled-chain kernel-vs-f32 grad Frobenius",
               max(fro(g, w) for g, w in zip(got, want)), 0.25, "rel"),
    ]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def check_shardmap_training(device="cuda", b: int = 8, w: int = 1024) -> list[Result]:
    """The shard_map training step in a one-rank process group (NCCL on the
    card, gloo on the CPU), bf16 PointNet through the pooled-chain kernels,
    must reproduce the bare step when the group has one rank (the average
    over one replica is the identity; jitter and dropout 0): loss drift
    <= 1e-5."""
    import torch.distributed as dist

    from pointcloudprocessing_tpu_torch.core.config import LearningConfig
    from pointcloudprocessing_tpu_torch.models import FreezeFlags, PointNet
    from pointcloudprocessing_tpu_torch.parallel import (
        data_parallel_mesh,
        initialize_multihost,
    )
    from pointcloudprocessing_tpu_torch.train import steps

    device = torch.device(device)
    pristine = PointNet(8, 4, dropout_rate=0.0, dtype=torch.bfloat16,
                        generator=torch.Generator().manual_seed(0), device=device)
    freeze, weights, jitter = FreezeFlags(), (1.0, 1.0, 0.1), (0.0, 0.0, 0.0)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(b, w, 3)).astype(np.float32)).to(device)
    targets = {
        "classification_output": torch.from_numpy(rng.integers(0, 8, b)).to(device),
        "segmentation_output": torch.from_numpy(rng.integers(0, 4, (b, w))).to(device),
        "se3": torch.eye(3, device=device).expand(b, 3, 3).contiguous(),
    }
    losses = {}
    initialize_multihost(f"127.0.0.1:{_free_port()}", 1, 0,
                         backend="nccl" if device.type == "cuda" else "gloo")
    try:
        mesh = data_parallel_mesh(device)
        for kind in ("shard_map", "bare"):
            model = copy.deepcopy(pristine)
            state, optimizer = steps.init_train_state(
                model, LearningConfig(rate=1e-3), freeze)
            if kind == "bare":
                step = steps.make_train_step(model, optimizer, weights, freeze, jitter)
            else:
                step = steps.make_shardmap_train_step(model, optimizer, weights,
                                                      freeze, jitter, mesh)
            with launching(device, "pooled_chain_forward_bf16",
                           "pooled_chain_backward_bf16"):
                losses[kind] = float(step(state, x, targets, 3)[1]["loss"])
    finally:
        dist.destroy_process_group()
    return [Result("shard_map-vs-bare bf16 train-step loss drift",
                   abs(losses["shard_map"] - losses["bare"]), 1e-5, "abs")]


CHECKS: tuple[Callable[..., list[Result]], ...] = (
    check_voxel_centroids,
    check_normals,
    check_rigid_alignment,
    check_fps_selection,
    check_inference_precision_drift,
    check_gather_maxmin_kernel,
    check_dgcnn_factored_edge,
    check_shardmap_pipeline,
    check_pooled_chain_training,
    check_shardmap_training,
)


def run_check(fn: Callable[..., list[Result]], device="cuda", **kwargs) -> list[Result]:
    """One check at PyTorch's default settings; a check that raises is one
    failed result that names the exception."""
    try:
        with pytorch_defaults():
            return fn(device=device, **kwargs)
    except Exception as e:  # a crashed check is a failure, not a skip
        return [Result(f"{fn.__name__} crashed: {type(e).__name__}: {e}",
                       float("nan"), 0.0, "")]


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("gpu_acceptance checks the port on an NVIDIA GPU, and "
                           "CUDA is not available")
    print(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}",
          flush=True)
    build.build_all()
    failures = []
    for fn in CHECKS:
        for result in run_check(fn):
            print(result.line(), flush=True)
            if not result.ok:
                failures.append(result.name)
    if failures:
        print(f"FAILED: {', '.join(failures)}", flush=True)
        return 1
    print("ALL CHECKS PASSED", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
