#!/usr/bin/env python3
"""Time the port's pooled-chain kernels (kernel 4, the forward, and kernel
5, the backward) on the training step's inputs, for comparing checkouts on
one card.

Each checkout given with ``--root`` (default: the one this file is in) runs
in a process of its own, in the order given, so ``--root A --root B --root
B --root A`` times A, B, B, A on one card. A process imports that
checkout's ``pointcloudprocessing_tpu_torch`` (building its kernels), draws
the inputs ``chip_smoke.py``'s phase 3 draws (seed 3 on the card: relu'd
normal x, weight 0.1 normal, 16 dead channels, the forward's own winners,
a non-symmetric m) at 8x8192 and 32x1024 points, 128 -> 1024 channels, in
f32 or (``--dtype bf16``) with x and the weight in bf16, checks each kernel
against its plain version with phase 3's bars, and prints the time a call:
CUDA events around 20 back-to-back calls, median of 5 (which includes the
host's launch overhead where the host is slower than the card), and the
device time from a torch.profiler trace of 20 calls, summed over every
launch of a call (the weight's relayout or the backward's first launch,
the main kernel, the combine over runs) and given launch by launch. Beside
each: its bound, the larger of the bytes it must move (each input read
once, each output written once) over 3.35 TB/s and its tensor-core products
over the dense peak (989 TFLOP/s bf16; 495 TF32, three products a 3xTF32
one); and, as a yardstick and not a library time for either kernel, the
GEMM alone, ``torch.matmul(x, w.t())`` (f32 with TF32 off, or bf16).

Needs CUDA; exits non-zero without it.

Usage: python tools/pooled_bench.py [--root DIR]... [--dtype f32|bf16]
"""

from __future__ import annotations

import argparse
import functools
import os
import re
import subprocess
import sys

from gather_bench import event_ms  # this file's directory is on sys.path

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BYTES_PER_S = 3.35e12
TENSOR_OPS_PER_S = {"f32": 495e12 / 3, "bf16": 989e12}


def kernel_ms(torch, fn, calls: int = 20) -> dict | None:
    """Device ms a call of ``fn`` by kernel name (the name before its
    template arguments), and their sum under "all", from a torch.profiler
    trace of ``calls`` calls after a warm-up; None without device rows."""
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
    out = {"all": 0.0}
    for e in rows:
        name = re.split(r"[<(]", e.name.replace("(anonymous namespace)::", "")
                        .removeprefix("void "))[0].split("::")[-1].strip()
        ms = e.time_range.elapsed_us() / calls / 1e3
        out[name] = out.get(name, 0.0) + ms
        out["all"] += ms
    return out


def line(torch, label: str, fn, bound_ms: float | None, check: str) -> None:
    ms, times = event_ms(torch, fn)
    dev = kernel_ms(torch, fn)
    device = "device not traced" if dev is None else (
        f"device {dev['all']:.4f} ms (" + ", ".join(
            f"{k} {v:.4f}" for k, v in dev.items() if k != "all") + ")")
    bound = "" if bound_ms is None else f"; bound {bound_ms:.4f} ms"
    print(f"{label}: {ms:.4f} ms a call by events (spread {min(times):.4f}-"
          f"{max(times):.4f}), {device}{bound}; {check}", flush=True)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(form: str, nbytes_moved: int, products: float) -> float:
    """The least ms for the bytes and the tensor-core products."""
    return max(nbytes_moved / HBM_BYTES_PER_S, 2 * products / TENSOR_OPS_PER_S[form]) * 1e3


def run_checkout(root: str, form: str) -> None:
    sys.path.insert(0, root)
    import torch

    from pointcloudprocessing_tpu_torch.ops.cuda import pooled_chain as pc

    if not torch.cuda.is_available():
        raise SystemExit("pooled_bench: needs CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    bf16 = form == "bf16"
    op = (lambda t: t.to(torch.bfloat16)) if bf16 else (lambda t: t)
    c_in, c = 128, 1024
    for b, n in ((8, 8192), (32, 1024)):
        x = op(torch.relu(torch.randn(b, n, c_in, device=dev, generator=gen)))
        w = op(torch.randn(c, c_in, device=dev, generator=gen) * 0.1)
        a = torch.rand(c, device=dev, generator=gen) + 0.5
        c_row = torch.randn(c, device=dev, generator=gen) * 0.5
        c_row[:16] = -1e4
        pooled, argmax = pc.pooled_chain_forward(x, w, a, c_row)
        want, want_arg = pc.pooled_chain_forward_reference(x, w, a, c_row)
        xf, wf = x.float(), w.float()
        gemm_bar = c_in * 2.0 ** -23 * torch.matmul(xf.abs(), wf.abs().t()) * a.abs()
        slack = (gemm_bar.gather(1, argmax.long()[:, None, :]).squeeze(1)
                 + gemm_bar.gather(1, want_arg.long()[:, None, :]).squeeze(1))
        ok = bool(((pooled - want).abs() <= slack).all())
        line(torch, f"pooled forward {form} {b}x{n}x{c_in}->{c}",
             functools.partial(pc.pooled_chain_forward, x, w, a, c_row),
             bound(form, nbytes(x, w, a, c_row, pooled, argmax), b * n * c_in * c),
             f"{'within' if ok else 'BEYOND'} the GEMM rounding bar, argmax "
             f"flips {int((argmax != want_arg).sum())}")
        if not ok:
            raise SystemExit("pooled_bench: the forward disagrees")
        line(torch, f"GEMM alone {form} {b}x{n}x{c_in} @ {c_in}x{c}",
             functools.partial(torch.matmul, x, w.t()), None,
             f"torch.matmul in {x.dtype}{'' if bf16 else ', TF32 off'}: a yardstick")

        coef = torch.randn(b, c, device=dev, generator=gen)
        m_small = torch.randn(c_in, c_in, device=dev, generator=gen) * 0.01
        const_row = torch.randn(c_in, device=dev, generator=gen) * 0.01
        args = (x, w, coef, argmax, m_small, const_row)
        dx, dk = pc.pooled_chain_backward(*args)
        dx2, dk2 = pc.pooled_chain_backward(*args)
        want_dx, want_dk = pc.pooled_chain_backward_reference(*args)
        d_dx = (dx.float() - want_dx.float()).abs()
        ulp = 2.0 ** -7 * want_dx.float().abs() if bf16 else 0.0
        ok = (torch.equal(dx, dx2) and torch.equal(dk, dk2)
              and bool((d_dx <= 1e-5 * (1 + want_dx.float().abs().max()) + ulp).all())
              and (dk - want_dk).abs().max() <= 1e-5 * (1 + want_dk.abs().max()))
        # bytes: x, w, coef, argmax, m, row in; dx, dk out. Products: x @ m,
        # and one coef * w row a (cloud, channel) winner
        line(torch, f"pooled backward {form} {b}x{n}x{c_in}<-{c}",
             functools.partial(pc.pooled_chain_backward, *args),
             bound(form, nbytes(*args, dx, dk), b * n * c_in * c_in),
             "within the bar, bit-identical on a rerun" if ok else "BEYOND THE BAR")
        if not ok:
            raise SystemExit("pooled_bench: the backward disagrees")
        del x, dx, dx2, want_dx
        torch.cuda.empty_cache()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", action="append", help="a checkout (repeatable)")
    parser.add_argument("--dtype", choices=("f32", "bf16"), default="f32",
                        help="the kernels' form: f32 (3xTF32) or bf16")
    parser.add_argument("--child", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child:
        run_checkout(args.child, args.dtype)
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    for root in args.root or [HERE]:
        root = os.path.abspath(root)
        print(f"== {root} ({args.dtype})", flush=True)
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--child", root, "--dtype", args.dtype])
        if proc.returncode:
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
