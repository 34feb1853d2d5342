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
a non-symmetric m) at 8x8192 and 32x1024 points, 128 -> 1024 channels,
checks each kernel against its plain version with phase 3's bars, and
prints the time a call: CUDA events around 20 back-to-back calls, median
of 5 (which includes the host's launch overhead where the host is slower
than the card), and the device time from a torch.profiler trace of 20
calls. Beside them, as a yardstick and not a library time for either
kernel: the GEMM alone, ``torch.matmul(x, w.t())`` in f32 with TF32 off.

Needs CUDA; exits non-zero without it.

Usage: python tools/pooled_bench.py [--root DIR]...
"""

from __future__ import annotations

import argparse
import functools
import os
import subprocess
import sys

from gather_bench import line  # this file's directory is on sys.path

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_checkout(root: str) -> None:
    sys.path.insert(0, root)
    import torch

    from pointcloudprocessing_tpu_torch.ops.cuda import pooled_chain as pc

    if not torch.cuda.is_available():
        raise SystemExit("pooled_bench: needs CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    c_in, c = 128, 1024
    for b, n in ((8, 8192), (32, 1024)):
        x = torch.relu(torch.randn(b, n, c_in, device=dev, generator=gen))
        w = torch.randn(c, c_in, device=dev, generator=gen) * 0.1
        a = torch.rand(c, device=dev, generator=gen) + 0.5
        c_row = torch.randn(c, device=dev, generator=gen) * 0.5
        c_row[:16] = -1e4
        pooled, argmax = pc.pooled_chain_forward(x, w, a, c_row)
        want, want_arg = pc.pooled_chain_forward_reference(x, w, a, c_row)
        bound = c_in * 2.0 ** -23 * torch.matmul(x.abs(), w.abs().t()) * a.abs()
        slack = (bound.gather(1, argmax.long()[:, None, :]).squeeze(1)
                 + bound.gather(1, want_arg.long()[:, None, :]).squeeze(1))
        ok = bool(((pooled - want).abs() <= slack).all())
        line(torch, f"pooled forward {b}x{n}x{c_in}->{c}",
             functools.partial(pc.pooled_chain_forward, x, w, a, c_row),
             f"{'within' if ok else 'BEYOND'} the GEMM rounding bar, argmax "
             f"flips {int((argmax != want_arg).sum())}")
        if not ok:
            raise SystemExit("pooled_bench: the forward disagrees")
        line(torch, f"GEMM alone {b}x{n}x{c_in} @ {c_in}x{c}",
             functools.partial(torch.matmul, x, w.t()),
             "torch.matmul in f32, TF32 off: a yardstick")

        coef = torch.randn(b, c, device=dev, generator=gen)
        m_small = torch.randn(c_in, c_in, device=dev, generator=gen) * 0.01
        const_row = torch.randn(c_in, device=dev, generator=gen) * 0.01
        args = (x, w, coef, argmax, m_small, const_row)
        dx, dk = pc.pooled_chain_backward(*args)
        dx2, dk2 = pc.pooled_chain_backward(*args)
        want_dx, want_dk = pc.pooled_chain_backward_reference(*args)
        ok = (torch.equal(dx, dx2) and torch.equal(dk, dk2)
              and (dx - want_dx).abs().max() <= 1e-5 * (1 + want_dx.abs().max())
              and (dk - want_dk).abs().max() <= 1e-5 * (1 + want_dk.abs().max()))
        line(torch, f"pooled backward {b}x{n}x{c_in}<-{c}",
             functools.partial(pc.pooled_chain_backward, *args),
             "within the bar, bit-identical on a rerun" if ok else "BEYOND THE BAR")
        if not ok:
            raise SystemExit("pooled_bench: the backward disagrees")
        del x, dx, dx2, want_dx
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
