"""What makes a ``torch.profiler`` session lose the device rows of its first
launch calls, on the card, in one fresh process.

A probe is three profiled windows of 40 tiny kernel launches: as they
are, after the host waits 20 ms inside the window, and after
``utils/profiling``'s pre-roll (``PREROLL`` launches and a synchronize);
it prints how many of the 40 launch calls have no device row (matched by
correlation id, ``utils/profiling._audit``), and how many of the
pre-roll's. The probe runs after each of these, in this order, so each
step's effect shows against the last: nothing (a fresh process); 20,000
launches of one tiny kernel outside any session; the first calls of ~150
kernels the process had not loaded (15 ops in 10 dtypes); 30 s of host
sleep; one profiled session of 100,000 launches; 50 sessions of 40
launches each; 60 s more of host sleep.

Usage: python tools/torch/trace_loss.py  (CUDA only)
"""

import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from pointcloudprocessing_tpu_torch.utils import profiling  # noqa: E402
from pointcloudprocessing_tpu_torch.utils.device import require_device  # noqa: E402

DTYPES = (torch.float32, torch.float16, torch.bfloat16, torch.float64, torch.int8,
          torch.uint8, torch.int16, torch.int32, torch.int64, torch.bool)


def session(launches: int, wait_s: float = 0.0, preroll: int = 0):
    """One profiled window of ``launches`` tiny launches, after ``wait_s``
    of host wait or a pre-roll of ``preroll`` launches and a synchronize
    inside the window: ``utils/profiling``'s audit of it."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(preroll):
            x.add_(1)
        torch.cuda.synchronize()
        time.sleep(wait_s)
        for _ in range(launches):
            x.add_(1)
        torch.cuda.synchronize()
        time.sleep(profiling.PAD_S)
    return profiling._audit(list(prof.events()), preroll, "cuda")[0]


def new_kernels() -> int:
    """First calls of ops in dtypes this process has not run: loads their
    kernels. Returns the op-dtype pairs run."""
    ops = (lambda t: t + t, lambda t: t * t, lambda t: t.max(), lambda t: t.sum(),
           lambda t: t.cumsum(0), lambda t: t.sort()[0], lambda t: t.flip(0),
           lambda t: torch.where(t > t[0], t, t[1]), lambda t: t.argmax(),
           lambda t: t.clone().index_add_(0, torch.zeros(2, dtype=torch.long,
                                                         device=t.device), t[:2]),
           lambda t: t.gather(0, torch.zeros(4, dtype=torch.long, device=t.device)),
           lambda t: t.unique(), lambda t: t.min(), lambda t: t.abs(),
           lambda t: t.to(torch.float32).sqrt())
    count = 0
    for dtype in DTYPES:
        t = (torch.arange(64, device="cuda") % 7).to(dtype)
        for op in ops:
            try:
                op(t)
            except RuntimeError:  # an op this dtype does not take
                continue
            count += 1
    torch.cuda.synchronize()
    return count


def main() -> None:
    require_device("cuda")
    t0 = time.monotonic()

    def probe(label: str) -> None:
        plain, waited = session(40), session(40, wait_s=0.02)
        pre = session(40, preroll=profiling.PREROLL)
        print(f"{time.monotonic() - t0:7.1f} s  {label:<44} launch calls without a "
              f"device row: {len(plain.missing)} of {plain.launches} (at "
              f"{plain.missing[:1] + plain.missing[-1:]}), after a 20 ms wait "
              f"{len(waited.missing)} of {waited.launches}, after the pre-roll "
              f"{len(pre.missing)} of {pre.launches} (the pre-roll's: "
              f"{pre.preroll_lost} of {pre.preroll})", flush=True)

    probe("fresh process")
    x = torch.zeros(1, device="cuda")
    for _ in range(20000):
        x.add_(1)
    torch.cuda.synchronize()
    probe("after 20,000 launches outside a session")
    probe(f"after first calls of {new_kernels()} op-dtype pairs")
    time.sleep(30)
    probe("after 30 s of host sleep")
    session(100000)
    probe("after a session of 100,000 launches")
    for _ in range(50):
        session(40)
    probe("after 50 sessions of 40 launches")
    time.sleep(60)
    probe("after 60 s more of host sleep")


if __name__ == "__main__":
    main()
