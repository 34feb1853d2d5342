"""Device traces of a stretch of the timed path, and what the metrics read
from them.

``device_trace``, ``_audit`` and ``summarize`` are copies of
``pointcloudprocessing_tpu_torch/utils/profiling.py`` (the whole-trace audit:
a window opens with tiny pre-roll launches and a synchronize, each launch
call of the stretch must have its device row, matched by correlation id,
and a trace that is not whole is retried with a longer pre-roll), so that a
later change to the program cannot change how the benchmark reads a trace.
The copy records host activity from the first attempt, so that idle gaps
can be named by what the host was doing, and it reports which attempt was
taken. A stretch that is not whole gives no metric.
"""

from __future__ import annotations

import dataclasses
import re
import time

import torch

#: CUDA API calls (``cuda*``, ``cu*``) that put one activity on the device
LAUNCH_CALL = re.compile(r"^cu(da)?(Launch|Memcpy|Memset)")
KERNEL_CALL = re.compile(r"^cu(da)?Launch")
SYNC_CALL = re.compile(r"^cu(da)?(Device|Stream|Ctx)Synchronize")
#: device rows that are copies or memsets, not kernels
NOT_KERNEL = re.compile(r"^(Memcpy|Memset)")
PREROLL = 64
PAD_S = 0.02
TRIES = 3
#: a breakdown's names are cut to this many characters (CUDA template names
#: run to hundreds)
NAME_CHARS = 160


@dataclasses.dataclass
class Attempt:
    preroll: int
    rows: int
    launches: int
    missing: list
    preroll_lost: int

    @property
    def whole(self) -> bool:
        return self.rows > 0 and not self.missing


@dataclasses.dataclass
class Stretch:
    """The device rows of one traced stretch, from its first whole attempt."""

    rows: list            # FunctionEvents whose device type is CUDA
    host: list            # host events of the same attempt
    wall_s: float         # host wall time of the stretch
    attempt: int          # index of the attempt taken
    attempts: list

    @property
    def whole(self) -> bool:
        return self.attempts[self.attempt].whole


# copied from pointcloudprocessing_tpu_torch/utils/profiling.py::_audit
def _audit(rows: list, preroll: int) -> tuple[Attempt, list]:
    from torch.autograd import DeviceType

    device_rows = [e for e in rows if e.device_type == DeviceType.CUDA]
    launches = sorted((e for e in rows if LAUNCH_CALL.match(e.name)),
                      key=lambda e: e.time_range.start)
    pre = []
    if preroll and launches:
        first = launches[0].time_range.start
        boundary = min((e.time_range.start for e in rows
                        if SYNC_CALL.match(e.name) and e.time_range.start > first),
                       default=float("inf"))
        pre = [e for e in launches if e.time_range.start < boundary]
    calls = launches[len(pre):]
    pre_ids = {e.id for e in pre}
    ids = {e.id for e in device_rows}
    kept = [e for e in device_rows if e.id not in pre_ids]
    missing = [i for i, e in enumerate(calls) if e.id not in ids]
    if len(pre) != preroll:
        missing = missing or [-1]
    return Attempt(preroll, len(kept), len(calls), missing,
                   sum(e.id not in ids for e in pre)), kept


# copied from pointcloudprocessing_tpu_torch/utils/profiling.py::device_trace
def device_trace(fn) -> Stretch | None:
    """Run ``fn`` under ``torch.profiler`` (host and device activity) until
    an attempt is whole, at most ``TRIES`` times, each with a longer
    pre-roll. None if no attempt recorded a device row."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    scratch = torch.zeros(1, device=torch.cuda.current_device())
    preroll, runs = PREROLL, []
    for _ in range(TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(preroll):
                scratch.add_(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            time.sleep(PAD_S)
        events = list(prof.events())
        attempt, kept = _audit(events, preroll)
        host = [e for e in events if e.device_type == DeviceType.CPU]
        runs.append((attempt, kept, host, wall))
        if attempt.whole:
            break
        preroll = 2 * (preroll + len(attempt.missing))
    best = max(range(len(runs)), key=lambda i: (runs[i][0].whole, runs[i][0].rows))
    attempt, kept, host, wall = runs[best]
    if attempt.rows == 0:
        return None
    return Stretch(kept, host, wall, best, [r[0] for r in runs])


# copied from pointcloudprocessing_tpu_torch/utils/profiling.py::summarize
def device_seconds_by_name(rows) -> dict[str, float]:
    """{row name: device seconds} over the stretch."""
    out: dict[str, float] = {}
    for e in rows:
        out[e.name] = out.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e6
    return out


def busy_intervals(rows) -> list[tuple[float, float]]:
    """The union of the rows' device intervals, in us, sorted."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in rows)
    merged: list[list[float]] = []
    for start, end in spans:
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


def busy_seconds(rows) -> float:
    """Seconds in which some operation ran on the device."""
    return sum(b - a for a, b in busy_intervals(rows)) / 1e6


def kernel_rows(rows) -> list:
    """The rows that are kernels (not copies or memsets)."""
    return [e for e in rows if not NOT_KERNEL.match(e.name)]


def symbol_rows(rows, symbols) -> list:
    """The rows whose CUDA symbol is one of ``symbols`` (CUPTI names a
    template instance ``void name<...>(...)``)."""
    pattern = re.compile(r"(?<!\w)(" + "|".join(map(re.escape, symbols)) + r")(?!\w)")
    return [e for e in rows if pattern.search(e.name)]


def launching_threads(host: list) -> set:
    """The host threads that launched a kernel: those that feed the device
    (the forward's and autograd's; not a thread that only stages copies or
    waits on events)."""
    return {e.thread for e in host if KERNEL_CALL.match(e.name)}


def idle_gaps(stretch: Stretch, top: int = 10) -> list[list]:
    """The longest gaps between device activity inside the stretch, each
    named by the innermost host operation that a launching thread was
    running at the gap's middle: [[name, seconds], ...], longest first."""
    spans = busy_intervals(stretch.rows)
    gaps = [(b0, a1) for (_, b0), (a1, _) in zip(spans, spans[1:]) if a1 > b0]
    gaps.sort(key=lambda g: g[0] - g[1])
    threads = launching_threads(stretch.host)
    host = [e for e in stretch.host if e.thread in threads]
    out = []
    for start, end in gaps[:top]:
        mid = (start + end) / 2
        covering = [e for e in host if e.time_range.start <= mid <= e.time_range.end]
        name = max(covering, key=lambda e: e.time_range.start).name if covering else "(no host op)"
        out.append([name[:NAME_CHARS], (end - start) / 1e6])
    return out


def breakdown(stretch: Stretch, top: int = 10) -> dict:
    """The ``--trace 1`` line's breakdown: the device operations that took
    most time and the longest idle gaps, each [name, seconds]."""
    by_name = device_seconds_by_name(stretch.rows)
    ops = sorted(([n[:NAME_CHARS], v] for n, v in by_name.items()), key=lambda r: -r[1])[:top]
    return {"device_ops": ops, "idle_gaps": idle_gaps(stretch, top)}
