"""Profiling and tracing hooks on ``torch.profiler``
(``pointcloudprocessing_tpu/utils/profiling.py``).

- ``trace(path)``: context manager around ``torch.profiler.profile`` that
  writes a Chrome trace (``trace.json``, loadable in Perfetto or
  TensorBoard) of host and, on CUDA, device activity into ``path``.
- ``span(name)``: a named host range at a layer boundary, recorded only
  while a profiler session is active.
- ``device_trace(fn)``: the device rows (kernels, copies, memsets) of one
  call of ``fn`` on the card, each CUDA call that launched device work
  checked to have its row, with the host wall time of the call and the
  host events.
- ``summarize(events, steps)``: device time a step by kernel name, the
  counterpart of ``tools/trace_ops.py::summarize``.
- ``by_span(events)``: device time by the ``pcp.`` span that launched it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import re
import time

import torch
import torch.autograd.profiler as autograd_profiler


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace into ``log_dir/trace.json``, of every
    thread: the loader's and the pipeline's producers too, whose ``span``
    ranges a default session, recording only the thread that opened it,
    would not see."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    every_thread = torch.profiler._ExperimentalConfig(profile_all_threads=True)
    with torch.profiler.profile(activities=activities,
                                experimental_config=every_thread) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


#: the prefix of every span's name
SPAN_PREFIX = "pcp."

_OFF = contextlib.nullcontext()


def span(name: str):
    """A named host range on the profiler's timeline, around one layer's
    work (``pcp.pipeline.batch``, ``pcp.train.step``, ...).

    With no profiler session active it costs one read of the profiler's
    enabled flag and returns a shared null context. In a session it opens
    a host range in the profiler's own buffer, on the clock of the device
    rows, and the session writes it out with them. Spans nest on one
    thread; none is held open across a ``yield``. The range is a plain
    host op (``_RecordFunctionFast``), not ``record_function``'s user
    annotation, which also puts a device row of the span's name among the
    kernels. A default session records only the thread that opened it
    (the profiler's callbacks are thread-local); :func:`trace` records
    every thread. While a program is being traced for export or
    compilation a span is the null context too, so that a span inside a
    ``forward`` never reaches the traced graph."""
    if not autograd_profiler._is_profiler_enabled or torch.compiler.is_compiling():
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name)


#: CUDA runtime and driver calls that put one activity on the device (a
#: kernel, a copy, a memset); in a whole trace each has a device row of
#: its correlation id
LAUNCH_CALL = re.compile(r"^cu(da)?(Launch|Memcpy|Memset)")
SYNC_CALL = re.compile(r"^cu(da)?(Device|Stream|Ctx)Synchronize")

#: tiny kernels launched in each profiled window before the call. A
#: profiling session records no device row for its first launch calls, a
#: count that grows with the process's age (none in a fresh process,
#: about 30 after eight minutes of ``chip_smoke.py`` on an H100, whatever
#: the host waits first; PERF.md section 7): the pre-roll's launches take
#: that loss, and an attempt whose pre-roll was too short is retried with
#: a longer one.
PREROLL = 64

#: host wait inside the window after the call (a trace of ~100,000 rows
#: has lost its last rows without it)
PAD_S = 0.02

#: profiled attempts of one call at most, each with a longer pre-roll
TRIES = 3


@dataclasses.dataclass
class Attempt:
    """One profiled run of the call: what it recorded."""

    activities: str       # "cuda" or "cpu+cuda"
    preroll: int          # tiny launches before the call
    rows: int             # the call's device rows
    launches: int         # the call's launch calls (kernels, copies, memsets)
    missing: list[int]    # their positions (in start order) without a row
    preroll_lost: int     # pre-roll launch calls without a row

    @property
    def whole(self) -> bool:
        return self.rows > 0 and not self.missing

    def describe(self) -> str:
        runs = []
        for i in self.missing:
            if runs and runs[-1][1] == i - 1:
                runs[-1][1] = i
            else:
                runs.append([i, i])
        where = ",".join(f"{a}" if a == b else f"{a}-{b}" for a, b in runs)
        return (f"{self.activities}, pre-roll {self.preroll}: "
                f"{self.rows} device rows, {self.launches} launch calls, "
                f"{len(self.missing)} without a row" + (f" (at {where})" if where else "")
                + f"; {self.preroll_lost} of the pre-roll's without a row")


@dataclasses.dataclass
class DeviceTrace:
    """The device rows of one call, from its first whole attempt."""

    events: list          # FunctionEvents whose device type is CUDA
    wall_us: float        # host wall time of the call
    attempts: list[Attempt]  # every attempt, the accepted one last
    host: list = dataclasses.field(default_factory=list)  # the attempt's host events

    @property
    def whole(self) -> bool:
        return self.attempts[-1].whole


def _audit(rows: list, preroll: int, activities: str) -> tuple[Attempt, list]:
    """Split a window's rows into the pre-roll's and the call's (the
    launch calls before the pre-roll's synchronize, which must be
    ``preroll`` of them), and match each launch call to its device row by
    correlation id. Returns the attempt and the call's device rows."""
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
    if len(pre) != preroll:  # the pre-roll is not where it must be
        missing = missing or [-1]
    return Attempt(activities, preroll, len(kept), len(calls), missing,
                   sum(e.id not in ids for e in pre)), kept


def device_trace(fn, log_dir: str | None = None) -> DeviceTrace | None:
    """Run ``fn`` once under ``torch.profiler`` on the card. Returns its
    device rows (kernels, copies, memsets: the rows whose device type is
    CUDA, so no host op that launched them is counted a second time) and
    the host wall time of the call, from the first attempt that is whole:
    device rows, and one for every CUDA call of ``fn`` that launched
    device work. None if no attempt recorded a device row. ``log_dir``
    takes the accepted attempt's Chrome trace (``trace.json``). Host
    activity is recorded too (the launch calls, host ops and ``span``
    ranges: ``host``), so that :func:`by_span` can give each row to the
    span that launched it.

    Each window opens with ``PREROLL`` tiny launches and a synchronize
    before the call (their rows are not the call's) and closes ``PAD_S``
    after it. An attempt that is not whole is retried with a longer
    pre-roll, up to ``TRIES`` attempts. The returned trace's ``attempts``
    say what each try recorded; if none was whole, the one with the most
    device rows is returned and ``whole`` is False."""
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
            wall_us = (time.perf_counter() - t0) * 1e6
            time.sleep(PAD_S)
        events = list(prof.events())
        attempt, kept = _audit(events, preroll, "cpu+cuda")
        host = [e for e in events if e.device_type == DeviceType.CPU]
        runs.append((attempt, prof, kept, wall_us, host))
        if attempt.whole:
            break
        preroll = 2 * (preroll + len(attempt.missing))
    attempt, prof, kept, wall_us, host = max(runs, key=lambda r: (r[0].whole, r[0].rows))
    if attempt.rows == 0:
        return None
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    return DeviceTrace(kept, wall_us,
                       [r[0] for r in runs if r[0] is not attempt] + [attempt], host)


@dataclasses.dataclass(frozen=True)
class OpRow:
    """One line of :func:`summarize`'s table."""

    name: str
    us_per_step: float
    percent: float
    n_per_step: float | None  # None on the "(+N more)" line


@dataclasses.dataclass(frozen=True)
class Summary:
    steps: int
    total_us_per_step: float
    rows: tuple[OpRow, ...]      # the top rows, then "(+N more)" if any
    by_name: dict                # every name's OpRow

    def table(self) -> str:
        lines = [f"{'us/step':>9}  {'%':>5}  {'n/step':>6}  op"]
        for r in self.rows:
            n = f"{'':>6}" if r.n_per_step is None else f"{r.n_per_step:6.1f}"
            lines.append(f"{r.us_per_step:9.1f}  {r.percent:5.1f}  {n}  {r.name[:110]}")
        return "\n".join(lines)


def summarize(events, steps: int, top: int = 40) -> Summary:
    """Device time a step by name over ``steps`` steps: the total, then
    each name's us a step, its share in %, and its rows a step, largest
    first; the first ``top`` names, then one "(+N more)" row for the rest.

    ``events`` are device rows (``device_trace(...).events``), named as
    CUPTI reports them: a kernel under its CUDA symbol, copies and memsets
    under their own names. Rows on one stream do not nest, so the JAX
    tool's split of async and parent spans has no counterpart here."""
    us: dict[str, float] = {}
    count: dict[str, int] = {}
    for e in events:
        us[e.name] = us.get(e.name, 0.0) + e.time_range.elapsed_us()
        count[e.name] = count.get(e.name, 0) + 1
    grand = sum(us.values())

    def row(name: str) -> OpRow:
        return OpRow(name, us[name] / steps, 100 * us[name] / grand if grand else 0.0,
                     count[name] / steps)

    by_name = {name: row(name) for name in us}
    ranked = sorted(by_name.values(), key=lambda r: -r.us_per_step)
    rows = ranked[:top]
    rest_us = sum(r.us_per_step for r in ranked[top:])
    if rest_us:
        rows.append(OpRow(f"(+{len(ranked) - top} more)", rest_us,
                          100 * rest_us * steps / grand, None))
    return Summary(steps, grand / steps, tuple(rows), by_name)


#: the spans that hold one batch or one step: a launch from a thread with
#: no span open is given to the span open on their thread at that instant
UNIT_SPANS = ("pcp.pipeline.batch", "pcp.train.step")

#: :func:`by_span`'s name for the device time that no span launched
NO_SPAN = "(no span)"


def _thread(e) -> tuple:
    """A host event's thread. The profiler numbers the threads it records;
    the CUDA calls of a thread it does not record carry the number of the
    thread that read the trace, but a resource id of their own."""
    return e.thread, getattr(e, "device_resource_id", 0)


def _innermost(spans: list, t: float):
    """The innermost of one thread's spans (sorted by start; they nest)
    open at ``t``, or None."""
    inner = None
    for s in spans:
        if s.time_range.start > t:
            break
        if t <= s.time_range.end:
            inner = s
    return inner


def _spans_by_thread(events) -> dict[tuple, list]:
    """The ``pcp.`` spans among ``events`` by thread, each thread's sorted
    by start."""
    from torch.autograd import DeviceType

    spans: dict[tuple, list] = {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name.startswith(SPAN_PREFIX):
            spans.setdefault(_thread(e), []).append(e)
    for thread_spans in spans.values():
        thread_spans.sort(key=lambda s: s.time_range.start)
    return spans


def span_of_rows(events) -> list[tuple]:
    """Each device row of ``events`` (host and device events of one trace)
    with the span it is given to, or None: the innermost ``pcp.`` span
    open on the thread of its launch call (matched by correlation id) when
    the call started, else the innermost open then on the thread of the
    unit spans (``UNIT_SPANS``): autograd's device thread launches the
    backward while the step's thread waits inside its span."""
    from torch.autograd import DeviceType

    spans = _spans_by_thread(events)
    unit = next((spans[t] for t in spans if any(s.name in UNIT_SPANS for s in spans[t])), [])
    host = [e for e in events if e.device_type == DeviceType.CPU]
    launches = {e.id: e for e in host if LAUNCH_CALL.match(e.name)}
    out = []
    for row in (e for e in events if e.device_type != DeviceType.CPU):
        call = launches.get(row.id)
        given = None
        if call is not None:
            t = call.time_range.start
            given = _innermost(spans.get(_thread(call), []), t)
            if given is None:
                given = _innermost(unit, t)
        out.append((row, given))
    return out


def by_span(events) -> dict[str, float]:
    """Device us by the ``pcp.`` span that launched each row
    (:func:`span_of_rows`), largest first; rows no span launched under
    ``NO_SPAN``. ``events``: a trace's host and device events
    (``DeviceTrace.host + DeviceTrace.events``)."""
    us: dict[str, float] = {}
    for row, given in span_of_rows(events):
        name = NO_SPAN if given is None else given.name
        us[name] = us.get(name, 0.0) + row.time_range.elapsed_us()
    return dict(sorted(us.items(), key=lambda kv: -kv[1]))
