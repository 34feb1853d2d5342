"""The program's spans in a traced stretch, and what the per-layer metrics of
its layers read from them.

The port marks each layer boundary with a host range named ``pcp.<layer>.
<part>`` (``pointcloudprocessing_tpu_torch/utils/profiling.py::span``),
recorded by the profiler beside the device rows, on their clock. Each
device row is given to the span that launched it: the innermost ``pcp.``
span open on the thread of its launch call (matched by correlation id, as
``trace._audit`` matches them) when the call started; a launch from a
thread with no span open goes to the innermost span open then on the thread
of the unit spans (``pcp.pipeline.batch``, ``pcp.train.step``). Host sync
calls are counted where a ``pcp.`` span is open on their own thread.

``span_of_rows``, ``by_span`` and their helpers are copies of the
program's, so that a later change to the program cannot change how the
benchmark reads a trace (``gpubench/tests/test_gpubench_spans.py`` holds
them equal). A stretch that holds no ``pcp.`` span (a program without
spans) gives no metric.
"""

from __future__ import annotations

import re

from torch.autograd import DeviceType

from gpubench.harness.trace import LAUNCH_CALL

SPAN_PREFIX = "pcp."
UNIT_SPANS = ("pcp.pipeline.batch", "pcp.train.step")
NO_SPAN = "(no span)"
#: host calls that wait for the device
HOST_SYNC = re.compile(r"^cu(da)?(Stream|Device|Event|Ctx)Synchronize$|^cu(da)?Memcpy$")
#: the spans of one serving batch and of one train step
BATCH_SPANS = ("pcp.pipeline.batch", "pcp.pipeline.voxel", "pcp.pipeline.sample",
               "pcp.pipeline.model")
STEP_PREFIX = "pcp.train."


# copied from pointcloudprocessing_tpu_torch/utils/profiling.py::_thread
def _thread(e) -> tuple:
    return e.thread, getattr(e, "device_resource_id", 0)


# copied from pointcloudprocessing_tpu_torch/utils/profiling.py::_innermost
def _innermost(spans: list, t: float):
    inner = None
    for s in spans:
        if s.time_range.start > t:
            break
        if t <= s.time_range.end:
            inner = s
    return inner


# copied from pointcloudprocessing_tpu_torch/utils/profiling.py::_spans_by_thread
def _spans_by_thread(events) -> dict[tuple, list]:
    spans: dict[tuple, list] = {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name.startswith(SPAN_PREFIX):
            spans.setdefault(_thread(e), []).append(e)
    for thread_spans in spans.values():
        thread_spans.sort(key=lambda s: s.time_range.start)
    return spans


# copied from pointcloudprocessing_tpu_torch/utils/profiling.py::span_of_rows
def span_of_rows(events) -> list[tuple]:
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


# copied from pointcloudprocessing_tpu_torch/utils/profiling.py::by_span
def by_span(events) -> dict[str, float]:
    us: dict[str, float] = {}
    for row, given in span_of_rows(events):
        name = NO_SPAN if given is None else given.name
        us[name] = us.get(name, 0.0) + row.time_range.elapsed_us()
    return dict(sorted(us.items(), key=lambda kv: -kv[1]))


def has_spans(reading) -> bool:
    """Whether the stretch holds a ``pcp.`` span at all."""
    return any(e.name.startswith(SPAN_PREFIX) for e in reading.stretch.host)


def device_ms(reading, names) -> float:
    """Device ms a unit (batch or step) of the rows given to the spans
    ``names``."""
    us = by_span(reading.stretch.rows + reading.stretch.host)
    return sum(us.get(n, 0.0) for n in names) / 1e3 / reading.units


def host_ms(reading, name: str) -> float:
    """Host ms a unit inside the spans called ``name``."""
    us = sum(e.time_range.elapsed_us() for e in reading.stretch.host if e.name == name)
    return us / 1e3 / reading.units


def syncs(reading) -> list[tuple]:
    """Each host sync call made inside a ``pcp.`` span of its own thread,
    with that (innermost) span."""
    spans = _spans_by_thread(reading.stretch.host)
    out = []
    for e in reading.stretch.host:
        if HOST_SYNC.match(e.name):
            given = _innermost(spans.get(_thread(e), []), e.time_range.start)
            if given is not None:
                out.append((e, given))
    return out
