"""Profiling and tracing hooks on ``torch.profiler``
(``pointcloudprocessing_tpu/utils/profiling.py``).

- ``trace(path)``: context manager around ``torch.profiler.profile`` that
  writes a Chrome trace (``trace.json``, loadable in Perfetto or
  TensorBoard) of host and, on CUDA, device activity into ``path``.
- ``annotate(name)``: a named region on the profiler's timeline.
- ``StepTimer``: wall-clock step timing with a percentile summary.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace into ``log_dir/trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named region for the profiler timeline."""
    return torch.profiler.record_function(name)


# copied from pointcloudprocessing_tpu/utils/profiling.py::StepTimer
class StepTimer:
    def __init__(self):
        self._durations: list[float] = []
        self._t0: float | None = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._durations.append(time.perf_counter() - self._t0)
        return False

    @property
    def count(self) -> int:
        return len(self._durations)

    def summary(self, items_per_step: float = 1.0) -> dict[str, float]:
        """p50/p90/mean step latency and items/sec throughput."""
        if not self._durations:
            return {}
        d = np.asarray(self._durations)
        return {
            "steps": float(len(d)),
            "mean_s": float(d.mean()),
            "p50_s": float(np.percentile(d, 50)),
            "p90_s": float(np.percentile(d, 90)),
            "items_per_s": float(items_per_step / d.mean()),
        }
