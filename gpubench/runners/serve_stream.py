"""Runner of the serving mixes (``"kind": "serve_stream"``): a closed loop
of batches through ``PointCloudPipeline.stream()``.

Set-up builds the model with the benchmark's weights, makes the pool of
frames and warms the stream up; the window then consumes batches for
``seconds``. Each batch's latency runs from the moment the source hands it
to ``stream()`` until its heads are complete on the device, read by a
waiter thread from an event recorded after the batch, so the consumer
never waits. The clouds per second count every batch taken in the window
over the window and the wait for its last batch. Outputs of a few batches
drawn from the seed are kept and, once the window has closed and the
program is freed, held against the reference on the same frames.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time

import numpy as np
import torch

from gpubench.harness import check, frames, trace
from gpubench.harness.session import Outcome, Reading, fixed_precision, program_with_weights
from gpubench.reference import pipeline as reference_pipeline
from gpubench.reference.voxel import voxel_downsample


class Waiter:
    """Completion times of batches, read off events by a thread of its own."""

    def __init__(self, device: torch.device):
        self.device = device
        self.done: dict[int, float] = {}
        self._queue: queue.Queue = queue.Queue()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def mark(self, ordinal: int) -> None:
        if self.device.type != "cuda":  # the CPU has finished the work
            self.done[ordinal] = time.perf_counter()
            return
        event = torch.cuda.Event(blocking=True)
        event.record()
        self._queue.put((ordinal, event))

    def _loop(self) -> None:
        while (item := self._queue.get()) is not None:
            ordinal, event = item
            event.synchronize()
            self.done[ordinal] = time.perf_counter()

    def finish(self) -> None:
        self._queue.put(None)
        self._thread.join()


def run(cell, seed: int, seconds: float, traced: bool, device, started: float) -> Outcome:
    """One run of a serving cell; ``started`` is the process's start on
    ``time.time()``'s clock."""
    from pointcloudprocessing_tpu_torch.models.pipeline import PointCloudPipeline

    fixed_precision()
    device = torch.device(device)
    mix = cell.traffic
    b = mix["batch"]
    model, weights = program_with_weights(cell, seed, device)
    pool = frames.make_pool(mix["frames"], seed, device)
    batches = [pool.points[i * b:(i + 1) * b] for i in range(len(pool.points) // b)]
    handed: list[float] = []

    def source():
        for j in itertools.count():
            handed.append(time.perf_counter())
            yield batches[j % len(batches)]

    pipe = PointCloudPipeline(model, scan_width=mix["scan_width"],
                              model_width=mix["model_width"],
                              voxel_size=mix["voxel_size"], sampler=mix["sampler"])
    stream = pipe.stream(source(), prefetch=mix["prefetch"])
    waiter = Waiter(device)
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x636D70]))
    compare = set(rng.choice(mix["compare_from_first"], mix["compare_batches"],
                             replace=False).tolist())
    kept: dict[int, dict] = {}
    consumed, first_timed = 0, None

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def consume(count: int) -> list[int]:
        nonlocal consumed
        taken = []
        for _ in range(count):
            out = next(stream)
            waiter.mark(consumed)
            if first_timed is not None and consumed - first_timed in compare:
                kept[consumed] = out
            taken.append(consumed)
            consumed += 1
        return taken

    consume(mix["warmup_batches"])
    sync()
    setup_peak = 0
    if device.type == "cuda":
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.time() - started
    first_timed = consumed
    stretches: list[list[int]] = []
    stretch = None
    t_start = time.perf_counter()
    t_end = t_start + seconds
    while time.perf_counter() < t_end:
        if traced and stretch is None and time.perf_counter() >= t_start + seconds / 3:
            sync()
            time.sleep(0.05)  # the producer settles before the pre-roll
            stretch = trace.device_trace(
                lambda: stretches.append(consume(mix["trace_batches"])))
            continue
        consume(1)
    sync()
    t_stop = time.perf_counter()
    window_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    stream.close()
    waiter.finish()
    timed = range(first_timed, consumed)
    latencies = [waiter.done[i] - handed[i] for i in timed]
    clouds = len(timed) * b
    outcome = Outcome(attempted=clouds, failed=0, compared=[],
                      memory_peak_bytes=max(window_peak, setup_peak))
    if not traced:
        outcome.metrics = {
            "serve_clouds_per_s": clouds / (t_stop - t_start),
            "serve_batch_p95_ms": float(np.percentile(latencies, 95)) * 1e3,
            "peak_mem_gib": window_peak / 2**30,
            "setup_s": setup_s,
        }

    # the program is freed before the reference runs
    del pipe, stream, model
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if traced and stretch is not None:
        taken = stretches[stretch.attempt]
        with torch.no_grad():
            valid = [voxel_downsample(torch.from_numpy(batches[i % len(batches)]).to(device),
                                      mix["voxel_size"])[1].sum(dim=1).tolist()
                     for i in taken]
        outcome.reading = Reading(cell.traffic["kind"], stretch, len(taken), len(taken) * b,
                                  cell, valid)
    forward = cell.model.reference_forward(cell.config, weights)
    gaps: dict[str, list] = {}
    with torch.no_grad():
        for i in sorted(kept):
            scans = torch.from_numpy(batches[i % len(batches)]).to(device)
            expected = reference_pipeline.serve(forward, scans, mix["voxel_size"],
                                                mix["model_width"])
            for name, gap in check.head_gaps(kept[i], expected).items():
                gaps.setdefault(name, []).append(gap)
    # np.max keeps a NaN, which fails its limit
    outcome.numbers = {k: float(np.max(v)) for k, v in gaps.items()}
    outcome.compared = check.held(outcome.numbers, cell.limits) if kept else []
    return outcome
