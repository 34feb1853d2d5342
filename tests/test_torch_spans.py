"""The port's spans (``utils/profiling.span``) on the CPU: free with no
profiler session, recorded at the pipeline's, the loader's and the train
step's layer boundaries inside one, on the clock of the session's trace,
and absent from the exported programs."""

import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from pointcloudprocessing_tpu_torch.core.config import LearningConfig
from pointcloudprocessing_tpu_torch.data.loader import DeviceLoader
from pointcloudprocessing_tpu_torch.models.pipeline import PointCloudPipeline
from pointcloudprocessing_tpu_torch.models.pointnet import FreezeFlags, PointNet
from pointcloudprocessing_tpu_torch.train import steps
from pointcloudprocessing_tpu_torch.utils import profiling

C, P, SCAN_W, MODEL_W = 5, 3, 256, 64


def _model(train: bool = False) -> PointNet:
    model = PointNet(C, P, regularize_input_transform=True,
                     regularize_feature_transform=True,
                     generator=torch.Generator().manual_seed(0), device="cpu")
    return model.train(train)


def _every_thread():
    """A CPU session that records every thread: the producers' threads
    too, which a default session does not see."""
    return profile(activities=[ProfilerActivity.CPU],
                   experimental_config=_ExperimentalConfig(profile_all_threads=True))


def _spans(prof) -> list:
    return sorted((e for e in prof.events() if e.device_type == DeviceType.CPU
                   and e.name.startswith(profiling.SPAN_PREFIX)),
                  key=lambda e: e.time_range.start)


def _inside(inner, outer) -> bool:
    return (inner.thread == outer.thread
            and outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


def test_a_span_with_no_session_is_one_shared_null_context(monkeypatch):
    """No profiler: every span is the same null object, nothing reaches the
    profiler's range, and a thousand spans allocate nothing."""
    def refuse(name):
        raise AssertionError(f"a range was opened for {name}")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    first = profiling.span("pcp.pipeline.batch")
    assert first is profiling.span("pcp.train.step") is profiling._OFF

    def spans(n):
        for _ in range(n):
            with profiling.span("pcp.pipeline.model"):
                pass

    spans(10)  # the loop's own first-call costs
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        spans(1000)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [s for s in after.compare_to(before, "filename")
             if s.traceback[0].filename == profiling.__file__ and s.size_diff > 0]
    assert grown == []


def test_a_span_in_a_session_is_a_host_op_on_the_trace_clock():
    """In a session a span is a host range (not a user annotation, which
    would put a device row of its name among the kernels), and its start
    less the session's trace start lies within 200 us of the wall clock
    read just before it."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(4).sum()  # the session's first op
        before_ns = time.time_ns()
        with profiling.span("pcp.clock"):
            torch.ones(4).sum()
    (clock,) = _spans(prof)
    assert clock.name == "pcp.clock" and not clock.is_user_annotation
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    gap_us = clock.time_range.start - (before_ns - start_ns) / 1e3
    assert abs(gap_us) < 200.0, gap_us
    assert [e.name for e in prof.events() if e.name == "aten::sum"
            and _inside(e, clock)] == ["aten::sum"]


def test_the_pipeline_marks_each_batch_and_its_stages():
    """Three batches of ``stream()`` in a session that records every
    thread: three of each ``pcp.pipeline`` range; voxel, sample and model
    inside their batch on the consumer's thread, the staging on the
    producer's."""
    pipe = PointCloudPipeline(_model(), scan_width=SCAN_W, model_width=MODEL_W,
                              voxel_size=0.25)
    rng = np.random.default_rng(3)
    scans = [rng.uniform(-2, 2, (2, SCAN_W, 3)).astype(np.float32) for _ in range(3)]
    with _every_thread() as prof:
        stream = pipe.stream(iter(scans))
        outs = [next(stream) for _ in range(3)]
        stream.close()
    assert all(o["classification_output"].shape == (2, C) for o in outs)
    spans = _spans(prof)
    by_name = {}
    for s in spans:
        by_name.setdefault(s.name.split(".")[-1], []).append(s)
    assert {k: len(v) for k, v in by_name.items()} == {
        k: 3 for k in ("stage", "queue_wait", "batch", "voxel", "sample", "model")}
    for i, batch in enumerate(by_name["batch"]):
        for child in ("voxel", "sample", "model"):
            assert _inside(by_name[child][i], batch), (child, i)
        assert by_name["queue_wait"][i].thread == batch.thread
        assert by_name["queue_wait"][i].time_range.end <= batch.time_range.start
        assert by_name["stage"][i].thread != batch.thread
    order = [by_name[k][0].time_range.start for k in ("voxel", "sample", "model")]
    assert order == sorted(order)


def test_the_train_step_marks_its_phases_and_the_loader_its_wait():
    """One CPU step fed by ``DeviceLoader.batches`` in a session that
    records every thread: forward, backward, metrics and optimizer once
    each inside the step, in that order; the loader's wait on the step's
    thread before it, its staging on its own thread."""
    model = _model(train=True)
    freeze = FreezeFlags()
    state, optimizer = steps.init_train_state(model, LearningConfig(rate=1e-4), freeze)
    step = steps.make_train_step(model, optimizer, (1.0, 1.0, 0.1), freeze,
                                 (0.01, 0.01, 0.01))
    rng = np.random.default_rng(4)
    b, n = 4, 128
    arrays = {"observations": rng.normal(size=(2 * b, n, 3)).astype(np.float32),
              "class_label": rng.integers(0, C, 2 * b),
              "part_labels": rng.integers(0, P, (2 * b, n)),
              "se3": np.tile(np.eye(3, dtype=np.float32), (2 * b, 1, 1))}
    loader = DeviceLoader(arrays, batch_size=b, shuffle=False)
    with _every_thread() as prof:
        feed = loader.batches(device="cpu", prefetch=1)
        x, targets = next(feed)
        state, logs = step(state, x, targets, 7)
        feed.close()
    assert np.isfinite(float(logs["loss"]))
    spans = _spans(prof)
    names = [s.name for s in spans]
    (unit,) = [s for s in spans if s.name == "pcp.train.step"]
    phases = [s for s in spans if _inside(s, unit) and s is not unit]
    assert [s.name for s in phases] == ["pcp.train.forward", "pcp.train.backward",
                                        "pcp.train.metrics", "pcp.train.optimizer"]
    (wait,) = [s for s in spans if s.name == "pcp.loader.wait"]
    assert wait.thread == unit.thread and wait.time_range.end <= unit.time_range.start
    stages = [s for s in spans if s.name == "pcp.loader.stage"]
    assert stages and all(s.thread != unit.thread for s in stages)
    assert set(names) == {"pcp.train.step", "pcp.train.forward", "pcp.train.backward",
                          "pcp.train.metrics", "pcp.train.optimizer", "pcp.loader.wait",
                          "pcp.loader.stage"}


@pytest.mark.parametrize("every_thread", [False, True])
def test_a_default_session_records_only_its_own_thread(every_thread):
    """A default session's callbacks are the opening thread's: another
    thread, started before the session or inside it, records no span
    (``by_span`` then gives its device rows to the unit span's thread). A
    session that records every thread sees both."""
    go, done = threading.Event(), threading.Event()

    def worker(name):
        with profiling.span(name):
            torch.ones(4).sum()

    def early_worker():
        go.wait(timeout=30)
        worker("pcp.early")
        done.set()

    early = threading.Thread(target=early_worker)
    early.start()
    session = _every_thread() if every_thread else profile(activities=[ProfilerActivity.CPU])
    with session as prof:
        go.set()
        assert done.wait(timeout=30)
        late = threading.Thread(target=worker, args=("pcp.late",))
        late.start()
        late.join(timeout=30)
        with profiling.span("pcp.own"):
            torch.ones(4).sum()
    early.join(timeout=30)
    assert not early.is_alive() and not late.is_alive()
    expect = ["pcp.early", "pcp.late", "pcp.own"] if every_thread else ["pcp.own"]
    assert [s.name for s in _spans(prof)] == expect


@pytest.mark.parametrize("family", ["pointnet", "dgcnn"])
def test_exported_programs_hold_no_span(tmp_path, family):
    """Spans sit around PointNet's call and inside DGCNN's ``forward``
    (``pcp.model.knn``, ``pcp.model.edge``), and neither reaches an exported
    program: a ``.pt2`` traced while a session records spans, and the ONNX
    writer's graph, hold no ``pcp.`` node."""
    from pointcloudprocessing_tpu_torch.export.onnx_native import (
        export_onnx_native,
        export_onnx_native_dgcnn,
    )
    from pointcloudprocessing_tpu_torch.export.pt2 import export_program
    from pointcloudprocessing_tpu_torch.models.dgcnn import DGCNN

    if family == "pointnet":
        model = PointNet(C, P, vanilla=True, generator=torch.Generator().manual_seed(1),
                         device="cpu").eval()
        write_onnx = export_onnx_native
    else:
        model = DGCNN(C, P, k=8, edge_widths=(16, 16, 32, 32), emb_width=64,
                      generator=torch.Generator().manual_seed(1), device="cpu").eval()
        write_onnx = export_onnx_native_dgcnn
    with profile(activities=[ProfilerActivity.CPU]):
        exported = export_program(model, 32, str(tmp_path / "m.pt2"), batch_size=2,
                                  device="cpu")
    text = str(exported.graph_module.graph) + "".join(
        str(node.args) for node in exported.graph_module.graph.nodes)
    assert "pcp." not in text and "record_function" not in text
    onnx = write_onnx(model, 32, str(tmp_path / "m.onnx"), print_func=lambda _: None)
    with open(onnx, "rb") as f:
        assert b"pcp." not in f.read()


@pytest.mark.parametrize("thread_of_copy", ["stage", "none"])
def test_by_span_gives_rows_to_the_launching_span(thread_of_copy):
    """``by_span`` on hand-built events: a kernel to the innermost span of
    its launching thread, autograd's launch (a thread with no span) to the
    step's thread's span at that instant, a copy from the producer to its
    ``stage`` span, or to the step's span when the producer was not
    recorded."""
    ev = _Events()
    ev.span("pcp.train.step", 0, 100, thread=1)
    ev.span("pcp.train.forward", 1, 40, thread=1)
    ev.span("pcp.train.backward", 41, 90, thread=1)
    ev.launch(2, 30.0, thread=1)      # forward
    ev.launch(50, 20.0, thread=2)     # autograd's thread: backward
    ev.launch(95, 3.0, thread=1)      # the step, past its phases
    if thread_of_copy == "stage":
        ev.span("pcp.loader.stage", 10, 20, thread=3)
    ev.launch(12, 5.0, thread=3, name="cudaMemcpyAsync")
    ev.launch(200, 7.0, thread=1)     # outside every span
    got = profiling.by_span(ev.events)
    copy_to = "pcp.loader.stage" if thread_of_copy == "stage" else "pcp.train.forward"
    expect = {"pcp.train.forward": 30.0, "pcp.train.backward": 20.0,
              "pcp.train.step": 3.0, profiling.NO_SPAN: 7.0}
    expect[copy_to] = expect.get(copy_to, 0.0) + 5.0
    assert got == expect
    assert list(got) == sorted(got, key=lambda k: -got[k])


class _Range:
    def __init__(self, start, end):
        self.start, self.end = start, end

    def elapsed_us(self):
        return self.end - self.start


class _Event:
    def __init__(self, name, start, end, thread, ident, device_type):
        self.name, self.thread, self.id = name, thread, ident
        self.time_range = _Range(start, end)
        self.device_type = device_type
        self.device_resource_id = 1000 + thread


class _Events:
    """Host spans and launch calls, each launch with its device row."""

    def __init__(self):
        self.events, self._id = [], 100

    def span(self, name, start, end, thread):
        self.events.append(_Event(name, start, end, thread, 0, DeviceType.CPU))

    def launch(self, t, device_us, thread, name="cudaLaunchKernel"):
        self._id += 1
        self.events.append(_Event(name, t, t + 0.5, thread, self._id, DeviceType.CPU))
        self.events.append(_Event("kernel", 1000 + t, 1000 + t + device_us, 7, self._id,
                                  DeviceType.CUDA))
