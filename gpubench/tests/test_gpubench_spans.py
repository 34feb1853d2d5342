"""The span readers (``harness/spans.py`` and the metrics that read it) on
hand-built traces: each device row given to the span that launched it, the
fallback for a thread with no span, the host sync calls, and every reader's
value, or None where the program has no spans. The program's ``by_span``
and its copy agree."""

import dataclasses

import pytest
from torch.autograd import DeviceType

from gpubench.harness import registry, spans, trace
from gpubench.harness.session import Reading
from gpubench.tests.helpers import ROOT
from pointcloudprocessing_tpu_torch.utils import profiling

UNITS = 2
#: the consumer's (or step's) thread, autograd's device thread, a producer
#: the profiler did not record (its calls carry the consumer's ordinal, a
#: resource id of their own), a producer it recorded, and a waiter thread
MAIN, AUTOGRAD, UNRECORDED, PRODUCER, WAITER = (1, 10), (2, 20), (1, 99), (3, 30), (1, 77)


@dataclasses.dataclass
class Range:
    start: float
    end: float

    def elapsed_us(self):
        return self.end - self.start


@dataclasses.dataclass
class Event:
    name: str
    time_range: Range
    thread: int
    device_resource_id: int
    id: int = 0
    device_type: DeviceType = DeviceType.CPU


class Trace:
    """Host events, and a device row for each launch call."""

    def __init__(self):
        self.host, self.rows, self._id = [], [], 1000

    def host_event(self, name, start, end, thread):
        self.host.append(Event(name, Range(start, end), *thread))

    def launch(self, t, device_us, thread, name="cudaLaunchKernel"):
        self._id += 1
        self.host.append(Event(name, Range(t, t + 0.5), *thread, id=self._id))
        self.rows.append(Event("kernel", Range(5000 + t, 5000 + t + device_us), 0, 7,
                               id=self._id, device_type=DeviceType.CUDA))

    def reading(self, kind, spans_kept=True):
        host = [e for e in self.host if spans_kept or not e.name.startswith("pcp.")]
        stretch = trace.Stretch(list(self.rows), host, 1e-3, 0,
                                [trace.Attempt(0, len(self.rows), 0, [], 0)])
        return Reading(kind, stretch, UNITS, UNITS * 4, None)


def serving() -> Trace:
    """Two batches: the consumer's wait, batch, voxel, sample and model;
    a copy from an unrecorded producer during the model, a waiter's event
    synchronize, one stream synchronize in the model a batch."""
    tr = Trace()
    for o in (0.0, 100.0):
        tr.host_event("pcp.pipeline.queue_wait", o, o + 5, MAIN)
        tr.host_event("pcp.pipeline.batch", o + 5, o + 90, MAIN)
        tr.host_event("pcp.pipeline.voxel", o + 6, o + 20, MAIN)
        tr.host_event("pcp.pipeline.sample", o + 21, o + 40, MAIN)
        tr.host_event("pcp.pipeline.model", o + 41, o + 89, MAIN)
        tr.host_event("aten::linear", o + 42, o + 43, MAIN)
        tr.launch(o + 7, 3.0, MAIN)
        tr.launch(o + 22, 4.0, MAIN)
        tr.launch(o + 42, 20.0, MAIN)
        tr.launch(o + 45, 2.0, UNRECORDED, "cudaMemcpyAsync")
        tr.host_event("cudaStreamSynchronize", o + 60, o + 62, MAIN)
        tr.host_event("cudaEventSynchronize", o + 50, o + 80, WAITER)
    return tr


def training() -> Trace:
    """Two steps: the loader's wait, then the step and its phases; the
    backward launched from autograd's thread, a pageable copy and its
    stream synchronize in the metrics, a copy on a recorded producer's
    ``pcp.loader.stage``."""
    tr = Trace()
    for o in (0.0, 100.0):
        tr.host_event("pcp.loader.wait", o, o + 8, MAIN)
        tr.host_event("pcp.train.step", o + 10, o + 95, MAIN)
        tr.host_event("pcp.train.forward", o + 11, o + 40, MAIN)
        tr.host_event("pcp.train.backward", o + 41, o + 70, MAIN)
        tr.host_event("pcp.train.metrics", o + 71, o + 80, MAIN)
        tr.host_event("pcp.train.optimizer", o + 81, o + 94, MAIN)
        tr.host_event("pcp.loader.stage", o + 20, o + 30, PRODUCER)
        tr.launch(o + 12, 10.0, MAIN)
        tr.launch(o + 45, 15.0, AUTOGRAD)
        tr.launch(o + 72, 1.0, MAIN, "cudaMemcpyAsync")
        tr.host_event("cudaStreamSynchronize", o + 73, o + 75, MAIN)
        tr.launch(o + 82, 5.0, MAIN)
        tr.launch(o + 22, 6.0, PRODUCER, "cudaMemcpyAsync")
    tr.launch(300.0, 9.0, MAIN)  # outside every span
    return tr


def metric(name):
    return registry.load_module(ROOT / "gpubench" / "metrics" / f"{name}.py",
                                "test_metric_" + name.replace(".", "_"))


def test_rows_go_to_the_launching_threads_innermost_span():
    tr = training()
    given = {row.time_range.start - 5000: s and s.name
             for row, s in spans.span_of_rows(tr.rows + tr.host)}
    assert given[12.0] == "pcp.train.forward"       # on the launching thread
    assert given[82.0] == "pcp.train.optimizer"
    assert given[72.0] == "pcp.train.metrics"
    assert given[45.0] == "pcp.train.backward"      # autograd's thread: the step's then
    assert given[22.0] == "pcp.loader.stage"        # the producer's copy, its own span
    assert given[300.0] is None
    assert spans.by_span(tr.rows + tr.host) == {
        "pcp.train.backward": 30.0, "pcp.train.forward": 20.0, "pcp.loader.stage": 12.0,
        "pcp.train.optimizer": 10.0, spans.NO_SPAN: 9.0, "pcp.train.metrics": 2.0}


def test_a_thread_with_no_span_falls_back_to_the_unit_spans_thread():
    """The unrecorded producer's copy shares the consumer's ordinal but not
    its resource id: it goes to the consumer's span open at its launch (the
    model), not to a span of its own."""
    tr = serving()
    assert spans.by_span(tr.rows + tr.host) == {
        "pcp.pipeline.model": 44.0, "pcp.pipeline.sample": 8.0, "pcp.pipeline.voxel": 6.0}


def test_sync_calls_are_counted_on_their_own_threads_span():
    tr = serving()
    found = spans.syncs(tr.reading("serve_stream"))
    # the waiter's event synchronize runs on a thread with no span
    assert [(e.name, s.name) for e, s in found] == [
        ("cudaStreamSynchronize", "pcp.pipeline.model")] * 2


@pytest.mark.parametrize("kind,build,expect", [
    ("serve_stream", serving, {
        "preprocess_device_ms.serve": 0.007, "model_device_ms.serve": 0.022,
        "queue_wait_ms.serve": 0.005, "host_syncs_per_batch.serve": 1.0}),
    ("train_step", training, {
        "forward_device_ms.train": 0.010, "backward_device_ms.train": 0.015,
        "optimizer_device_ms.train": 0.005, "feed_wait_ms.train": 0.008,
        "step_host_busy_ms.train": 0.083, "host_syncs_per_step.train": 1.0}),
])
def test_each_reader_on_a_hand_made_stretch(kind, build, expect):
    """Each reader's value a unit; None on the other kind's stretch, and
    None (not 0) where the program recorded no span."""
    tr = build()
    other = "train_step" if kind == "serve_stream" else "serve_stream"
    for name, value in expect.items():
        reader = metric(name)
        assert reader.read(tr.reading(kind)) == pytest.approx(value), name
        assert reader.read(tr.reading(kind, spans_kept=False)) is None, name
        assert reader.read(tr.reading(other)) is None, name


def test_the_new_metrics_are_declared_with_their_readers():
    """Each new reader has its ``per_layer`` entry, read where it lists."""
    from gpubench.tests.helpers import benchmark

    declared = {m["name"]: m for m in benchmark()["per_layer"]}
    for name in ("preprocess_device_ms.serve", "model_device_ms.serve",
                 "queue_wait_ms.serve", "host_syncs_per_batch.serve"):
        assert declared[name]["workloads"] == ["pointnet_serve_8192", "pointnet2_serve_8192"]
    for name in ("forward_device_ms.train", "backward_device_ms.train",
                 "optimizer_device_ms.train", "feed_wait_ms.train",
                 "step_host_busy_ms.train", "host_syncs_per_step.train"):
        assert declared[name]["workloads"] == ["pointnet_train_8192"]


@pytest.mark.parametrize("build", [serving, training])
def test_the_copy_is_the_programs(build):
    """``harness/spans.py``'s ``span_of_rows`` and ``by_span`` give what
    ``utils/profiling``'s give, on the same events."""
    tr = build()
    events = tr.rows + tr.host
    assert spans.by_span(events) == profiling.by_span(events)
    assert [(r.id, s and id(s)) for r, s in spans.span_of_rows(events)] == \
        [(r.id, s and id(s)) for r, s in profiling.span_of_rows(events)]
    assert spans.NO_SPAN == profiling.NO_SPAN and spans.UNIT_SPANS == profiling.UNIT_SPANS
    assert spans.SPAN_PREFIX == profiling.SPAN_PREFIX
