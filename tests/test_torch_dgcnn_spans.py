"""DGCNN's spans on the CPU: a forward through ``PointCloudPipeline`` in a
profiler session opens ``pcp.model.knn`` once a graph and
``pcp.model.edge`` once an EdgeConv, inside ``pcp.pipeline.model``, and
counts no kernel launch; a session changes no output; and a span stays out of a program being traced
for export or compilation."""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from pointcloudprocessing_tpu_torch.models import dgcnn
from pointcloudprocessing_tpu_torch.models.dgcnn import DGCNN
from pointcloudprocessing_tpu_torch.models.pipeline import PointCloudPipeline
from pointcloudprocessing_tpu_torch.ops.cuda import build
from pointcloudprocessing_tpu_torch.utils import profiling

C, P, SCAN_W, MODEL_W = 5, 3, 256, 64
GRAPHS = {"dynamic": 4, "static": 1}


def _model(graph: str, impl: str = "auto") -> DGCNN:
    return DGCNN(C, P, k=8, edge_widths=(16, 16, 32, 32), emb_width=64, graph=graph,
                 edge_impl=impl, generator=torch.Generator().manual_seed(5),
                 device="cpu").eval()


def _scans() -> np.ndarray:
    return np.random.default_rng(7).uniform(-2, 2, (2, SCAN_W, 3)).astype(np.float32)


def _spans(prof, name: str) -> list:
    return sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CPU and e.name == name),
                  key=lambda e: e.time_range.start)


def _inside(inner, outer) -> bool:
    return (inner.thread == outer.thread
            and outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


@pytest.mark.parametrize("impl", ["reference", "factored"])
@pytest.mark.parametrize("graph", ["dynamic", "static"])
def test_a_forward_marks_each_graph_and_edge_block(graph, impl):
    """One batch through the pipeline in a session: ``pcp.model.knn`` once
    a graph built (4 dynamic, 1 static), ``pcp.model.edge`` once an
    EdgeConv, each inside the batch's ``pcp.pipeline.model``, none
    overlapping another; the CPU's graphs count no launch
    (``build.LAUNCHES``)."""
    pipe = PointCloudPipeline(_model(graph, impl), scan_width=SCAN_W, model_width=MODEL_W,
                              voxel_size=0.25)
    before = dict(build.LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = pipe(_scans())
    assert out["segmentation_output"].shape == (2, MODEL_W, P)
    assert build.LAUNCHES == before
    (model,) = _spans(prof, "pcp.pipeline.model")
    knn, edge = _spans(prof, "pcp.model.knn"), _spans(prof, "pcp.model.edge")
    assert (len(knn), len(edge)) == (GRAPHS[graph], 4)
    assert all(_inside(s, model) for s in knn + edge)
    ordered = sorted(knn + edge, key=lambda e: e.time_range.start)
    assert all(a.time_range.end <= b.time_range.start for a, b in zip(ordered, ordered[1:]))
    expect = ["knn", "edge"] * 4 if graph == "dynamic" else ["knn"] + ["edge"] * 4
    assert [s.name.split(".")[-1] for s in ordered] == expect


@pytest.mark.parametrize("graph", ["dynamic", "static"])
def test_a_session_changes_no_output(graph):
    """The heads bit for bit with and without a profiler session."""
    pipe = PointCloudPipeline(_model(graph), scan_width=SCAN_W, model_width=MODEL_W,
                              voxel_size=0.25)
    plain = pipe(_scans())
    with profile(activities=[ProfilerActivity.CPU]):
        traced = pipe(_scans())
    assert plain.keys() == traced.keys()
    assert all(torch.equal(plain[k], traced[k]) for k in plain)


def test_the_counter_survives_a_recorder_on_the_name(monkeypatch):
    """A stand-in for ``models.dgcnn.knn_graph`` (a recorder, as a replay
    uses) calls the real function, whose ``pcp.model.knn`` spans still
    count the graphs."""
    real, seen = dgcnn.knn_graph, []

    def recording(feats, k):
        idx = real(feats, k)
        seen.append(idx)
        return idx

    monkeypatch.setattr(dgcnn, "knn_graph", recording)
    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU]) as prof:
        _model("dynamic")(torch.randn(2, 32, 3))
    assert len(seen) == 4 and len(_spans(prof, "pcp.model.knn")) == 4


def test_a_span_while_compiling_is_the_null_context(monkeypatch):
    """In a session, a span is the shared null context while
    ``torch.compiler.is_compiling()`` is true; with no session the
    compiling check is never made."""
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.span("pcp.model.knn") is not profiling._OFF
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
        assert profiling.span("pcp.model.knn") is profiling._OFF

    def refuse():
        raise AssertionError("the compiling check ran with no session")

    monkeypatch.setattr(torch.compiler, "is_compiling", refuse)
    assert profiling.span("pcp.model.edge") is profiling._OFF
