"""The port's per-kernel device-time tool (``tools/torch/trace_ops.py``, twin
of ``tools/trace_ops.py``) and its trace reader
(``pointcloudprocessing_tpu_torch/utils/profiling.py``) on the CPU.

``summarize`` and the trace audit run on hand-built rows; the four
workloads run end to end at a tiny size through the kernels' plain
versions; the ``preprocess`` and ``infer`` workloads are held against the
JAX package's same calls on the same seeded inputs (the weights carried
across by the port's converter). The traces themselves need the card:
``chip_smoke.py`` phase 16 runs the workloads there at the JAX tool's
shapes.
"""

import importlib
import importlib.util
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from pointcloudprocessing_tpu.models.pointnet import PointNet as JaxPointNet
from pointcloudprocessing_tpu_torch.convert import state_dict_from_flax
from pointcloudprocessing_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
jvoxel = importlib.import_module("pointcloudprocessing_tpu.ops.voxel")
jnormals = importlib.import_module("pointcloudprocessing_tpu.ops.normals")


def _load(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


trace_ops = _load("trace_ops_torch_under_test", "tools/torch/trace_ops.py")


def _row(name, start, dur, ident=0):
    span = types.SimpleNamespace(start=start, end=start + dur,
                                 elapsed_us=lambda: dur)
    return types.SimpleNamespace(name=name, time_range=span, id=ident)


def _rows(spec):
    """Device rows from (name, us, count) triples, laid end to end."""
    rows, t = [], 0.0
    for name, us, count in spec:
        for _ in range(count):
            rows.append(_row(name, t, us))
            t += us
    return rows


def test_summarize_ranks_names_by_device_time():
    rows = _rows([("void fps_kernel<1024>(x)", 10.0, 4), ("Memcpy HtoD", 1.0, 2),
                  ("elementwise", 3.0, 20), ("Memset (Device)", 0.5, 2)])
    s = profiling.summarize(rows, steps=2)
    assert s.steps == 2
    assert s.total_us_per_step == pytest.approx((40 + 2 + 60 + 1) / 2)
    assert [r.name for r in s.rows] == ["elementwise", "void fps_kernel<1024>(x)",
                                        "Memcpy HtoD", "Memset (Device)"]
    top = s.rows[0]
    assert top.us_per_step == pytest.approx(30.0)
    assert top.n_per_step == pytest.approx(10.0)
    assert top.percent == pytest.approx(100 * 60 / 103)
    assert sum(r.percent for r in s.rows) == pytest.approx(100.0)
    # copies and memsets are rows of their own, by name
    assert s.by_name["Memcpy HtoD"].n_per_step == pytest.approx(1.0)
    assert s.by_name["Memset (Device)"].us_per_step == pytest.approx(0.5)


@pytest.mark.parametrize("top", [1, 2, 3])
def test_summarize_folds_the_rest_into_one_more_row(top):
    rows = _rows([("a", 5.0, 2), ("b", 4.0, 2), ("c", 3.0, 2), ("d", 2.0, 1)])
    s = profiling.summarize(rows, steps=1, top=top)
    assert [r.name for r in s.rows[:top]] == ["a", "b", "c", "d"][:top]
    more = s.rows[top]
    assert more.name == f"(+{4 - top} more)"
    assert more.n_per_step is None
    assert more.us_per_step == pytest.approx(sum([10.0, 8.0, 6.0, 2.0][top:]))
    assert more.percent == pytest.approx(100 * more.us_per_step / 26.0)
    assert len(s.rows) == top + 1
    assert len(s.by_name) == 4  # every name keeps its row


def test_summarize_without_a_rest_row_and_its_table():
    rows = _rows([("void pooled_forward_tma_kernel<128>(CUtensorMap)", 19.5, 6),
                  ("elementwise", 2.0, 3)])
    s = profiling.summarize(rows, steps=2, top=40)
    assert not any(r.name.startswith("(+") for r in s.rows)
    lines = s.table().splitlines()
    assert lines[0].split() == ["us/step", "%", "n/step", "op"]
    assert lines[1].split()[:3] == ["58.5", "95.1", "3.0"]
    assert lines[1].endswith("pooled_forward_tma_kernel<128>(CUtensorMap)")
    assert lines[2].split() == ["3.0", "4.9", "1.5", "elementwise"]
    more = profiling.summarize(rows, steps=2, top=1).table().splitlines()[-1]
    assert more.split() == ["3.0", "4.9", "(+1", "more)"]


def _host(name, start, ident):
    row = _row(name, start, 1.0, ident)
    row.device_type = DeviceType.CPU
    return row


def _device(start, ident):
    row = _row("k", start, 1.0, ident)
    row.device_type = DeviceType.CUDA
    return row


def test_audit_finds_launch_calls_without_their_device_rows():
    """The window's launch calls before the pre-roll's synchronize are the
    pre-roll's: their rows are dropped and their losses counted. Each of
    the call's launch calls (kernel, copy, memset) whose correlation id
    has no device row makes the attempt not whole, at its position."""
    pre = [_host("cudaLaunchKernel", t, 10 + t) for t in (0, 1, 2)]
    sync = [_host("cudaDeviceSynchronize", 3, 13), _host("aten::add_", 0.5, 99)]
    calls = [_host(name, 10.0 * i + 10, 100 + i) for i, name in enumerate(
        ["cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
         "cudaMemcpyAsync", "cudaMemsetAsync", "cudaStreamSynchronize",
         "cudaLaunchKernel"])]
    device = [_device(0.5, 11), _device(1.5, 12)] + [
        _device(10.0 * i + 15, 100 + i) for i in (1, 2, 3, 6)]
    rows = pre + sync + calls + device
    attempt, kept = profiling._audit(rows, 3, "cuda")
    # the pre-roll lost one row (id 10); the call's synchronize launches
    # nothing; its calls 0 and 4 lost their rows
    assert attempt.preroll_lost == 1
    assert attempt.launches == 6
    assert attempt.missing == [0, 4]
    assert not attempt.whole
    assert attempt.rows == 4 and sorted(e.id for e in kept) == [101, 102, 103, 106]
    text = attempt.describe()
    assert "4 device rows, 6 launch calls, 2 without a row (at 0,4)" in text
    assert "1 of the pre-roll's without a row" in text
    # a synchronize before the pre-roll's first launch is not its boundary
    early = [_host("cudaDeviceSynchronize", -5.0, 9)]
    assert profiling._audit(early + rows, 3, "cuda")[0] == attempt

    whole, kept = profiling._audit(pre + sync + calls[1:4] + device[:5], 3, "cpu+cuda")
    assert whole.whole and whole.missing == [] and whole.activities == "cpu+cuda"
    assert len(kept) == 3
    # no pre-roll: every launch call is the call's
    none, _ = profiling._audit(calls[1:4] + device[2:5], 0, "cuda")
    assert none.whole and none.launches == 3 and none.preroll_lost == 0
    # a pre-roll whose synchronize is not in the trace cannot be told apart
    lost, _ = profiling._audit(pre + calls + device, 3, "cuda")
    assert not lost.whole
    empty, _ = profiling._audit(calls, 0, "cuda")
    assert not empty.whole and empty.rows == 0


def test_report_prints_the_jax_header_and_the_table():
    rows = _rows([("void window_moments_kernel<16>(float4 const*)", 90.0, 20),
                  ("elementwise", 5.0, 40)])
    attempt = profiling.Attempt("cuda", 64, 60, 60, [], 0)
    trace = profiling.DeviceTrace(rows, 4500.0, [attempt])
    traced = trace_ops.Traced(trace, profiling.summarize(rows, 20), 4.2, 0)
    workload = trace_ops.Workload("preprocess", lambda: None, 20, 1, np.zeros(1))
    text = trace_ops.report(workload, traced).splitlines()
    assert text[0] == ("sync compute: 100.0 us/step over 20 steps (2.00 ms traced "
                       "in 4.50 ms of host wall; CUDA events 4.20 ms)")
    assert text[1] == ("trace: cuda, pre-roll 64: 60 device rows, 60 launch calls, "
                       "0 without a row; 0 of the pre-roll's without a row")
    assert text[3].split()[-1] == "op"
    assert text[4].split()[:3] == ["90.0", "90.0", "1.0"]
    assert "no device rows" in trace_ops.report(
        workload, trace_ops.Traced(None, None, 0.0, 0))


def test_report_prints_device_time_by_span():
    """With host events the report ends with the device time a step by
    the ``pcp.`` span that launched it, rows of no span last."""
    host, device = [], []
    for span_name, start, end in [("pcp.train.forward", 0, 10),
                                  ("pcp.train.backward", 10, 20)]:
        span = _row(span_name, start, end - start)
        span.device_type, span.thread = DeviceType.CPU, 1
        host.append(span)
    for ident, (t, us) in enumerate([(1, 30.0), (12, 50.0), (30, 20.0)]):
        call = _host("cudaLaunchKernel", t, ident)
        call.thread = 1
        host.append(call)
        row = _device(t + 100, ident)
        row.time_range = _row("k", t + 100, us).time_range
        device.append(row)
    attempt = profiling.Attempt("cpu+cuda", 64, 3, 3, [], 0)
    trace = profiling.DeviceTrace(device, 500.0, [attempt], host)
    traced = trace_ops.Traced(trace, profiling.summarize(device, 2), 0.4, 0)
    workload = trace_ops.Workload("train", lambda: None, 2, 1, np.zeros(1))
    text = trace_ops.report(workload, traced).splitlines()
    assert text[-4].split() == ["us/step", "%", "span"]
    assert [line.split() for line in text[-3:]] == [
        ["25.0", "50.0", "pcp.train.backward"], ["15.0", "30.0", "pcp.train.forward"],
        ["10.0", "20.0", "(no", "span)"]]


@pytest.mark.parametrize("what,kwargs", [
    ("train", dict(chunk=2, batch=2, width=64)),
    ("preprocess", dict(batch=2, width=256)),
    ("infer", dict(batch=2, width=256)),
    ("pn2", dict(batch=2, width=256)),
])
def test_workloads_run_end_to_end_on_the_cpu(what, kwargs):
    """Each workload at a tiny size, one dispatch, through the plain
    versions: finite outputs of the expected shapes."""
    w = trace_ops.WORKLOADS[what]("cpu", n_dispatch=1, **kwargs)
    assert w.name == what and w.n_dispatch == 1
    out = w.dispatch()
    if what == "train":
        assert w.steps == 2 and w.model.training
        assert w.inputs.shape == (2, 2, 64, 3)
        assert all(np.isfinite(float(v)) for v in out.values())
        assert out["classification_total"].item() == 2
    elif what == "preprocess":
        vox, mask, normals = out
        assert vox.shape == normals.shape == (2, 256, 3) and mask.shape == (2, 256)
        assert torch.isfinite(normals[mask]).all()
    else:
        assert not w.model.training
        assert out["classification_output"].shape == (2, 23)
        assert out["segmentation_output"].shape == (2, 256, 12)
        assert out["se3"].shape == (2, 3, 3)
        assert all(torch.isfinite(v).all() for v in out.values())


def _angles(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Angle in degrees between unit vectors, up to sign, from the chord."""
    a, b = a.astype(np.float64), b.astype(np.float64)
    chord = np.minimum(np.linalg.norm(a - b, axis=-1), np.linalg.norm(a + b, axis=-1))
    return np.degrees(2 * np.arcsin(np.clip(chord / 2, 0.0, 1.0)))


def test_preprocess_matches_jax():
    """Config 2's voxel 0.5 and window normals k 16 (``trace_ops.py:82-86``)
    on the workload's seeded uniform(-30, 30) clouds: the voxel counts and
    mask identical, the voxels within f32 rounding, the normals within the
    window-normals parity bar (median under 0.1 degree, as
    ``test_torch_normals.py`` holds them)."""
    w = trace_ops.preprocess("cpu", batch=2, width=1024, n_dispatch=1)
    vox, mask, normals = (t.numpy() for t in w.dispatch())
    jv, jm = jvoxel.voxel_downsample_batch(jnp.asarray(w.inputs), 0.5)
    jn = jnormals.estimate_normals_batch(jv, k=16, valid_mask=jm, method="window")
    np.testing.assert_array_equal(mask, np.asarray(jm))
    assert (mask.sum(1) > 900).all()
    np.testing.assert_allclose(vox, np.asarray(jv), rtol=1e-6, atol=1e-6)
    ang = _angles(normals, np.asarray(jn))[mask]
    assert np.median(ang) < 0.1, np.median(ang)


def test_infer_matches_jax():
    """The multi-head inference workload (``trace_ops.py:98-119``) with
    the JAX model's initial weights carried over by the converter: every
    head within 1e-4 of the JAX model's on the same seeded clouds."""
    w = trace_ops.infer("cpu", batch=2, width=256, n_dispatch=1)
    jmodel = JaxPointNet(num_classes=23, num_parts=12)
    variables = jmodel.init(jax.random.key(0), jnp.asarray(w.inputs[:1]), train=False)
    w.model.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, dict(variables))))
    got = w.dispatch()
    want = jmodel.apply(variables, jnp.asarray(w.inputs), train=False)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=0, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("argv,error", [
    (["infer"], RuntimeError), (["train", "--device", "cuda"], RuntimeError),
    (["preprocess", "--device", "cpu"], SystemExit),
])
def test_main_needs_cuda(argv, error):
    """Without CUDA the default device raises through ``utils/device.py``;
    a CPU device is refused: the tool reads device time."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(error):
        trace_ops.main(argv)


def test_trace_loss_probe_needs_cuda():
    """``tools/torch/trace_loss.py`` (the probe of the profiler's lost
    device rows) runs on the card only."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    probe = _load("trace_loss_torch_under_test", "tools/torch/trace_loss.py")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        probe.main()
