"""The port's native ONNX writer and interpreter against the JAX package's.

On the same weights (a randomized Flax tree, converted into the port's
model) the port writes the same bytes as the JAX writer for PointNet (full
and vanilla), PointNet++ and DGCNN (dynamic and static graph); the port's
interpreter runs its file within 1e-4 of the port's eager CPU forward (the
JAX ONNX tests' bar) at batch 1 and 3 (the batch is dynamic); and every op
case of ``tests/test_onnx_fuzz.py``, built with the port's writer
primitives, gives identical results (bit for bit) through both
interpreters. Sizes: 5 classes, 4 parts, 64 points.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudprocessing_tpu.export import onnx_native as jax_onnx
from pointcloudprocessing_tpu.models import PointNet as JaxPointNet
from pointcloudprocessing_tpu.models import dgcnn as jax_dgcnn
from pointcloudprocessing_tpu.models import pointnet2 as jax_pn2
from pointcloudprocessing_tpu_torch.convert import state_dict_from_flax
from pointcloudprocessing_tpu_torch.export import onnx_native
from pointcloudprocessing_tpu_torch.models import dgcnn, pointnet2
from pointcloudprocessing_tpu_torch.models.pointnet import PointNet
from test_torch_pointnet import randomize

N = 64
C, P = 5, 4
ATOL = 1e-4  # the JAX ONNX tests' bar (tests/test_onnx_native.py)
HEADS = ("classification_output", "segmentation_output", "se3")
FAMILIES = ("pointnet", "pointnet_vanilla", "pointnet2", "dgcnn", "dgcnn_static")
WRITERS = {
    "pointnet": "export_onnx_native",
    "pointnet_vanilla": "export_onnx_native",
    "pointnet2": "export_onnx_native_pointnet2",
    "dgcnn": "export_onnx_native_dgcnn",
    "dgcnn_static": "export_onnx_native_dgcnn",
}


def _models(family: str):
    """(JAX model, the port's model on the CPU) of one family."""
    if family.startswith("pointnet") and family != "pointnet2":
        vanilla = family == "pointnet_vanilla"
        return (JaxPointNet(C, P, vanilla=vanilla),
                PointNet(C, P, vanilla=vanilla, device="cpu"))
    if family == "pointnet2":
        return (jax_pn2.pointnet2_for_width(C, P, N),
                pointnet2.pointnet2_for_width(C, P, N, device="cpu"))
    kw = dict(graph="static", k=10) if family == "dgcnn_static" else {}
    return (jax_dgcnn.dgcnn_for_width(C, P, N, **kw),
            dgcnn.dgcnn_for_width(C, P, N, device="cpu", **kw))


@pytest.fixture(scope="module", params=FAMILIES)
def pair(request):
    """A family's JAX model with randomized variables and the port's twin
    loaded with the converted weights, in eval mode."""
    jmodel, model = _models(request.param)
    init = jax.jit(lambda r, x: jmodel.init(r, x, train=False))(
        jax.random.key(0), jnp.zeros((1, N, 3), jnp.float32))
    variables = randomize({"params": init["params"],
                           "batch_stats": init["batch_stats"]}, seed=1)
    model.load_state_dict(state_dict_from_flax(variables))
    return request.param, jmodel, variables, model.eval()


def _cloud(b, seed):
    return (np.random.default_rng(seed).normal(size=(b, N, 3)) * 3.0).astype(
        np.float32)


def test_file_bytes_equal_jax_writer(pair, tmp_path):
    """The same weights give byte-equal files through both writers."""
    family, jmodel, variables, model = pair
    want_path, got_path = str(tmp_path / "jax.onnx"), str(tmp_path / "port.onnx")
    getattr(jax_onnx, WRITERS[family])(jmodel, variables, N, want_path,
                                       print_func=lambda s: None)
    getattr(onnx_native, WRITERS[family])(model, N, got_path,
                                          print_func=lambda s: None)
    want, got = open(want_path, "rb").read(), open(got_path, "rb").read()
    assert len(got) == len(want) and got == want


def test_run_onnx_matches_eager_forward(pair, tmp_path):
    """The port's file through the port's interpreter, at batch 1 and 3,
    against the port's eager CPU forward: every head within 1e-4."""
    family, _, _, model = pair
    path = str(tmp_path / "m.onnx")
    getattr(onnx_native, WRITERS[family])(model, N, path, print_func=lambda s: None)
    parsed = onnx_native.parse_model(open(path, "rb").read())
    assert parsed["opset"] == 13 and parsed["inputs"] == ["points"]
    assert parsed["outputs"] == list(HEADS)
    for b in (1, 3):
        pts = _cloud(b, seed=b)
        got = onnx_native.run_onnx(parsed, {"points": pts})
        with torch.no_grad():
            want = model(torch.from_numpy(pts))
        for key in HEADS:
            assert got[key].shape == tuple(want[key].shape), key
            np.testing.assert_allclose(got[key], want[key].numpy(), rtol=0,
                                       atol=ATOL, err_msg=f"{family} b={b} {key}")


def test_opset_other_than_13_is_refused(tmp_path):
    model = PointNet(C, P, vanilla=True, device="cpu")
    with pytest.raises(ValueError, match="opset 13"):
        onnx_native.export_onnx_native(model, N, str(tmp_path / "m.onnx"),
                                       opset=11)


# -- tests/test_onnx_fuzz.py's op cases through both interpreters -----------

def _f(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _i64(values):
    return np.asarray(values, np.int64)


def _attr_i(name, value):
    return onnx_native._attr_i(name, value)


def _attr_ints(name, values):
    return onnx_native._attr_ints(name, values)


def _matmul(rng):
    for sa, sb in (((4, 5), (5, 3)), ((2, 4, 5), (2, 5, 3)),
                   ((2, 3, 4, 5), (2, 3, 5, 6)), ((2, 4, 5), (5, 3))):
        yield "MatMul", {"a": _f(rng, *sa), "b": _f(rng, *sb)}, (), (), 1


def _elementwise(rng):
    cases = (((3, 4), (3, 4)), ((3, 4), (4,)), ((2, 1, 4), (3, 1)), ((5,), ()))
    for op in ("Add", "Sub", "Mul", "Div", "Max", "Min"):
        for sa, sb in cases:
            yield op, {"a": _f(rng, *sa), "b": _f(rng, *sb) + 2.0}, (), (), 1


def _unary(rng):
    x = _f(rng, 3, 5)
    yield "Relu", {"x": x}, (), (), 1
    yield "Sqrt", {"x": np.abs(x)}, (), (), 1


def _softmax(rng):
    x = _f(rng, 2, 7, 5) * 4.0
    for axis in (-1, 1, 2):
        yield "Softmax", {"x": x}, (_attr_i("axis", axis),), (), 1


def _reduce_attr_axes(rng):
    x = _f(rng, 2, 6, 5)
    for axes in ((1,), (-1,), (1, 2), (0, -1)):
        for keep in (0, 1):
            attrs = (_attr_ints("axes", axes), _attr_i("keepdims", keep))
            yield "ReduceMean", {"x": x}, attrs, (), 1
            yield "ReduceMax", {"x": x}, attrs, (), 1


def _reducesum_input_axes(rng):
    x = _f(rng, 3, 4, 5)
    for axes in ((0,), (2,), (1, 2)):
        yield ("ReduceSum", {"x": x}, (_attr_i("keepdims", 1),),
               (("ax", _i64(axes)),), 1)


def _unsqueeze_input_axes(rng):
    x = _f(rng, 3, 4)
    for axes in ((0,), (2,), (0, 3)):
        yield "Unsqueeze", {"x": x}, (), (("ax", _i64(axes)),), 1


def _transpose_concat_reshape(rng):
    x = _f(rng, 2, 3, 4)
    for perm in ((0, 2, 1), (2, 0, 1), (1, 2, 0)):
        yield "Transpose", {"x": x}, (_attr_ints("perm", perm),), (), 1
    yield ("Concat", {"a": _f(rng, 2, 3, 4), "b": _f(rng, 2, 5, 4)},
           (_attr_i("axis", 1),), (), 1)
    yield "Reshape", {"x": x}, (), (("s", _i64([-1, 4])),), 1


def _topk(rng):
    x = _f(rng, 3, 16)
    x[:, 5] = x[:, 2]  # ties: the lower index first
    for largest in (1, 0):
        yield ("TopK", {"x": x}, (_attr_i("axis", -1), _attr_i("largest", largest)),
               (("k", _i64([4])),), 2)


def _gathernd(rng):
    yield ("GatherND", {"d": _f(rng, 3, 10, 6),
                        "i": rng.integers(0, 10, (3, 4, 5, 1)).astype(np.int64)},
           (_attr_i("batch_dims", 1),), (), 1)


def _where_lessorequal_argmax(rng):
    a, b = _f(rng, 4, 5), _f(rng, 4, 5)
    yield "LessOrEqual", {"a": a, "b": b}, (), (), 1
    yield "Where", {"c": a <= b, "a": a, "b": b}, (), (), 1
    for keep in (0, 1):
        yield ("ArgMax", {"x": a}, (_attr_i("axis", 1), _attr_i("keepdims", keep)),
               (), 1)


def _slice(rng):
    x = _f(rng, 4, 10, 6)
    for starts, ends, axes in (([1], [3], [0]), ([0], [-1], [1]),
                               ([2], [1 << 30], [1]), ([0, 1], [2, 4], [0, 2])):
        yield ("Slice", {"x": x}, (),
               (("s", _i64(starts)), ("e", _i64(ends)), ("a", _i64(axes))), 1)


def _expand_gather_shape_identity(rng):
    x = _f(rng, 3, 1, 5)
    yield "Expand", {"x": x}, (), (("s", _i64([3, 4, 5])),), 1
    yield "Shape", {"x": x}, (), (), 1
    yield ("Gather", {"d": _f(rng, 7, 4),
                      "i": rng.integers(0, 7, (3,)).astype(np.int64)},
           (_attr_i("axis", 0),), (), 1)
    yield "Identity", {"x": x}, (), (), 1


OP_CASES = {f.__name__[1:]: f for f in (
    _matmul, _elementwise, _unary, _softmax, _reduce_attr_axes,
    _reducesum_input_axes, _unsqueeze_input_axes, _transpose_concat_reshape,
    _topk, _gathernd, _where_lessorequal_argmax, _slice,
    _expand_gather_shape_identity)}


def _single_op_model(writer, op_type, feeds, attrs, initializers, n_out):
    in_names = list(feeds) + [name for name, _ in initializers]
    out_names = [f"out{i}" for i in range(n_out)]
    node = writer.node_proto(op_type, in_names, out_names, "n0", attrs=list(attrs))
    graph = writer.graph_proto(
        nodes=[node], name="fuzz",
        initializers=[writer.tensor_proto(n, a) for n, a in initializers],
        inputs=[writer.value_info(n, np.shape(feeds[n])) for n in feeds],
        outputs=[writer.value_info(n, ()) for n in out_names],
    )
    return writer.model_proto(graph), out_names


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_op_cases_identical_through_both_interpreters(case, seed):
    """Each one-op graph: the two writers' bytes are equal, and the port's
    interpreter returns JAX's interpreter's arrays bit for bit (values,
    dtypes and shapes)."""
    rng = np.random.default_rng(100 + seed)
    count = 0
    for op_type, feeds, attrs, inits, n_out in OP_CASES[case](rng):
        blob, outs = _single_op_model(onnx_native, op_type, feeds, attrs, inits, n_out)
        jblob, _ = _single_op_model(jax_onnx, op_type, feeds, attrs, inits, n_out)
        assert blob == jblob, op_type
        got = onnx_native.run_onnx(onnx_native.parse_model(blob), dict(feeds))
        want = jax_onnx.run_onnx(jax_onnx.parse_model(blob), dict(feeds))
        for name in outs:
            assert got[name].dtype == want[name].dtype, op_type
            np.testing.assert_array_equal(got[name], want[name], err_msg=op_type)
        count += 1
    assert count > 0
