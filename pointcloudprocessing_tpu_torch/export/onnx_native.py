"""Native ONNX (opset 13) export and its numpy interpreter
(``pointcloudprocessing_tpu/export/onnx_native.py``), fed from the port's
torch models.

The writer, the graph emitters, the protobuf reader and the interpreter are
numpy-only copies of the JAX package's, tagged. Only the three entry points
differ: each takes a torch model, reads its weights as the Flax-shaped numpy
tree (``convert.flax_from_state_dict(model.state_dict())``) and its
hyperparameters from the port's modules (PointNet++'s ``sa1``/``sa2``
``num_centroids``/``k``/``radius``, DGCNN's ``k``/``edge_widths``/``graph``).
On the same weights the port writes the same bytes as the JAX writer.

The graph is the inference program with a dynamic batch: running BatchNorm
statistics folded into Mul/Add, exact TopK kNN, FPS unrolled with direct
difference distances (the FPS kernel's plain version), the output
signature ``[-1, C], [-1, n, P], [-1, 3, 3]``. Opset-13 details the
interpreter enforces: ``ReduceSum`` and ``Unsqueeze`` take their axes as an
input, ``ReduceMean``/``ReduceMax`` as an attribute, ``Reshape`` its shape
as an input.
"""

from __future__ import annotations

import struct
from typing import Callable, Sequence

import numpy as np

# -- minimal protobuf writer --------------------------------------------------

# copied from pointcloudprocessing_tpu/export/onnx_native.py::_WIRE_VARINT
_WIRE_VARINT = 0
# copied from pointcloudprocessing_tpu/export/onnx_native.py::_WIRE_I64
_WIRE_I64 = 1
# copied from pointcloudprocessing_tpu/export/onnx_native.py::_WIRE_LEN
_WIRE_LEN = 2
# copied from pointcloudprocessing_tpu/export/onnx_native.py::_WIRE_I32
_WIRE_I32 = 5

# copied from pointcloudprocessing_tpu/export/onnx_native.py::FLOAT
#: TensorProto.DataType
FLOAT = 1
# copied from pointcloudprocessing_tpu/export/onnx_native.py::INT64
INT64 = 7


# copied from pointcloudprocessing_tpu/export/onnx_native.py::_varint
def _varint(value: int) -> bytes:
    out = bytearray()
    v = value & 0xFFFFFFFFFFFFFFFF  # two's complement for negative ints
    while True:
        byte = v & 0x7F
        v >>= 7
        if v:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


# copied from pointcloudprocessing_tpu/export/onnx_native.py::_tag
def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


# copied from pointcloudprocessing_tpu/export/onnx_native.py::_ld
def _ld(field: int, payload: bytes) -> bytes:
    return _tag(field, _WIRE_LEN) + _varint(len(payload)) + payload


# copied from pointcloudprocessing_tpu/export/onnx_native.py::_vi
def _vi(field: int, value: int) -> bytes:
    return _tag(field, _WIRE_VARINT) + _varint(value)


# copied from pointcloudprocessing_tpu/export/onnx_native.py::_str
def _str(field: int, s: str) -> bytes:
    return _ld(field, s.encode("utf-8"))


# copied from pointcloudprocessing_tpu/export/onnx_native.py::tensor_proto
def tensor_proto(name: str, arr: np.ndarray) -> bytes:
    """TensorProto: dims=1, data_type=2, name=8, raw_data=9."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.float32:
        dt = FLOAT
    elif arr.dtype == np.int64:
        dt = INT64
    else:
        raise TypeError(f"unsupported initializer dtype {arr.dtype}")
    out = b"".join(_vi(1, int(d)) for d in arr.shape)
    out += _vi(2, dt)
    out += _str(8, name)
    out += _ld(9, arr.tobytes())
    return out


# copied from pointcloudprocessing_tpu/export/onnx_native.py::_attr_i
def _attr_i(name: str, value: int) -> bytes:
    # AttributeProto: name=1, i=3, type=20 (INT=2)
    return _str(1, name) + _vi(3, value) + _vi(20, 2)


# copied from pointcloudprocessing_tpu/export/onnx_native.py::_attr_ints
def _attr_ints(name: str, values: Sequence[int]) -> bytes:
    # ints=8 (repeated varint), type INTS=7
    out = _str(1, name)
    for v in values:
        out += _vi(8, v)
    return out + _vi(20, 7)


# copied from pointcloudprocessing_tpu/export/onnx_native.py::node_proto
def node_proto(
    op_type: str,
    inputs: Sequence[str],
    outputs: Sequence[str],
    name: str,
    attrs: Sequence[bytes] = (),
) -> bytes:
    # NodeProto: input=1, output=2, name=3, op_type=4, attribute=5
    out = b"".join(_str(1, i) for i in inputs)
    out += b"".join(_str(2, o) for o in outputs)
    out += _str(3, name)
    out += _str(4, op_type)
    out += b"".join(_ld(5, a) for a in attrs)
    return out


# copied from pointcloudprocessing_tpu/export/onnx_native.py::value_info
def value_info(name: str, shape: Sequence) -> bytes:
    """ValueInfoProto for a float tensor; str dims become dim_param."""
    dims = b""
    for d in shape:
        if isinstance(d, str):
            dims += _ld(1, _str(2, d))  # Dimension.dim_param=2
        else:
            dims += _ld(1, _vi(1, int(d)))  # Dimension.dim_value=1
    tensor_type = _vi(1, FLOAT) + _ld(2, dims)  # elem_type=1, shape=2
    type_proto = _ld(1, tensor_type)  # TypeProto.tensor_type=1
    return _str(1, name) + _ld(2, type_proto)  # name=1, type=2


# copied from pointcloudprocessing_tpu/export/onnx_native.py::graph_proto
def graph_proto(
    nodes: Sequence[bytes],
    name: str,
    initializers: Sequence[bytes],
    inputs: Sequence[bytes],
    outputs: Sequence[bytes],
) -> bytes:
    # GraphProto: node=1, name=2, initializer=5, input=11, output=12
    out = b"".join(_ld(1, n) for n in nodes)
    out += _str(2, name)
    out += b"".join(_ld(5, t) for t in initializers)
    out += b"".join(_ld(11, i) for i in inputs)
    out += b"".join(_ld(12, o) for o in outputs)
    return out


# copied from pointcloudprocessing_tpu/export/onnx_native.py::model_proto
def model_proto(graph: bytes, opset: int = 13) -> bytes:
    # ModelProto: ir_version=1, producer_name=2, graph=7, opset_import=8
    opset_id = _str(1, "") + _vi(2, opset)  # OperatorSetIdProto
    return (
        _vi(1, 8)  # IR version 8 (opset 13 era)
        # the JAX writer's producer name: both writers give the same bytes
        + _str(2, "pointcloudprocessing_tpu")
        + _ld(7, graph)
        + _ld(8, opset_id)
    )


# -- graph builder ------------------------------------------------------------


# copied from pointcloudprocessing_tpu/export/onnx_native.py::_Builder
class _Builder:
    def __init__(self):
        self.nodes: list[bytes] = []
        self.inits: list[bytes] = []
        self._n = 0

    def _name(self, op: str) -> str:
        self._n += 1
        return f"{op}_{self._n}"

    def init(self, arr: np.ndarray, name: str | None = None) -> str:
        name = name or self._name("const")
        self.inits.append(tensor_proto(name, arr))
        return name

    def op(self, op_type: str, inputs: Sequence[str], attrs=(), n_out: int = 1):
        name = self._name(op_type)
        outs = [name] if n_out == 1 else [f"{name}_o{i}" for i in range(n_out)]
        self.nodes.append(node_proto(op_type, inputs, outs, name, attrs))
        return outs[0] if n_out == 1 else outs

    # common ops
    def matmul(self, a, b):
        return self.op("MatMul", [a, b])

    def add(self, a, b):
        return self.op("Add", [a, b])

    def sub(self, a, b):
        return self.op("Sub", [a, b])

    def mul(self, a, b):
        return self.op("Mul", [a, b])

    def div(self, a, b):
        return self.op("Div", [a, b])

    def relu(self, x):
        return self.op("Relu", [x])

    def softmax(self, x):
        return self.op("Softmax", [x], [_attr_i("axis", -1)])

    def reduce_mean(self, x, axes, keepdims):
        return self.op(
            "ReduceMean", [x],
            [_attr_ints("axes", axes), _attr_i("keepdims", int(keepdims))],
        )

    def reduce_max(self, x, axes, keepdims):
        return self.op(
            "ReduceMax", [x],
            [_attr_ints("axes", axes), _attr_i("keepdims", int(keepdims))],
        )

    def reduce_sum(self, x, axes, keepdims):
        # opset 13: axes is an INPUT tensor
        ax = self.init(np.asarray(axes, np.int64))
        return self.op("ReduceSum", [x, ax], [_attr_i("keepdims", int(keepdims))])

    def unsqueeze(self, x, axes):
        ax = self.init(np.asarray(axes, np.int64))
        return self.op("Unsqueeze", [x, ax])

    def reshape(self, x, shape):
        sh = self.init(np.asarray(shape, np.int64))
        return self.op("Reshape", [x, sh])

    # graph-building ops for the kNN/FPS model families (PN++/DGCNN)
    def transpose(self, x, perm):
        return self.op("Transpose", [x], [_attr_ints("perm", perm)])

    def concat(self, xs, axis):
        return self.op("Concat", list(xs), [_attr_i("axis", axis)])

    def topk(self, x, k, axis=-1, largest=0):
        """opset 13: k is a 1-D input tensor. Returns (values, indices)."""
        kt = self.init(np.asarray([k], np.int64))
        return self.op(
            "TopK", [x, kt],
            [_attr_i("axis", axis), _attr_i("largest", largest),
             _attr_i("sorted", 1)],
            n_out=2,
        )

    def gather_nd(self, data, indices, batch_dims=1):
        return self.op(
            "GatherND", [data, indices], [_attr_i("batch_dims", batch_dims)]
        )

    def where(self, cond, a, b):
        return self.op("Where", [cond, a, b])

    def less_equal(self, a, b):
        return self.op("LessOrEqual", [a, b])

    def argmax(self, x, axis, keepdims=0):
        return self.op(
            "ArgMax", [x], [_attr_i("axis", axis), _attr_i("keepdims", keepdims)]
        )

    def slice_(self, x, starts, ends, axes):
        return self.op("Slice", [
            x,
            self.init(np.asarray(starts, np.int64)),
            self.init(np.asarray(ends, np.int64)),
            self.init(np.asarray(axes, np.int64)),
        ])

    def emax(self, a, b):
        return self.op("Max", [a, b])

    def emin(self, a, b):
        return self.op("Min", [a, b])

    def shape(self, x):
        return self.op("Shape", [x])

    def expand(self, x, target):
        return self.op("Expand", [x, target])

    def rename_output(self, value: str, public_name: str):
        """Emit Identity so the graph output carries a stable name."""
        node = self._name("Identity")
        self.nodes.append(node_proto("Identity", [value], [public_name], node))


# copied from pointcloudprocessing_tpu/export/onnx_native.py::_f32
def _f32(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32)


# -- shared emit helpers (all three family exporters) --------------------------


# copied from pointcloudprocessing_tpu/export/onnx_native.py::_subtree
def _subtree(tree, path: str):
    for part in path.split("/"):
        tree = tree[part]
    return tree


# copied from pointcloudprocessing_tpu/export/onnx_native.py::_fold_bn
def _fold_bn(params, stats, tree_path: str):
    """(a, b) with y = a*x + b — inference BatchNorm folded."""
    from pointcloudprocessing_tpu_torch.core.constants import KERAS_BN_EPSILON

    p = _subtree(params, tree_path)
    s = _subtree(stats, tree_path)
    gamma, beta = _f32(p["scale"]), _f32(p["bias"])
    mean, var = _f32(s["mean"]), _f32(s["var"])
    a = gamma / np.sqrt(var + np.float32(KERAS_BN_EPSILON))
    return a, beta - mean * a


# copied from pointcloudprocessing_tpu/export/onnx_native.py::_emit_block
def _emit_block(g: _Builder, params, stats, x, prefix: str, dense_name: str,
                apply_bn: bool, act):
    """MatMul + folded-BN (or bias) + activation for one Pointwise/Dense
    block (models/layers.py conventions: ``use_bias = not apply_bn``)."""
    p = _subtree(params, prefix)
    x = g.matmul(x, g.init(_f32(p[dense_name]["kernel"])))
    if apply_bn:
        a, b = _fold_bn(params, stats, f"{prefix}/bn")
        x = g.add(g.mul(x, g.init(a)), g.init(b))
    else:
        x = g.add(x, g.init(_f32(p[dense_name]["bias"])))
    if act == "relu":
        x = g.relu(x)
    elif act == "softmax":
        x = g.softmax(x)
    return x


# copied from pointcloudprocessing_tpu/export/onnx_native.py::_emit_normalize
def _emit_normalize(g: _Builder, points: str) -> str:
    """Unit-sphere normalization (ops/normalize.py): centroid-center then
    scale by max distance (eps floor)."""
    from pointcloudprocessing_tpu_torch.core.constants import NORMALIZATION_EPSILON

    centroid = g.reduce_mean(points, [1], keepdims=True)
    centered = g.sub(points, centroid)
    sq = g.reduce_sum(g.mul(centered, centered), [2], keepdims=True)
    dist = g.op("Sqrt", [sq])
    max_dist = g.reduce_max(dist, [1], keepdims=True)  # (b, 1, 1)
    eps = g.init(_f32(NORMALIZATION_EPSILON).reshape(1, 1, 1))
    return g.div(centered, g.emax(max_dist, eps))


# copied from pointcloudprocessing_tpu/export/onnx_native.py::_emit_identity_se3
def _emit_identity_se3(g: _Builder, points: str) -> str:
    """se3 output = identity broadcast to the dynamic batch (families with
    no transform regression — models/pointnet2.py, models/dgcnn.py)."""
    eye = g.init(np.eye(3, dtype=np.float32)[None])
    shp = g.shape(points)
    b_dim = g.op(
        "Gather", [shp, g.init(np.asarray([0], np.int64))], [_attr_i("axis", 0)]
    )
    target = g.concat([b_dim, g.init(np.asarray([3, 3], np.int64))], 0)
    return g.expand(eye, target)


# copied from pointcloudprocessing_tpu/export/onnx_native.py::_emit_sq_dists
def _emit_sq_dists(g: _Builder, q: str, p: str) -> str:
    """Pairwise squared distances (b, m, 3|c) x (b, n, 3|c) -> (b, m, n),
    clamped at 0 — the |q|^2 + |p|^2 - 2 q.p expansion the model families
    use (models/pointnet2.py::_grouping_knn, models/dgcnn.py::knn_graph)."""
    q2 = g.reduce_sum(g.mul(q, q), [2], keepdims=True)  # (b, m, 1)
    p2 = g.unsqueeze(g.reduce_sum(g.mul(p, p), [2], keepdims=False), [1])
    cross = g.matmul(q, g.transpose(p, [0, 2, 1]))  # (b, m, n)
    two = g.init(_f32(2.0).reshape(()))
    d = g.sub(g.add(q2, p2), g.mul(two, cross))
    return g.emax(d, g.init(_f32(0.0).reshape(())))


# copied from pointcloudprocessing_tpu/export/onnx_native.py::_emit_gather_rows
def _emit_gather_rows(g: _Builder, data: str, idx: str, idx_rank: int) -> str:
    """Row gather data (b, n, c) by idx (b, ...) -> (b, ..., c): GatherND
    with batch_dims=1 over trailing unsqueezed index depth 1."""
    return g.gather_nd(data, g.unsqueeze(idx, [idx_rank]), batch_dims=1)


# copied from pointcloudprocessing_tpu/export/onnx_native.py::_emit_fps
def _emit_fps(g: _Builder, pc: str, num_samples: int) -> str:
    """Farthest-point sampling, unrolled (ops/fps.py semantics: seed index
    0, running min squared distance, argmax selection — first-max ties).
    Returns (b, num_samples) int64 indices."""
    shp = g.shape(pc)
    b_dim = g.op(
        "Gather", [shp, g.init(np.asarray([0], np.int64))], [_attr_i("axis", 0)]
    )
    target = g.concat([b_dim, g.init(np.asarray([1], np.int64))], 0)
    sel0 = g.expand(g.init(np.zeros((1, 1), np.int64)), target)  # (b, 1)
    selected = [sel0]
    last = _emit_gather_rows(g, pc, sel0, idx_rank=2)  # (b, 1, 3)
    diff = g.sub(pc, last)
    min_dist = g.reduce_sum(g.mul(diff, diff), [2], keepdims=False)  # (b, n)
    for i in range(1, num_samples):
        nxt = g.unsqueeze(g.argmax(min_dist, axis=1, keepdims=0), [1])
        selected.append(nxt)
        if i < num_samples - 1:
            last = _emit_gather_rows(g, pc, nxt, idx_rank=2)
            diff = g.sub(pc, last)
            d = g.reduce_sum(g.mul(diff, diff), [2], keepdims=False)
            min_dist = g.emin(min_dist, d)
    return g.concat(selected, 1) if num_samples > 1 else sel0


def _variables(model) -> dict:
    """The Flax-shaped ``{"params", "batch_stats"}`` numpy tree of a torch
    model's weights, which the copied emitters read."""
    from pointcloudprocessing_tpu_torch.convert import flax_from_state_dict

    return flax_from_state_dict(model.state_dict())


# adapted from pointcloudprocessing_tpu/export/onnx_native.py::export_onnx_native:
# a torch model in place of (model, variables)
def export_onnx_native(
    model,
    input_width: int,
    path: str,
    print_func: Callable[[str], None] = print,
    opset: int = 13,
) -> str:
    """Write a torch :class:`~pointcloudprocessing_tpu_torch.models.pointnet.PointNet`'s
    inference graph as an opset-13 .onnx file.

    Inference semantics: running BatchNorm statistics folded into Mul/Add,
    dropout omitted, all three heads emitted — the reference export's
    signature (cls (-1, C), seg (-1, n, P), se3 (-1, 3, 3)).
    """
    if opset != 13:
        # the emitted op set is written to opset-13 semantics (ReduceSum
        # axes-as-input, Reduce* axes attributes, Softmax axis) — refuse
        # rather than stamp a version the graph may not satisfy
        raise ValueError(f"native ONNX export supports opset 13 only, got {opset}")
    variables = _variables(model)
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    g = _Builder()

    def fold_bn(tree_path: str):
        return _fold_bn(params, stats, tree_path)

    def block(x, prefix: str, dense_name: str, apply_bn: bool, act):
        return _emit_block(g, params, stats, x, prefix, dense_name, apply_bn, act)

    def tnet(x, name: str, k: int):
        h = block(x, f"{name}/conv_layer_1", "conv", True, "relu")
        h = block(h, f"{name}/conv_layer_2", "conv", True, "relu")
        h = block(h, f"{name}/conv_layer_3", "conv", True, "relu")
        h = g.reduce_max(h, [1], keepdims=False)  # (b, 1024)
        h = block(h, f"{name}/dense_layer_1", "dense", True, "relu")
        h = block(h, f"{name}/dense_layer_2", "dense", True, "relu")
        w = g.init(_f32(params[name]["w"]))
        b = g.init(_f32(params[name]["b"]))
        h = g.matmul(h, w)  # (b, k*k)
        h = g.reshape(h, [-1, k, k])
        return g.add(h, b)  # broadcast (k, k)

    # input + normalization (ops/normalize.py — centroid, max-norm scale)
    points = "points"
    pc = _emit_normalize(g, points)

    vanilla = "input_transform" not in params
    if not vanilla:
        r = tnet(pc, "input_transform", 3)
        x = g.matmul(pc, r)
    else:
        # se3 output = identity broadcast to the dynamic batch
        r = _emit_identity_se3(g, points)
        x = pc

    x = block(x, "mlp_1_1", "conv", True, "relu")
    x = block(x, "mlp_1_2", "conv", True, "relu")

    if not vanilla:
        r64 = tnet(x, "feature_transform", 64)
        x64 = g.matmul(x, r64)
    else:
        x64 = x

    x = block(x64, "mlp_2_1", "conv", True, "relu")
    x = block(x, "mlp_2_2", "conv", True, "relu")
    x = block(x, "mlp_2_3", "conv", True, "relu")
    global_features = g.reduce_max(x, [1], keepdims=False)  # (b, 1024)

    # classification head
    c = block(global_features, "mlp_cls_1", "dense", True, "relu")
    c = block(c, "mlp_cls_2", "dense", True, "relu")
    cls_out = block(c, "mlp_cls_3", "dense", False, "softmax")

    # segmentation head: split-kernel form of the 1088-wide concat layer
    seg_kernel = _f32(params["mlp_seg_1"]["conv"]["kernel"])  # (1088, 512)
    d_local = 64
    per_point = g.matmul(x64, g.init(seg_kernel[:d_local]))
    per_cloud = g.matmul(global_features, g.init(seg_kernel[d_local:]))
    s = g.add(per_point, g.unsqueeze(per_cloud, [1]))  # (b,n,512)+(b,1,512)
    a, b = fold_bn("mlp_seg_1/bn")
    s = g.relu(g.add(g.mul(s, g.init(a)), g.init(b)))
    s = block(s, "mlp_seg_2", "conv", True, "relu")
    s = block(s, "mlp_seg_3", "conv", True, "relu")
    s = block(s, "mlp_seg_4", "conv", True, "relu")
    seg_out = block(s, "mlp_seg_5", "conv", False, "softmax")

    num_classes = params["mlp_cls_3"]["dense"]["kernel"].shape[1]
    num_parts = params["mlp_seg_5"]["conv"]["kernel"].shape[1]
    return _finish_model(g, "pointnet", input_width, num_classes, num_parts,
                         cls_out, seg_out, r, path, print_func, "PointNet")


# copied from pointcloudprocessing_tpu/export/onnx_native.py::_finish_model
def _finish_model(g: _Builder, graph_name: str, input_width: int,
                  num_classes: int, num_parts: int, cls_out: str,
                  seg_out: str, se3: str, path: str, print_func, label: str):
    g.rename_output(cls_out, "classification_output")
    g.rename_output(seg_out, "segmentation_output")
    g.rename_output(se3, "se3")
    gp = graph_proto(
        g.nodes,
        graph_name,
        g.inits,
        [value_info("points", ["batch", input_width, 3])],
        [
            value_info("classification_output", ["batch", num_classes]),
            value_info("segmentation_output", ["batch", input_width, num_parts]),
            value_info("se3", ["batch", 3, 3]),
        ],
    )
    blob = model_proto(gp, opset=13)
    with open(path, "wb") as f:
        f.write(blob)
    print_func(
        f"Native ONNX export ({label}): {path} ({len(blob)} bytes, opset 13, "
        f"dynamic batch). No onnxruntime in this image — the graph is "
        f"numerically verified by the bundled numpy interpreter "
        f"(export/onnx_native.py::run_onnx)."
    )
    return path


# adapted from pointcloudprocessing_tpu/export/onnx_native.py::export_onnx_native_pointnet2:
# a torch model in place of (model, variables)
def export_onnx_native_pointnet2(
    model,
    input_width: int,
    path: str,
    print_func: Callable[[str], None] = print,
    opset: int = 13,
) -> str:
    """Write a torch PointNet++ (SSG)'s inference graph as opset-13 ONNX.

    kNN is exact TopK, as the port's model computes it. FPS is unrolled
    (``num_samples`` static per set-abstraction level), matching ops/fps.py:
    seed index 0, running min squared distance, argmax.
    """
    if opset != 13:
        raise ValueError(f"native ONNX export supports opset 13 only, got {opset}")
    variables = _variables(model)
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    g = _Builder()

    def block(x, prefix, dense_name="conv", apply_bn=True, act="relu"):
        return _emit_block(g, params, stats, x, prefix, dense_name, apply_bn, act)

    pc = _emit_normalize(g, "points")
    se3 = _emit_identity_se3(g, "points")

    def set_abstraction(xyz, feats, m, k, radius, name):
        """models/pointnet2.py::sample_and_group + _SetAbstraction."""
        centroid_idx = _emit_fps(g, xyz, m)
        new_xyz = _emit_gather_rows(g, xyz, centroid_idx, idx_rank=2)
        d = _emit_sq_dists(g, new_xyz, xyz)
        vals, idx = g.topk(d, k, largest=0)  # (b, m, k) each
        within = g.less_equal(vals, g.init(_f32(radius * radius).reshape(())))
        idx0 = g.slice_(idx, [0], [1], [2])  # (b, m, 1)
        idx = g.where(within, idx, idx0)
        grouped_xyz = _emit_gather_rows(g, xyz, idx, idx_rank=3)  # (b,m,k,3)
        grouped_xyz = g.sub(grouped_xyz, g.unsqueeze(new_xyz, [2]))
        if feats is not None:
            grouped = g.concat(
                [grouped_xyz, _emit_gather_rows(g, feats, idx, idx_rank=3)], -1
            )
        else:
            grouped = grouped_xyz
        x = grouped
        n_layers = len(_subtree(params, name))
        for i in range(n_layers):
            x = block(x, f"{name}/l{i + 1}")
        return new_xyz, g.reduce_max(x, [2], keepdims=False)

    m1, k1, r1 = model.sa1.num_centroids, model.sa1.k, model.sa1.radius
    m2, k2, r2 = model.sa2.num_centroids, model.sa2.k, model.sa2.radius
    xyz1, f1 = set_abstraction(pc, None, m1, k1, r1, "sa1")
    xyz2, f2 = set_abstraction(xyz1, f1, m2, k2, r2, "sa2")

    x = g.concat([xyz2, f2], -1)
    for i in range(len(_subtree(params, "sa3"))):
        x = block(x, f"sa3/l{i + 1}")
    global_features = g.reduce_max(x, [1], keepdims=False)  # (b, 1024)

    c = block(global_features, "mlp_cls_1", "dense")
    c = block(c, "mlp_cls_2", "dense")
    cls_out = block(c, "mlp_cls_out", "dense", apply_bn=False, act="softmax")

    def interpolate(fine_xyz, coarse_xyz, coarse_feats):
        """models/pointnet2.py::interpolate_features — exact 3-NN,
        inverse-squared-distance weights."""
        d = _emit_sq_dists(g, fine_xyz, coarse_xyz)
        vals, idx = g.topk(d, 3, largest=0)  # (b, n, 3)
        w = g.div(g.init(_f32(1.0).reshape(())),
                  g.add(vals, g.init(_f32(1e-8).reshape(()))))
        w = g.div(w, g.reduce_sum(w, [2], keepdims=True))
        nbr = _emit_gather_rows(g, coarse_feats, idx, idx_rank=3)  # (b,n,3,c)
        return g.reduce_sum(g.mul(nbr, g.unsqueeze(w, [3])), [2], keepdims=False)

    # segmentation decoder: global context onto f2, then FP2 -> FP1 -> full res
    shp_f2 = g.shape(f2)
    b_m2 = g.slice_(shp_f2, [0], [2], [0])  # (b, m2)
    gdim = int(_subtree(params, "sa3")[f"l{len(_subtree(params, 'sa3'))}"]["conv"]["kernel"].shape[1])
    target = g.concat([b_m2, g.init(np.asarray([gdim], np.int64))], 0)
    g2 = g.expand(g.unsqueeze(global_features, [1]), target)
    d2 = g.concat([f2, g2], -1)
    d2 = block(d2, "mlp_seg_fp2_l1")
    d2 = block(d2, "mlp_seg_fp2_l2")

    d1 = g.concat([f1, interpolate(xyz1, xyz2, d2)], -1)
    d1 = block(d1, "mlp_seg_fp1_l1")
    d1 = block(d1, "mlp_seg_fp1_l2")

    d0 = interpolate(pc, xyz1, d1)
    d0 = block(d0, "mlp_seg_l1")
    d0 = block(d0, "mlp_seg_l2")
    seg_out = block(d0, "mlp_seg_out", apply_bn=False, act="softmax")

    num_classes = params["mlp_cls_out"]["dense"]["kernel"].shape[1]
    num_parts = params["mlp_seg_out"]["conv"]["kernel"].shape[1]
    return _finish_model(g, "pointnet2", input_width, num_classes, num_parts,
                         cls_out, seg_out, se3, path, print_func, "PointNet2")


# adapted from pointcloudprocessing_tpu/export/onnx_native.py::export_onnx_native_dgcnn:
# a torch model in place of (model, variables)
def export_onnx_native_dgcnn(
    model,
    input_width: int,
    path: str,
    print_func: Callable[[str], None] = print,
    opset: int = 13,
) -> str:
    """Write a torch DGCNN's inference graph as opset-13 ONNX.

    Dynamic kNN per EdgeConv is exact TopK; the edge MLP is emitted in the
    literal Wang et al. dataflow (models/dgcnn.py ``impl='reference'`` —
    identical parameters and math to the factored path). A
    ``graph='static'`` model exports with ONE input-space TopK shared by
    every EdgeConv, matching the serving opt-in's semantics."""
    if opset != 13:
        raise ValueError(f"native ONNX export supports opset 13 only, got {opset}")
    variables = _variables(model)
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    g = _Builder()

    def block(x, prefix, dense_name="conv", apply_bn=True, act="relu"):
        return _emit_block(g, params, stats, x, prefix, dense_name, apply_bn, act)

    pc = _emit_normalize(g, "points")
    se3 = _emit_identity_se3(g, "points")

    x = pc
    static = getattr(model, "graph", "dynamic") == "static"
    shared_idx = None
    if static:
        d = _emit_sq_dists(g, pc, pc)
        _, shared_idx = g.topk(d, model.k, largest=0)  # (b, n, k)
    layer_outs = []
    for i in range(len(model.edge_widths)):
        if static:
            idx = shared_idx
        else:
            d = _emit_sq_dists(g, x, x)
            _, idx = g.topk(d, model.k, largest=0)  # (b, n, k) — self included
        nbr = _emit_gather_rows(g, x, idx, idx_rank=3)  # (b, n, k, c)
        center = g.unsqueeze(x, [2])  # (b, n, 1, c)
        center = g.expand(center, g.shape(nbr))
        edge = g.concat([center, g.sub(nbr, center)], -1)  # (b, n, k, 2c)
        h = block(edge, f"ec{i + 1}/l1")
        x = g.reduce_max(h, [2], keepdims=False)  # (b, n, w)
        layer_outs.append(x)

    local = g.concat(layer_outs, -1)  # (b, n, 512)
    emb = block(local, "emb")
    global_features = g.reduce_max(emb, [1], keepdims=False)

    c = block(global_features, "mlp_cls_1", "dense")
    c = block(c, "mlp_cls_2", "dense")
    cls_out = block(c, "mlp_cls_out", "dense", apply_bn=False, act="softmax")

    # seg head: split-kernel concat block (models/layers.py
    # ConcatPointwiseBlock — same params as the literal concat)
    seg_kernel = _f32(params["mlp_seg_1"]["conv"]["kernel"])
    d_local = int(sum(model.edge_widths))
    per_point = g.matmul(local, g.init(seg_kernel[:d_local]))
    per_cloud = g.matmul(global_features, g.init(seg_kernel[d_local:]))
    s = g.add(per_point, g.unsqueeze(per_cloud, [1]))
    a, b = _fold_bn(params, stats, "mlp_seg_1/bn")
    s = g.relu(g.add(g.mul(s, g.init(a)), g.init(b)))
    s = block(s, "mlp_seg_2")
    s = block(s, "mlp_seg_3")
    seg_out = block(s, "mlp_seg_out", apply_bn=False, act="softmax")

    num_classes = params["mlp_cls_out"]["dense"]["kernel"].shape[1]
    num_parts = params["mlp_seg_out"]["conv"]["kernel"].shape[1]
    return _finish_model(g, "dgcnn", input_width, num_classes, num_parts,
                         cls_out, seg_out, se3, path, print_func, "DGCNN")


# -- minimal reader + numpy interpreter (verification) ------------------------


# copied from pointcloudprocessing_tpu/export/onnx_native.py::_read_varint
def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


# copied from pointcloudprocessing_tpu/export/onnx_native.py::_parse_fields
def _parse_fields(buf: bytes):
    """Yield (field, wire, value) — value is bytes for LEN, int otherwise."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == _WIRE_VARINT:
            value, pos = _read_varint(buf, pos)
        elif wire == _WIRE_LEN:
            length, pos = _read_varint(buf, pos)
            value = buf[pos:pos + length]
            pos += length
        elif wire == _WIRE_I64:
            value = struct.unpack("<q", buf[pos:pos + 8])[0]
            pos += 8
        elif wire == _WIRE_I32:
            value = struct.unpack("<i", buf[pos:pos + 4])[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, value


# copied from pointcloudprocessing_tpu/export/onnx_native.py::_parse_tensor
def _parse_tensor(buf: bytes) -> tuple[str, np.ndarray]:
    dims, dtype, name, raw = [], FLOAT, "", b""
    for field, _, value in _parse_fields(buf):
        if field == 1:
            dims.append(value)
        elif field == 2:
            dtype = value
        elif field == 8:
            name = value.decode()
        elif field == 9:
            raw = value
    np_dtype = {FLOAT: np.float32, INT64: np.int64}[dtype]
    return name, np.frombuffer(raw, np_dtype).reshape(dims).copy()


# copied from pointcloudprocessing_tpu/export/onnx_native.py::_signed_int
def _signed_int(i):
    # protobuf varints store negatives as two's complement; undo for axis=-1
    return i - (1 << 64) if i >= (1 << 63) else i


# copied from pointcloudprocessing_tpu/export/onnx_native.py::_parse_node
def _parse_node(buf: bytes) -> dict:
    node = {"inputs": [], "outputs": [], "op": "", "attrs": {}}
    for field, _, value in _parse_fields(buf):
        if field == 1:
            node["inputs"].append(value.decode())
        elif field == 2:
            node["outputs"].append(value.decode())
        elif field == 4:
            node["op"] = value.decode()
        elif field == 5:
            aname, ints, ival = "", [], None
            for f2, _, v2 in _parse_fields(value):
                if f2 == 1:
                    aname = v2.decode()
                elif f2 == 3:
                    ival = _signed_int(v2)
                elif f2 == 8:
                    ints.append(_signed_int(v2))
            node["attrs"][aname] = ints if ints else ival
    return node


# copied from pointcloudprocessing_tpu/export/onnx_native.py::parse_model
def parse_model(blob: bytes) -> dict:
    """{nodes, initializers, inputs, outputs} from ModelProto bytes."""
    graph = None
    opset = None
    for field, _, value in _parse_fields(blob):
        if field == 7:
            graph = value
        elif field == 8:
            for f2, _, v2 in _parse_fields(value):
                if f2 == 2:
                    opset = v2
    nodes, inits, ins, outs = [], {}, [], []
    for field, _, value in _parse_fields(graph):
        if field == 1:
            nodes.append(_parse_node(value))
        elif field == 5:
            name, arr = _parse_tensor(value)
            inits[name] = arr
        elif field == 11:
            for f2, _, v2 in _parse_fields(value):
                if f2 == 1:
                    ins.append(v2.decode())
        elif field == 12:
            for f2, _, v2 in _parse_fields(value):
                if f2 == 1:
                    outs.append(v2.decode())
    return {"nodes": nodes, "initializers": inits, "inputs": ins,
            "outputs": outs, "opset": opset}


# copied from pointcloudprocessing_tpu/export/onnx_native.py::run_onnx
def run_onnx(parsed: dict, feeds: dict) -> dict:
    """Execute the parsed graph with numpy (the opset-13 subset we emit)."""
    env: dict[str, np.ndarray] = dict(parsed["initializers"])
    env.update(feeds)
    for node in parsed["nodes"]:
        op = node["op"]
        x = [env[i] for i in node["inputs"]]
        at = node["attrs"]
        if op == "MatMul":
            out = np.matmul(x[0], x[1])
        elif op == "Add":
            out = x[0] + x[1]
        elif op == "Sub":
            out = x[0] - x[1]
        elif op == "Mul":
            out = x[0] * x[1]
        elif op == "Div":
            out = x[0] / x[1]
        elif op == "Relu":
            out = np.maximum(x[0], 0)
        elif op == "Sqrt":
            out = np.sqrt(x[0])
        elif op == "Max":
            out = np.maximum(x[0], x[1])
        elif op == "Softmax":
            axis = at.get("axis", -1)
            e = np.exp(x[0] - x[0].max(axis=axis, keepdims=True))
            out = e / e.sum(axis=axis, keepdims=True)
        elif op == "ReduceMean":
            out = x[0].mean(axis=tuple(at["axes"]),
                            keepdims=bool(at.get("keepdims", 1)))
        elif op == "ReduceMax":
            out = x[0].max(axis=tuple(at["axes"]),
                           keepdims=bool(at.get("keepdims", 1)))
        elif op == "ReduceSum":  # opset 13: axes input
            out = x[0].sum(axis=tuple(int(a) for a in x[1]),
                           keepdims=bool(at.get("keepdims", 1)))
        elif op == "Unsqueeze":  # opset 13: axes input
            out = x[0]
            for a in sorted(int(v) for v in x[1]):
                out = np.expand_dims(out, a)
        elif op == "Reshape":
            out = x[0].reshape([int(_signed_int(int(d))) for d in x[1]])
        elif op == "Identity":
            out = x[0]
        elif op == "Shape":
            out = np.asarray(x[0].shape, np.int64)
        elif op == "Gather":
            out = np.take(x[0], x[1], axis=at.get("axis", 0))
        elif op == "Concat":
            out = np.concatenate(x, axis=at["axis"])
        elif op == "Expand":
            # ONNX Expand follows broadcast semantics: dims of 1 in the
            # requested shape keep the input's actual extent
            target = tuple(int(d) for d in x[1])
            shape = np.broadcast_shapes(x[0].shape, target)
            out = np.broadcast_to(x[0], shape).copy()
        elif op == "Transpose":
            out = np.transpose(x[0], at["perm"])
        elif op == "TopK":
            k = int(x[1][0])
            axis = at.get("axis", -1)
            largest = at.get("largest", 1)
            data = -x[0] if largest else x[0]
            # stable ascending sort: ties resolved to the LOWEST index —
            # the jax.lax.top_k convention the model families follow
            order = np.argsort(data, axis=axis, kind="stable")
            idx = np.take(order, range(k), axis=axis)
            vals = np.take_along_axis(x[0], idx, axis=axis)
            out = (vals, idx.astype(np.int64))
        elif op == "GatherND":
            bd = at.get("batch_dims", 0)
            if bd != 1 or x[1].shape[-1] != 1:
                raise NotImplementedError(
                    "GatherND interpreter covers batch_dims=1, depth-1 "
                    "indices (the row gathers the exporters emit)"
                )
            data, indices = x[0], x[1]
            b = data.shape[0]
            flat = indices.reshape(b, -1)
            rows = np.take_along_axis(
                data, flat[..., None].astype(np.int64), axis=1
            )
            out = rows.reshape(*indices.shape[:-1], data.shape[-1])
        elif op == "Where":
            out = np.where(x[0], x[1], x[2])
        elif op == "LessOrEqual":
            out = x[0] <= x[1]
        elif op == "ArgMax":
            axis = at.get("axis", 0)
            out = np.argmax(x[0], axis=axis).astype(np.int64)
            if at.get("keepdims", 1):
                out = np.expand_dims(out, axis)
        elif op == "Slice":
            starts, ends = x[1], x[2]
            axes = x[3] if len(x) > 3 else np.arange(len(starts))
            steps = x[4] if len(x) > 4 else np.ones(len(starts), np.int64)
            sl = [slice(None)] * x[0].ndim
            for s, e, a, st in zip(starts, ends, axes, steps):
                sl[int(a)] = slice(int(s), int(e), int(st))
            out = x[0][tuple(sl)]
        elif op == "Min":
            out = x[0]
            for other in x[1:]:
                out = np.minimum(out, other)
        else:
            raise NotImplementedError(f"op {op}")
        outs = out if isinstance(out, tuple) else (out,)
        if len(outs) != len(node["outputs"]):
            raise NotImplementedError(
                f"op {op}: {len(node['outputs'])} outputs, interpreter "
                f"produced {len(outs)}"
            )
        for nm, val in zip(node["outputs"], outs):
            env[nm] = val
    return {name: env[name] for name in parsed["outputs"]}
