"""The Point Transformer configuration on the CPU at its published widths (2
clouds of 1,024 points): the port against ``reference/point_transformer.py``
within the cell's limits; the tie-break rule on coordinates, which takes a
near-tie within tau and refuses a neighbour beyond it; planted faults that
the comparison reads as not correct; the FLOP count and the attention's
bound against hand counts; the per-layer readers; and the cell's result
line. On the card (``card``): the TF32 control fails the cell's limits."""

import numpy as np
import pytest
import torch

from gpubench import probe
from gpubench.harness import attn_roofline, check, registry, trace
from gpubench.harness.session import Reading
from gpubench.harness.weights import make_weights
from gpubench.reference import dgcnn as ref_dgcnn
from gpubench.tests.helpers import ROOT, SEED, measure, small_cell

B, N = 2, 1024


@pytest.fixture(scope="module")
def cell():
    return small_cell("point_transformer_serve_8192", width=2048)


def _points(seed: int = 3) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    scale = np.array([3.0, 1.0, 0.4], np.float32)
    return torch.from_numpy((rng.normal(size=(B, N, 3)) * scale).astype(np.float32))


def _agreement(cell, cfg=None) -> tuple[dict, bool]:
    """The program and the reference on the same weights and points: each
    head's gap, and whether every limit of the cell holds."""
    cfg = cell.config if cfg is None else cfg
    program = cell.model.build_program(cfg, "cpu")
    weights = make_weights({k: tuple(v.shape) for k, v in program.state_dict().items()},
                           SEED, "cpu")
    program.load_state_dict(weights)
    points = _points()
    with torch.inference_mode():
        got = program(points)
    with torch.no_grad():
        want = cell.model.reference_forward(cfg, weights)(points)
    gaps = check.head_gaps(got, want)
    return gaps, all(c.ok for c in check.held(gaps, cell.limits))


def test_the_port_agrees_with_the_reference(cell, capfd):
    """Within the cell's limits; the reference says on standard error what
    it took of the program's graphs."""
    gaps, ok = _agreement(cell)
    assert ok, gaps
    assert gaps["seg_prob_gap"] < 1e-6 and gaps["se3_gap"] == 0.0, gaps
    assert "point transformer reference: the program's set taken in" in capfd.readouterr().err


def test_build_program_refuses_other_sizes(cell, monkeypatch):
    """A family whose block counts are not the file's is refused."""
    import pointcloudprocessing_tpu_torch.models.point_transformer as pt

    monkeypatch.setattr(pt, "ENCODER_BLOCKS", (1, 2, 3, 4, 2))
    with pytest.raises(ValueError, match="the configuration's"):
        cell.model.build_program(cell.config, "cpu")


def _near_tie(ratio: float, k: int = 8):
    """Coordinates of one cloud where point 0's (k + 1)-th neighbour lies
    ``ratio`` rounding units past its k-th, and the program's graph that
    swaps the two in row 0."""
    p = torch.from_numpy(np.random.default_rng(11).uniform(-1, 1, (1, 128, 3))
                         .astype(np.float32))
    p = p / p.norm(dim=-1).amax()
    own, d = ref_dgcnn.knn(p, k)
    order = d[0, 0].argsort()
    kth, nxt = int(order[k - 1]), int(order[k])
    step = (p[0, kth] - p[0, 0]).double()
    for _ in range(2):
        sq = (p.double() ** 2).sum(-1)[0]
        unit = ref_dgcnn.F32_ULP * float(sq[0] + sq[order[:k + 1]].max())
        grow = (1.0 + ratio * unit / float((step * step).sum())) ** 0.5
        p[0, nxt] = (p[0, 0].double() + step * grow).float()
    own, d = ref_dgcnn.knn(p, k)
    program = own.clone()
    row = program[0, 0]
    program[0, 0] = torch.where(row == kth, torch.full_like(row, nxt), row)
    return p, d, own, program


@pytest.mark.parametrize("ratio", [2.0, 200.0])
def test_a_near_tie_in_coordinates_is_taken_within_tau_and_refused_beyond(cell, ratio):
    from gpubench.reference import point_transformer as ref_pt

    p, d, own, program = _near_tie(ratio)
    assert set(own[0, 0].tolist()) != set(program[0, 0].tolist())
    tau = cell.model.TIE_SCALE
    ties = ref_dgcnn.Ties()
    idx = ref_pt.self_graph(p, 8, program, tau, ties)
    taken = ratio < tau
    assert ties.differ == 1 and ties.taken == int(taken)
    assert torch.equal(idx.sort(-1).values, (program if taken else own).sort(-1).values)


def _beyond_tau(real):
    """The k-th neighbour of every row replaced by the (k + 3)-th."""
    def knn_graph(feats, k):
        n = feats.shape[1]
        if k + 3 > n:
            return real(feats, k)
        wide = real(feats, k + 3)
        idx = wide[..., :k].clone()
        idx[..., k - 1] = wide[..., k + 2]
        return idx
    return knn_graph


def _softmax_over_channels(self, p, y, idx, *, train=False, frozen=False, fold=None):
    from pointcloudprocessing_tpu_torch.ops.gather import gather_rows

    bn = dict(train=train, frozen=frozen, fold=fold)
    b, n, c = y.shape
    q, key, value = self.q(y), self.k(y), self.v(y)
    delta = self.pos2(self.pos1(gather_rows(p, idx) - p[:, :, None, :], **bn))
    r = gather_rows(key, idx) - q[:, :, None, :] + delta
    weights = torch.softmax(self.w2(self.w1(self.rel(r, **bn), **bn)), dim=-1)
    vals = (gather_rows(value, idx) + delta).view(b, n, -1, self.share, c // self.share)
    return (vals * weights[:, :, :, None, :]).sum(dim=2).reshape(b, n, c)


def _no_delta_in_values(self, p, y, idx, *, train=False, frozen=False, fold=None):
    from pointcloudprocessing_tpu_torch.ops.gather import gather_rows

    bn = dict(train=train, frozen=frozen, fold=fold)
    b, n, c = y.shape
    q, key, value = self.q(y), self.k(y), self.v(y)
    delta = self.pos2(self.pos1(gather_rows(p, idx) - p[:, :, None, :], **bn))
    r = gather_rows(key, idx) - q[:, :, None, :] + delta
    weights = torch.softmax(self.w2(self.w1(self.rel(r, **bn), **bn)), dim=2)
    vals = gather_rows(value, idx).view(b, n, -1, self.share, c // self.share)
    return (vals * weights[:, :, :, None, :]).sum(dim=2).reshape(b, n, c)


def _shared_t8_u(self, p, y, idx, *, train=False, frozen=False, fold=None):
    from pointcloudprocessing_tpu_torch.ops.gather import gather_rows

    bn = dict(train=train, frozen=frozen, fold=fold)
    b, n, c = y.shape
    q, key, value = self.q(y), self.k(y), self.v(y)
    delta = self.pos2(self.pos1(gather_rows(p, idx) - p[:, :, None, :], **bn))
    r = gather_rows(key, idx) - q[:, :, None, :] + delta
    weights = torch.softmax(self.w2(self.w1(self.rel(r, **bn), **bn)), dim=2)
    vals = (gather_rows(value, idx) + delta).view(b, n, -1, c // self.share, self.share)
    return (vals * weights[..., None]).sum(dim=2).reshape(b, n, c)


def _squared_weights(fine, coarse, feats, eps=1e-8):
    from pointcloudprocessing_tpu_torch.models.pointnet2 import _three_nearest
    from pointcloudprocessing_tpu_torch.ops.gather import gather_rows

    idx, sq = _three_nearest(fine, coarse)
    w = 1.0 / (sq + eps)
    w = w / w.sum(dim=-1, keepdim=True)
    return (gather_rows(feats, idx) * w[..., None]).sum(dim=2)


@pytest.mark.parametrize("fault", ["neighbour_beyond_tau", "softmax_over_channels",
                                   "delta_left_out_of_values", "weights_shared_t8_u",
                                   "three_nn_squared_distance", "batch_statistics"])
def test_planted_faults_are_not_correct(cell, fault, monkeypatch):
    """Each fault sits in the program, so the reference's replay carries it
    too; the comparison reads every one as not correct."""
    from pointcloudprocessing_tpu_torch.models import layers
    from pointcloudprocessing_tpu_torch.models import point_transformer as pt

    if fault == "neighbour_beyond_tau":
        monkeypatch.setattr(pt, "knn_graph", _beyond_tau(pt.knn_graph))
    elif fault == "softmax_over_channels":
        monkeypatch.setattr(pt.VectorAttention, "forward", _softmax_over_channels)
    elif fault == "delta_left_out_of_values":
        monkeypatch.setattr(pt.VectorAttention, "forward", _no_delta_in_values)
    elif fault == "weights_shared_t8_u":
        monkeypatch.setattr(pt.VectorAttention, "forward", _shared_t8_u)
    elif fault == "three_nn_squared_distance":
        monkeypatch.setattr(pt, "interpolate", _squared_weights)
    else:
        # an inference forward folds its BatchNorms; unfolded, they take the
        # batch's statistics
        monkeypatch.setattr(pt, "fold_batchnorms", lambda owners: None)
        forward = layers.BatchNorm.forward
        monkeypatch.setattr(layers.BatchNorm, "forward",
                            lambda self, x, *, use_running: forward(self, x, use_running=False))
        monkeypatch.setattr(layers.BatchNorm, "update_running", lambda self, m, v: None)
    gaps, ok = _agreement(cell)
    assert not ok, gaps


def test_forward_flops_and_the_attentions_bound_are_the_hand_counts(cell):
    cfg, n = cell.config, 1024
    # stage 2: 256 points, k 16, 64 channels, 2 encoder blocks and 1 decoder block
    c, k, m, s = 64, 16, 256, 8
    attn = m * 3 * c * c + m * k * (9 + 3 * c + c * (c // s) + (c // s) ** 2)
    assert cell.model.attn_products(m, k, c, s) == attn
    other = m * k * (3 + 6 * c + 4 * (c // s))
    assert cell.model.attn_elementwise(m, k, c, s) == other
    ms, binds = attn_roofline.attn_bound(256, m, k, c, attn, other)
    moved = 256 * m * (2 * c + 3) * 4 + 256 * m * k * 4
    # the products in 3xTF32 on the tensor cores, the rest on the f32 units
    want = max(moved / 3.35e12, 3 * 2 * 256 * attn / 495e12, 256 * other / 67e12) * 1e3
    assert ms == pytest.approx(want) and binds == "operations"
    sizes = [(1024, 8, 0), (256, 16, 16), (64, 16, 16), (16, 16, 16), (4, 4, 16)]
    assert cell.model.stage_sizes(cfg) == sizes
    widths, blocks = [32, 64, 128, 256, 512], [2, 3, 4, 6, 3]
    ops = n * 3 * 32
    for i, ((pts, kk, group), w, nb) in enumerate(zip(sizes, widths, blocks)):
        ops += nb * (2 * pts * w * w + pts * 3 * w * w
                     + pts * kk * (9 + 3 * w + w * w // 8 + (w // 8) ** 2))
        ops += 3 * pts * pts
        if i:
            prev, pw = sizes[i - 1][0], widths[i - 1]
            ops += pts * group * (3 + pw) * w + 3 * pts * prev
            ops += prev * pw * pw + pts * w * pw + 3 * prev * pts
    ops += 512 * 512 + 4 * 1024 * 512
    ops += 512 * 256 + 256 * 128 + 128 * 23 + n * (32 * 32 + 32 * 12)
    assert cell.model.forward_flops(cfg, n) == 2.0 * ops
    assert 0.35e9 < cell.model.forward_flops(cfg, n) < 0.40e9
    layers = cell.model.attn_layers(cfg)
    assert len(layers) == 18
    assert layers[:3] == [(1, 1024, 8, 32), (2, 256, 16, 64), (2, 256, 16, 64)]
    assert layers[-5:] == [(5, 4, 4, 512), (4, 16, 16, 256), (3, 64, 16, 128),
                           (2, 256, 16, 64), (1, 1024, 8, 32)]
    assert cell.model.model_fps(cfg, n) == [(1024, 256), (256, 64), (64, 16), (16, 4)]


class _Range:
    def __init__(self, start, end):
        self.start, self.end = start, end

    def elapsed_us(self):
        return self.end - self.start


class _Event:
    def __init__(self, name, start, end, ident=0, device_type=None):
        from torch.autograd import DeviceType

        self.name, self.id, self.thread = name, ident, 1
        self.time_range = _Range(start, end)
        self.device_type = DeviceType.CPU if device_type is None else device_type
        self.device_resource_id = 1001


def test_the_readers_read_the_spans(cell):
    """One batch: an attention row, a transition-down row with a kNN row
    nested in it, and a transition-up row; a program without the spans gives
    no reading."""
    from torch.autograd import DeviceType

    cuda = DeviceType.CUDA
    host = [_Event("pcp.pipeline.model", 0, 100),
            _Event("pcp.model.attn", 1, 10), _Event("cudaLaunchKernel", 2, 3, 1),
            _Event("pcp.model.down", 11, 30), _Event("cudaLaunchKernel", 12, 13, 2),
            _Event("pcp.model.knn", 14, 20), _Event("cudaLaunchKernel", 15, 16, 3),
            _Event("pcp.model.up", 31, 40), _Event("cudaLaunchKernel", 32, 33, 4)]
    rows = [_Event("softmax", 100, 2100, 1, cuda), _Event("fps_kernel", 2100, 2400, 2, cuda),
            _Event("knn_select_kernel", 2400, 2500, 3, cuda),
            _Event("gemm", 2500, 2550, 4, cuda)]
    stretch = trace.Stretch(rows, host, 1e-3, 0, [trace.Attempt(0, len(rows), 0, [], 0)])
    reading = Reading("serve_stream", stretch, 1, cell.traffic["batch"], cell, [])
    names = ("attn_device_ms.serve", "down_device_ms.serve", "up_device_ms.serve",
             "attn_roofline.serve", "knn_device_ms.serve")
    readers = {name: registry.load_module(ROOT / f"gpubench/metrics/{name}.py", name)
               for name in names}
    assert readers["attn_device_ms.serve"].read(reading) == pytest.approx(2.0)
    assert readers["down_device_ms.serve"].read(reading) == pytest.approx(0.3)
    assert readers["knn_device_ms.serve"].read(reading) == pytest.approx(0.1)
    assert readers["up_device_ms.serve"].read(reading) == pytest.approx(0.05)
    b = cell.traffic["batch"]
    bound = sum(attn_roofline.attn_bound(b, n, k, c, cell.model.attn_products(n, k, c, 8),
                                         cell.model.attn_elementwise(n, k, c, 8))[0]
                for _, n, k, c in cell.model.attn_layers(cell.config))
    assert readers["attn_roofline.serve"].read(reading) == pytest.approx(100 * bound / 2.0)
    reading.stretch = trace.Stretch(rows, host[:1] + [e for e in host if "Launch" in e.name],
                                    1e-3, 0, stretch.attempts)
    assert all(r.read(reading) is None for r in readers.values())


def test_the_roofline_reader_is_silent_for_a_model_without_attention():
    other = small_cell("dgcnn_serve_8192", width=2048)
    stretch = trace.Stretch([], [_Event("pcp.model.attn", 0, 1)], 1e-3, 0, [])
    reading = Reading("serve_stream", stretch, 1, 2, other, [])
    reader = registry.load_module(ROOT / "gpubench/metrics/attn_roofline.serve.py", "r")
    assert reader.read(reading) is None


def test_the_cells_line_is_correct_on_the_cpu(cell):
    line = measure(cell)
    assert line["correct"], line["compared"]
    assert set(line["compared"]) == {"cls_prob_gap", "seg_prob_gap"}
    assert set(line["metrics"]) == {"serve_clouds_per_s", "serve_batch_p95_ms",
                                    "peak_mem_gib", "setup_s"}


def test_the_reference_loads_no_program_and_the_cell_no_jax():
    from gpubench.tests.test_gpubench_harness import imported_with

    forbidden = ("jax", "jaxlib", "flax", "optax", "pointcloudprocessing_tpu")
    assert imported_with("import gpubench.reference.point_transformer",
                         forbidden + ("pointcloudprocessing_tpu_torch",)) == []
    cell = "\n".join([
        "from gpubench.tests.helpers import small_cell",
        "c = small_cell('point_transformer_serve_8192')",
        "c.model.build_program(c.config, 'cpu')",
        "import gpubench.harness.attn_roofline",
    ])
    assert imported_with(cell, forbidden) == []


@pytest.mark.card
def test_the_tf32_control_fails_the_cells_limits(card):
    cell = small_cell("point_transformer_serve_8192", batch=16, width=8192)
    gaps = probe.control_serve(cell, SEED, card)
    assert any(gaps[k] > v["limit"] for k, v in cell.limits.items()), gaps
