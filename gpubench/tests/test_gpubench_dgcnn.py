"""The DGCNN configuration on the CPU at a small size with the published edge
widths (2 clouds of 128 points, k 8): the port through both edge blocks and
both graphs against ``reference/dgcnn.py`` within the cell's limits; the
tie-break rule, which takes a near-tie within tau and refuses one beyond
it or one that repeats a neighbour; planted faults that the comparison reads as not correct; the FLOP count
and kernel 7's bound against hand counts; the per-layer readers; and the
cell's result line."""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gpubench.harness import check, gather_roofline, registry, roofline, trace
from gpubench.harness.session import Reading
from gpubench.harness.weights import make_weights
from gpubench.reference import dgcnn as ref_dgcnn
from gpubench.tests.helpers import ROOT, SEED, measure, small_cell

B, N, K = 2, 128, 8


@pytest.fixture(scope="module")
def cell():
    return small_cell("dgcnn_serve_8192", width=2048)


def _cfg(cell, graph: str = "dynamic") -> dict:
    return dict(copy.deepcopy(cell.config), input_width=N, k=K, graph=graph)


def _points(seed: int = 3) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).normal(size=(B, N, 3)).astype(np.float32))


def _agreement(cell, cfg: dict, impl: str, monkeypatch) -> tuple[dict, bool]:
    """The program (its EdgeConvs' ``impl`` forced, in the replay too) and
    the reference on the same weights and points: each head's gap, and
    whether every limit of the cell holds."""
    module = cell.model
    build = module.build_program

    def forced(*args, **kwargs):
        model = build(*args, **kwargs)
        for i in range(len(cfg["edge_widths"])):
            getattr(model, f"ec{i + 1}").impl = impl
        return model

    monkeypatch.setattr(module, "build_program", forced)
    program = module.build_program(cfg, "cpu")
    weights = make_weights({k: tuple(v.shape) for k, v in program.state_dict().items()},
                           SEED, "cpu")
    program.load_state_dict(weights)
    points = _points()
    with torch.inference_mode():
        got = program(points)
    with torch.no_grad():
        want = module.reference_forward(cfg, weights)(points)
    gaps = check.head_gaps(got, want)
    return gaps, all(c.ok for c in check.held(gaps, cell.limits))


@pytest.mark.parametrize("impl", ["reference", "factored"])
@pytest.mark.parametrize("graph", ["dynamic", "static"])
def test_the_port_agrees_with_the_reference(cell, graph, impl, monkeypatch):
    """Both edge blocks (the factored one through ``gather_maxmin``'s plain
    version on the CPU) and both graphs within the cell's limits."""
    gaps, ok = _agreement(cell, _cfg(cell, graph), impl, monkeypatch)
    assert ok, gaps
    assert gaps["seg_prob_gap"] < 1e-6, gaps


def _near_tie(ratio: float):
    """Features of one cloud where point 0's (k + 1)-th neighbour lies
    ``ratio`` rounding units past its k-th, and the program's graph that
    swaps the two in row 0."""
    x = torch.from_numpy(np.random.default_rng(11).normal(size=(1, 64, 16)).astype(np.float32))
    own, d = ref_dgcnn.knn(x, K)
    order = d[0, 0].argsort()
    kth, nxt = int(order[K - 1]), int(order[K])
    step = (x[0, kth] - x[0, 0]).double()
    reach = order[:K + 1]
    for _ in range(2):  # tau's scale over the row's sets, with nxt where it lands
        sq = (x.double() ** 2).sum(-1)[0]
        unit = ref_dgcnn.F32_ULP * float(sq[0] + sq[reach].max())
        grow = (1.0 + ratio * unit / float((step * step).sum())) ** 0.5
        x[0, nxt] = (x[0, 0].double() + step * grow).float()
    own, d = ref_dgcnn.knn(x, K)
    program = own.clone()
    row = program[0, 0]
    program[0, 0] = torch.where(row == kth, torch.full_like(row, nxt), row)
    return x, d, own, program


@pytest.mark.parametrize("ratio", [2.0, 200.0])
def test_a_near_tie_is_taken_within_tau_and_refused_beyond(ratio):
    x, d, own, program = _near_tie(ratio)
    assert set(own[0, 0].tolist()) != set(program[0, 0].tolist())
    idx, ties = ref_dgcnn.take_ties(x, d, own, program, 16.0)
    taken = ratio < 16.0
    assert ties.differ == 1 and ties.taken == int(taken)
    assert torch.equal(idx, program if taken else own)
    assert ratio / 2 < ties.largest_differ < 2 * ratio


def test_a_repeated_neighbour_is_refused_however_near():
    """A program row that repeats a member of its own set (the k-th
    replaced by the first) differs from the exact set while every member
    lies within it; the rule keeps the reference's set."""
    x, d, own, _ = _near_tie(2.0)
    program = own.clone()
    program[0, 0, K - 1] = program[0, 0, 0]
    idx, ties = ref_dgcnn.take_ties(x, d, own, program, 16.0)
    assert ties.differ == 1 and ties.taken == 0
    assert torch.equal(idx, own)


def test_a_permutation_inside_the_set_changes_nothing(cell):
    x, d, own, _ = _near_tie(2.0)
    shuffled = own.flip(-1)
    idx, ties = ref_dgcnn.take_ties(x, d, own, shuffled, 16.0)
    assert ties.differ == 0 and torch.equal(idx, own)
    cfg = _cfg(cell)
    program = cell.model.build_program(cfg, "cpu")
    weights = make_weights({k: tuple(v.shape) for k, v in program.state_dict().items()},
                           SEED, "cpu")
    points = _points()
    with torch.no_grad():
        graphs = []
        heads, _ = ref_dgcnn.forward(weights, points, K, 4)
        # the reference's own graphs, each row reversed, as a program's
        real_knn = ref_dgcnn.knn

        def recording(x, k):
            idx, dist = real_knn(x, k)
            graphs.append(idx.flip(-1))
            return idx, dist

        ref_dgcnn.knn = recording
        try:
            ref_dgcnn.forward(weights, points, K, 4)
        finally:
            ref_dgcnn.knn = real_knn
        again, ties = ref_dgcnn.forward(weights, points, K, 4, program_graphs=graphs,
                                        scale=16.0)
    assert all(t.differ == 0 for t in ties)
    assert all(torch.equal(heads[h], again[h]) for h in heads)


def _beyond_tau(real):
    def knn_graph(feats, k):
        wide = real(feats, k + 5)
        idx = wide[..., :k].clone()
        idx[..., k - 1] = wide[..., k + 4]  # the k-th replaced by the (k+5)-th
        return idx
    return knn_graph


def _repeated(real):
    def knn_graph(feats, k):
        idx = real(feats, k).clone()
        idx[..., k - 1] = idx[..., 0]  # the k-th replaced by the first
        return idx
    return knn_graph


def _swapped_uv(self, x, idx, *, train, frozen):
    from pointcloudprocessing_tpu_torch.ops.cuda.gather_maxmin import gather_maxmin

    c = x.shape[-1]
    weight = self.l1.conv.weight
    u, v = weight[:, c:], weight[:, :c]  # the two halves swapped
    p, q = F.linear(x, u - v), F.linear(x, v)
    qmax, qmin = gather_maxmin(q.contiguous(), idx.contiguous())
    bn = self.l1.bn
    return torch.maximum(torch.relu(bn(p + qmax, use_running=True)),
                         torch.relu(bn(p + qmin, use_running=True)))


@pytest.mark.parametrize("fault", ["neighbour_beyond_tau", "neighbour_repeated",
                                   "u_v_swapped", "batch_statistics", "bf16_features"])
def test_planted_faults_are_not_correct(cell, fault, monkeypatch):
    """Each fault sits in the program, so the replay carries it too; the
    comparison reads every one as not correct."""
    from pointcloudprocessing_tpu_torch.models import dgcnn, layers

    if fault == "neighbour_beyond_tau":
        monkeypatch.setattr(dgcnn, "knn_graph", _beyond_tau(dgcnn.knn_graph))
    elif fault == "neighbour_repeated":
        monkeypatch.setattr(dgcnn, "knn_graph", _repeated(dgcnn.knn_graph))
    elif fault == "u_v_swapped":
        monkeypatch.setattr(dgcnn.EdgeConv, "_factored", _swapped_uv)
    elif fault == "batch_statistics":
        forward = layers.BatchNorm.forward
        monkeypatch.setattr(layers.BatchNorm, "forward",
                            lambda self, x, *, use_running: forward(self, x, use_running=False))
        monkeypatch.setattr(layers.BatchNorm, "update_running", lambda self, m, v: None)
    else:
        forward = dgcnn.EdgeConv.forward
        monkeypatch.setattr(dgcnn.EdgeConv, "forward",
                            lambda self, x, **kw: forward(self, x, **kw).bfloat16().float())
    gaps, ok = _agreement(cell, _cfg(cell), "factored", monkeypatch)
    assert not ok, gaps


def test_forward_flops_and_kernel_7s_bound_are_the_hand_counts(cell):
    n = 1024
    distances = n * n * (3 + 64 + 64 + 128)
    edges = 2 * n * (3 * 64 + 64 * 64 + 64 * 128 + 128 * 256)
    embedding = n * 512 * 1024
    heads = 1024 * 512 + 512 * 256 + 256 * 23 + n * (512 * 256 + 256 * 256 + 256 * 128
                                                       + 128 * 12) + 1024 * 256
    assert cell.model.forward_flops(cell.config, n) == 2.0 * (distances + edges + embedding
                                                              + heads)
    assert 2.27e9 < cell.model.forward_flops(cell.config, n) < 2.29e9
    assert cell.model.edge_gathers(cell.config) == [(64, 20), (64, 20), (128, 20), (256, 20)]
    assert cell.model.model_fps(cell.config, n) == []
    ms, binds = gather_roofline.gather_maxmin_bound(256, 1024, 20, 256)
    moved = 3 * 256 * 1024 * 256 * 4 + 256 * 1024 * 20 * 4
    assert binds == "bytes" and ms == pytest.approx(moved / 3.35e12 * 1e3)
    import sys

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    q, idx = torch.zeros(4, 512, 128), torch.zeros(4, 512, 20, dtype=torch.int32)
    got = (torch.zeros_like(q), torch.zeros_like(q))
    assert roofline.roofline(chip_smoke.nbytes(q, idx, *got), 2 * 4 * 512 * 20 * 128) == \
        gather_roofline.gather_maxmin_bound(4, 512, 20, 128)


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


def test_the_readers_read_spans_and_kernel_7s_rows(cell):
    """One batch: a kNN row and an edge row launched inside their spans,
    and kernel 7's four rows; a program without the spans or the rows
    gives no reading."""
    from torch.autograd import DeviceType

    cuda = DeviceType.CUDA
    host = [_Event("pcp.pipeline.model", 0, 100), _Event("pcp.model.knn", 1, 40),
            _Event("cudaLaunchKernel", 2, 3, 1), _Event("pcp.model.edge", 41, 90),
            _Event("cudaLaunchKernel", 42, 43, 2)]
    rows = [_Event("void at::native::mbtopk::gatherTopK<float>()", 100, 1100, 1, cuda),
            _Event("void (anonymous namespace)::gather_maxmin_shared_kernel<float>()",
                   1100, 1600, 2, cuda)]
    stretch = trace.Stretch(rows, host, 1e-3, 0, [trace.Attempt(0, len(rows), 0, [], 0)])
    reading = Reading("serve_stream", stretch, 1, cell.traffic["batch"], cell, [])
    readers = {name: registry.load_module(ROOT / f"gpubench/metrics/{name}.py", name)
               for name in ("knn_device_ms.serve", "edge_device_ms.serve",
                            "gather_maxmin_roofline.serve")}
    assert readers["knn_device_ms.serve"].read(reading) == pytest.approx(1.0)
    assert readers["edge_device_ms.serve"].read(reading) == pytest.approx(0.5)
    b, n = cell.traffic["batch"], cell.traffic["model_width"]
    bound = sum(gather_roofline.gather_maxmin_bound(b, n, k, w)[0]
                for w, k in cell.model.edge_gathers(cell.config))
    assert readers["gather_maxmin_roofline.serve"].read(reading) == pytest.approx(
        100 * bound / 0.5)
    bare = trace.Stretch(rows[:1], [e for e in host if not e.name.startswith("pcp.model")],
                         1e-3, 0, stretch.attempts)
    reading.stretch = bare
    assert all(r.read(reading) is None for r in readers.values())


def test_the_cells_line_is_correct_on_the_cpu(cell):
    line = measure(cell)
    assert line["correct"], line["compared"]
    assert set(line["compared"]) == {"cls_prob_gap", "seg_prob_gap"}
    assert set(line["metrics"]) == {"serve_clouds_per_s", "serve_batch_p95_ms",
                                    "peak_mem_gib", "setup_s"}


def test_the_reference_loads_no_program_and_the_cell_no_jax():
    from gpubench.tests.test_gpubench_harness import imported_with

    forbidden = ("jax", "jaxlib", "flax", "optax", "pointcloudprocessing_tpu")
    assert imported_with("import gpubench.reference.dgcnn",
                         forbidden + ("pointcloudprocessing_tpu_torch",)) == []
    cell = "\n".join([
        "from gpubench.tests.helpers import small_cell",
        "c = small_cell('dgcnn_serve_8192'); c.model.build_program(c.config, 'cpu')",
        "import gpubench.harness.gather_roofline",
    ])
    assert imported_with(cell, forbidden) == []
