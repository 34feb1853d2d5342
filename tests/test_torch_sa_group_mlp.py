"""PointNet++'s set-abstraction kernel (``ops/cuda/sa_group_mlp.py``,
``csrc/sa_group_mlp.cu``) and its route in ``models/pointnet2.py``: an f32
level on CUDA with running statistics and no gradient to keep runs as one
launch, from the grouping's masked neighbour indices, with the BatchNorm
folded in; the CPU, bf16, training and a frozen level under a trained
parameter keep the plain path.

On the CPU the plain version is held to the level's plain path, the route
is forced on (``_level_kernel``) with the kernel replaced by a recorder
around its plain version, the wrapper's refusals are checked on meta and CPU
tensors, and the kernel's group max is emulated. Tests marked ``card`` hold
the kernel itself against its plain version on a CUDA device and skip
without one; run them there with ``python -m pytest --noconftest -m card
tests/test_torch_sa_group_mlp.py`` (``--noconftest``: the suite's conftest
hides CUDA and imports JAX).
"""

import numpy as np
import pytest
import torch

from pointcloudprocessing_tpu_torch.core.constants import KERAS_BN_EPSILON
from pointcloudprocessing_tpu_torch.models import pointnet2
from pointcloudprocessing_tpu_torch.models.layers import BatchNorm
from pointcloudprocessing_tpu_torch.models.pointnet import FreezeFlags
from pointcloudprocessing_tpu_torch.ops.cuda import build
from pointcloudprocessing_tpu_torch.ops.cuda import sa_group_mlp as sa
from pointcloudprocessing_tpu_torch.ops.gather import gather_rows

SA1 = (0, (64, 64, 128))    # (in_features, mlp) of the canonical levels
SA2 = (128, (128, 128, 256))
LEVEL_KERNEL = pointnet2._level_kernel


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def randomize_batch_norms(module, seed=1):
    """Scales, biases and running statistics away from their initial values."""
    g = torch.Generator().manual_seed(seed)
    for bn in (m for m in module.modules() if isinstance(m, BatchNorm)):
        c = bn.running_mean.numel()
        with torch.no_grad():
            bn.weight.copy_(torch.rand(c, generator=g) + 0.5)
            bn.bias.copy_(torch.randn(c, generator=g) * 0.2)
            bn.running_mean.copy_(torch.randn(c, generator=g) * 0.3)
            bn.running_var.copy_(torch.rand(c, generator=g) * 1.5 + 0.5)
    return module


def level(widths, m, k, radius=0.4, device="cpu", seed=0):
    """A set-abstraction level with randomized BatchNorms, in eval mode."""
    in_features, mlp = widths
    block = pointnet2._SetAbstraction(
        in_features, m, k, radius, mlp, generator=torch.Generator().manual_seed(seed),
        device=device)
    return randomize_batch_norms(block, seed + 1).eval()


def inputs(b, n, in_features, device="cpu", seed=0):
    """A unit-scale cloud and relu features of ``in_features`` channels."""
    g = torch.Generator().manual_seed(seed)
    xyz = torch.rand(b, n, 3, generator=g) * 2 - 1
    feats = torch.relu(torch.randn(b, n, in_features, generator=g)) if in_features else None
    return xyz.to(device), None if feats is None else feats.to(device)


def layers_of(block):
    return [(blk.conv.weight, blk.bn.weight, blk.bn.bias, blk.bn.running_mean,
             blk.bn.running_var) for blk in (block.l1, block.l2, block.l3)]


def max_rel_err(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


# ------------------------------------------------------ the plain version

@pytest.mark.parametrize("widths", [SA1, SA2], ids=["sa1", "sa2"])
@pytest.mark.parametrize("k, m", [(1, 37), (20, 37), (32, 16), (64, 9)])
def test_plain_version_matches_the_level(widths, k, m):
    """The plain version (folded affine) against the level's plain path
    (BatchNorm's ``(x - mean) * mul + bias``) on the same groups: equal
    within f32 rounding, at both levels' widths and k 1 to 64, m ragged
    against every tile's groups (37 = 2 x 16 + 5, 6 x 6 + 1; 9 = 4 x 2 + 1)."""
    block = level(widths, m, k)
    xyz, feats = inputs(2, 128, widths[0])
    with torch.no_grad():
        new_xyz, want = block(xyz, feats, train=False)
        centers, idx = pointnet2.group_indices(xyz, m, k, block.radius)
        got = sa.sa_group_mlp_reference(xyz, feats, centers, idx, layers_of(block),
                                        KERAS_BN_EPSILON)
    assert torch.equal(new_xyz, centers)
    assert got.shape == (2, m, widths[1][-1])
    assert max_rel_err(got, want) <= 2e-6


def test_group_indices_are_the_grouping():
    """``sample_and_group`` gathers at the indices that ``group_indices``
    returns: its grouped coordinates and features, bit for bit."""
    xyz, feats = inputs(2, 96, 64)
    new_xyz, grouped = pointnet2.sample_and_group(xyz, feats, 24, 16, 0.3)
    centers, idx = pointnet2.group_indices(xyz, 24, 16, 0.3)
    assert idx.dtype == torch.int32 and idx.shape == (2, 24, 16)
    assert torch.equal(new_xyz, centers)
    want = torch.cat([gather_rows(xyz, idx) - centers[:, :, None, :],
                      gather_rows(feats, idx)], dim=-1)
    assert torch.equal(grouped, want)


# ---------------------------------------------------------------- the route

@pytest.mark.parametrize("device, dtype, x_dtypes, running, keeps_grad, takes", [
    ("cuda", None, (torch.float32,), True, False, True),
    ("cuda:1", None, (torch.float32, torch.float32), True, False, True),
    ("cpu", None, (torch.float32,), True, False, False),
    ("cuda", torch.bfloat16, (torch.float32,), True, False, False),
    ("cuda", None, (torch.float32, torch.bfloat16), True, False, False),
    ("cuda", None, (torch.float64,), True, False, False),
    ("cuda", None, (torch.float32,), False, False, False),
    ("cuda", None, (torch.float32,), True, True, False),
], ids=["cuda", "cuda1-feats", "cpu", "bf16-compute", "bf16-feats", "f64", "train",
        "keeps-grad"])
def test_level_kernel_condition(device, dtype, x_dtypes, running, keeps_grad, takes):
    assert pointnet2._level_kernel(torch.device(device), dtype, x_dtypes, running,
                                   keeps_grad) is takes


@pytest.fixture
def forced_route(monkeypatch):
    """The route's device test forced on (a CPU tensor taken as CUDA) and
    the kernel replaced by a recorder around its plain version: yields the
    recorded calls."""
    calls = []

    def recorder(xyz, feats, centers, idx, layers, eps):
        calls.append((xyz, feats, centers, idx, layers, eps))
        return sa.sa_group_mlp_reference(xyz, feats, centers, idx, layers, eps)

    monkeypatch.setattr(pointnet2, "_level_kernel",
                        lambda _device, *rest: LEVEL_KERNEL(torch.device("cuda"), *rest))
    monkeypatch.setattr(pointnet2, "sa_group_mlp", recorder)
    return calls


def small_model(dtype=None):
    model = pointnet2.pointnet2_for_width(
        5, 4, 256, device="cpu", generator=torch.Generator().manual_seed(0), dtype=dtype,
        dropout_rate=0.0)
    return randomize_batch_norms(model)


def run_plain(model, points, **kwargs):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pointnet2, "_level_kernel", lambda *_: False)
        return model(points, **kwargs)


def test_eval_forward_takes_the_route_twice(forced_route):
    """An f32 inference forward sends both levels to the kernel, with the
    grouping's indices and each block's parameters, and its heads equal the
    plain path's within f32 rounding."""
    model = small_model().eval()
    points = torch.from_numpy(
        np.random.default_rng(3).normal(size=(2, 256, 3)).astype(np.float32))
    with torch.no_grad():
        got = model(points)
        want = run_plain(model, points)
    assert len(forced_route) == 2
    (xyz1, f0, _, idx1, layers1, eps), (_, f1, _, idx2, layers2, _) = forced_route
    assert f0 is None and f1.shape == (2, 128, 128) and eps == KERAS_BN_EPSILON
    assert idx1.shape == (2, 128, 32) and idx2.shape == (2, 32, 64)
    assert idx1.dtype == torch.int32 and xyz1.is_contiguous()
    assert layers1[0][0] is model.sa1.l1.conv.weight
    assert layers2[2][4] is model.sa2.l3.bn.running_var
    for name in want:
        torch.testing.assert_close(got[name], want[name], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", ["train", "bf16", "frozen-under-grad", "cpu"])
def test_other_levels_keep_the_plain_path(forced_route, case, monkeypatch):
    """Training, bf16 (both with no gradient to keep) and a frozen level
    under a trained parameter (grad on) call no kernel with the route
    forced, and give the plain path's outputs bit for bit; the CPU (the
    route not forced) calls none either."""
    model = small_model(torch.bfloat16 if case == "bf16" else None)
    points = torch.from_numpy(
        np.random.default_rng(4).normal(size=(2, 256, 3)).astype(np.float32))
    if case == "cpu":
        monkeypatch.setattr(pointnet2, "_level_kernel", LEVEL_KERNEL)
    kwargs = {}
    if case == "train":
        kwargs = dict(train=True)
    elif case == "frozen-under-grad":
        kwargs = dict(train=True, freeze=FreezeFlags(shared_network=True))
    if case in ("bf16", "cpu"):
        model.eval()
    grad = torch.enable_grad() if case == "frozen-under-grad" else torch.no_grad()
    state = {k: v.clone() for k, v in model.state_dict().items()}
    with grad:
        got = model(points, **kwargs)
    model.load_state_dict(state)  # train mode moved the running statistics
    with grad:
        want = run_plain(model, points, **kwargs)
    assert forced_route == []
    for name in want:
        assert torch.equal(got[name], want[name]), name


def test_frozen_level_without_grad_takes_the_route(forced_route):
    """A frozen level in train mode with no gradient to keep (grad off) has
    running statistics: both levels take the kernel."""
    model = small_model()
    points = torch.randn(2, 256, 3, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        model(points, train=True, freeze=FreezeFlags(shared_network=True))
    assert len(forced_route) == 2


# ------------------------------------------------------ the wrapper's checks

def call_args(b=1, n=64, m=8, k=16, widths=SA2, device="cpu", dtype=torch.float32):
    in_features, mlp = widths
    xyz, feats = inputs(b, n, in_features)
    centers = xyz[:, :m].contiguous()
    idx = torch.randint(0, n, (b, m, k), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(0))
    c_in, layers = 3 + in_features, []
    for c in mlp:
        layers.append((torch.randn(c, c_in) * 0.1, torch.ones(c), torch.zeros(c),
                       torch.zeros(c), torch.ones(c)))
        c_in = c
    to = dict(device=device)
    layers = [tuple(t.to(dtype=dtype, **to) for t in layer) for layer in layers]
    return (xyz.to(**to), None if feats is None else feats.to(**to), centers.to(**to),
            idx.to(**to), layers, KERAS_BN_EPSILON)


def widened(args, i, c):
    """The arguments with layer ``i`` (and the next one's input) ``c`` wide."""
    xyz, feats, centers, idx, layers, eps = args
    layers = list(layers)
    w = layers[i][0]
    layers[i] = (torch.randn(c, w.shape[1]), *(torch.ones(c) for _ in range(4)))
    if i + 1 < len(layers):
        nxt = layers[i + 1][0]
        layers[i + 1] = (torch.randn(nxt.shape[0], c), *layers[i + 1][1:])
    return xyz, feats, centers, idx, layers, eps


def refusal_cases():
    def with_feats(c):
        xyz, _, centers, idx, layers, eps = call_args(widths=(c, (64, 64, 64)))
        return xyz, torch.randn(1, 64, c), centers, idx, layers, eps

    def strided():
        xyz, feats, centers, idx, layers, eps = call_args()
        return xyz, feats, centers, idx[..., ::2], layers, eps

    return {
        "width-96": (ValueError, "multiples of 64", lambda: widened(call_args(), 0, 96)),
        "width-320": (ValueError, "multiples of 64", lambda: widened(call_args(), 2, 320)),
        "feats-32": (ValueError, "multiples of 64", lambda: with_feats(32)),
        "depth-2": (ValueError, "3 layers",
                    lambda: (*call_args()[:4], call_args()[4][:2], KERAS_BN_EPSILON)),
        "k-65": (ValueError, "k <= 64", lambda: call_args(k=65)),
        "f64": (TypeError, "f32", lambda: call_args(dtype=torch.float64)),
        "idx-int64": (TypeError, "int32",
                      lambda: (*call_args()[:3], call_args()[3].long(), *call_args()[4:])),
        "strided": (ValueError, "contiguous", strided),
        "shapes": (ValueError, "do not match",
                   lambda: (call_args()[0], call_args()[1], call_args()[2][:, :4],
                            *call_args()[3:])),
    }


@pytest.mark.parametrize("case", sorted(refusal_cases()))
def test_wrapper_refuses(case):
    """Every width, dtype, depth, layout or shape the kernel does not take
    raises before any launch, on the CPU too (a level that raises on the
    card must not pass here), and counts nothing."""
    error, match, make = refusal_cases()[case]
    before = dict(build.LAUNCHES)
    with pytest.raises(error, match=match):
        sa.sa_group_mlp(*make())
    assert build.LAUNCHES == before


def test_wrapper_refuses_other_devices():
    """A meta tensor (no kernel) raises; mixed devices raise."""
    before = dict(build.LAUNCHES)
    with pytest.raises(ValueError, match="^no SA kernel for device meta"):
        sa.sa_group_mlp(*call_args(device="meta"))
    xyz, feats, centers, idx, layers, eps = call_args()
    with pytest.raises(ValueError, match="one device"):
        sa.sa_group_mlp(xyz, feats, centers, idx.to("meta"), layers, eps)
    assert build.LAUNCHES == before


def test_wrapper_on_the_cpu_is_the_plain_version():
    args = call_args(widths=SA1, k=20)
    assert torch.equal(sa.sa_group_mlp(*args), sa.sa_group_mlp_reference(*args))


# ------------------------------------------------- the kernel's tile plan

@pytest.mark.parametrize("f, c1, c2, rows", [
    (0, 64, 64, 128), (128, 128, 128, 128), (64, 128, 64, 128), (64, 192, 64, 64),
    (256, 64, 64, 64), (0, 256, 256, 64), (192, 192, 192, 64)])
def test_tile_rows_fit_shared_memory(f, c1, c2, rows):
    """128 rows a tile while two regions of them fit a block's 227 KB, else
    64, which fits every width the kernel takes."""
    assert sa.tile_rows(f, c1, c2) == rows
    assert sa.smem_bytes(rows, f, c1, c2) <= 232448
    assert sa.smem_bytes(64, 256, 256, 256) <= 232448


@pytest.mark.parametrize("f, c1, c2, c3", [
    (0, 64, 64, 128), (128, 128, 128, 256), (64, 192, 64, 128), (256, 256, 256, 256)])
def test_split_scratch_holds_every_stage(f, c1, c2, c3):
    """The scratch holds one 64-column x 32-channel stage (its hi and lo) for
    each step of a tile: each layer's 64-column slices times its input's
    32-channel chunks, layer 1 on the features alone (the coordinates run in
    FFMA)."""
    steps = (c1 // 64) * (f // 32) + (c2 // 64) * (c1 // 32) + (c3 // 64) * (c2 // 32)
    assert sa.split_floats(f, c1, c2, c3) == steps * 2 * 64 * 32


def segmented_group_max(values, k, valid):
    """The kernel's layer-3 max over a tile, emulated: each warp's 16 rows
    as two 8-row halves (rows 16 w + g and 16 w + g + 8, g = lane / 4), a
    shuffle down by d = 1, 2, 4 rows taken where the row d on is in the
    same group, then each group's first row of a half (its head) combining
    into the group's slot by max. values (rows,), NaN winning; rows from
    ``valid`` on belong to no group."""
    rows = values.shape[0]
    slots = {}
    for base in range(0, rows, 8):
        v = values[base:base + 8].copy()
        r = np.arange(base, base + 8)
        grp = np.where(r < valid, r // k, -1)
        g = r - base
        length = np.where(grp < 0, -1, np.minimum(7 - g, (grp + 1) * k - 1 - r))
        for d in (1, 2, 4):
            shifted = np.concatenate([v[d:], v[:d]])  # lanes past 7 read anything
            v = np.where((d <= length) & ((shifted > v) | np.isnan(shifted)), shifted, v)
        head = (grp >= 0) & ((g == 0) | ((r - 1) // k != grp))
        for i in np.nonzero(head)[0]:
            cur = slots.get(grp[i], 0.0)
            slots[grp[i]] = np.nan if np.isnan(cur) or np.isnan(v[i]) else max(cur, v[i])
    return slots


@pytest.mark.parametrize("rows", [64, 128])
@pytest.mark.parametrize("k", [1, 3, 7, 8, 13, 16, 20, 32, 33, 50, 64])
def test_segmented_group_max_is_amax(rows, k):
    """The kernel's segmented max gives each group's amax for every k, with
    tiles holding floor(rows / k) groups (at most 16), the last ragged, and
    a NaN row winning its group alone."""
    groups = min(16, rows // k)  # the kernel's groups a tile
    rng = np.random.default_rng(k * rows)
    for gv in {groups, max(1, groups - 1)}:
        valid = gv * k
        values = np.maximum(rng.normal(size=rows), 0.0)
        values[valid:] = 1e9  # rows past the groups must never reach a slot
        if gv > 1:
            values[k + k // 2] = np.nan
        slots = segmented_group_max(values, k, valid)
        assert sorted(slots) == list(range(gv))
        for grp in range(gv):
            want = values[grp * k:(grp + 1) * k]
            if np.isnan(want).any():
                assert np.isnan(slots[grp])
            else:
                assert slots[grp] == want.max()


# ------------------------------------------------------------- on the card

def card_level(widths, b, n, m, k, card, seed=0):
    block = level(widths, m, k, device=card, seed=seed)
    xyz, feats = inputs(b, n, widths[0], card, seed)
    with torch.no_grad():
        centers, idx = pointnet2.group_indices(xyz, m, k, block.radius)
    return block, (xyz, feats, centers, idx, layers_of(block), KERAS_BN_EPSILON)


@pytest.mark.card
@pytest.mark.parametrize("widths, b, n, m, k", [
    (SA1, 256, 1024, 512, 32), (SA2, 256, 512, 128, 64),
    (SA1, 8, 256, 37, 1), (SA1, 8, 256, 37, 20), (SA1, 8, 256, 9, 64),
    (SA2, 8, 256, 37, 1), (SA2, 8, 256, 37, 20), (SA2, 8, 256, 9, 64),
    ((256, (256, 256, 256)), 4, 256, 13, 20), ((256, (256, 256, 256)), 4, 256, 13, 32),
    ((64, (192, 64, 128)), 4, 256, 11, 33),
], ids=["sa1-serving", "sa2-serving", "sa1-k1", "sa1-k20", "sa1-k64", "sa2-k1",
        "sa2-k20", "sa2-k64", "wide-k20", "wide-k32", "mixed-k33"])
def test_card_kernel_matches_its_plain_version(card, widths, b, n, m, k):
    """The kernel against its plain version on the card at the serving
    shapes (256 x 512 x 32 and 256 x 128 x 64), at k 1, 20 and 64 with m no
    multiple of a tile's groups, and at 64-row tiles: within 2e-6 of the
    largest output, one launch a call."""
    _, args = card_level(widths, b, n, m, k, card)
    launched = build.LAUNCHES["sa_group_mlp"]
    with torch.no_grad():
        got = sa.sa_group_mlp(*args)
        want = sa.sa_group_mlp_reference(*args)
    torch.cuda.synchronize()
    assert build.LAUNCHES["sa_group_mlp"] - launched == 1
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert max_rel_err(got, want) <= 2e-6


@pytest.mark.card
@pytest.mark.parametrize("k", [20, 32])
@pytest.mark.parametrize("widths", [SA1, SA2], ids=["sa1", "sa2"])
def test_card_nan_row_reaches_its_group(card, widths, k):
    """A NaN in one neighbour row makes its group's every output NaN, and no
    other group's: in the segmented max (k 20) and the butterfly (k 32)."""
    _, (xyz, feats, centers, idx, layers, eps) = card_level(widths, 4, 256, 37, k, card)
    p = int(idx[2, 5, 7])
    if feats is None:
        xyz = xyz.clone()
        xyz[2, p, 1] = float("nan")
    else:
        feats = feats.clone()
        feats[2, p, 3] = float("nan")
    with torch.no_grad():
        got = sa.sa_group_mlp(xyz, feats, centers, idx, layers, eps)
    hit = (idx == p).any(dim=-1)
    hit[[0, 1, 3]] = False
    assert torch.isnan(got[hit]).all()
    assert torch.isfinite(got[~hit]).all()


@pytest.mark.card
def test_card_launches_twice_a_pointnet2_inference_forward(card):
    """An f32 PointNet++ inference forward launches the kernel twice and
    gives the plain path's heads within f32 rounding; a train step, a bf16
    forward and a CPU forward launch none."""
    model = randomize_batch_norms(pointnet2.pointnet2_for_width(
        23, 12, 1024, device=card, generator=torch.Generator().manual_seed(0),
        dropout_rate=0.0)).eval()
    points = torch.randn(8, 1024, 3, device=card)
    build.reset("sa_group_mlp")
    with torch.no_grad():
        got = model(points)
    torch.cuda.synchronize()
    assert build.LAUNCHES["sa_group_mlp"] == 2
    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(pointnet2, "_level_kernel", lambda *_: False)
        want = model(points)
    for name in want:
        torch.testing.assert_close(got[name], want[name], rtol=1e-5, atol=1e-6)

    build.reset("sa_group_mlp")
    model.train()
    out = model(points, train=True)
    (out["classification_output"].sum() + out["segmentation_output"].sum()).backward()
    bf16 = pointnet2.pointnet2_for_width(23, 12, 1024, device=card, dtype=torch.bfloat16,
                                         generator=torch.Generator().manual_seed(0))
    cpu = pointnet2.pointnet2_for_width(23, 12, 1024, device="cpu",
                                        generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        bf16.eval()(points)
        cpu.eval()(points[:2].cpu())
    torch.cuda.synchronize()
    assert build.LAUNCHES["sa_group_mlp"] == 0
