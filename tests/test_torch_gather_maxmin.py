"""The plain version of the port's neighbour max/min kernel against the JAX
package's ``gather_maxmin``: its Pallas lane kernel in interpret mode at the
shapes that kernel takes (n % 128 == 0, w <= 96), and its gather fallback at
the DGCNN widths above that. Max and min create no values, so the bar is
bit-identical; NaN propagates on both sides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudprocessing_tpu.ops.gather import gather_rows as jax_gather_rows
from pointcloudprocessing_tpu.ops.pallas.gather_maxmin import (
    gather_maxmin as jax_gather_maxmin,
)
from pointcloudprocessing_tpu_torch.ops.cuda.gather_maxmin import (
    gather_maxmin,
    gather_maxmin_reference,
)
from pointcloudprocessing_tpu_torch.ops.gather import gather_rows


def _case(b, n, w, k, seed, nan=False):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, n, w)).astype(np.float32)
    idx = rng.integers(0, n, (b, n, k)).astype(np.int32)
    if nan:
        q[0, 5, 1] = np.nan
        idx[0, :4, 0] = 5  # four rows see the NaN neighbour
    return q, idx


@pytest.mark.parametrize("b,n,w,k,nan", [
    (2, 128, 64, 20, False),
    (1, 256, 96, 20, False),
    (2, 128, 3, 8, True),
], ids=["w64", "w96-n256", "w3-nan"])
def test_matches_jax_lane_kernel(b, n, w, k, nan):
    q, idx = _case(b, n, w, k, seed=w, nan=nan)
    want = jax_gather_maxmin(jnp.asarray(q), jnp.asarray(idx), interpret=True)
    got = gather_maxmin(torch.from_numpy(q), torch.from_numpy(idx))
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))
    if nan:
        assert np.isnan(got[0].numpy()[0, :4, 1]).all()
        assert np.isnan(got[1].numpy()[0, :4, 1]).all()


@pytest.mark.parametrize("w", [128, 256])
def test_matches_jax_gather_fallback(w):
    """Above the lane kernel's width the JAX function gathers and reduces:
    the DGCNN layers 3 and 4 shapes, cut to 2 clouds of 256 points."""
    q, idx = _case(2, 256, w, 20, seed=w)
    want = jax_gather_maxmin(jnp.asarray(q), jnp.asarray(idx), allow_pallas=False)
    got = gather_maxmin_reference(torch.from_numpy(q), torch.from_numpy(idx))
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))


def test_gather_rows_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 40, 5)).astype(np.float32)
    idx = rng.integers(0, 40, (2, 7, 3)).astype(np.int32)
    want = np.asarray(jax_gather_rows(jnp.asarray(x), jnp.asarray(idx)))
    got = gather_rows(torch.from_numpy(x), torch.from_numpy(idx)).numpy()
    assert got.shape == (2, 7, 3, 5)
    np.testing.assert_array_equal(got, want)


def test_gather_form_slices_and_blocks():
    """The shared form takes the largest slice that fits and gives about a
    block an SM: at DGCNN's 64 clouds of 1,024 points, S 32 at every edge
    width (128 blocks at w 64) and at w 96; S 4 at w 3; S 8 at 16 clouds
    of w 64."""
    from pointcloudprocessing_tpu_torch.ops.cuda.gather_maxmin import (
        MIN_BLOCKS,
        gather_form,
    )

    assert MIN_BLOCKS == 128
    for w in (64, 128, 256, 96):
        assert gather_form(64, 1024, w) == ("shared", 32)
    assert gather_form(64, 1024, 3) == ("shared", 4)
    assert gather_form(16, 1024, 64) == ("shared", 8)
    # b x ceil(w / S) around the block count: 64 clouds x 2 slices of 32
    # reach it, 63 do not
    assert gather_form(63, 1024, 64) == ("shared", 16)
    # no slice gives enough blocks: the smallest that fits
    assert gather_form(1, 1024, 64) == ("shared", 4)


@pytest.mark.parametrize("s,n_max", [(32, 1816), (16, 3632), (8, 7264),
                                     (4, 14528)])
def test_gather_form_where_each_slice_stops_fitting(s, n_max):
    """n x S x 4 bytes within a block's 232,448: the largest n of each
    slice keeps it, one more point takes the next smaller slice (at w 256
    and 128 clouds, where every slice gives enough blocks), and past S 4
    the L2 form."""
    from pointcloudprocessing_tpu_torch.ops.cuda.gather_maxmin import (
        SHARED_BYTES,
        gather_form,
    )

    assert n_max * s * 4 <= SHARED_BYTES < (n_max + 1) * s * 4
    assert gather_form(128, n_max, 256) == ("shared", s)
    assert gather_form(128, n_max + 1, 256) == (
        ("shared", s // 2) if s > 4 else ("l2", 0))


def test_gather_form_refuses_empty_shapes():
    from pointcloudprocessing_tpu_torch.ops.cuda.gather_maxmin import gather_form

    for shape in ((0, 4, 4), (4, 0, 4), (4, 4, 0)):
        with pytest.raises(ValueError):
            gather_form(*shape)


def test_width_no_multiple_of_the_slice_matches_jax_lane_kernel():
    """w 40 at DGCNN's batch takes slices of 32 (one full, one of 8): the
    plain version against the lane kernel in interpret mode at that w."""
    from pointcloudprocessing_tpu_torch.ops.cuda.gather_maxmin import gather_form

    form, s = gather_form(64, 1024, 40)
    assert form == "shared" and 40 % s
    q, idx = _case(2, 128, 40, 20, seed=40, nan=True)
    want = jax_gather_maxmin(jnp.asarray(q), jnp.asarray(idx), interpret=True)
    got = gather_maxmin(torch.from_numpy(q), torch.from_numpy(idx))
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))


def test_cloud_past_the_shared_memory_matches_jax_gather_fallback():
    """A cloud of 14,529 points fits no slice (the L2 form): the plain
    version against the JAX function's gather fallback, k 1 and k 3."""
    from pointcloudprocessing_tpu_torch.ops.cuda.gather_maxmin import gather_form

    n = 14529
    assert gather_form(1, n, 8) == ("l2", 0)
    for k in (1, 3):
        q, idx = _case(1, n, 8, k, seed=k, nan=True)
        want = jax_gather_maxmin(jnp.asarray(q), jnp.asarray(idx),
                                 allow_pallas=False)
        got = gather_maxmin(torch.from_numpy(q), torch.from_numpy(idx))
        for g, wnt in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))


# --------------------------------------------------------------- gather_plan

from pointcloudprocessing_tpu_torch.ops.cuda import gather_maxmin as gm  # noqa: E402


def _ring(slice_, c_begin, slices, parts, blocks):
    return gm.Launch("ring", slice_, c_begin, slices, parts, blocks)


@pytest.mark.parametrize("b,n,w,want", [
    # DGCNN's 64 clouds of 1,024 points: 64-channel slices; two point ranges
    # a slab at w 64 (128 tiles), one at w 128 (128) and w 256 (256 tiles
    # on 132 persistent blocks)
    (64, 1024, 64, (_ring(64, 0, 1, 2, 128),)),
    (64, 1024, 128, (_ring(64, 0, 2, 1, 128),)),
    (64, 1024, 256, (_ring(64, 0, 4, 1, 132),)),
    # w 72: the full 64 channels, then the last 8 in 16-byte rows
    (64, 1024, 72, (_ring(64, 0, 1, 2, 128), _ring(8, 64, 1, 1, 64))),
    # w 40 and w 8: one slice in the narrowest rows that hold w
    (64, 1024, 40, (_ring(64, 0, 1, 2, 128),)),
    (64, 1024, 8, (_ring(8, 0, 1, 1, 64),)),
    # fewer clouds: more point ranges, at least a round of the block's
    # warps (128 points at 128-byte rows) each
    (16, 1024, 64, (_ring(64, 0, 1, 8, 128),)),
    (8, 1024, 64, (_ring(64, 0, 1, 8, 64),)),
    (1, 1024, 64, (_ring(64, 0, 1, 8, 8),)),
    # the 128-byte ring's last row and one past it (64-byte rows)
    (4, 1792, 64, (_ring(64, 0, 1, 14, 56),)),
    (4, 1793, 64, (_ring(32, 0, 2, 7, 56),)),
    # the narrowest ring's last row, one past it (the shared form's S 8 to
    # 14,528 points), and n 16,384 (the L2 form: a warp a point row)
    (1, 14336, 64, (_ring(8, 0, 8, 14, 112),)),
    (1, 14337, 64, (gm.Launch("shared", 8, 0, 8, 1, 8),)),
    (4, 16384, 64, (gm.Launch("l2", 0, 0, 0, 1, 8192),)),
    # the kc46 DGCNN stage: 8 clouds of 8,192 points in 16-byte rows, the
    # ring form while its 64 slabs leave half the SMs idle, else the shared
    # form (a block a slab)
    (8, 8192, 64, (_ring(8, 0, 8, 2, 128),)),
    (8, 8192, 128, (gm.Launch("shared", 8, 0, 16, 1, 128),)),
    (8, 8192, 256, (gm.Launch("shared", 8, 0, 32, 1, 256),)),
    (2, 8192, 256, (_ring(8, 0, 32, 2, 128),)),
])
def test_gather_plan_bf16_edges(b, n, w, want):
    assert gm.gather_plan(b, n, w, 2) == want


def test_gather_plan_takes_the_shared_form_where_the_ring_cannot():
    """f32 keeps gather_form's single launch; bf16 takes it where TMA cannot
    copy the rows (w not a multiple of 8 channels, q not 16-byte aligned)
    and past the narrowest ring."""
    for b, n, w in ((64, 1024, 64), (16, 1024, 64), (4, 16384, 64), (64, 1024, 3)):
        form, s = gm.gather_form(b, n, w, 4)
        assert gm.gather_plan(b, n, w, 4) == (
            (gm.Launch("l2", 0, 0, 0, 1, -(-b * n // 8)),) if form == "l2" else
            (gm.Launch("shared", s, 0, -(-w // s), 1, b * -(-w // s)),))
    assert gm.gather_plan(64, 1024, 3, 2) == (gm.Launch("shared", 8, 0, 1, 1, 64),)
    assert gm.gather_plan(64, 1024, 100, 2)[0].form == "shared"
    assert gm.gather_plan(64, 1024, 64, 2, aligned=False)[0].form == "shared"
    for shape in ((0, 4, 8), (4, 0, 8), (4, 4, 0)):
        with pytest.raises(ValueError):
            gm.gather_plan(*shape, 2)
    with pytest.raises(ValueError):
        gm.gather_plan(4, 4, 8, 3)


def test_ring_rows_fill_a_block():
    """Whole 8 KB boxes (at most 256 rows) and two mbarriers within a
    block's 232,448 bytes of shared memory, and one more box would not fit."""
    assert {rb: gm.ring_rows(rb) for rb in gm.RING_ROW_BYTES} == {
        128: 1792, 64: 3584, 32: 7168, 16: 14336}
    for rb in gm.RING_ROW_BYTES:
        box = gm.ring_box_rows(rb)
        assert gm.ring_rows(rb) * rb + 16 <= gm.SHARED_BYTES
        assert (gm.ring_rows(rb) + box) * rb + 16 > gm.SHARED_BYTES


def _walk(b, n, w, itemsize, plan):
    """Every store the plan's launches make, as the kernels make them: the
    ring form's tile t (on block t mod grid) is slab t // parts (cloud,
    slice) and points [part n // parts, (part + 1) n // parts), its lanes
    storing the slice's channels below w; the shared form's block a
    (cloud, slice) over every point; the L2 form every (point, channel).
    Returns the count of writes of each (cloud, point, channel), which both
    outputs share, and the largest slab a block stages, in bytes."""
    writes = np.zeros((b, n, w), np.int32)
    slab_bytes = 0
    for step in plan:
        if step.form == "l2":
            writes += 1
            continue
        if step.form == "shared":
            slab_bytes = max(slab_bytes, n * step.slice * itemsize)
            for a in range(b * step.slices):
                c0 = (a % step.slices) * step.slice
                writes[a // step.slices, :, c0:c0 + step.slice] += 1
            continue
        rb = 2 * step.slice
        assert n <= gm.ring_rows(rb) and step.blocks <= step.tiles(b)
        slab_bytes = max(slab_bytes, gm.ring_rows(rb) * rb + 16)
        per_block = [0] * step.blocks
        for t in range(step.tiles(b)):
            per_block[t % step.blocks] += 1
            slab, part = divmod(t, step.parts)
            cloud, s = divmod(slab, step.slices)
            c0 = step.c_begin + s * step.slice
            lo, hi = part * n // step.parts, (part + 1) * n // step.parts
            writes[cloud, lo:hi, c0:min(c0 + step.slice, w)] += 1
        # the tiles are dealt evenly: no block takes two more than another
        assert max(per_block) - min(per_block) <= 1
    return writes, slab_bytes


WALK_SHAPES = [
    (64, 1024, 64), (64, 1024, 128), (64, 1024, 256), (16, 1024, 64),
    (64, 1024, 72), (64, 1024, 40), (64, 1024, 8), (64, 1024, 96),
    (64, 1024, 200), (1, 1024, 64), (8, 1000, 64), (3, 1000, 136),
    (2, 1792, 128), (2, 1793, 128), (2, 3584, 64), (2, 3585, 64),
    (2, 7168, 24), (2, 7169, 24), (1, 14336, 16), (1, 14337, 16),
    (8, 8192, 64), (4, 8192, 128), (2, 8192, 256), (1, 16384, 8),
    (3, 5, 8), (200, 300, 512), (7, 129, 72), (1, 1, 8), (5, 2048, 264),
    (33, 640, 192), (64, 1024, 3), (9, 1024, 100),
]


@pytest.mark.parametrize("b,n,w", WALK_SHAPES)
def test_gather_plan_writes_every_output_once(b, n, w):
    """A plain walk of the bf16 plan (and of f32's form): every (cloud,
    point, channel) of both outputs is written exactly once, and no block
    stages more than a block's shared memory."""
    for itemsize in (2, 4):
        plan = gm.gather_plan(b, n, w, itemsize)
        writes, slab_bytes = _walk(b, n, w, itemsize, plan)
        assert (writes == 1).all(), (itemsize, plan)
        assert slab_bytes <= gm.SHARED_BYTES == 232_448


def _ring_schedule(n, rb, tiles):
    """The ring's copies as ``gather_maxmin_ring_kernel`` issues them for
    one block's ``tiles`` tiles: tile j lies at ring row 0 (j even) or
    rows - npad (j odd); its early boxes are issued once tile j - 1 has
    landed, its late ones once tile j - 1's gathers are over. Returns, a
    tile at a time, the rows each event writes and the rows then in use."""
    box, rows = gm.ring_box_rows(rb), gm.ring_rows(rb)
    nb = -(-n // box)
    npad = nb * box
    ov = max(0, 2 * npad - rows) // box
    base = [0 if j % 2 == 0 else rows - npad for j in range(tiles)]
    events = []
    for j in range(tiles):
        early = range(ov, nb) if j % 2 else range(0, nb - ov)
        late = range(0, ov) if j % 2 else range(nb - ov, nb)
        if j == 0:
            early, late = range(nb), range(0)
        # early: issued while tile j - 1 is gathered (in use)
        in_use = set(range(base[j - 1], base[j - 1] + npad)) if j else set()
        events.append(({r for i in early for r in range(base[j] + i * box,
                                                          base[j] + (i + 1) * box)},
                       in_use))
        # late: tile j - 1 is over; nothing else is in use
        events.append(({r for i in late for r in range(base[j] + i * box,
                                                         base[j] + (i + 1) * box)},
                       set()))
    return events, rows, nb, npad


@pytest.mark.parametrize("n,rb", [(1024, 128), (1, 128), (896, 128), (897, 128),
                                  (1792, 128), (1000, 64), (3584, 64), (8192, 16),
                                  (14336, 16), (7168, 32)])
def test_ring_copies_never_overwrite_rows_in_use(n, rb):
    """Each tile's boxes land inside the ring, cover its npad rows once,
    and an early box never writes a row of the tile being gathered."""
    events, rows, nb, npad = _ring_schedule(n, rb, 5)
    for j in range(5):
        (early, in_use), (late, _) = events[2 * j], events[2 * j + 1]
        assert not early & in_use
        assert not early & late
        assert len(early | late) == npad
        assert all(0 <= r < rows for r in early | late)
