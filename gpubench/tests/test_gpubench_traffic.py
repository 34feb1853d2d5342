"""The frame generator: one pool a seed, the same sizes for every seed, labels
that stay on their parts through the resampling, and frames that keep more
points than FPS takes after the 2 cm voxel."""

import json

import numpy as np
import pytest

from gpubench.harness import frames
from gpubench.tests.helpers import ROOT

SEED = 2**31 + 3


def occupied_voxels(points: np.ndarray, voxel: float) -> np.ndarray:
    """Occupied voxels of each frame (frames, n, 3): the rows a voxel
    downsample keeps."""
    cells = np.floor(points / np.float32(voxel)).astype(np.int64)
    return np.array([len(np.unique(c, axis=0)) for c in cells])


def spec(**changes) -> dict:
    with open(ROOT / "gpubench/traffic/kc46_frames_b256.json") as f:
        out = json.load(f)["frames"]
    out.update(changes)
    return out


def test_a_seed_gives_one_pool_and_another_seed_another():
    small = spec(pool_frames=23, width=512, native_points=[256, 768])
    a, b, c = (frames.make_pool(small, s) for s in (SEED, SEED, SEED + 1))
    for name in ("points", "class_label", "part_labels", "se3", "native"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert not np.array_equal(a.points, c.points)


def test_every_seed_gets_the_same_sizes_and_classes():
    small = spec(pool_frames=46, width=512, native_points=[256, 768])
    a, b = frames.make_pool(small, 1), frames.make_pool(small, 2)
    np.testing.assert_array_equal(np.sort(a.native), np.sort(b.native))
    np.testing.assert_array_equal(np.bincount(a.class_label), np.bincount(b.class_label))
    assert np.bincount(a.class_label).tolist() == [2] * 23


def test_labels_stay_on_their_parts_through_the_resampling():
    """With no pose, no offset and no noise every point lies on the part its
    label names: the repeats that pad a short frame carry their labels."""
    flat = spec(pool_frames=46, width=1024, native_points=[512, 1536], yaw_deg=[0, 0],
                pitch_deg=[0, 0], roll_deg=[0, 0], elevation_deg=[0, 0], distance=[0, 0],
                noise_stdev=0.0)
    pool = frames.make_pool(flat, SEED)
    meshes = frames.class_meshes(flat)
    names = {int(k): v for k, v in flat["part_labels"].items()}
    for f in range(len(pool.points)):
        mesh = meshes[pool.class_label[f]]
        for part in np.unique(pool.part_labels[f]):
            corners = mesh.vertices[mesh.triangles[mesh.parts == names[part]]].reshape(-1, 3)
            lo, hi = corners.min(axis=0) - 1e-5, corners.max(axis=0) + 1e-5
            on = pool.points[f][pool.part_labels[f] == part]
            assert ((on >= lo) & (on <= hi)).all(), (f, names[part])
    short = pool.native < flat["width"]
    assert short.any() and (~short).any()


@pytest.mark.parametrize("seed", [SEED, 7])
def test_every_frame_keeps_more_points_than_fps_takes(seed):
    """The cell's own pool: every frame keeps at least the 1,024 points FPS
    takes after the 2 cm voxel (PERF.md records the distribution)."""
    full = spec()
    pool = frames.make_pool(full, seed)
    valid = occupied_voxels(pool.points, 0.02)
    assert valid.min() >= 1024, np.percentile(valid, [0, 5, 50, 95, 100])
    assert pool.points.shape == (1024, 8192, 3)
