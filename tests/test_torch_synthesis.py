"""The port's synthesis package against the JAX package's on the CPU.

- The copied mesh code (``synthesis/mesh.py``, ``procedural.py``) gives the
  same arrays: OBJ and OFF parsing, uniform sampling from the same
  generator, areas and normals, every procedural factory.
- ``MeshSampler`` with the same seed gives the same observations, part
  labels, positions and DCMs (within 1e-5; the DCMs are f32 on both sides,
  built from the same numpy viewpoints), for the plain and ``reproject``
  forms of all three observation methods.
- ``write_collect`` writes the same files byte for byte (both writers);
  the port's frame and pose-log parsers read back the observations, parts
  and DCMs; and the collect ingests through the port's ``PointCloudSet`` to
  the split arrays the JAX package's ingest gives.
"""

import filecmp
import importlib
import os

import numpy as np
import pytest

from pointcloudprocessing_tpu.synthesis import collect as jax_collect
from pointcloudprocessing_tpu.synthesis import mesh as jax_mesh
from pointcloudprocessing_tpu.synthesis import procedural as jax_procedural
from pointcloudprocessing_tpu_torch.data.frames import parse_frame_file, parse_state_info
from pointcloudprocessing_tpu.data import pointcloudset as jax_pointcloudset
from pointcloudprocessing_tpu_torch.data import pointcloudset
from pointcloudprocessing_tpu_torch.synthesis import collect, mesh, procedural
from pointcloudprocessing_tpu_torch.synthesis.meshsampler import MeshSampler, pad_observation

jax_meshsampler = importlib.import_module("pointcloudprocessing_tpu.synthesis.meshsampler")

CUBE_OBJ = """v -1 -1 -1\nv 1 -1 -1\nv 1 1 -1\nv -1 1 -1\nv -1 -1 1\nv 1 -1 1
v 1 1 1\nv -1 1 1\nf 1 4 3 2\nf 5/1 6/2 7/3 8/4\nf 1 2 6 5\nf 2 3 7 6\nf 3 4 8 7
f -5 -8 -4 -1\n"""
OFF = "OFF 4 2 0\n0 0 0\n1 0 0\n1 1 0\n0 1 0\n4 0 1 2 3\n3 0 2 3\n"


def same_mesh(a, b):
    assert np.array_equal(a.vertices, b.vertices) and a.vertices.dtype == b.vertices.dtype
    assert np.array_equal(a.triangles, b.triangles) and a.triangles.dtype == b.triangles.dtype


def test_mesh_code_equals_jax(tmp_path):
    (tmp_path / "cube.obj").write_text(CUBE_OBJ)
    (tmp_path / "quad.off").write_text(OFF)
    for loader in ("load_obj", "load_off"):
        path = str(tmp_path / ("cube.obj" if loader == "load_obj" else "quad.off"))
        got, want = getattr(mesh, loader)(path), getattr(jax_mesh, loader)(path)
        same_mesh(got, want)
    got, want = mesh.load_obj(str(tmp_path / "cube.obj")), jax_mesh.load_obj(
        str(tmp_path / "cube.obj"))
    for method in ("triangle_areas", "triangle_normals", "vertex_normals"):
        assert np.array_equal(getattr(got, method)(), getattr(want, method)())
    rot = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    got.scale(2.0, np.ones(3)).rotate(rot, np.ones(3)).translate(np.arange(3.0))
    want.scale(2.0, np.ones(3)).rotate(rot, np.ones(3)).translate(np.arange(3.0))
    same_mesh(got, want)
    for flag in (False, True):
        a = mesh.sample_points_uniformly(got, 999, np.random.default_rng(4), flag)
        b = jax_mesh.sample_points_uniformly(want, 999, np.random.default_rng(4), flag)
        for x, y in zip(a if flag else [a], b if flag else [b]):
            assert np.array_equal(x, y)


@pytest.mark.parametrize("factory,args", [
    ("box_mesh", ((1.0, 2.0, 3.0),)), ("octahedron_mesh", (2.0, 2)),
    ("aircraft_like_mesh", ()), ("kc46_like_mesh", ()), ("f15_like_mesh", ()),
    ("_tube_mesh", (3.0, 0.5, 7))])
def test_procedural_equals_jax(factory, args):
    got = getattr(procedural, factory)(*args)
    want = getattr(jax_procedural, factory)(*args)
    if isinstance(got, tuple):
        same_mesh(got[0], want[0])
        assert np.array_equal(got[1], want[1])
    else:
        same_mesh(got, want)


def test_compound_library_and_helpers_equal_jax():
    parts = [procedural.box_mesh((1, 1, 1)), procedural.octahedron_mesh(0.5, 1)]
    same_mesh(procedural.compound_mesh(*parts), jax_procedural.compound_mesh(*parts))
    got, got_names = procedural.labeled_compound([("a", parts[0]), ("b", parts[1])])
    want, want_names = jax_procedural.labeled_compound([("a", parts[0]), ("b", parts[1])])
    same_mesh(got, want)
    assert np.array_equal(got_names, want_names)
    got, want = procedural.shape_library(7), jax_procedural.shape_library(7)
    assert list(got) == list(want)
    for k in got:
        same_mesh(got[k], want[k])
    for n, obs in ((2, [1, 2, 3]), (7, [1, 2, 3]), (3, [])):
        if obs or n == 0:
            assert pad_observation(n, obs) == jax_meshsampler.pad_observation(n, obs)
    clouds = np.random.default_rng(0).normal(size=(3, 40, 3)) * [3.0, 1.0, 0.5]
    assert np.array_equal(collect.dominant_axis_parts(clouds),
                          jax_collect.dominant_axis_parts(clouds))


@pytest.fixture(scope="module")
def kc46():
    return procedural.kc46_like_mesh()


def sampler_pair(kc46, seed, **kw):
    m, _ = kc46
    got = MeshSampler(None, "kc-46", mesh=m, random_seed=seed, device="cpu", **kw)
    want = jax_meshsampler.MeshSampler(None, "kc-46", mesh=m, random_seed=seed, **kw)
    return got, want


def same_observations(got, want):
    (go, gl, gp, gd), (wo, wl, wp, wd) = got, want
    assert go.shape == wo.shape and gd.dtype == wd.dtype == np.float32
    np.testing.assert_allclose(go, wo, rtol=0, atol=1e-5)
    assert np.array_equal(gl, wl)
    np.testing.assert_allclose(gp, wp, rtol=0, atol=1e-5)
    np.testing.assert_allclose(gd, wd, rtol=0, atol=1e-5)


@pytest.mark.parametrize("reproject", [False, True])
def test_meshsampler_equals_jax(kc46, reproject):
    rot = np.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    got, want = sampler_pair(kc46, 7, rotation_matrix=rot,
                             center_point=np.array([1.0, 0.0, 0.5]), scale=0.5)
    kw = dict(n=3, p=2500, pad=600, dist_range=(40.0, 60.0), camera_rot=15.0,
              reproject=reproject)
    same_observations(got.create_labeled_viewpoint_observations(
        triangle_parts=kc46[1], **kw),
        want.create_labeled_viewpoint_observations(triangle_parts=kc46[1], **kw))
    same_observations(got.create_viewpoint_observations(**kw),
                      want.create_viewpoint_observations(**kw))
    kw["pad"] = 2000
    same_observations(got.create_full_sample_observations(**kw),
                      want.create_full_sample_observations(**kw))
    if reproject:  # the camera frame's +x points at the aircraft
        obs = got.create_viewpoint_observations(**kw)[0]
        assert (obs[..., 0] > 0).mean() > 0.95


def test_meshsampler_without_a_mesh(capsys):
    obs, labels, pos, dcms = MeshSampler(None, "x", device="cpu").create_viewpoint_observations(2, 10, 4)
    assert obs.size == labels.size == pos.size == dcms.size == 0
    assert "No mesh loaded" in capsys.readouterr().out


@pytest.fixture(scope="module")
def observations(kc46):
    m, parts = kc46
    s = MeshSampler(None, "kc-46", mesh=m, random_seed=3, device="cpu")
    return s.create_labeled_viewpoint_observations(n=20, p=3000, pad=256,
                                                   triangle_parts=parts)


@pytest.mark.parametrize("fast", [False, True])
def test_write_collect_equals_jax_and_ingests(observations, tmp_path, fast):
    obs, parts, pos, dcms = observations
    got = collect.write_collect(str(tmp_path / "port" / "collect_a"), obs, "kc-46",
                                parts, dcms=dcms, positions=pos, fast=fast)
    want = jax_collect.write_collect(str(tmp_path / "jax" / "collect_a"), obs, "kc-46",
                                     parts, dcms=dcms, positions=pos, fast=fast)
    for sub in ("", "Lidar"):
        names = sorted(os.listdir(os.path.join(got, sub)))
        assert names == sorted(os.listdir(os.path.join(want, sub)))
        files = [n for n in names if os.path.isfile(os.path.join(got, sub, n))]
        match, mismatch, errors = filecmp.cmpfiles(
            os.path.join(got, sub), os.path.join(want, sub), files, shallow=False)
        assert not mismatch and not errors and len(match) == len(files) > 0

    class_labels = {"kc-46": 0}
    part_names = sorted(set(parts.ravel()))
    part_labels = {p: i for i, p in enumerate(part_names)}
    for i in (0, 7, 19):
        xyz, cls, part = parse_frame_file(os.path.join(got, "Lidar", f"frame_{i}.txt"),
                                          class_labels, part_labels)
        if fast:  # 6 decimals
            np.testing.assert_allclose(xyz, obs[i], rtol=2.0**-23, atol=5e-7)
        else:
            assert np.array_equal(xyz, obs[i].astype(np.float32))
        assert cls == 0 and [part_names[p] for p in part] == list(parts[i])
    log = [f for f in os.listdir(got) if f.startswith("_palindrome_state__")]
    poses = parse_state_info(os.path.join(got, log[0]))
    assert sorted(poses) == list(range(20))
    for i, pose in poses.items():
        np.testing.assert_allclose(pose["tanker_in_sensor_frame"][:3, :3], dcms[i],
                                   atol=1e-7)
        np.testing.assert_allclose(pose["tanker_in_sensor_frame"][:3, 3], pos[i],
                                   atol=1e-7)

    sets = [module.PointCloudSet(
        "synth", ["kc-46"], part_names, 256, batch_size=4, rand_seed=42,
        print_func=lambda *_: None, data_path=str(tmp_path / name) + "/")
        for module, name in ((pointcloudset, "data"), (jax_pointcloudset, "jax_data"))]
    for pc in sets:
        assert pc.add_from_aftr_output(got)
    counts = {s: sets[0].split_count(s) for s in ("train", "val", "test")}
    assert sum(counts.values()) == 20 and counts["train"] > 0
    for split in counts:
        a, b = (pc.load_split_arrays(split) for pc in sets)
        assert sorted(a) == sorted(b) and a["observations"].shape == (counts[split], 256, 3)
        assert all(np.array_equal(a[k], b[k]) for k in a)
