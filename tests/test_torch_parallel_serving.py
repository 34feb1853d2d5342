"""The port's multi-device surface in one process: the mesh's functions
(row shares, whole-batch draws, the replica's generators, the refusals of
``initialize_multihost`` and of the mesh forms), the steps' refusal of a
model with the other BatchNorm statistics, ``sync_batch_stats``; sharded
serving, ``PointCloudPipeline(mesh=["cpu", "cpu"])``, equal to the
single-device pipeline and within 1e-4 of JAX's ``mesh=`` serving over 2
of the conftest's virtual CPU devices; and ``dryrun_multichip(2)`` on gloo
ranks.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_parallel_worker as tpw
from pointcloudprocessing_tpu.models.pipeline import PointCloudPipeline as JaxPipeline
from pointcloudprocessing_tpu.models.pointnet import PointNet as JaxPointNet
from pointcloudprocessing_tpu_torch.graft_entry import dryrun_multichip
from pointcloudprocessing_tpu_torch.models.pipeline import PointCloudPipeline
from pointcloudprocessing_tpu_torch.models.pointnet import FreezeFlags
from pointcloudprocessing_tpu_torch.parallel import mesh as mesh_lib
from pointcloudprocessing_tpu_torch.train import steps
from test_torch_parallel import C, NO_JITTER, PARTS, POINTNET, WEIGHTS


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread, as ``tests/test_torch_parallel.py`` runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------- in one process

@pytest.mark.parametrize("world", [1, 2, 3, 4, 7])
@pytest.mark.parametrize("batch", [4, 11, 32])
def test_row_shares_cover_the_batch_in_order(world, batch):
    slices = [mesh_lib.row_slice(batch, r, world) for r in range(world)]
    assert slices[0].start == 0 and slices[-1].stop == batch
    assert all(a.stop == b.start for a, b in zip(slices, slices[1:]))
    sizes = [s.stop - s.start for s in slices]
    assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("rows", [slice(0, 1), slice(1, 3), slice(3, 4)])
def test_row_draws_are_the_whole_batch_draws(rows):
    full = torch.rand((4, 5, 3), generator=torch.Generator().manual_seed(3))
    part = mesh_lib.draw(torch.rand, (rows.stop - rows.start, 5, 3),
                         mesh_lib.RowDraws(torch.Generator().manual_seed(3), 4, rows))
    assert torch.equal(part, full[rows])


def test_step_generators_fold_the_replica():
    cpu = torch.device("cpu")
    draws = [[torch.rand(4, generator=g) for g in steps.step_generators(7, 2, cpu, r)]
             for r in (0, 1, 2)]
    single = [torch.rand(4, generator=g) for g in steps.step_generators(7, 2, cpu)]
    assert all(torch.equal(a, b) for a, b in zip(draws[0], single))
    assert not torch.equal(draws[1][0], draws[0][0])
    assert not torch.equal(draws[1][1], draws[2][1])


def test_initialize_multihost_refuses_nccl_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="NCCL"):
        mesh_lib.initialize_multihost("127.0.0.1:1", 1, 0)
    with pytest.raises(RuntimeError, match="NCCL"):
        mesh_lib.initialize_multihost("127.0.0.1:1", 1, 0, backend="nccl")


def test_initialize_multihost_names_a_missing_variable(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        mesh_lib.initialize_multihost(backend="gloo")


def test_in_process_mesh_and_its_refusals(monkeypatch):
    mesh = mesh_lib.data_parallel_mesh(["cpu", "cpu", "cpu"])
    assert mesh.group is None and mesh.world == 3 and mesh.devices == (torch.device("cpu"),) * 3
    shards = [mesh_lib.shard_batch(np.arange(7), mesh, r) for r in range(3)]
    assert [s.tolist() for s in shards] == [[0, 1], [2, 3], [4, 5, 6]]
    assert mesh_lib.replicate_from_local({"w": torch.ones(2)}, mesh)["w"].sum() == 2
    with pytest.raises(ValueError, match="points axis"):
        mesh_lib.data_parallel_mesh(["cpu", "cpu"], points_axis=2)
    with pytest.raises(ValueError, match="process-group"):
        steps.make_train_step(tpw._build("pointnet", POINTNET), None, WEIGHTS,
                              FreezeFlags(), NO_JITTER, mesh)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh_lib.data_parallel_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh_lib.data_parallel_mesh(["cuda:0"])


@pytest.mark.parametrize("synced,mode", [(False, "global"), (True, "single"),
                                         (True, "shard_map")])
def test_a_step_refuses_a_model_with_the_other_statistics(synced, mode):
    """Building a step changes no BatchNorm: the global step needs the
    group's statistics (``sync_batch_stats(model, mesh)``), the single and
    shard_map steps local ones, and each refuses the other."""
    model = tpw._build("pointnet", POINTNET)
    mesh = mesh_lib.DataParallelMesh((torch.device("cpu"),), "group", 0, 2)
    mesh_lib.sync_batch_stats(model, mesh if synced else None)
    build = {"global": lambda: steps.make_train_step(
                 model, None, WEIGHTS, FreezeFlags(), NO_JITTER, mesh),
             "single": lambda: steps.make_train_step(
                 model, None, WEIGHTS, FreezeFlags(), NO_JITTER),
             "shard_map": lambda: steps.make_shardmap_train_step(
                 model, None, WEIGHTS, FreezeFlags(), NO_JITTER, mesh)}[mode]
    with pytest.raises(ValueError, match="sync_batch_stats"):
        build()
    bns = [m for m in model.modules() if hasattr(m, "stats_group")]
    assert all(m.stats_group == ("group" if synced else None) for m in bns)


def test_sync_batch_stats_switches_every_batchnorm():
    model = tpw._build("pointnet", POINTNET)
    mesh = mesh_lib.DataParallelMesh((torch.device("cpu"),), "group", 0, 2)
    bns = [m for m in model.modules() if hasattr(m, "stats_group")]
    assert len(bns) > 10 and all(m.stats_group is None for m in bns)
    mesh_lib.sync_batch_stats(model, mesh)
    assert all(m.stats_group == "group" for m in bns)
    assert model.mlp_2_3.bn.stats_group == "group"  # the pooled chain's
    mesh_lib.sync_batch_stats(model, None)
    assert all(m.stats_group is None for m in bns)


# ---------------------------------------------------------- sharded serving

@pytest.fixture(scope="module")
def serving():
    from test_torch_pipeline import _one_point_per_voxel_scans
    from test_torch_pointnet import jax_variables, torch_model

    jmodel = JaxPointNet(num_classes=C, num_parts=PARTS)
    variables = jax_variables(jmodel, 64, seed=1)
    scans = _one_point_per_voxel_scans(np.random.default_rng(8), b=4)
    return jmodel, variables, torch_model(variables, C, PARTS, vanilla=False), scans


@pytest.mark.parametrize("sampler", ["fps", "stride", "head"])
def test_pipeline_mesh_equals_single_device_and_jax_mesh(serving, sampler):
    jmodel, variables, model, scans = serving
    kw = dict(scan_width=256, model_width=64, voxel_size=0.25, sampler=sampler)
    sharded = PointCloudPipeline(model, mesh=["cpu", "cpu"], **kw)
    single = PointCloudPipeline(model, **kw)
    jmesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    want = JaxPipeline(jmodel, variables, mesh=jmesh, **kw)(scans)
    got, one = sharded(scans), single(scans)
    assert set(got) == set(want) == set(one)
    for key in want:
        assert torch.equal(got[key], one[key]), key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=1e-4, err_msg=key)


def test_pipeline_mesh_stream_and_refusals(serving):
    _, _, model, scans = serving
    pipe = PointCloudPipeline(model, scan_width=256, model_width=64,
                              voxel_size=0.25, mesh=["cpu", "cpu"])
    assert len(pipe.replicas) == 1  # one replica for a repeated device
    streamed = list(pipe.stream(iter([scans, scans[::-1].copy()])))
    for batch, out in zip([scans, scans[::-1].copy()], streamed):
        direct = pipe(batch)
        for key in direct:
            assert torch.equal(out[key], direct[key]), key
    with pytest.raises(ValueError, match="equal shards"):
        pipe(scans[:3])
    with pytest.raises(ValueError, match="in-process"):
        PointCloudPipeline(model, scan_width=256, model_width=64, mesh=mesh_lib.
                           DataParallelMesh((torch.device("cpu"),), "group", 0, 2))


def test_dryrun_multichip_two_ranks(capsys):
    dryrun_multichip(2, device="cpu")
    out = capsys.readouterr().out
    for leg in ("leg 1 (global train step", "leg 2 (shard_map train step",
                "leg 3 (sharded serving pipeline"):
        assert leg in out
    assert "dryrun_multichip OK" in out
