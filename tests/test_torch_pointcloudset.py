"""The port's PointCloudSet against the JAX package's: the same collects,
ingested with ``rand_seed`` 42 through both, give byte-identical TFRecord
files for each split, an equal census and ``get_info()``, and equal
``load_split_arrays`` (exact: bytes and ``assert_array_equal``). Mirrors the
cases of ``tests/test_pointcloudset.py``."""

import glob
import os
import shutil

import joblib
import numpy as np
import pytest

from helpers import CLASS_LABELS, PART_LABELS, make_collect
from pointcloudprocessing_tpu.data import pointcloudset as jax_pcs
from pointcloudprocessing_tpu_torch.data import pointcloudset as pcs
from pointcloudprocessing_tpu_torch.data.loader import DeviceLoader, StreamingLoader

WIDTH = 64


def _make_set(module, out_dir, seed=42, messages=None, batch_size=4):
    return module.PointCloudSet(
        name="unit", class_labels=CLASS_LABELS, part_labels=PART_LABELS,
        network_input_width=WIDTH, batch_size=batch_size, rand_seed=seed,
        description="unit-test set",
        print_func=(messages.append if messages is not None else lambda *a: None),
        data_path=str(out_dir) + "/",
    )


def _split_bytes(pc):
    return {os.path.relpath(p, pc._set_dir): open(p, "rb").read()
            for p in sorted(glob.glob(f"{pc._set_dir}/*/*.tfrecord"))}


@pytest.fixture(scope="module")
def collects(tmp_path_factory):
    root = tmp_path_factory.mktemp("in")
    a = make_collect(str(root), num_frames=20, points_per_frame=50, seed=0,
                     name="collect_A")
    b = make_collect(str(root), num_frames=13, points_per_frame=80, seed=1,
                     class_name="f-15_model", name="collect_B", sorted_parts=True)
    with open(os.path.join(b, "Lidar", "frame_4.txt"), "a") as f:
        f.write("(0, 0, 0) who-knows wing\n")  # skipped alike
    return a, b


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "python"])
def test_ingest_equal_jax(collects, tmp_path, monkeypatch, use_native):
    monkeypatch.setattr(pcs.native, "native_available", lambda: use_native)
    monkeypatch.setattr(jax_pcs.native, "native_available", lambda: use_native)
    msgs, jax_msgs = [], []
    pc = _make_set(pcs, tmp_path / "port", messages=msgs)
    ref = _make_set(jax_pcs, tmp_path / "jax", messages=jax_msgs)
    for collect in collects:
        pc.add_from_aftr_output(collect)
        ref.add_from_aftr_output(collect)
    got, want = _split_bytes(pc), _split_bytes(ref)
    assert len(got) == 6 and got.keys() == want.keys()
    for name in got:
        assert got[name] == want[name], name
    assert pc._data_size == ref._data_size
    assert pc.get_info() == ref.get_info()
    assert msgs == jax_msgs and any("frame_4" in m for m in msgs)
    assert sum(pc.split_count(s) for s in ("train", "val", "test")) == 32
    for split in ("train", "val", "test"):
        arrays, jax_arrays = pc.load_split_arrays(split), ref.load_split_arrays(split)
        for k in arrays:
            assert arrays[k].dtype == jax_arrays[k].dtype
            np.testing.assert_array_equal(arrays[k], jax_arrays[k])


@pytest.fixture
def pc_set(collects, tmp_path):
    pc = _make_set(pcs, tmp_path / "data")
    pc.add_from_aftr_output(collects[0])
    return pc


def test_counts_arrays_and_loader(pc_set):
    assert {s: pc_set.split_count(s) for s in ("train", "val", "test")} == {
        "train": 15, "val": 3, "test": 2}
    arrays = pc_set.load_split_arrays("train")
    assert arrays["observations"].shape == (15, WIDTH, 3)
    for r in arrays["se3"]:
        np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-5)
    loader = pc_set.get_train_set()
    assert isinstance(loader, DeviceLoader) and loader.steps_per_epoch == 3
    batches = list(loader.batches(num_steps=5, device="cpu"))
    assert len(batches) == 5
    x, targets = batches[0]
    assert x.shape == (4, WIDTH, 3) and x.device.type == "cpu"
    assert targets["segmentation_output"].shape == (4, WIDTH)
    assert targets["se3"].shape == (4, 3, 3)


def test_streaming_switch(pc_set):
    """``max_in_memory_bytes`` below the split's bytes streams it."""
    assert isinstance(pc_set.get_val_set(), DeviceLoader)
    pc_set.max_in_memory_bytes = pc_set._split_bytes("val") - 1
    loader = pc_set.get_val_set()
    assert isinstance(loader, StreamingLoader) and len(loader) == 3
    assert isinstance(pc_set.get_test_set(streaming=False), DeviceLoader)


def test_persistence_roundtrip_and_jax_pickle_refused(pc_set, tmp_path):
    path = f"{pc_set._set_dir}/pc_set.joblib"
    loaded = pcs.load_from_file(path)
    assert type(loaded) is pcs.PointCloudSet
    assert joblib.load(path)._data_size == pc_set._data_size  # joblib reads it
    assert loaded._data_size == pc_set._data_size
    assert loaded.network_input_width == WIDTH
    assert loaded.load_split_arrays("val")["observations"].shape[0] == 3
    ref = _make_set(jax_pcs, tmp_path / "jax")
    with pytest.raises(ValueError, match="JAX package"):
        pcs.load_from_file(f"{ref._set_dir}/pc_set.joblib")


def test_unseeded_ingest(collects, tmp_path):
    pc = _make_set(pcs, tmp_path / "out", seed=None)
    assert pc.add_from_aftr_output(collects[0])
    assert "Is not seeded" in pc.get_info()
    assert sum(pc.split_count(s) for s in ("train", "val", "test")) == 20


def test_missing_tfrecords_raise(pc_set):
    shutil.rmtree(pc_set._set_dir)
    with pytest.raises(FileNotFoundError, match="census but no"):
        pc_set.get_train_set()
