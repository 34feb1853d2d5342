"""The port's loaders against the JAX package's: ``DeviceLoader``'s index
and content sequences and ``StreamingLoader``'s batches are equal, batch
for batch (exact), and the host cases of ``tests/test_streaming.py``
(epoch-addressable replay, the persistent stream, abandoned batches
delivered again, a producer error raised in the consumer) hold."""

import collections
import itertools

import numpy as np
import pytest
import torch

from helpers import CLASS_LABELS, PART_LABELS
from pointcloudprocessing_tpu.data import loader as jax_loader
from pointcloudprocessing_tpu_torch.data import loader
from pointcloudprocessing_tpu_torch.data.pointcloudset import PointCloudSet

WIDTH = 16


def _arrays(n, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "observations": rng.normal(size=(n, WIDTH, 3)).astype(np.float32),
        "class_label": rng.integers(0, 23, n).astype(np.int32),
        "part_labels": rng.integers(0, 12, (n, WIDTH)).astype(np.int32),
        "se3": rng.normal(size=(n, 3, 3)).astype(np.float32),
    }


def _host(batch):
    """(x, class labels, part labels, se3) as numpy; labels as int64, since
    the JAX loader sends part labels as uint8 (its wire shrink)."""
    x, t = batch
    return [np.asarray(x),
            np.asarray(t["classification_output"]).astype(np.int64),
            np.asarray(t["segmentation_output"]).astype(np.int64),
            np.asarray(t["se3"])]


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(_host(g), _host(w)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,batch,epochs,seed", [
    (23, 4, (0, 1, 2), 7),     # drop_remainder tail
    (24, 6, (0, 1, 2), 0),     # exact epochs
    (3, 5, (0, 1, 2), 11),     # smaller than one batch: with replacement
])
def test_device_loader_sequences_equal_jax(n, batch, epochs, seed):
    arrays = _arrays(n, seed)
    ours = loader.DeviceLoader(arrays, batch, seed=seed)
    ref = jax_loader.DeviceLoader(arrays, batch, seed=seed, device_resident=False)
    assert ours.steps_per_epoch == ref.steps_per_epoch
    steps = max(ours.steps_per_epoch, 1)
    for epoch in epochs:
        idx = list(itertools.islice(ours._batch_indices(epoch), steps))
        ref_idx = list(itertools.islice(ref._batch_indices(epoch), steps))
        for a, b in zip(idx, ref_idx):
            np.testing.assert_array_equal(a, b)
        got = list(ours.batches(num_steps=steps, device="cpu", epoch=epoch))
        want = list(ref.batches(num_steps=steps, epoch=epoch))
        _assert_batches_equal(got, want)
        assert got[0][0].dtype == torch.float32 and got[0][0].device.type == "cpu"
    # epoch=None: the stateful stream, across epoch boundaries
    got = list(ours.batches(num_steps=3 * steps + 1, device="cpu"))
    want = list(ref.batches(num_steps=3 * steps + 1))
    _assert_batches_equal(got, want)


def test_device_loader_unshuffled_and_empty():
    arrays = _arrays(10)
    ours = loader.DeviceLoader(arrays, 4, shuffle=False, drop_remainder=False)
    ref = jax_loader.DeviceLoader(arrays, 4, shuffle=False, drop_remainder=False,
                                  device_resident=False)
    _assert_batches_equal(list(ours.batches(num_steps=6, device="cpu")),
                          list(ref.batches(num_steps=6)))
    assert list(loader.DeviceLoader(_arrays(0), 4).batches(device="cpu")) == []


@pytest.fixture(scope="module")
def split_files(tmp_path_factory):
    """Several TFRecord files written by the port's PointCloudSet."""
    tmp = tmp_path_factory.mktemp("stream")
    pc = PointCloudSet(name="stream_set", class_labels=CLASS_LABELS,
                       part_labels=PART_LABELS, network_input_width=WIDTH,
                       rand_seed=0, data_path=str(tmp) + "/",
                       print_func=lambda *a: None)
    rng = np.random.default_rng(0)
    for k in range(3):
        n = 40 + k * 7
        pc.add_data(
            f"set_{k}", rng.normal(size=(n, WIDTH, 3)).astype(np.float32),
            np.full(n, k % 2, np.int64),
            rng.integers(0, len(PART_LABELS), (n, WIDTH)).astype(np.int64),
            np.tile(np.eye(3, dtype=np.float32), (n, 1, 1)))
    return pc


def _streams(pc, use_native, **kw):
    args = dict(files=pc._split_files("train"), width=WIDTH,
                count=pc.split_count("train"), shuffle_window=16,
                chunk_records=4, use_native=use_native, **kw)
    return loader.StreamingLoader(**args), jax_loader.StreamingLoader(**args)


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "python"])
def test_streaming_equal_jax(split_files, use_native):
    count = split_files.split_count("train")
    ours, ref = _streams(split_files, use_native, batch_size=5, seed=7)
    for epoch in (0, 1):  # epoch-addressable
        _assert_batches_equal(
            list(ours.batches(num_steps=count // 5, device="cpu", epoch=epoch)),
            list(ref.batches(num_steps=count // 5, epoch=epoch)))
    # the persistent repeat stream, over two calls that straddle epochs
    for _ in range(2):
        _assert_batches_equal(
            list(ours.batches(num_steps=count // 5 + 3, device="cpu")),
            list(ref.batches(num_steps=count // 5 + 3)))


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "python"])
def test_chunked_reader_equal_jax(split_files, use_native):
    path = split_files._split_files("train")[0]
    ours, ref = _streams(split_files, use_native, batch_size=4)
    whole = split_files.load_split_arrays("train")
    offset, chunks = 0, []
    while offset >= 0:
        chunk, nxt = ours._read_chunk(path, offset)
        want, want_nxt = ref._read_chunk(path, offset)
        assert nxt == want_nxt
        for a, b in zip(chunk, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        chunks.append(chunk)
        offset = nxt
    got = np.concatenate([c[0] for c in chunks])
    np.testing.assert_array_equal(got, whole["observations"][: len(got)])


def test_epoch_addressable_replay(split_files):
    count = split_files.split_count("train")

    def run(ldr, epoch):
        return [(x.numpy().copy(), t["classification_output"].numpy().copy())
                for x, t in ldr.batches(num_steps=count // 5, device="cpu", epoch=epoch)]

    original, _ = _streams(split_files, True, batch_size=5, seed=7)
    run0, run1 = run(original, 0), run(original, 1)
    resumed, _ = _streams(split_files, True, batch_size=5, seed=7)
    re1 = run(resumed, 1)
    assert len(run1) == len(re1) == count // 5
    for (xa, ca), (xb, cb) in zip(run1, re1):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ca, cb)
    assert not all(np.array_equal(a[0], b[0]) for a, b in zip(run0, run1))
    fp = [v for x, _ in run1 for v in x.sum(axis=(1, 2)).round(4)]
    assert max(collections.Counter(fp).values()) == 1


def _fingerprints(x):
    return x.numpy().sum(axis=(1, 2)).round(4).tolist()


def test_stream_persists_across_epochs(split_files):
    count = split_files.split_count("train")
    ours, _ = _streams(split_files, True, batch_size=count, seed=3)
    seen = []
    for _ in range(2):
        for x, _t in ours.batches(num_steps=1, device="cpu"):
            seen.extend(_fingerprints(x))
    want = split_files.load_split_arrays("train")["observations"].sum(axis=(1, 2)).round(4).tolist()
    assert collections.Counter(seen) == collections.Counter(want + want)


def test_abandoned_batches_delivered_again(split_files):
    count = split_files.split_count("train")
    ours, _ = _streams(split_files, True, batch_size=count, seed=7)
    gen = ours.batches(num_steps=2, prefetch=2, device="cpu")
    next(gen)
    gen.close()
    seen = []
    for _ in range(4):
        for x, _t in ours.batches(num_steps=1, device="cpu"):
            seen.extend(_fingerprints(x))
    want = split_files.load_split_arrays("train")["observations"].sum(axis=(1, 2)).round(4).tolist()
    missing = collections.Counter(want * 5) - collections.Counter(seen)
    assert sum(missing.values()) == count  # exactly the one delivered batch


def test_tiny_split_epoch_mode_still_yields(split_files):
    count = split_files.split_count("train")
    ours, _ = _streams(split_files, True, batch_size=count + 5, seed=3)
    got = list(ours.batches(num_steps=1, epoch=0, device="cpu"))
    assert len(got) == 1 and got[0][0].shape[0] == count + 5


def test_producer_error_raised_in_consumer(tmp_path):
    missing = loader.StreamingLoader([str(tmp_path / "missing.tfrecord")], 8,
                                     batch_size=2, count=4, shuffle_window=4,
                                     chunk_records=2, seed=0)
    with pytest.raises((FileNotFoundError, ValueError)):
        for _ in missing.batches(num_steps=1, device="cpu"):
            pass

    def failing():
        yield _arrays(2)["observations"], {"classification_output": np.zeros(2)}
        raise RuntimeError("producer broke")

    got = loader._prefetch_to_device(failing(), None, "cpu")
    next(got)
    with pytest.raises(RuntimeError, match="producer broke"):
        next(got)
