"""The port's CRC32C, Example codec, TFRecord framing and native readers
against the JAX package's, bit for bit on the same seeded inputs.

Mirrors the cases of ``tests/test_tfrecord.py`` and
``tests/test_native_reader.py`` that apply. Tolerance: none; every
comparison is exact (bytes, or arrays with ``assert_array_equal``).
"""

import numpy as np
import pytest

from pointcloudprocessing_tpu.data import tfrecord as jax_tfr
from pointcloudprocessing_tpu.utils import native as jax_native
from pointcloudprocessing_tpu_torch.data import tfrecord as tfr
from pointcloudprocessing_tpu_torch.utils import native

WIDTH = 64


@pytest.fixture(scope="module", autouse=True)
def jax_native_library(tmp_path_factory):
    """The JAX package's native library, built by this module alone.

    The JAX loader compiles onto the shared ``native/libpcp_native.so``,
    and the linker rewrites that file in place. Under a parallel run one
    worker may load it while another worker's build is still writing it:
    ``ctypes`` then raises, and the loader records the failure for the
    rest of that worker's life, so every JAX native entry returns None.
    Here the JAX loader builds (with its own flags) into a directory of
    this module's own, which no other process writes, and its ``_lib`` is
    that library while the module runs; the loader's state comes back
    afterwards."""
    so = tmp_path_factory.mktemp("jax_native") / "libpcp_native.so"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_SO", str(so))
        mp.setattr(jax_native, "_lib", None)
        mp.setattr(jax_native, "_build_failed", False)
        if native.native_available():
            assert jax_native.native_available(), "the JAX native library did not build"
        yield


@pytest.fixture
def with_native():
    """Skip where the C++ helpers do not build (decided at run time, so
    every test worker collects the same tests)."""
    if not native.native_available():
        pytest.skip("native library unavailable")


def _sample(rng, width=16, part_high=12, cls=5):
    return (rng.normal(size=(width, 3)).astype(np.float32), cls,
            rng.integers(0, part_high, width).astype(np.int64),
            rng.normal(size=(3, 3)).astype(np.float32))


def _python_example(obs, cls, parts, se3, codec):
    """The pure-Python contract body (encode_example itself takes the
    native path when the library builds)."""
    features = b"".join([
        codec._map_entry("observations", codec._feature(codec._float_list(obs.ravel()), 2)),
        codec._map_entry("class_label", codec._feature(codec._int64_list(cls), 3)),
        codec._map_entry("part_labels", codec._feature(codec._int64_list(parts.ravel()), 3)),
        codec._map_entry("se3", codec._feature(codec._float_list(se3.ravel()), 2)),
    ])
    return codec._len_delimited(1, features)


def _write(path, samples, codec):
    with codec.TFRecordWriter(path) as w:
        for s in samples:
            w.write(codec.encode_example(*s))


@pytest.mark.parametrize("data", [
    b"", b"123456789", b"\x00" * 32, bytes(range(256)) * 7 + b"tail",
    np.random.default_rng(3).bytes(4099),
])
def test_crc32c_and_masked_equal_jax(data):
    assert native.crc32c(data) == jax_native.crc32c(data)
    assert native._crc32c_python(data) == jax_native._crc32c_python(data)
    assert native.crc32c(data) == native._crc32c_python(data)
    assert tfr.masked_crc32c(data) == jax_tfr.masked_crc32c(data)
    assert native.crc32c(b"123456789") == 0xE3069283  # RFC 3720 vector


@pytest.mark.parametrize("width,part_high,cls", [
    (16, 12, 5), (37, 300, 200), (1, 3, 0), (2, 3, 1), (5, 3, 22), (64, 12, 7),
])
def test_encode_decode_example_equal_jax(width, part_high, cls):
    rng = np.random.default_rng(width)
    s = _sample(rng, width, part_high, cls)
    got = tfr.encode_example(*s)
    assert got == jax_tfr.encode_example(*s)
    assert got == _python_example(*s, tfr) == _python_example(*s, jax_tfr)
    if native.native_available():
        assert native.encode_example_native(*s) == got
    dec, jdec = tfr.decode_example(got), jax_tfr.decode_example(got)
    assert dec.keys() == jdec.keys()
    for k in dec:
        assert dec[k].dtype == jdec[k].dtype
        np.testing.assert_array_equal(dec[k], jdec[k])
    np.testing.assert_array_equal(dec["observations"].reshape(width, 3), s[0])
    np.testing.assert_array_equal(dec["part_labels"], s[2])


def test_negative_int64_roundtrip_equal_jax():
    args = (np.zeros((2, 3), np.float32), -3, np.array([-1, 5]), np.eye(3, dtype=np.float32))
    rec = tfr.encode_example(*args)
    assert rec == jax_tfr.encode_example(*args)
    dec = tfr.decode_example(rec)
    assert dec["class_label"][0] == -3
    np.testing.assert_array_equal(dec["part_labels"], [-1, 5])


def test_writer_bytes_and_reader_equal_jax(tmp_path):
    samples = [_sample(np.random.default_rng(i), 8) for i in range(5)]
    ours, theirs = str(tmp_path / "ours.tfrecord"), str(tmp_path / "jax.tfrecord")
    _write(ours, samples, tfr)
    _write(theirs, samples, jax_tfr)
    raw = open(ours, "rb").read()
    assert raw == open(theirs, "rb").read()
    assert raw == b"".join(tfr.frame_record(tfr.encode_example(*s)) for s in samples)
    records = list(tfr.read_tfrecord_file(ours))
    assert records == list(jax_tfr.read_tfrecord_file(ours))
    assert len(records) == 5


@pytest.mark.parametrize("where", ["length", "data"])
def test_corrupt_crc_detected_like_jax(tmp_path, where):
    path = str(tmp_path / "corrupt.tfrecord")
    _write(path, [_sample(np.random.default_rng(0))], tfr)
    raw = bytearray(open(path, "rb").read())
    raw[9 if where == "length" else 40] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    for codec in (tfr, jax_tfr):
        with pytest.raises(ValueError, match="corrupt"):
            list(codec.read_tfrecord_file(path))


@pytest.mark.usefixtures("with_native")
def test_native_file_reader_equal_jax(tmp_path):
    rng = np.random.default_rng(42)
    path = str(tmp_path / "a.tfrecord")
    samples = [_sample(rng, WIDTH, 12, int(rng.integers(0, 23))) for _ in range(7)]
    _write(path, samples, tfr)
    got = native.read_tfrecord_file_native(path, WIDTH, 32)
    want = jax_native.read_tfrecord_file_native(path, WIDTH, 32)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    for i, (o, c, p, s) in enumerate(samples):
        np.testing.assert_array_equal(got[0][i], o)
        assert got[1][i] == c
        np.testing.assert_array_equal(got[2][i], p)
        np.testing.assert_array_equal(got[3][i], s)
    # exact capacity decodes; one record short of it is an error, as in JAX
    assert len(native.read_tfrecord_file_native(path, WIDTH, 7)[1]) == 7
    for mod in (native, jax_native):
        with pytest.raises(ValueError):
            mod.read_tfrecord_file_native(path, WIDTH, 6)
        with pytest.raises(ValueError, match="width|length"):
            mod.read_tfrecord_file_native(path, WIDTH * 2, 8)


@pytest.mark.usefixtures("with_native")
@pytest.mark.parametrize("chunk", [1, 3, 7, 8])
def test_native_chunk_reader_resumes_equal_jax(tmp_path, chunk):
    """Chunked reads at exact capacity and on resume: the same arrays and
    byte offsets as the JAX package's reader, and together the whole file."""
    rng = np.random.default_rng(chunk)
    path = str(tmp_path / "c.tfrecord")
    _write(path, [_sample(rng, WIDTH) for _ in range(7)], tfr)
    whole = native.read_tfrecord_file_native(path, WIDTH, 7)
    offset, pieces = 0, []
    while offset >= 0:
        got = native.read_tfrecord_chunk_native(path, offset, WIDTH, chunk)
        want = jax_native.read_tfrecord_chunk_native(path, offset, WIDTH, chunk)
        assert got[4] == want[4]
        for g, w in zip(got[:4], want[:4]):
            np.testing.assert_array_equal(g, w)
        pieces.append(got[:4])
        offset = got[4]
    for k in range(4):
        np.testing.assert_array_equal(np.concatenate([p[k] for p in pieces]), whole[k])
    assert len(pieces) == -(-7 // chunk)


@pytest.mark.usefixtures("with_native")
def test_native_detects_corruption_like_jax(tmp_path):
    path = str(tmp_path / "bad.tfrecord")
    _write(path, [_sample(np.random.default_rng(1), WIDTH) for _ in range(2)], tfr)
    raw = bytearray(open(path, "rb").read())
    raw[40] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    for mod in (native, jax_native):
        with pytest.raises(ValueError, match="corrupt|malformed"):
            mod.read_tfrecord_file_native(path, WIDTH, 8)


@pytest.mark.usefixtures("with_native")
@pytest.mark.parametrize("seed,low,high,n", [
    ([1, 0], 0.0, 37.0, 257), ([0, 5], 0.0, 1.0, 64),
    ([(2**62) + 12345, 3], 0.0, 483.0, 100),
    ([987654321, (2**40) + 7], -2.5, 9.75, 33), ([0, 0], 0.0, 6.0, 1),
])
def test_numpy_uniform_and_seed_words_equal_jax(seed, low, high, n):
    np.testing.assert_array_equal(native.seed_entropy_words(seed),
                                  jax_native.seed_entropy_words(seed))
    got = native.numpy_uniform_native(seed, low, high, n)
    np.testing.assert_array_equal(got, np.random.default_rng(list(seed)).uniform(low, high, n))
    np.testing.assert_array_equal(got, jax_native.numpy_uniform_native(seed, low, high, n))


@pytest.mark.usefixtures("with_native")
def test_ingest_frame_equal_jax():
    rng = np.random.default_rng(42)
    cv, pv = ["kc-46", "f-15_model"], ["wing", "fuselage", "engine"]
    se3 = rng.normal(size=(3, 3)).astype(np.float32)
    for width, n_pts in [(64, 40), (64, 64), (32, 50)]:
        pts = rng.uniform(-10, 10, (n_pts, 3))
        text = "".join(f"({p[0]:.4f}, {p[1]:.4f}, {p[2]:.4f}) kc-46 {q}\n"
                       for p, q in zip(pts, rng.choice(pv, n_pts))).encode()
        got = native.ingest_frame_native(text, cv, pv, width, (99, 7), se3)
        want = jax_native.ingest_frame_native(text, cv, pv, width, (99, 7), se3)
        assert got[:3] == want[:3] and got[0] == 0
        np.testing.assert_array_equal(got[3], want[3])
    for text, status in [(b"(1, 2, 3) mystery wing\n", 1), (b"", 2),
                         (b"(nan, nan, nan) kc-46 wing\n", 3),
                         (b"(1, 2) kc-46 wing\n", 4)]:
        res = native.ingest_frame_native(text, ["kc-46"], ["wing"], 16, (1, 2), se3)
        assert res[0] == status == jax_native.ingest_frame_native(
            text, ["kc-46"], ["wing"], 16, (1, 2), se3)[0]
        assert native.INGEST_STATUS_MESSAGES[status] == jax_native.INGEST_STATUS_MESSAGES[status]


@pytest.mark.usefixtures("with_native")
def test_ingest_frames_batch_equal_jax(tmp_path):
    from helpers import make_collect

    collect = make_collect(str(tmp_path), num_frames=6, points_per_frame=50, seed=4)
    with open(f"{collect}/Lidar/frame_2.txt", "a") as f:
        f.write("(0, 0, 0) who-knows wing\n")
    paths = [f"{collect}/Lidar/frame_{i}.txt" for i in range(6)]
    pose_ok = np.array([1, 1, 1, 0, 1, 1], np.uint8)
    se3s = np.random.default_rng(0).normal(size=(6, 9)).astype(np.float32)
    args = (paths, ["kc-46", "f-15_model"], ["wing", "fuselage", "engine"], 64, 777, 0,
            pose_ok, se3s)
    got, want = native.ingest_frames_native(*args), jax_native.ingest_frames_native(*args)
    arena, offsets = got[0], got[1]
    np.testing.assert_array_equal(offsets, want[1])
    np.testing.assert_array_equal(arena[: offsets[-1]], want[0][: want[1][-1]])
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(g, w)
    assert got[4][2] != 0 and got[4][3] != 0  # the bad frame and the missing pose


def test_pose_log_and_listing_equal_jax(tmp_path):
    from helpers import make_collect
    from pointcloudprocessing_tpu.data import frames as jax_frames
    from pointcloudprocessing_tpu_torch.data import frames

    collect = make_collect(str(tmp_path), num_frames=5, points_per_frame=20, seed=3)
    log = f"{collect}/_palindrome_state__2026.Jan.01_00.00.00.UTC.log"
    got, want = frames.parse_state_info(log), jax_frames.parse_state_info(log)
    assert got.keys() == want.keys() == set(range(5))
    for i in got:
        assert got[i].keys() == want[i].keys()
        for k in got[i]:
            np.testing.assert_array_equal(got[i][k], want[i][k])
    msgs, jax_msgs = [], []
    assert sorted(frames.get_dir_contents(collect, msgs.append)) == sorted(
        jax_frames.get_dir_contents(collect, jax_msgs.append))
    assert frames.get_dir_contents(str(tmp_path / "nope"), msgs.append) == []
    jax_frames.get_dir_contents(str(tmp_path / "nope"), jax_msgs.append)
    assert msgs == jax_msgs and len(msgs) == 1

