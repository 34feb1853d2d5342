"""The port's ingest bench (``tools/torch/bench_ingest.py``, twin of
``tools/bench_ingest.py``) on the CPU: its ``run`` with the native pass on
and off writes byte-identical splits, equal to those the JAX tool's own
``run`` writes from the same collect."""

import importlib.util
import os
import sys

import pytest

from helpers import make_collect

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


bench = _load("bench_ingest_torch_under_test", "tools/torch/bench_ingest.py")
jax_bench = _load("bench_ingest_jax_under_test", "tools/bench_ingest.py")


def _splits(out: str) -> dict:
    """Each split file under ``out`` (the TFRecords, not the pickled set),
    by path relative to ``out``."""
    found = {}
    for root, _, names in os.walk(out):
        for name in names:
            if name.endswith(".tfrecord"):
                path = os.path.join(root, name)
                with open(path, "rb") as f:
                    found[os.path.relpath(path, out)] = f.read()
    return found


@pytest.fixture(scope="module")
def collect(tmp_path_factory):
    return make_collect(str(tmp_path_factory.mktemp("ingest")), num_frames=4,
                        points_per_frame=256, sorted_parts=True)


def test_native_and_python_splits_equal_the_jax_tool(collect, tmp_path):
    """4 frames x 256 points at the tool's width: the native and Python
    passes write the same bytes, and so does the JAX tool's Python pass
    (its native pass would load the JAX package's library, which other
    test workers may be rebuilding in place)."""
    from pointcloudprocessing_tpu_torch.utils import native

    if not native.native_available():
        pytest.skip("the port's native library did not build here")
    outs = {}
    for label, use_native in (("native", True), ("python", False)):
        seconds = bench.run(collect, str(tmp_path / label), use_native, bench.WIDTH)
        assert seconds >= 0.0
        outs[label] = _splits(str(tmp_path / label))
    jax_bench.run(collect, str(tmp_path / "jax"), False, bench.WIDTH)
    outs["jax"] = _splits(str(tmp_path / "jax"))
    assert sorted(outs["native"]) == [
        f"bench/{os.path.basename(collect)}/{s}_0.tfrecord"
        for s in ("test", "train", "val")]
    assert all(outs["native"].values())
    assert outs["python"] == outs["native"]
    assert outs["jax"] == outs["native"]


def test_run_restores_the_native_switch(collect, tmp_path):
    """``run`` patches ``native_available`` for its pass only."""
    from pointcloudprocessing_tpu_torch.data import pointcloudset as pcs_mod

    real = pcs_mod.native.native_available
    bench.run(collect, str(tmp_path / "off"), False, 512)
    assert pcs_mod.native.native_available is real
    assert _splits(str(tmp_path / "off"))
