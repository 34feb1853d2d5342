"""The one launch path of the port's hand-written kernels on the CPU: every
wrapper refuses a device with no kernel (here the meta device) and counts
nothing; ``ops/cuda/build.py`` declares the launch counters once and
refuses any other name; and no wrapper launches around it."""

from pathlib import Path

import pytest
import torch

from pointcloudprocessing_tpu_torch.ops.cuda import (
    build,
    fps,
    gather_maxmin,
    knn_select,
    pooled_chain,
    sa_group_mlp,
    voxel_reduce,
    window_normals,
)


def _meta(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device="meta")


I32, BOOL = torch.int32, torch.bool
CALLS = {
    "sorted_segment_reduce": lambda: voxel_reduce.sorted_segment_reduce(
        _meta(1, 8, 4), _meta(1, 8, dtype=I32)),
    "segment_reduce": lambda: voxel_reduce.segment_reduce(
        _meta(1, 200, 4), _meta(1, 200, dtype=I32)),
    "monotone_segment_sum": lambda: voxel_reduce.monotone_segment_sum(
        _meta(1, 200, 4), _meta(1, 200, dtype=I32)),
    "fps_with_points": lambda: fps.fps_with_points(
        _meta(1, 8, 3), 4, _meta(1, 8, dtype=BOOL), _meta(1, dtype=I32)),
    "pooled_chain_forward": lambda: pooled_chain.pooled_chain_forward(
        _meta(1, 8, 64), _meta(64, 64), _meta(64), _meta(64)),
    "pooled_chain_backward": lambda: pooled_chain.pooled_chain_backward(
        _meta(1, 8, 64), _meta(64, 64), _meta(1, 64), _meta(1, 64, dtype=I32),
        _meta(64, 64), _meta(64)),
    "windowed_moment_sums": lambda: window_normals.windowed_moment_sums(
        _meta(1, 256, 3), _meta(1, 256, dtype=BOOL), 16),
    "gather_maxmin": lambda: gather_maxmin.gather_maxmin(
        _meta(1, 8, 4), _meta(1, 8, 2, dtype=I32)),
    "knn_select": lambda: knn_select.knn_select(_meta(2, 64, 8), 20),
    "sa_group_mlp": lambda: sa_group_mlp.sa_group_mlp(
        _meta(1, 8, 3), None, _meta(1, 4, 3), _meta(1, 4, 2, dtype=I32),
        [(_meta(c, c_in), *(_meta(c) for _ in range(4)))
         for c_in, c in ((3, 64), (64, 64), (64, 128))], 1e-3),
}


@pytest.mark.parametrize("wrapper", sorted(CALLS))
def test_no_silent_fallback_off_cpu(wrapper):
    """Only a CPU tensor takes the plain version; any other device goes to
    the kernel or raises (here the meta device, which has no kernel), and a
    refusal counts no launch."""
    before = dict(build.LAUNCHES)
    with pytest.raises(ValueError, match=r"^no .* kernel for device meta"):
        CALLS[wrapper]()
    assert build.LAUNCHES == before


def test_the_counters_are_the_kernels_line_names():
    """One counter a wrapper and form, under the names of ``chip_smoke.py``'s
    kernels JSON line, declared once."""
    assert build.COUNTERS == tuple(build.LAUNCHES)
    assert sorted(build.COUNTERS) == sorted([
        "sorted_segment_sum", "segment_reduce", "fps_with_points",
        "pooled_chain_forward", "pooled_chain_backward", "pooled_chain_forward_bf16",
        "pooled_chain_backward_bf16", "windowed_moment_sums", "gather_maxmin",
        "gather_maxmin_bf16", "knn_select", "sa_group_mlp"])


@pytest.mark.parametrize("name", ["knn_graph", "gather_maxmin_f32", ""])
def test_an_undeclared_counter_raises(name):
    """Counting or zeroing under a name that ``build.COUNTERS`` does not
    declare raises and adds no counter."""
    before = dict(build.LAUNCHES)
    with pytest.raises(KeyError, match="no launch counter"):
        build.count(name)
    with pytest.raises(KeyError, match="no launch counter"):
        build.reset(name)
    assert build.LAUNCHES == before


def test_only_build_launches():
    """No module under ``ops/cuda/`` but ``build.py`` loads a library or
    reads a stream: every launch goes through ``build.launch``."""
    wrappers = [p for p in Path(build.__file__).parent.glob("*.py") if p.name != "build.py"]
    assert {"fps.py", "knn_select.py", "pooled_chain.py", "sa_group_mlp.py"} <= {
        p.name for p in wrappers}
    for path in wrappers:
        source = path.read_text()
        assert "cuda_stream" not in source, path.name
        assert "build.load(" not in source, path.name
