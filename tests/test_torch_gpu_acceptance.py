"""``tools/gpu_acceptance.py`` on the CPU: each check runs with
``device="cpu"`` at its own bars (at smaller sizes where the check takes
them), so that a rename or a changed signature in the port fails here and
not only on the card; ``main()`` refuses to run without CUDA, and a check
that raises counts as a failure.
"""

import ast
import inspect
import importlib.util
import os

import pytest
import torch

from pointcloudprocessing_tpu_torch.ops.cuda import build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


acceptance = _load("gpu_acceptance")

# CPU sizes for the checks whose card sizes are heavy on the host (the
# exact normals' (b, n, n) distance matrices, full-width models)
CPU_SIZES = {
    "check_normals": dict(n=4096, b=1),
    "check_inference_precision_drift": dict(b=2, n=256),
    "check_dgcnn_factored_edge": dict(b=2, n=64),
    "check_pooled_chain_training": dict(b=2, n=256),
    "check_shardmap_training": dict(b=2, w=128),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("fn", acceptance.CHECKS, ids=lambda f: f.__name__)
def test_check_passes_on_the_cpu(fn):
    results = acceptance.run_check(fn, "cpu", **CPU_SIZES.get(fn.__name__, {}))
    assert results
    for result in results:
        assert result.ok, result.line()


def test_checks_twin_the_jax_tool():
    """One check for each of the JAX tool's, but the one-hot gather's (the
    port has no one-hot gather)."""
    with open(os.path.join(REPO, "tools", "tpu_acceptance.py")) as f:
        tree = ast.parse(f.read())
    jax_checks = {node.name for node in tree.body
                  if isinstance(node, ast.FunctionDef)
                  and node.name.startswith("check_")} - {"check"}
    assert {fn.__name__ for fn in acceptance.CHECKS} == jax_checks - {
        "check_onehot_gather"}


def test_main_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        acceptance.main()


def test_a_crashed_check_is_a_failure(monkeypatch, capsys):
    def check_crashes(device="cuda"):
        raise ValueError("boom")

    (result,) = acceptance.run_check(check_crashes, "cpu")
    assert not result.ok
    assert "check_crashes crashed: ValueError: boom" in result.name
    assert result.line().startswith("[FAIL]")

    # main() reports it and exits 1
    from pointcloudprocessing_tpu_torch.ops.cuda import build

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *_: "test card")
    monkeypatch.setattr(build, "build_all", lambda: None)
    monkeypatch.setattr(acceptance, "CHECKS", (check_crashes,))
    assert acceptance.main() == 1
    out = capsys.readouterr().out
    assert "[FAIL] check_crashes crashed" in out and "FAILED: check_crashes" in out


def test_a_result_over_its_bound_fails():
    Result = acceptance.Result
    assert Result("x", 1.0, 1.0, "mm").ok
    assert not Result("x", 1.5, 1.0, "mm").ok
    assert not Result("x", float("nan"), 1.0, "mm").ok
    assert Result("x", 0.5, 1.0, "mm").line() == "[PASS] x: 0.5 mm (bound 1)"


def test_precision_contexts_restore():
    """``pytorch_defaults`` and ``matmul_precision`` set their modes in the
    block and put the caller's back after it."""
    saved = (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32)
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    try:
        with acceptance.pytorch_defaults():
            assert torch.get_float32_matmul_precision() == "highest"
            assert torch.backends.cudnn.allow_tf32 is True
            with acceptance.matmul_precision("high"):
                assert torch.get_float32_matmul_precision() == "high"
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.backends.cudnn.allow_tf32 is False
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]


def test_a_kernel_check_fails_on_the_card_unless_its_kernel_launched():
    """``launching`` raises on a CUDA device when a named counter of
    ``build.LAUNCHES`` did not rise in the block (the check would hold the
    plain version against itself), and asserts nothing on the CPU."""
    with pytest.raises(AssertionError, match=r"did not launch.*'knn_select'"):
        with acceptance.launching("cuda", "knn_select"):
            pass
    saved = build.LAUNCHES["knn_select"]
    try:
        with acceptance.launching("cuda", "knn_select"):
            build.count("knn_select")
    finally:
        build.LAUNCHES["knn_select"] = saved
    with acceptance.launching("cpu", "knn_select"):
        pass
    with pytest.raises(ValueError):  # the block's own error passes through
        with acceptance.launching("cuda", "knn_select"):
            raise ValueError


# the checks that hold none of the port's kernels
NO_KERNEL = {"check_rigid_alignment", "check_inference_precision_drift"}


@pytest.mark.parametrize("fn", [f for f in acceptance.CHECKS
                                if f.__name__ not in NO_KERNEL],
                         ids=lambda f: f.__name__)
def test_each_kernel_check_asserts_its_launches(fn):
    """Every check that holds a kernel runs it inside ``launching``, the
    twin of the JAX tool's asserts that its kernel path is active."""
    assert "launching(device" in inspect.getsource(fn)
