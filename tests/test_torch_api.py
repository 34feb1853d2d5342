"""The port's package surface: every name a JAX subpackage exports in its
``__all__`` is importable from the port's subpackage of the same name,
except the few that have no twin by design (stated below, with the reason).
"""

import importlib

import pytest

SUBPACKAGES = ("ops", "train", "models", "data", "utils", "parallel", "export",
               "synthesis", "toolkit", "core")

# (subpackage, name): why the port has no such name
EXCEPTIONS = {
    ("parallel", "batch_sharding"): "a jax.sharding object",
    ("parallel", "replicated_sharding"): "a jax.sharding object",
    ("export", "export_stablehlo"): "export/pt2.py::export_program stands in",
    ("export", "load_stablehlo"): "export/pt2.py::load_program stands in",
    ("export", "export_tf_savedmodel"): "blocked: no TensorFlow bridge",
}


def _jax(sub):
    return importlib.import_module(f"pointcloudprocessing_tpu.{sub}")


def _port(sub):
    return importlib.import_module(f"pointcloudprocessing_tpu_torch.{sub}")


CASES = [(sub, name) for sub in SUBPACKAGES for name in _jax(sub).__all__]


@pytest.mark.parametrize("sub,name", CASES, ids=[f"{s}.{n}" for s, n in CASES])
def test_name_is_exported(sub, name):
    """``from pointcloudprocessing_tpu_torch.<sub> import <name>`` works,
    or the name is a stated exception and the port does not provide it."""
    port = _port(sub)
    if (sub, name) in EXCEPTIONS:
        assert not hasattr(port, name), f"{sub}.{name} exists: drop the exception"
    else:
        assert hasattr(port, name), f"pointcloudprocessing_tpu_torch.{sub} lacks {name}"
        assert name in port.__all__


def test_exceptions_are_jax_names():
    """Every stated exception names a name the JAX package exports."""
    assert set(EXCEPTIONS) <= set(CASES)


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_all_keeps_the_jax_order(sub):
    """The JAX names of each port ``__all__`` come in the JAX order; each
    listed name exists."""
    port = _port(sub)
    assert all(hasattr(port, n) for n in port.__all__)
    jax_names = [n for n in _jax(sub).__all__ if (sub, n) not in EXCEPTIONS]
    assert [n for n in port.__all__ if n in jax_names] == jax_names


def test_modules_stay_modules():
    """``mat_ops`` is bound as a module, as in the JAX package; ``knn`` and
    ``icp`` are the functions, as in the JAX package."""
    import types

    from pointcloudprocessing_tpu_torch import ops, toolkit

    assert isinstance(ops.mat_ops, types.ModuleType)
    assert ops.mat_ops.__name__ == "pointcloudprocessing_tpu_torch.ops.mat_ops"
    assert isinstance(toolkit.mat_ops, types.ModuleType)
    assert callable(ops.knn) and not isinstance(ops.knn, types.ModuleType)
    assert callable(ops.icp) and not isinstance(ops.icp, types.ModuleType)
    knn_mod = importlib.import_module("pointcloudprocessing_tpu_torch.ops.knn")
    assert knn_mod.knn is ops.knn


def test_onnx_available_is_the_jax_rule(monkeypatch):
    """True only when tensorflow, tf2onnx and onnx all import."""
    import sys
    import types

    from pointcloudprocessing_tpu_torch.export import onnx_available

    names = ("tensorflow", "tf2onnx", "onnx")
    for name in names:
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert onnx_available() is True
    for missing in names:
        monkeypatch.setitem(sys.modules, missing, None)  # import raises
        assert onnx_available() is False
        monkeypatch.setitem(sys.modules, missing, types.ModuleType(missing))
