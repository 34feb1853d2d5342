"""The port never imports JAX, Flax or anything of the JAX package, and its
copy of the config schema reads configs as the JAX package's does.

The import check runs in a subprocess: tests/conftest.py imports jax into
the test process itself.
"""

import dataclasses
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = """
import importlib, json, pkgutil, sys
sys.path.insert(0, REPO)
import pointcloudprocessing_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
# the Qt views raise the GUI's advisory without PyQt6, by design; import
# them again under the Qt test double so that their imports are checked too
gated = [n for n in names if n.endswith((".gui.views", ".gui.main_app"))]
refused = []
for name in names:
    try:
        importlib.import_module(name)
    except ImportError as e:
        if name not in gated or "requires PyQt6" not in str(e):
            raise
        refused.append(name)
sys.path.insert(0, REPO + "/tests")
import qt_stub
sys.modules.update(qt_stub.install())
for name in gated:
    sys.modules.pop(name, None)
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", REPO + "/chip_smoke.py")
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
names.append("chip_smoke")
forbidden = ("jax", "jaxlib", "flax", "pointcloudprocessing_tpu")
bad = sorted(m for m in sys.modules if m.split(".")[0] in forbidden)
print(json.dumps({"names": names, "bad": bad, "gated": gated,
                  "refused": refused}))
"""


def test_port_imports_nothing_of_jax():
    """Every module of the port, and chip_smoke.py imported as a module,
    leave no module of jax, jaxlib, flax or pointcloudprocessing_tpu in
    sys.modules. The GUI's Qt views refuse to import without PyQt6 (the
    GUI's advisory) and are imported under the Qt test double."""
    code = f"REPO = {REPO!r}\n" + _CHECK
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["bad"] == [], f"port modules pulled in {report['bad']}"
    assert len(report["names"]) >= 30  # every module of the port was imported
    for name in ("ops.augment", "ops.cuda.pooled_chain", "models.fused_pool",
                 "train.losses", "train.steps", "core.config", "core.constants",
                 "utils.native", "ops.knn", "ops.normals", "ops.gather",
                 "ops.cuda.window_normals", "ops.cuda.gather_maxmin",
                 "models.dgcnn", "models.pointnet2", "ops.cuda.voxel_reduce"):
        assert f"pointcloudprocessing_tpu_torch.{name}" in report["names"], name
    assert "chip_smoke" in report["names"]
    gui = "pointcloudprocessing_tpu_torch.toolkit.gui"
    assert sorted(report["gated"]) == [f"{gui}.main_app", f"{gui}.views"]
    # without PyQt6 exactly those two refuse, with the GUI's advisory
    try:
        import PyQt6  # noqa: F401
    except ImportError:
        assert sorted(report["refused"]) == sorted(report["gated"])
    for name in ("export.onnx_native", "export.pt2", "export.cli",
                 "export.keras_compat", "export.onnx_bridge", "toolkit.mat_ops",
                 "toolkit.calibration", "toolkit.radar_truth",
                 "toolkit.reflector_analysis", "toolkit.gui.views",
                 "parallel", "parallel.mesh", "graft_entry"):
        assert f"pointcloudprocessing_tpu_torch.{name}" in report["names"], name


def test_no_import_statement_names_jax():
    """Every import statement of the port, of chip_smoke.py and of the
    kernel tools in tools/, including those inside functions (which
    importing a module does not run), names neither JAX nor the JAX
    package."""
    import ast

    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "tools", "fps_bench.py"),
             os.path.join(REPO, "tools", "window_bench.py"),
             os.path.join(REPO, "tools", "window_events.py")]
    for root, _, names in os.walk(os.path.join(REPO, "pointcloudprocessing_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    forbidden = ("jax", "jaxlib", "flax", "pointcloudprocessing_tpu")
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
            else:
                continue
            bad += [f"{os.path.relpath(path, REPO)}:{node.lineno} {m}"
                    for m in mods if m.split(".")[0] in forbidden]
    assert len(files) >= 30
    assert bad == []


_SURFACE = """
import glob, importlib, importlib.util, json, os, sys
sys.path.insert(0, REPO)
for sub in ("ops", "train", "models", "data", "utils", "parallel", "export",
            "synthesis", "toolkit", "core"):
    importlib.import_module("pointcloudprocessing_tpu_torch." + sub)
paths = sorted(glob.glob(os.path.join(REPO, "examples", "torch", "*.py")))
paths.append(os.path.join(REPO, "tools", "gpu_acceptance.py"))
paths += sorted(glob.glob(os.path.join(REPO, "tools", "torch", "*.py")))
for path in paths:
    name = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location("checked_" + name, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
print(json.dumps({"paths": [os.path.relpath(p, REPO) for p in paths], "bad": bad}))
"""

# none of these is installed on the GPU machine, or may be imported there
SURFACE_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pointcloudprocessing_tpu",
                     "PyQt6", "pandas", "joblib")


def test_surface_examples_and_acceptance_import_nothing_of_jax():
    """Importing every port subpackage (their re-exports), every
    ``examples/torch`` script, ``tools/gpu_acceptance.py`` and the JAX
    tools' twins in ``tools/torch`` (``trace_ops.py``, ``bench_ingest.py``)
    leaves no
    module of JAX, Flax, optax, the JAX package, PyQt6, pandas or joblib in
    ``sys.modules``; no import statement of those files names one either."""
    import ast
    import glob

    code = f"REPO = {REPO!r}\nFORBIDDEN = {SURFACE_FORBIDDEN!r}\n" + _SURFACE
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["bad"] == [], f"imports pulled in {report['bad']}"
    assert len(report["paths"]) >= 15  # twelve twins, the acceptance tool, two tools
    for tool in ("trace_ops.py", "bench_ingest.py"):
        assert os.path.join("tools", "torch", tool) in report["paths"]

    files = glob.glob(os.path.join(REPO, "examples", "torch", "*.py"))
    files.append(os.path.join(REPO, "tools", "gpu_acceptance.py"))
    files += glob.glob(os.path.join(REPO, "tools", "torch", "*.py"))
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
            else:
                continue
            bad += [f"{os.path.relpath(path, REPO)}:{node.lineno} {m}"
                    for m in mods if m.split(".")[0] in SURFACE_FORBIDDEN]
    assert bad == []


def test_config_copy_matches_jax():
    """``configs/kc46_lidar_config.json`` through both ``load_config``s:
    the same dataclasses, field by field, stages included."""
    from pointcloudprocessing_tpu.core import config as jax_config
    from pointcloudprocessing_tpu.core import constants as jax_constants
    from pointcloudprocessing_tpu_torch.core import config, constants

    path = os.path.join(REPO, "configs", "kc46_lidar_config.json")
    want, got = jax_config.load_config(path), config.load_config(path)
    assert type(got).__name__ == type(want).__name__ == "TrainConfig"
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [f.name for f in dataclasses.fields(got)] == [
        f.name for f in dataclasses.fields(want)]
    assert len(got.stages) > 1 and got.num_classes == want.num_classes
    with open(path) as f:
        raw = json.load(f)
    raw["params"]["model"], raw["params"]["model_options"] = "dgcnn", {"k": 10}
    assert dataclasses.asdict(config.parse_config(raw)) == dataclasses.asdict(
        jax_config.parse_config(raw))
    names = [n for n in dir(jax_constants) if n.isupper()]
    assert names and all(getattr(constants, n) == getattr(jax_constants, n)
                         for n in names)
