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
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", REPO + "/chip_smoke.py")
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
names.append("chip_smoke")
forbidden = ("jax", "jaxlib", "flax", "pointcloudprocessing_tpu")
bad = sorted(m for m in sys.modules if m.split(".")[0] in forbidden)
print(json.dumps({"names": names, "bad": bad}))
"""


def test_port_imports_nothing_of_jax():
    """Every module of the port, and chip_smoke.py imported as a module,
    leave no module of jax, jaxlib, flax or pointcloudprocessing_tpu in
    sys.modules."""
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
