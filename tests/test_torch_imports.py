"""The port never imports JAX or Flax.

Checked in a subprocess: tests/conftest.py imports jax into the test
process itself.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = """
import importlib, json, pkgutil, sys
import pointcloudprocessing_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax"))
print(json.dumps({"names": names, "bad": bad}))
"""


def test_port_imports_no_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _CHECK], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["bad"] == [], f"port modules pulled in {report['bad']}"
    assert len(report["names"]) >= 20  # every module of the port was imported
    # the training slice's modules are among them
    for name in ("ops.augment", "ops.cuda.pooled_chain", "models.fused_pool",
                 "train.losses", "train.steps"):
        assert f"pointcloudprocessing_tpu_torch.{name}" in report["names"], name
