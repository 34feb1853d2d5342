"""The port never imports JAX or Flax.

Checked in a subprocess: tests/conftest.py imports jax into the test
process itself.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = """
import importlib, pkgutil, sys
import pointcloudprocessing_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax"))
print(len(names), bad)
"""


def test_port_imports_no_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _CHECK], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    count, bad = proc.stdout.strip().split(" ", 1)
    assert bad == "[]", f"port modules pulled in {bad}"
    assert int(count) >= 20  # every module of the port was imported
