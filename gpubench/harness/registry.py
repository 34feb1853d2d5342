"""Finds everything a cell needs by the names in ``BENCHMARK.json``, so that a
cell, a configuration, a traffic mix or a metric is added by adding files
and entries, never by editing a file that is there:

- ``configs/<config>.json``: the configuration's sizes as run (the entry's
  ``file``), and ``configs/<config>.py`` beside it: ``build_program``,
  ``reference_forward``, ``forward_flops`` and ``model_fps``;
- ``traffic/<traffic>.json``: the mix's parameters; its ``kind`` names the
  runner ``runners/<kind>.py``, which runs it;
- ``metrics/<metric>.py``: the reader of one per-layer metric (``read``);
- ``limits/<workload>.json``: each number the cell compares, its limit and
  the readings the limit was set from.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parents[1]


def load_module(path: Path, name: str) -> ModuleType:
    """Import the file ``path`` under the module name ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` and everything it names."""

    name: str
    chips: int
    config_name: str
    config: dict              # the configuration file's content
    model: ModuleType         # configs/<config>.py
    traffic_name: str
    traffic: dict
    runner: ModuleType        # runners/<kind>.py
    end_to_end: list          # the entries of the metrics this cell reports
    per_layer: list
    readers: dict             # per-layer metric name -> metrics/<name>.py
    limits: dict              # compared number -> {"limit": ..., ...}


def reports(metric: dict, workload: str) -> bool:
    """Whether a metric entry is reported in ``workload``."""
    return "workloads" not in metric or workload in metric["workloads"]


def find_cell(benchmark: dict, workload: str, root: Path,
              bench_dir: Path = BENCH_DIR) -> Cell:
    """Resolve ``workload`` of ``benchmark`` (the parsed ``BENCHMARK.json``
    at ``root``) to its files."""
    cells = {w["name"]: w for w in benchmark["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(it has {', '.join(sorted(cells))})")
    entry = cells[workload]
    config_entry = next(c for c in benchmark["configs"] if c["name"] == entry["config"])
    config_file = root / config_entry["file"]
    traffic = _json(bench_dir / "traffic" / f"{entry['traffic']}.json")
    per_layer = [m for m in benchmark["per_layer"] if reports(m, workload)]
    return Cell(
        name=workload,
        chips=entry["chips"],
        config_name=entry["config"],
        config=_json(config_file),
        model=load_module(config_file.with_suffix(".py"), f"gpubench_config_{entry['config']}"),
        traffic_name=entry["traffic"],
        traffic=traffic,
        runner=load_module(bench_dir / "runners" / f"{traffic['kind']}.py",
                           f"gpubench_runner_{traffic['kind']}"),
        end_to_end=[m for m in benchmark["end_to_end"] if reports(m, workload)],
        per_layer=per_layer,
        readers={m["name"]: load_module(bench_dir / "metrics" / f"{m['name']}.py",
                                        "gpubench_metric_" + m["name"].replace(".", "_"))
                 for m in per_layer},
        limits=_json(bench_dir / "limits" / f"{workload}.json"),
    )
