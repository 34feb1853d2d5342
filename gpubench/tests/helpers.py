"""Cells of ``BENCHMARK.json`` shrunk to sizes a CPU test holds: the same
files and code paths, fewer and smaller frames."""

from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

import torch

from gpubench.harness.registry import find_cell

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 11


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def small_cell(workload: str, batch: int = 2, width: int = 1024):
    """``workload`` with a pool of a few frames of ``width`` points."""
    cell = find_cell(benchmark(), workload, ROOT)
    mix = copy.deepcopy(cell.traffic)
    mix["frames"].update(pool_frames=3 * batch, width=width,
                         native_points=[width // 2, 3 * width // 2])
    mix["batch"] = batch
    if mix["kind"] == "serve_stream":
        mix.update(scan_width=width, warmup_batches=1, compare_batches=2,
                   compare_from_first=2, trace_batches=2)
    else:
        mix.update(warmup_steps=3, compared_steps=3, trace_steps=2)
    cell.traffic = mix
    return cell


def measure(cell, seconds: float = 1.0, traced: bool = False) -> dict:
    """``run.py``'s measurement of ``cell`` on the CPU, past its look for a
    chip: the result line."""
    sys.path.insert(0, str(ROOT / "gpubench"))
    try:
        import run
    finally:
        sys.path.remove(str(ROOT / "gpubench"))
    return run.measure(cell, SEED, seconds, traced, torch.device("cpu"))
