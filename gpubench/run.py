#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``. Loads, warms up,
measures for ``--seconds``, checks what the timed path produced against the
reference, prints each compared number beside its limit as the last lines
of standard error, and prints one JSON line last on standard output: the
cell's end-to-end metrics (``--trace 0``) or its per-layer metrics read from
a traced stretch of the window (``--trace 1``). Fails, and prints no
result, without CUDA or with fewer cards than the cell asks for, and when
JAX or the JAX package was loaded.
"""

from __future__ import annotations

import os
import time


def _process_start() -> float:
    """When this process started, on ``time.time()``'s clock."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))


STARTED = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

#: top-level module names that no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pointcloudprocessing_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole."""
    return sorted(m for m in list(sys.modules) if m.split(".", 1)[0] in FORBIDDEN)


def caches() -> None:
    """Kernel caches at fixed paths inside the checkout. The port builds its
    CUDA libraries into ``pointcloudprocessing_tpu_torch/csrc/build/``;
    Triton, for kernels to come, under ``gpubench/.cache/triton``."""
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "gpubench" / ".cache" / "triton")


def measure(cell, seed: int, seconds: float, trace: bool, device) -> dict:
    """One run of ``cell`` on ``device``: the result line as a dict, its
    compared numbers last. Prints each compared number beside its limit on
    standard error."""
    from gpubench.harness.session import device_info
    from gpubench.harness.trace import breakdown, busy_seconds

    outcome = cell.runner.run(cell, seed, seconds, trace, device, STARTED)
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    info = device_info(device, cell.chips, outcome.memory_peak_bytes)
    reading = outcome.reading
    line = {"correct": outcome.correct, "attempted": outcome.attempted,
            "failed": outcome.failed}
    if trace:
        values = {}
        if reading is not None and reading.stretch.whole:
            values = {name: reader.read(reading) for name, reader in cell.readers.items()}
            info["busy_s"] = busy_seconds(reading.stretch.rows)
            info["window_s"] = reading.stretch.wall_s
        else:
            print("the traced stretch is not whole: no per-layer metric", file=sys.stderr)
    else:
        values = {m["name"]: outcome.metrics[m["name"]] for m in cell.end_to_end}
    line["metrics"] = {k: {"value": v, "unit": units[k]} for k, v in values.items()
                       if v is not None}
    line["device"] = info
    if trace and reading is not None and reading.stretch.whole:
        line["breakdown"] = breakdown(reading.stretch)
    line["compared"] = {c.name: {"value": c.value, "limit": c.limit} for c in outcome.compared}
    for c in outcome.compared:
        print(f"compared {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    return line


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    caches()

    import torch

    from gpubench.harness.registry import find_cell

    with open(ROOT / "BENCHMARK.json") as f:
        benchmark = json.load(f)
    cell = find_cell(benchmark, args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    line = measure(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
