"""The harness on the CPU: the result line, the copied bounds, the trace
arithmetic, the FLOP counts, the refusals, the imports, and a cell found
from new files alone."""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from gpubench.harness import registry, roofline, trace
from gpubench.harness.session import Reading
from gpubench.tests.helpers import ROOT, SEED, benchmark, measure, small_cell


@pytest.mark.parametrize("workload", ["pointnet_serve_8192", "pointnet_train_8192",
                                      "pointnet2_serve_8192"])
def test_the_last_line_has_the_contracts_keys(workload):
    cell = small_cell(workload, batch=8 if "train" in workload else 2,
                      width=512 if "train" in workload else 2048)
    line = measure(cell)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "compared"]
    assert line["attempted"] > 0 and line["failed"] == 0
    names = {m["name"] for m in cell.end_to_end}
    assert set(line["metrics"]) == names and "setup_s" in names
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert set(line["compared"]) == set(cell.limits)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    json.dumps(line)
    if "serve" in workload:  # f32 on the CPU agrees with the reference within every limit
        assert line["correct"], line["compared"]


def test_the_copied_bounds_are_chip_smokes():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    b, n, k = 4, 2048, 1024
    points, mask = torch.zeros(b, 3, n), torch.ones(b, n, dtype=torch.bool)
    mask[:, 1500:] = False
    start, idx, sampled = (torch.zeros(b, dtype=torch.int32), torch.zeros(b, k, dtype=torch.int32),
                           torch.zeros(b, k, 3))
    assert chip_smoke.fps_bound(points, k, mask, start, idx, sampled) == \
        roofline.fps_bound(b, n, k, int(mask.sum()))
    b, n, c_in, c = 2, 512, 128, 1024
    x, w = torch.zeros(b, n, c_in), torch.zeros(c, c_in)
    a, row = torch.zeros(c), torch.zeros(c)
    pooled, am = torch.zeros(b, c), torch.zeros(b, c, dtype=torch.int32)
    assert chip_smoke.pooled_forward_bound(x, w, a, row, pooled, am) == \
        roofline.pooled_forward_bound(b, n, c_in, c)
    coef, m, crow = torch.zeros(b, c), torch.zeros(c_in, c_in), torch.zeros(c_in)
    dx, dk = torch.zeros(b, n, c_in), torch.zeros(c_in, c)
    assert chip_smoke.pooled_backward_bound(x, w, coef, am, m, crow, dx, dk) == \
        roofline.pooled_backward_bound(b, n, c_in, c)


@dataclasses.dataclass
class Span:
    start: float
    end: float

    def elapsed_us(self):
        return self.end - self.start


@dataclasses.dataclass
class Row:
    name: str
    time_range: Span
    thread: int = 1


def fake_reading(kind, rows, wall_s, units, cell, host=(), valid=()):
    stretch = trace.Stretch(rows, list(host), wall_s, 0, [trace.Attempt(0, len(rows), 0, [], 0)])
    return Reading(kind, stretch, units, units * cell.traffic["batch"], cell, list(valid))


def test_busy_time_is_the_union_of_device_rows():
    rows = [Row("a", Span(0, 10)), Row("b", Span(5, 20)), Row("Memcpy HtoD", Span(30, 40)),
            Row("c", Span(40, 45))]
    assert trace.busy_intervals(rows) == [(0, 20), (30, 45)]
    assert trace.busy_seconds(rows) == pytest.approx(35e-6)
    assert [r.name for r in trace.kernel_rows(rows)] == ["a", "b", "c"]
    cell = small_cell("pointnet_serve_8192")
    host = [Row("aten::linear", Span(18, 35)), Row("aten::mm", Span(21, 29)),
            Row("cudaLaunchKernel", Span(22, 23)), Row("cudaEventSynchronize", Span(20, 30), 2)]
    reading = fake_reading("serve_stream", rows, 50e-6, 2, cell, host)
    idle = registry.load_module(ROOT / "gpubench/metrics/device_idle_share.serve.py", "idle")
    assert idle.read(reading) == pytest.approx(30.0)
    assert trace.idle_gaps(reading.stretch) == [["aten::mm", pytest.approx(10e-6)]]
    per_batch = registry.load_module(ROOT / "gpubench/metrics/kernels_per_batch.serve.py", "kpb")
    assert per_batch.read(reading) == 1.5
    train_idle = registry.load_module(ROOT / "gpubench/metrics/device_idle_share.train.py", "ti")
    assert train_idle.read(reading) is None  # not a training cell's stretch


def test_rooflines_read_bound_over_device_time():
    cell = small_cell("pointnet2_serve_8192", batch=2, width=2048)
    rows = [Row("void fps_kernel<8>(float const*)", Span(0, 1000)), Row("other", Span(0, 5))]
    reading = fake_reading("serve_stream", rows, 1e-3, 1, cell, valid=[[1500, 1700]])
    fps = registry.load_module(ROOT / "gpubench/metrics/fps_roofline.serve.py", "fps")
    bound = (roofline.fps_bound(2, 2048, 1024, 3200)[0] + roofline.fps_bound(2, 1024, 512, 2048)[0]
             + roofline.fps_bound(2, 512, 128, 1024)[0])
    assert fps.read(reading) == pytest.approx(100 * bound / 1.0)
    reading.stretch.rows = [rows[1]]
    assert fps.read(reading) is None  # nothing to read: no FPS row


def test_flop_counts_are_the_products_of_the_equations():
    """The configurations' counts against torch's own count of the
    reference's products, less the global term the reference repeats at
    every point (or centroid) and the counts hold once a cloud."""
    from torch.utils.flop_counter import FlopCounterMode

    for workload, n in (("pointnet_serve_8192", 256), ("pointnet2_serve_8192", 1024)):
        cell = small_cell(workload)
        model = cell.model.build_program(cell.config, "cpu")
        weights = {k: v for k, v in model.state_dict().items()}
        forward = cell.model.reference_forward(cell.config, weights)
        with FlopCounterMode(display=False) as counter, torch.no_grad():
            forward(torch.randn(1, n, 3))
        counted = counter.get_total_flops()
        if workload.startswith("pointnet_"):
            repeats = 2 * 1024 * 512 * (n - 1)
        else:
            repeats = 2 * 1024 * 256 * (cell.config["sa2"]["centroids"] - 1)
        assert cell.model.forward_flops(cell.config, n) == counted - repeats


def test_a_run_without_cuda_prints_nothing_and_fails():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "gpubench/run.py", "--workload", "pointnet_serve_8192",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA" in out.stderr


IMPORT_CHECK = """
import sys
sys.path.insert(0, {root!r})
{imports}
found = sorted(m for m in sys.modules if m.split(".", 1)[0] in {names!r})
print(",".join(found))
"""


def imported_with(imports: str, names) -> list[str]:
    code = IMPORT_CHECK.format(root=str(ROOT), imports=imports, names=tuple(names))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    return [m for m in out.stdout.strip().split(",") if m]


def test_the_harness_loads_no_jax_and_the_reference_no_program():
    everything = "\n".join([
        "import gpubench.harness.registry, gpubench.harness.trace, gpubench.harness.session",
        "import gpubench.probe, gpubench.runners.serve_stream, gpubench.runners.train_step",
        "from gpubench.tests.helpers import small_cell",
        "for w in ('pointnet_serve_8192', 'pointnet_train_8192', 'pointnet2_serve_8192'):",
        "    c = small_cell(w); c.model.build_program(c.config, 'cpu')",
        "sys.path.insert(0, 'gpubench'); import run",
    ])
    forbidden = ("jax", "jaxlib", "flax", "optax", "pointcloudprocessing_tpu")
    assert imported_with(everything, forbidden) == []
    # the top-level name is compared whole: the port's name begins with the JAX package's
    assert "pointcloudprocessing_tpu_torch" in imported_with(
        everything, ("pointcloudprocessing_tpu_torch",))
    reference = ("import gpubench.reference.pipeline, gpubench.reference.pointnet2, "
                 "gpubench.reference.train")
    assert imported_with(reference, forbidden + ("pointcloudprocessing_tpu_torch",)) == []


def test_a_new_config_mix_and_metric_are_found_from_new_files(tmp_path):
    """A cell added as files and entries alone: a copy of the benchmark's
    folder gains a configuration, a mix, a metric and a limits file, and
    the cell resolves to them with no file of the folder edited."""
    bench = tmp_path / "gpubench"
    shutil.copytree(ROOT / "gpubench", bench, ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    cfg = json.loads((bench / "configs/pointnet_kc46.json").read_text())
    (bench / "configs/tiny_pointnet.json").write_text(json.dumps(dict(cfg, num_classes=5)))
    (bench / "configs/tiny_pointnet.py").write_text(
        "from gpubench.configs.pointnet_kc46 import *  # noqa: F401,F403\n")
    mix = json.loads((bench / "traffic/kc46_frames_b256.json").read_text())
    (bench / "traffic/tiny_frames.json").write_text(json.dumps(dict(mix, batch=4)))
    (bench / "metrics/batches.serve.py").write_text(
        "def read(reading):\n    return float(reading.units)\n")
    (bench / "limits/tiny_serve.json").write_text(json.dumps({"cls_prob_gap": {"limit": 1e-3}}))
    spec = benchmark()
    spec["configs"].append({"name": "tiny_pointnet", "source": "test", "reduced": [],
                            "file": "gpubench/configs/tiny_pointnet.json", "why": "test"})
    spec["workloads"].append({"name": "tiny_serve", "config": "tiny_pointnet",
                              "traffic": "tiny_frames", "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "batches.serve", "unit": "batches", "better": "higher",
                              "source": "device_trace", "layer": "pipeline",
                              "moves": "serve_clouds_per_s", "workloads": ["tiny_serve"]})
    spec["end_to_end"][0]["workloads"].append("tiny_serve")
    cell = registry.find_cell(spec, "tiny_serve", tmp_path, bench)
    assert cell.config["num_classes"] == 5 and cell.traffic["batch"] == 4
    assert cell.limits == {"cls_prob_gap": {"limit": 1e-3}}
    assert "batches.serve" in cell.readers and "mfu.serve" not in cell.readers
    assert [m["name"] for m in cell.end_to_end] == ["serve_clouds_per_s", "peak_mem_gib",
                                                    "setup_s"]
    assert cell.readers["batches.serve"].read(fake_reading("serve_stream", [], 1.0, 3, cell)) == 3
    assert all(p.read_bytes() == data for p, data in before.items())
