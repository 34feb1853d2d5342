"""End-to-end flagship smoke of the PyTorch port: synthesize -> ingest ->
train -> serve (twin of ``examples/flagship_smoke.py``).

The full production path at the JAX script's shapes: 4-class
``MeshSampler`` data (64 frames a class at 8,192 points), the bertha
four-class config (two stages), ``TrainProfile`` at batch 16 in bf16 for
3 epochs a stage, the stage artifacts (``best/model.pt``, the ``.pt2``
program and the ONNX file), and the serving CLI over one collect. On the
card, training runs the bf16 pooled-chain kernels (4 and 5). Serving
voxelizes at 2 cm before farthest-point sampling to the model's width, so
that it runs the voxel segment sum (kernel 1) and FPS (kernel 2); the JAX
script serves by head truncation, which runs neither.

Run: python examples/torch/flagship_smoke.py [--device cuda|cpu]
[--frames-per-class 64]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(os.path.dirname(HERE)), HERE,
                os.path.dirname(HERE)]

from make_class_test_configs import build_config  # noqa: E402
from make_class_test_data import synthesize_class_collects  # noqa: E402

from pointcloudprocessing_tpu_torch.serve import main as serve_main  # noqa: E402
from pointcloudprocessing_tpu_torch.train import TrainProfile  # noqa: E402
from pointcloudprocessing_tpu_torch.utils.device import require_device  # noqa: E402

SERVE_VOXEL_M = 0.02


def main(device="cuda", frames_per_class: int = 64, sample_points: int = 4096,
         width: int = 8192, epochs: int = 3, batch: int = 16) -> dict:
    """Run the flagship path in a temporary directory (removed at the end);
    returns its seconds by part, the stage histories, the number of served
    frames and each stage's artifacts."""
    device = require_device(device)
    root = tempfile.mkdtemp(prefix="flagship_")
    try:
        return _run(str(device), frames_per_class, sample_points, width, epochs,
                    batch, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _run(device, frames_per_class, sample_points, width, epochs, batch, root):
    print("workdir:", root, flush=True)
    data_dir = os.path.join(root, "data")
    os.makedirs(os.path.join(root, "models"), exist_ok=True)
    seconds = {}

    t0 = time.time()
    collects = synthesize_class_collects(
        data_dir, 4, frames_per_class=frames_per_class,
        sample_points=sample_points, pad=width, device=device,
    )
    seconds["synthesis"] = time.time() - t0
    print(f"synthesized 4x{frames_per_class} frames @{width}pts in "
          f"{seconds['synthesis']:.1f}s", flush=True)

    cfg = build_config("four", 4)
    for stage in cfg["info"]["training_profiles"].values():
        stage["datasets"] = {str(i): os.path.basename(c) for i, c in enumerate(collects)}
    cfg["params"].update({
        "input_width": width, "epochs": epochs, "batch_size": batch,
        "compute_dtype": "bfloat16",
        "learning": {"rate": 1e-3, "decay_steps": 1000, "decay_rate": 0.9},
    })
    cfg["file_system"] = {
        "model_path": os.path.join(root, "models") + "/",
        "input_path": data_dir + "/",
        "data_path": data_dir + "/",
    }
    config_path = os.path.join(root, "bertha_four_class_config.json")
    with open(config_path, "w") as f:
        json.dump(cfg, f)

    t0 = time.time()
    tp = TrainProfile(config_path, log_to_file=False, device=device)
    seconds["ingest"] = time.time() - t0
    print(f"ingest done in {seconds['ingest']:.1f}s", flush=True)

    t0 = time.time()
    histories = tp.train()
    seconds["training"] = time.time() - t0
    print(f"training ({len(histories)} stages x {epochs} epochs, b{batch}/w{width}, "
          f"bf16) in {seconds['training']:.1f}s", flush=True)
    for stage, h in histories.items():
        print(f"  {stage}: loss {h['loss'][0]:.3f} -> {h['loss'][-1]:.3f}, "
              f"cls acc {h['classification_output_sparse_categorical_accuracy'][-1]:.3f}, "
              f"val acc {h['val_classification_output_sparse_categorical_accuracy'][-1]:.3f}",
              flush=True)

    name = cfg["info"]["name"]
    artifacts = {}
    for stage in histories:
        stage_dir = os.path.join(root, "models", name, stage)
        artifacts[stage] = sorted(
            f for f in (os.path.join("best", "model.pt"), f"{name}_{stage}.pt2",
                        f"{name}_{stage}.onnx")
            if os.path.isfile(os.path.join(stage_dir, f)))

    # serve over one collect with the final stage
    stage_dir = os.path.join(root, "models", name, "four_class_seg")
    out_path = os.path.join(root, "preds.jsonl")
    t0 = time.time()
    rc = serve_main(["--model", stage_dir, "--input", collects[0],
                     "--output", out_path, "--batch", str(batch),
                     "--voxel-size", str(SERVE_VOXEL_M), "--device", device])
    with open(out_path) as f:
        records = [json.loads(line) for line in f]
    seconds["serve"] = time.time() - t0
    print(f"serve rc={rc}: {len(records)} frames in {seconds['serve']:.1f}s; "
          f"first: {records[0]['class']}, parts={list(records[0]['part_counts'])[:3]}",
          flush=True)
    if rc != 0 or not records:
        raise RuntimeError(f"serve returned {rc} with {len(records)} records")
    print("flagship smoke OK", flush=True)
    return {"seconds": seconds, "histories": histories, "served": len(records),
            "artifacts": artifacts}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--frames-per-class", type=int, default=64)
    args = parser.parse_args()
    main(args.device, args.frames_per_class)
