"""Serving CLI: stream collect frames through a trained model (PointNet,
PointNet++ or DGCNN, as the stage's config says) on the GPU
(``pointcloudprocessing_tpu/serve.py``, same arguments and JSONL records).

Loads a trained stage directory: its ``*_config.json`` and PyTorch weights,
either the port's own training checkpoint ``best/model.pt`` (written by
``train/callbacks.py::BestCheckpoint``) or, for a stage that the JAX
package trained, ``torch/model.pt``, which
``tools/convert_stage_to_torch.py`` writes from the stage's Orbax
checkpoint. It streams ``Lidar/frame_*.txt`` scans
through ``PointCloudPipeline`` and writes one JSON line per frame with the
predicted class, per-part point counts and the SE(3) head's rotation.

Usage:
  python -m pointcloudprocessing_tpu_torch.serve \\
      --model models/kc46_lidar/final \\
      --input data/collect_xyz \\
      --output predictions.jsonl \\
      [--batch 64] [--scan-width 8192] [--voxel-size 0.4] [--no-fps] \\
      [--device cuda]

``--scan-width``/``--model-width`` default to the config's input_width.
``--device`` defaults to ``cuda``; without a usable CUDA device the command
fails rather than serving on the CPU.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import re
import sys
from typing import Iterator

import numpy as np
import torch

from pointcloudprocessing_tpu_torch.core.constants import BEST_DIR, BEST_FILE

WEIGHTS = os.path.join("torch", "model.pt")
TRAINED_WEIGHTS = os.path.join(BEST_DIR, BEST_FILE)


def _weights_path(model_dir: str) -> str:
    """The stage's weights: the port's ``best/model.pt``, else the
    converter's ``torch/model.pt``."""
    for name in (TRAINED_WEIGHTS, WEIGHTS):
        path = os.path.join(model_dir, name)
        if os.path.isfile(path):
            return path
    raise FileNotFoundError(
        f"No {TRAINED_WEIGHTS} or {WEIGHTS} in {model_dir}: train the stage "
        "with `python -m pointcloudprocessing_tpu_torch.train.cli`, or convert "
        "a JAX-trained stage with `python tools/convert_stage_to_torch.py "
        f"{model_dir}`"
    )


def _find_config(model_dir: str) -> str:
    configs = sorted(glob.glob(os.path.join(model_dir, "*_config.json")))
    if not configs:
        raise FileNotFoundError(
            f"No *_config.json in {model_dir} (expected the TrainProfile "
            "stage artifact layout)"
        )
    return configs[0]


def _frame_paths(input_dir: str) -> list[str]:
    lidar = os.path.join(input_dir, "Lidar")
    root = lidar if os.path.isdir(lidar) else input_dir
    # only exact frame_<N>.txt names: strays like frame_2_backup.txt must not
    # break the numeric sort
    indexed = []
    for path in glob.glob(os.path.join(root, "frame_*.txt")):
        m = re.fullmatch(r"frame_(\d+)\.txt", os.path.basename(path))
        if m:
            indexed.append((int(m.group(1)), path))
    return [path for _, path in sorted(indexed)]


def _scan_batches(
    paths: list[str], class_labels, part_labels, width: int, batch: int
) -> Iterator[tuple[list[str], np.ndarray]]:
    """Yield (frame names, (b, width, 3) arrays); last batch zero-padded.

    Unparseable frames are skipped with an advisory: an exception here would
    end the pipeline's producer thread early."""
    from pointcloudprocessing_tpu_torch.data.frames import (
        FrameError,
        parse_frame_file,
    )
    from pointcloudprocessing_tpu_torch.ops.resample import (
        adjust_to_input_width_np,
    )

    rng = np.random.default_rng(0)
    names, scans = [], []
    for path in paths:
        try:
            obs, _, parts = parse_frame_file(path, class_labels, part_labels)
            obs, _ = adjust_to_input_width_np(obs, parts, width, rng)
        except (FrameError, OSError, ValueError, KeyError) as e:
            print(
                f"Skipping {os.path.basename(path)}: {type(e).__name__}: {e}",
                file=sys.stderr,
            )
            continue
        names.append(os.path.basename(path))
        scans.append(obs.astype(np.float32))
        if len(scans) == batch:
            yield names, np.stack(scans)
            names, scans = [], []
    if scans:
        pad = batch - len(scans)
        scans.extend([np.zeros((width, 3), np.float32)] * pad)
        yield names, np.stack(scans)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--model", required=True,
                        help="trained stage directory (config + best/model.pt "
                             "or torch/model.pt)")
    parser.add_argument("--input", required=True,
                        help="collect directory (Lidar/frame_*.txt) or frame dir")
    parser.add_argument("--output", default="-",
                        help="output JSONL path ('-' = stdout)")
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--scan-width", type=int, default=None)
    parser.add_argument("--model-width", type=int, default=None)
    parser.add_argument("--voxel-size", type=float, default=None,
                        help="optional voxel downsample before sampling")
    parser.add_argument("--no-fps", action="store_true",
                        help="head-truncate instead of farthest-point sampling")
    parser.add_argument("--heads", default="classification,segmentation,se3",
                        help="comma list of model heads to compute; dropping "
                             "'segmentation' skips ~80%% of inference FLOPs")
    parser.add_argument("--device", default="cuda",
                        help="torch device to serve on (default cuda)")
    args = parser.parse_args(argv)

    paths = _frame_paths(args.input)
    if not paths:
        print(f"No frame_*.txt files under {args.input}", file=sys.stderr)
        return 1

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"--device {args.device}: CUDA is not available", file=sys.stderr)
        return 1

    from pointcloudprocessing_tpu_torch.core.config import load_config
    from pointcloudprocessing_tpu_torch.models.factory import model_from_config
    from pointcloudprocessing_tpu_torch.models.pipeline import PointCloudPipeline

    cfg = load_config(_find_config(args.model))
    scan_width = args.scan_width or cfg.input_width
    model_width = args.model_width or cfg.input_width

    alias = {"classification": "classification_output",
             "segmentation": "segmentation_output", "se3": "se3"}
    try:
        heads = tuple(alias[h.strip()] for h in args.heads.split(",") if h.strip())
    except KeyError as e:
        print(f"Unknown head {e.args[0]!r}; valid: {', '.join(alias)}",
              file=sys.stderr)
        return 2

    model = model_from_config(cfg, device=device)
    state = torch.load(_weights_path(args.model), map_location=device,
                       weights_only=True)
    model.load_state_dict(state)
    pipe = PointCloudPipeline(
        model,
        scan_width=scan_width,
        model_width=model_width,
        voxel_size=args.voxel_size,
        sampler="head" if args.no_fps else "fps",
        heads=heads,
    )

    class_map = {c: i for i, c in enumerate(cfg.class_labels)}
    part_map = {p: i for i, p in enumerate(cfg.part_labels)}

    out = sys.stdout if args.output == "-" else open(args.output, "w")
    served = 0
    try:
        # stream() prefetches ahead, so names are queued per batch as the
        # producer reads them and popped as each batch's outputs arrive
        names_per_batch: collections.deque[list[str]] = collections.deque()

        def scans_iter():
            for names, scans in _scan_batches(
                paths, class_map, part_map, scan_width, args.batch
            ):
                names_per_batch.append(names)
                yield scans

        for outputs in pipe.stream(scans_iter()):
            names = names_per_batch.popleft()
            host = {k: v.cpu().numpy() for k, v in outputs.items()}
            cls = seg = se3 = None
            if "classification_output" in host:
                cls = np.argmax(host["classification_output"], -1)
            if "segmentation_output" in host:
                seg = np.argmax(host["segmentation_output"], -1)
            if "se3" in host:
                se3 = host["se3"]
            for j, name in enumerate(names):
                record = {"frame": name}
                if cls is not None:
                    record["class"] = cfg.class_labels[int(cls[j])]
                if seg is not None:
                    part_ids, part_counts = np.unique(seg[j], return_counts=True)
                    record["part_counts"] = {
                        cfg.part_labels[int(p)]: int(c)
                        for p, c in zip(part_ids, part_counts)
                    }
                if se3 is not None:
                    record["se3"] = se3[j].round(6).tolist()
                out.write(json.dumps(record) + "\n")
                served += 1
    finally:
        if out is not sys.stdout:
            out.close()
    print(f"Served {served} frames from {args.input}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
