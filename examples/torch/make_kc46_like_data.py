"""Synthesize kc46-scale collects for the flagship training run, with the
PyTorch port (twin of ``examples/make_kc46_like_data.py``).

The reference's headline result (val segmentation accuracy 0.9808 on the
kc46 collects at input_width 8192) trained on four AftrBurner collect
directories named in ``configs/kc46_lidar_config.json`` that are not
redistributable. This script regenerates a workload of the same shape from
the procedural KC-46-like labelled tanker mesh: the same four collect
directory names, single class "kc-46", 8192-point frames with per-point
part ground truth carried through per-viewpoint hidden-point removal, and a
pose log with the viewpoint DCMs. The look-at rotations are computed on
``--device``; the rest is host work (numpy and Qhull).

Run: ``python examples/torch/make_kc46_like_data.py <input_dir>
[frames_per_collect] [--device cuda|cpu]``
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

from pointcloudprocessing_tpu_torch.synthesis import MeshSampler, write_collect  # noqa: E402
from pointcloudprocessing_tpu_torch.synthesis.procedural import kc46_like_mesh  # noqa: E402
from pointcloudprocessing_tpu_torch.utils.device import require_device  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CHUNK = 200  # frames per sampler instance: each chunk re-samples the dense
# surface cloud with a fresh seed, so frames are not all subsets of one
# fixed sampling (the reference's collects came from live per-frame sim)


def collect_names(config_path: str) -> list[str]:
    with open(config_path) as f:
        cfg = json.load(f)
    stage = next(iter(cfg["info"]["training_profiles"].values()))
    return list(stage["datasets"].values())


def make_collects(
    input_dir: str,
    frames_per_collect: int = 2400,
    pad: int = 8192,
    dense_points: int = 20000,
    seed: int = 42,
    config_path: str | None = None,
    mesh_factory=kc46_like_mesh,
    class_name: str = "kc-46",
    device="cuda",
) -> list[str]:
    """Synthesize the collect directories a flagship config names.

    Parametrized by mesh factory and class name so the f15 twin
    (make_f15_like_data.py) shares the whole pipeline; the defaults
    reproduce the kc46 workload."""
    device = require_device(device)
    if config_path is None:
        config_path = os.path.join(REPO, "configs", "kc46_lidar_config.json")
    names = collect_names(config_path)
    mesh, triangle_parts = mesh_factory()
    out = []
    for c, name in enumerate(names):
        t0 = time.time()
        obs_chunks, part_chunks, pos_chunks, dcm_chunks = [], [], [], []
        done = 0
        while done < frames_per_collect:
            n = min(CHUNK, frames_per_collect - done)
            sampler = MeshSampler(
                None, class_name, mesh=mesh, random_seed=seed + 1000 * c + done,
                device=device,
            )
            obs, parts, pos, dcms = sampler.create_labeled_viewpoint_observations(
                n=n, p=dense_points, pad=pad, triangle_parts=triangle_parts
            )
            obs_chunks.append(obs)
            part_chunks.append(parts)
            pos_chunks.append(pos)
            dcm_chunks.append(dcms)
            done += n
        collect = write_collect(
            os.path.join(input_dir, name),
            np.concatenate(obs_chunks),
            class_name,
            np.concatenate(part_chunks),
            dcms=np.concatenate(dcm_chunks),
            positions=np.concatenate(pos_chunks),
            fast=True,
        )
        print(
            f"collect {c + 1}/{len(names)}: {frames_per_collect} frames x {pad} pts "
            f"in {time.time() - t0:.0f}s -> {collect}",
            flush=True,
        )
        out.append(collect)
    return out


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("input_dir", nargs="?", default="input")
    parser.add_argument("frames", nargs="?", type=int, default=2400)
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


if __name__ == "__main__":
    args = parse_args()
    make_collects(args.input_dir, args.frames, device=args.device)
