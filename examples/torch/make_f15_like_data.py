"""Synthesize f15-scale collects for the second flagship run, with the
PyTorch port (twin of ``examples/make_f15_like_data.py``).

The reference's f15 flagship (val segmentation accuracy 0.7874 at
input_width 8192) trained on five AftrBurner collects named in
``configs/f15_lidar_config.json`` that are not redistributable. Unlike
kc46 (``"vanilla": true``) the f15 config trains with both T-Nets. This
script regenerates a same-shape workload from the procedural F-15-like
labelled mesh: the same five collect directory names, single class
"f-15_model", 8192-point frames with per-point part ground truth, and a
pose log with the viewpoint DCMs.

Run: ``python examples/torch/make_f15_like_data.py <input_dir>
[frames_per_collect] [--device cuda|cpu]``
"""

from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(os.path.dirname(HERE)), HERE]

from pointcloudprocessing_tpu_torch.synthesis.procedural import f15_like_mesh  # noqa: E402

from make_kc46_like_data import REPO, make_collects, parse_args  # noqa: E402


def make_f15_collects(
    input_dir: str, frames_per_collect: int = 2400, **kwargs
) -> list[str]:
    return make_collects(
        input_dir,
        frames_per_collect,
        config_path=os.path.join(REPO, "configs", "f15_lidar_config.json"),
        mesh_factory=f15_like_mesh,
        class_name="f-15_model",
        **kwargs,
    )


if __name__ == "__main__":
    args = parse_args()
    make_f15_collects(args.input_dir, args.frames, device=args.device)
