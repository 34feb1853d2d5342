"""Synthesize per-class collect directories for the class-test sweep, with
the PyTorch port (twin of ``examples/make_class_test_data.py``).

Pairs with ``examples/make_class_test_configs.py``: the configs name one
``collect_<class>`` directory per class; this script fills a data directory
with ``MeshSampler`` observations of geometrically distinct procedural
shapes. The viewpoints' look-at rotations are computed on ``--device``.

Run: ``python examples/torch/make_class_test_data.py <data_dir> [n_classes]
[--device cuda|cpu]``
"""

from __future__ import annotations

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(os.path.dirname(HERE)), os.path.dirname(HERE)]

from pointcloudprocessing_tpu_torch.synthesis import (  # noqa: E402
    MeshSampler,
    dominant_axis_parts,
    shape_library,
    write_collect,
)
from pointcloudprocessing_tpu_torch.utils.device import require_device  # noqa: E402

# the single source of the aircraft label list (keeps the generated
# collect_<class> directory names in sync with the configs' dataset names)
from make_class_test_configs import CLASS_LABELS as CLASS_NAMES  # noqa: E402


def synthesize_class_collects(
    data_dir: str,
    n_classes: int,
    frames_per_class: int = 64,
    sample_points: int = 2048,
    pad: int = 4096,
    seed: int = 42,
    device="cuda",
) -> list[str]:
    """One collect directory per class; returns the collect paths."""
    device = require_device(device)
    meshes = shape_library(n_classes)
    out = []
    for k, ((shape_name, mesh), class_name) in enumerate(
        zip(meshes.items(), CLASS_NAMES)
    ):
        sampler = MeshSampler(None, class_name, mesh=mesh, random_seed=seed + k,
                              device=device)
        observations, _, positions, dcms = sampler.create_viewpoint_observations(
            n=frames_per_class, p=sample_points, pad=pad
        )
        parts = dominant_axis_parts(observations)
        collect = write_collect(
            os.path.join(data_dir, f"collect_{class_name}"),
            observations,
            class_name,
            parts,
            dcms=dcms,
            positions=positions,
        )
        print(f"class {k} ({class_name} <- {shape_name}): {collect}")
        out.append(collect)
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("data_dir", nargs="?", default="data")
    parser.add_argument("n_classes", nargs="?", type=int, default=4)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    synthesize_class_collects(args.data_dir, args.n_classes, device=args.device)
