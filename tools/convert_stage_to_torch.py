"""Convert a trained stage's weights for the PyTorch port's serving CLI.

Reads the stage's Orbax checkpoint ``<stage>/best/`` (written by
``pointcloudprocessing_tpu.train.callbacks.BestCheckpoint``), converts the
Flax variables with ``pointcloudprocessing_tpu_torch.convert``, checks them
against the port's model built from the stage's ``*_config.json``, and
writes ``<stage>/torch/model.pt``, which
``python -m pointcloudprocessing_tpu_torch.serve --model <stage>`` loads.

Usage:
  python tools/convert_stage_to_torch.py models/kc46_lidar/final
"""

from __future__ import annotations

import os
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)


def convert_stage(stage_dir: str) -> str:
    """Write ``<stage_dir>/torch/model.pt``; returns its path."""
    import jax
    import numpy as np
    import torch

    from pointcloudprocessing_tpu_torch.core.config import load_config
    from pointcloudprocessing_tpu.train.callbacks import load_checkpoint
    from pointcloudprocessing_tpu_torch.convert import state_dict_from_flax
    from pointcloudprocessing_tpu_torch.models.factory import model_from_config
    from pointcloudprocessing_tpu_torch.serve import WEIGHTS, _find_config

    payload = load_checkpoint(stage_dir)
    variables = jax.tree_util.tree_map(
        np.asarray,
        {"params": payload["params"], "batch_stats": payload["batch_stats"]},
    )
    state = state_dict_from_flax(variables)
    model = model_from_config(load_config(_find_config(stage_dir)), device="cpu")
    model.load_state_dict(state)  # strict: every tensor named and shaped
    path = os.path.join(stage_dir, WEIGHTS)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(state, path)
    return path


def main(argv: list[str] | None = None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    print(f"Wrote {convert_stage(args[0])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
