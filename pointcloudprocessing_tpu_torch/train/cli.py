"""CLI: ``python -m pointcloudprocessing_tpu_torch.train.cli <name>_config.json
[--device cuda|cpu] [--backend nccl|gloo]``
(``pointcloudprocessing_tpu/train/cli.py``).

Trains every stage of each config on ``--device``: CUDA unless the CPU is
asked for, and without CUDA the default raises. Prints the JAX CLI's two
closing messages and exits 1 when no config was given; an error in
training propagates (exit code 1).

Under ``torchrun --nproc-per-node N`` (``WORLD_SIZE`` > 1) every process
joins the process group first (``parallel.mesh.initialize_multihost``,
``--backend``, NCCL by default) and trains on its device, ``cuda:LOCAL_RANK``
(``train/profile.py``).
"""

import argparse
import os
import sys

import torch.distributed as dist

from pointcloudprocessing_tpu_torch.parallel.mesh import initialize_multihost
from pointcloudprocessing_tpu_torch.train.profile import train_pointnet


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--backend", default="nccl")
    args, rest = parser.parse_known_args(sys.argv[1:] if argv is None else argv)
    joined = int(os.environ.get("WORLD_SIZE", "1")) > 1
    if joined:
        initialize_multihost(backend=args.backend)
    try:
        ok = train_pointnet(rest, device=args.device)
    finally:
        if joined:
            dist.destroy_process_group()
    if ok:
        print("Model training completed successfully.")
        return 0
    print("Model training failed.")
    return 1


if __name__ == "__main__":
    sys.exit(main())
