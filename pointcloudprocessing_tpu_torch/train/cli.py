"""CLI: ``python -m pointcloudprocessing_tpu_torch.train.cli <name>_config.json
[--device cuda|cpu]`` (``pointcloudprocessing_tpu/train/cli.py``).

Trains every stage of each config on ``--device``: CUDA unless the CPU is
asked for, and without CUDA the default raises. Prints the JAX CLI's two
closing messages and exits 1 when no config was given; an error in
training propagates (exit code 1).
"""

import argparse
import sys

from pointcloudprocessing_tpu_torch.train.profile import train_pointnet


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--device", default="cuda")
    args, rest = parser.parse_known_args(sys.argv[1:] if argv is None else argv)
    if train_pointnet(rest, device=args.device):
        print("Model training completed successfully.")
        return 0
    print("Model training failed.")
    return 1


if __name__ == "__main__":
    sys.exit(main())
