"""Build and persist a PointCloudSet from an AftrBurner collect directory,
with the PyTorch port (twin of ``examples/build_from_aftr.py``).

Ingest is host work (frame parsing, splits, TFRecord shards); ``--device``
names the device the set is built for and, as every example of the port,
refuses CUDA when there is none.

Usage: python examples/torch/build_from_aftr.py <collect_dir> [data_dir]
[--device cuda|cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from pointcloudprocessing_tpu_torch.data import PointCloudSet  # noqa: E402
from pointcloudprocessing_tpu_torch.utils.device import require_device  # noqa: E402

PART_LABELS = [
    "fuselage", "left_engine", "right_engine", "left_wing", "right_wing",
    "left_hstab", "right_hstab", "vstab", "left_boom_stab", "right_boom_stab",
    "boom_wing", "boom_hull", "boom_hose",
]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("collect_dir", help="path to the Aftr collect directory")
    parser.add_argument("data_dir", nargs="?", default="data")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    require_device(args.device)
    if not os.path.isdir(args.collect_dir):
        print("Invalid path provided.")
        return 1
    data_dir = args.data_dir + "/"
    os.makedirs(data_dir, exist_ok=True)
    pc = PointCloudSet(
        name=args.collect_dir.rstrip("/").split("/")[-1],
        class_labels=["kc46"],
        part_labels=PART_LABELS,
        network_input_width=4096,
        batch_size=8,
        rand_seed=42,
        data_path=data_dir,
    )
    pc.add_from_aftr_output(args.collect_dir)
    print(pc.get_info())
    print(f"Dataset written under {data_dir}{pc._name}/ (pc_set.joblib + TFRecords)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
