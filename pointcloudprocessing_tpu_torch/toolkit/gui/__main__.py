"""``python -m pointcloudprocessing_tpu_torch.toolkit.gui [--device cpu]`` —
launch the toolkit GUI (reference: point_cloud_toolkit/main.py:5-9)."""

import sys

from pointcloudprocessing_tpu_torch.toolkit.gui import run_app

if __name__ == "__main__":
    argv = sys.argv[1:]
    device = argv[argv.index("--device") + 1] if "--device" in argv else "cuda"
    sys.exit(run_app(device))
