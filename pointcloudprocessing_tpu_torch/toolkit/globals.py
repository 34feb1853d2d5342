"""Toolkit constants (``pointcloudprocessing_tpu/toolkit/globals.py``; API
parity with point_cloud_toolkit/utils/globals.py:1-13)."""

from pointcloudprocessing_tpu_torch.core.constants import TF_METRICS, MODEL_OUTPUTS, C

__all__ = ["TF_METRICS", "MODEL_OUTPUTS", "C"]
