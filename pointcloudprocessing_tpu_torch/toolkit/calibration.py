"""Kabsch extrinsic calibration (``pointcloudprocessing_tpu/toolkit/calibration.py``;
API parity with utils/calibration.py:3-31).

Same return contract as the reference's ``solve_kabsch``; the math runs in
the port's ``ops/mat_ops.py`` on ``device`` (CUDA unless the caller asks for
the CPU) and comes back as numpy for GUI/toolkit consumers.
"""

from __future__ import annotations

import numpy as np

from pointcloudprocessing_tpu_torch.ops import mat_ops


def solve_kabsch(truth_vecs: np.ndarray, measured_vecs: np.ndarray,
                 device="cuda"):
    """SVD Kabsch alignment; returns (R (3,3), t (3,), rmse) as numpy."""
    r, t, rmse = mat_ops.solve_kabsch(
        np.asarray(truth_vecs, dtype=np.float64),
        np.asarray(measured_vecs, dtype=np.float64),
        device,
    )
    return r.cpu().numpy(), t.cpu().numpy(), float(rmse)
