"""Global constants (the port's copy of
``pointcloudprocessing_tpu/core/constants.py``, which the port may not
import).

Mirrors the reference's ``point_cloud_analysis/utils/global_constants.py:1-4``
(SE3 matrix constants used by the pose-log parser) and
``point_cloud_toolkit/utils/globals.py:1-13`` (metric/output names, speed of
light).
"""

# SE3 matrix constants (reference: utils/global_constants.py:1-4)
# copied from pointcloudprocessing_tpu/core/constants.py::SE3_ROWS
SE3_ROWS = 4
# copied from pointcloudprocessing_tpu/core/constants.py::SE3_COLS
SE3_COLS = 4
# copied from pointcloudprocessing_tpu/core/constants.py::SE3_SIZE
SE3_SIZE = SE3_ROWS * SE3_COLS

# Model metric names (reference: point_cloud_toolkit/utils/globals.py:2-5)
# copied from pointcloudprocessing_tpu/core/constants.py::TF_METRICS
TF_METRICS = [
    "sparse_categorical_accuracy",
    "root_mean_squared_error",
]

# Model output names (reference: point_cloud_toolkit/utils/globals.py:7-11)
# copied from pointcloudprocessing_tpu/core/constants.py::MODEL_OUTPUTS
MODEL_OUTPUTS = [
    "classification_output",
    "segmentation_output",
    "se3",
]

# Speed of light, m/s (reference: point_cloud_toolkit/utils/globals.py:13)
# copied from pointcloudprocessing_tpu/core/constants.py::C
C = 299792458

# Keras numerical conventions the reference model inherits; kept here so the
# whole framework agrees on them (required for <=1e-4 logit parity).
# copied from pointcloudprocessing_tpu/core/constants.py::KERAS_EPSILON
KERAS_EPSILON = 1e-7          # probability clipping in crossentropy
# copied from pointcloudprocessing_tpu/core/constants.py::KERAS_BN_EPSILON
KERAS_BN_EPSILON = 1e-3       # keras.layers.BatchNormalization default
# copied from pointcloudprocessing_tpu/core/constants.py::KERAS_BN_MOMENTUM
KERAS_BN_MOMENTUM = 0.99      # reference ConvLayer/DenseLayer default
# copied from pointcloudprocessing_tpu/core/constants.py::NORMALIZATION_EPSILON
NORMALIZATION_EPSILON = 1e-7  # PointCloudNormalization scale floor (PointNet.py:701)

# The port's checkpoint layout (no counterpart in the JAX package, whose
# stages hold Orbax directories): ``<stage>/best/model.pt`` holds the best
# weights, ``<stage>/resume/`` a killed stage's train state
BEST_DIR = "best"
BEST_FILE = "model.pt"
RESUME_DIR = "resume"
