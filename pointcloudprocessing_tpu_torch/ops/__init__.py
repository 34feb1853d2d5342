"""Point-cloud ops of the port (counterparts of
``pointcloudprocessing_tpu/ops``); ``ops/cuda`` holds the kernel wrappers."""
