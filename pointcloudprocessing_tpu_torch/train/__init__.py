"""Training of the port (counterparts of ``pointcloudprocessing_tpu/train``):
losses and the single-device train, eval and predict steps."""
