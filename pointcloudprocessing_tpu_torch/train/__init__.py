"""Training of the port (counterparts of ``pointcloudprocessing_tpu/train``):
losses, the single-device train, eval and predict steps for every model
family, the callbacks (early stopping, torch checkpoints, resume, Ctrl-C),
the staged trainer ``TrainProfile`` and its CLI."""
