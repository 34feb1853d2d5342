"""Training of the port (counterparts of ``pointcloudprocessing_tpu/train``):
losses, the train, eval and predict steps for every model family (one
device, or several in the global and shard_map modes), the callbacks
(early stopping, torch checkpoints, resume, Ctrl-C), the staged trainer
``TrainProfile`` and its CLI."""
