"""Multi-device training and serving of the port (counterpart of
``pointcloudprocessing_tpu/parallel``): process groups, meshes, row shards,
state broadcast and group batch statistics (``parallel/mesh.py``)."""
