"""Models of the port (counterparts of ``pointcloudprocessing_tpu/models``)."""
