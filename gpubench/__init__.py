"""The benchmark of the PyTorch and CUDA port (``pointcloudprocessing_tpu_torch``)
on NVIDIA GPUs: ``python3 gpubench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``. ``gpubench/README.md`` says how it is laid
out and how a cell, a configuration or a metric is added."""
