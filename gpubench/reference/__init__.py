"""The plain reference that decides ``correct``: plain PyTorch in float32 with
TF32 off, over the same frames and weights the benchmark hands the program.

Frozen copies, each tagged with what it copies: the voxel downsample and FPS
(``voxel.py``, ``fps.py``), PointNet and PointNet++ as functions of a dict
of named tensors (``pointnet.py``, ``pointnet2.py``), the serving path
(``pipeline.py``) and the training step with Adam's Keras conventions
(``train.py``). Nothing here imports the program, JAX or the JAX package.
"""
