"""Synthetic LiDAR data (``pointcloudprocessing_tpu/synthesis``): meshes,
procedural shapes, viewpoint observations with hidden-point removal, and
collect directories the ingest path reads."""

from pointcloudprocessing_tpu_torch.synthesis.mesh import (
    Mesh,
    load_obj,
    sample_points_uniformly,
)
from pointcloudprocessing_tpu_torch.synthesis.meshsampler import MeshSampler, pad_observation
from pointcloudprocessing_tpu_torch.synthesis.collect import (
    dominant_axis_parts,
    write_collect,
)
from pointcloudprocessing_tpu_torch.synthesis.procedural import (
    aircraft_like_mesh,
    box_mesh,
    compound_mesh,
    octahedron_mesh,
    shape_library,
)

__all__ = [
    "Mesh",
    "load_obj",
    "sample_points_uniformly",
    "MeshSampler",
    "pad_observation",
    "write_collect",
    "dominant_axis_parts",
    "box_mesh",
    "octahedron_mesh",
    "compound_mesh",
    "aircraft_like_mesh",
    "shape_library",
]
