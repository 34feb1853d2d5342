"""``fps_roofline.serve``: FPS's share of its roofline while serving (kernel
2, ``csrc/fps.cu``): the least time of every FPS call of the traced stretch
(``harness/roofline.py::fps_bound``: the pipeline's call over each batch's
occupied voxels, from the reference voxel downsample, then the model's own
calls over all their points), over the device time of the FPS rows, in %.
The rows are found by the kernel's CUDA symbols, listed here."""

from gpubench.harness.roofline import fps_bound
from gpubench.harness.trace import symbol_rows

SYMBOLS = ("fps_kernel", "fps_large_kernel")


def read(reading):
    if reading.kind != "serve_stream":
        return None
    rows = symbol_rows(reading.stretch.rows, SYMBOLS)
    if not rows:
        return None
    cell, mix = reading.cell, reading.cell.traffic
    b, k = mix["batch"], mix["model_width"]
    bound_ms = 0.0
    for valid in reading.valid:
        bound_ms += fps_bound(b, mix["scan_width"], k, int(sum(valid)))[0]
        for n, picks in cell.model.model_fps(cell.config, k):
            bound_ms += fps_bound(b, n, picks, b * n)[0]
    device_ms = sum(e.time_range.elapsed_us() for e in rows) / 1e3
    return 100.0 * bound_ms / device_ms
