"""``gather_maxmin_roofline.serve``: kernel 7's share of its roofline while
serving (``csrc/gather_maxmin.cu``, DGCNN's factored edge block): the least
time of each call of a forward (``harness/gather_roofline.py``, at the
batch, the model's width and the configuration's ``edge_gathers``), times
the batches of the traced stretch, over the device time of the kernel's
rows, in %. The rows are found by the kernel's f32 CUDA symbols, listed
here. None for a configuration without such calls or a stretch without
such rows."""

from gpubench.harness.gather_roofline import gather_maxmin_bound
from gpubench.harness.trace import symbol_rows

SYMBOLS = ("gather_maxmin_shared_kernel", "gather_maxmin_l2_kernel")


def read(reading):
    if reading.kind != "serve_stream":
        return None
    cell = reading.cell
    gathers = getattr(cell.model, "edge_gathers", None)
    rows = symbol_rows(reading.stretch.rows, SYMBOLS)
    if gathers is None or not rows:
        return None
    b, n = cell.traffic["batch"], cell.traffic["model_width"]
    bound_ms = reading.units * sum(gather_maxmin_bound(b, n, k, w)[0]
                                   for w, k in gathers(cell.config))
    device_ms = sum(e.time_range.elapsed_us() for e in rows) / 1e3
    return 100.0 * bound_ms / device_ms
