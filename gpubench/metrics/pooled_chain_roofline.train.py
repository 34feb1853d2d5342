"""``pooled_chain_roofline.train``: the pooled chain's share of its roofline
in the train step (kernels 4 and 5, ``csrc/pooled_chain.cu``): the least
time of each chain's forward and backward a step
(``harness/roofline.py::pooled_forward_bound``, ``pooled_backward_bound``,
at the frames' shapes and the configuration's chains), times the steps of
the traced stretch, over the device time of every row of the library's
kernels, in %. The rows are found by the CUDA symbols listed here."""

from gpubench.harness.roofline import pooled_backward_bound, pooled_forward_bound
from gpubench.harness.trace import symbol_rows

SYMBOLS = ("pooled_forward_split_kernel", "pooled_forward_relayout_kernel",
           "pooled_forward_kernel", "pooled_combine_kernel", "pooled_backward_dx_kernel",
           "pooled_backward_prep_kernel", "pooled_forward_tma_kernel",
           "pooled_backward_prep_tma_kernel", "pooled_backward_dx_tma_kernel")


def read(reading):
    if reading.kind != "train_step":
        return None
    cell = reading.cell
    chains = getattr(cell.model, "pooled_chains", None)
    rows = symbol_rows(reading.stretch.rows, SYMBOLS)
    if chains is None or not rows:
        return None
    b, n = cell.traffic["batch"], cell.traffic["frames"]["width"]
    bound_ms = reading.units * sum(
        pooled_forward_bound(b, n, c_in, c)[0] + pooled_backward_bound(b, n, c_in, c)[0]
        for c_in, c in chains(cell.config))
    device_ms = sum(e.time_range.elapsed_us() for e in rows) / 1e3
    return 100.0 * bound_ms / device_ms
