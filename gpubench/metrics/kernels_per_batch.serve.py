"""``kernels_per_batch.serve``: kernels the device ran a batch over the traced
stretch of a serving cell (copies and memsets not counted): a count that
repeats exactly while the program's path does not change."""

from gpubench.harness.trace import kernel_rows


def read(reading):
    if reading.kind != "serve_stream":
        return None
    return len(kernel_rows(reading.stretch.rows)) / reading.units
