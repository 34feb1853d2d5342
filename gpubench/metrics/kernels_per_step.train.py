"""``kernels_per_step.train``: kernels the device ran a train step over the
traced stretch (copies and memsets not counted): a count that repeats
exactly while the program's step does not change."""

from gpubench.harness.trace import kernel_rows


def read(reading):
    if reading.kind != "train_step":
        return None
    return len(kernel_rows(reading.stretch.rows)) / reading.units
