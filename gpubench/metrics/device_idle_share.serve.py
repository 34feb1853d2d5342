"""``device_idle_share.serve``: the share of the traced stretch's wall time in
which no operation ran on the device, in a serving cell (1 - the union of
the device rows' intervals over the stretch's host wall time), in %."""

from gpubench.harness.trace import busy_seconds


def read(reading):
    if reading.kind != "serve_stream":
        return None
    return 100.0 * (1.0 - busy_seconds(reading.stretch.rows) / reading.stretch.wall_s)
