"""``step_host_busy_ms.train``: host ms a train step inside
``pcp.train.step``, less the time its thread sat in host sync calls there
(``harness/spans.py``): the host's own work of a step. None where the
stretch holds no span."""

from gpubench.harness.spans import STEP_PREFIX, has_spans, host_ms, syncs


def read(reading):
    if reading.kind != "train_step" or not has_spans(reading):
        return None
    waited_us = sum(e.time_range.elapsed_us() for e, s in syncs(reading)
                    if s.name.startswith(STEP_PREFIX))
    return host_ms(reading, "pcp.train.step") - waited_us / 1e3 / reading.units
