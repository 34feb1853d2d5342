"""``host_syncs_per_step.train``: host calls that wait for the device
(stream, device, event or context synchronize, a synchronous memcpy) a
train step, made inside ``pcp.train.step`` or its phases
(``harness/spans.py``). None where the stretch holds no span."""

from gpubench.harness.spans import STEP_PREFIX, has_spans, syncs


def read(reading):
    if reading.kind != "train_step" or not has_spans(reading):
        return None
    return sum(s.name.startswith(STEP_PREFIX) for _, s in syncs(reading)) / reading.units
