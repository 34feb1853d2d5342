"""``feed_wait_ms.train``: host ms a train step that the step's thread spent
inside ``pcp.loader.wait``: waiting for ``DeviceLoader``'s staged batch and
ordering its copy before the compute. None where the stretch holds no
span."""

from gpubench.harness.spans import has_spans, host_ms


def read(reading):
    if reading.kind != "train_step" or not has_spans(reading):
        return None
    return host_ms(reading, "pcp.loader.wait")
