"""``queue_wait_ms.serve``: host ms a serving batch that the consumer spent
inside ``pcp.pipeline.queue_wait``: waiting for the producer's staged batch
and ordering its copy before the compute. None where the stretch holds no
span."""

from gpubench.harness.spans import has_spans, host_ms


def read(reading):
    if reading.kind != "serve_stream" or not has_spans(reading):
        return None
    return host_ms(reading, "pcp.pipeline.queue_wait")
