"""``host_syncs_per_batch.serve``: host calls that wait for the device
(stream, device, event or context synchronize, a synchronous memcpy) a
serving batch, made inside ``pcp.pipeline.batch`` or its voxel, sample and
model spans (``harness/spans.py``). None where the stretch holds no span."""

from gpubench.harness.spans import BATCH_SPANS, has_spans, syncs


def read(reading):
    if reading.kind != "serve_stream" or not has_spans(reading):
        return None
    return sum(s.name in BATCH_SPANS for _, s in syncs(reading)) / reading.units
