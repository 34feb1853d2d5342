"""``preprocess_device_ms.serve``: device ms a serving batch of the rows the
pipeline's preprocess launched: those given to ``pcp.pipeline.voxel`` and
``pcp.pipeline.sample`` (``harness/spans.py``). None where the stretch
holds no span."""

from gpubench.harness.spans import device_ms, has_spans


def read(reading):
    if reading.kind != "serve_stream" or not has_spans(reading):
        return None
    return device_ms(reading, ("pcp.pipeline.voxel", "pcp.pipeline.sample"))
