"""``model_device_ms.serve``: device ms a serving batch of the rows given to
``pcp.pipeline.model``, the model's forward (``harness/spans.py``). None
where the stretch holds no span."""

from gpubench.harness.spans import device_ms, has_spans


def read(reading):
    if reading.kind != "serve_stream" or not has_spans(reading):
        return None
    return device_ms(reading, ("pcp.pipeline.model",))
