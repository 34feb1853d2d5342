"""``down_device_ms.serve``: device ms a serving batch of the rows given to
``pcp.model.down``, the transitions down (the model's FPS, the gather, the
grouped dense layer, BatchNorm, relu and the group max; their kNN rows go to
the nested ``pcp.model.knn``), 4 a forward, as ``harness/spans.py`` gives
rows to spans. None where the stretch holds no such span."""

from gpubench.harness.spans import device_ms

SPAN = "pcp.model.down"


def read(reading):
    if reading.kind != "serve_stream" or not any(e.name == SPAN for e in reading.stretch.host):
        return None
    return device_ms(reading, (SPAN,))
