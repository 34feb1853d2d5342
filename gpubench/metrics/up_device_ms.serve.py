"""``up_device_ms.serve``: device ms a serving batch of the rows given to
``pcp.model.up``, the transitions up (the head transition's global and
concat layers; the skip and coarse dense layers, BatchNorm, relu, the
interpolation weights, gather-sum and add; the 3-NN rows go to the nested
``pcp.model.knn``), 5 a forward, as ``harness/spans.py`` gives rows to
spans. None where the stretch holds no such span."""

from gpubench.harness.spans import device_ms

SPAN = "pcp.model.up"


def read(reading):
    if reading.kind != "serve_stream" or not any(e.name == SPAN for e in reading.stretch.host):
        return None
    return device_ms(reading, (SPAN,))
