"""``edge_device_ms.serve``: device ms a serving batch of the rows given to
``pcp.model.edge``, the model's EdgeConv edge blocks (p and q or the
literal edges, kernel 7, BatchNorm, relu and the max), as
``harness/spans.py`` gives rows to spans. None where the stretch holds no
such span."""

from gpubench.harness.spans import device_ms

SPAN = "pcp.model.edge"


def read(reading):
    if reading.kind != "serve_stream" or not any(e.name == SPAN for e in reading.stretch.host):
        return None
    return device_ms(reading, (SPAN,))
