"""``attn_device_ms.serve``: device ms a serving batch of the rows given to
``pcp.model.attn``, the vector attention of each Point Transformer layer (q,
k and v, the position encoding, the relation, the weight MLP, the softmax
over the neighbours and the aggregation; ``models/point_transformer.py``),
18 a forward, as ``harness/spans.py`` gives rows to spans. None where the
stretch holds no such span."""

from gpubench.harness.spans import device_ms

SPAN = "pcp.model.attn"


def read(reading):
    if reading.kind != "serve_stream" or not any(e.name == SPAN for e in reading.stretch.host):
        return None
    return device_ms(reading, (SPAN,))
