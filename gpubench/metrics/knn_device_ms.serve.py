"""``knn_device_ms.serve``: device ms a serving batch of the rows given to
``pcp.model.knn``, the model's kNN graphs (distance products, clamp and
``topk``; ``models/dgcnn.py::knn_graph``), as ``harness/spans.py`` gives
rows to spans. None where the stretch holds no such span."""

from gpubench.harness.spans import device_ms

SPAN = "pcp.model.knn"


def read(reading):
    if reading.kind != "serve_stream" or not any(e.name == SPAN for e in reading.stretch.host):
        return None
    return device_ms(reading, (SPAN,))
