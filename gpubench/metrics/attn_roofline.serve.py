"""``attn_roofline.serve``: Point Transformer's vector attention's share of
its roofline while serving: the least time of each attention call of a
forward (``harness/attn_roofline.py``, at the batch and the configuration's
``attn_layers``, ``attn_products`` and ``attn_elementwise``), times the
batches of the traced stretch, over the device time of the rows given to
``pcp.model.attn`` (``harness/spans.py``), in %.
Read by span, not by kernel name, so any implementation of the layer is
held to the same work. None for a configuration without ``attn_layers`` or a
stretch without the span."""

from gpubench.harness.attn_roofline import attn_bound
from gpubench.harness.spans import device_ms

SPAN = "pcp.model.attn"


def read(reading):
    if reading.kind != "serve_stream":
        return None
    cell = reading.cell
    layers = getattr(cell.model, "attn_layers", None)
    if layers is None or not any(e.name == SPAN for e in reading.stretch.host):
        return None
    b, share, model = cell.traffic["batch"], cell.config["share_planes"], cell.model
    bound_ms = sum(attn_bound(b, n, k, c, model.attn_products(n, k, c, share),
                              model.attn_elementwise(n, k, c, share))[0]
                   for _, n, k, c in layers(cell.config))
    return 100.0 * bound_ms / device_ms(reading, (SPAN,))
