"""The least time of one vector attention of Point Transformer
(``models/point_transformer.py``'s layer A) from the shapes of its work
alone, whatever implements it: the input features y (b, n, C), the
coordinates (b, n, 3) and the graph (b, n, k) int32 read once, the output
(b, n, C) written once; the layer's products (q, k and v, the position
encoding, the weight MLP; all GEMM-shaped) on the tensor cores at three
TF32 products an f32-accurate product, as ``roofline.py`` counts the port's
f32 products; its elementwise work at the f32 rate. The counts are the
configuration's (``configs/point_transformer_kc46.py``). Read by span, so a
fused kernel later is held to the same work."""

from __future__ import annotations

from gpubench.harness.roofline import F32, I32, roofline


def attn_bound(b: int, n: int, k: int, c: int, products: int,
               elementwise: int) -> tuple[float, str]:
    """(least ms, what binds) of one attention over b clouds of n points
    with k neighbours and c channels, of ``products`` multiply-adds and
    ``elementwise`` other operations a cloud."""
    bytes_moved = b * n * (2 * c + 3) * F32 + b * n * k * I32
    return roofline(bytes_moved, b * elementwise, 3 * 2 * b * products)
