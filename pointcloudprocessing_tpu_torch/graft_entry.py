"""The port's twin of the repo's ``__graft_entry__.entry()``: one inference
step on the flagship model, for a compile-and-run check on one card.

``entry()`` returns ``(fn, args)``: ``fn(state, points)`` runs the full
multi-head PointNet (23 classes, 12 parts, the kc46/f15 configuration) in
eval mode with the parameters and running statistics of ``state`` (a
``state_dict``) and returns its heads; ``args`` are the model's own seeded
state and a batch of 8 x 1,024 zero points. It builds on the card unless
the caller asks for the CPU. The multi-device dry run of the JAX entry is
not part of this twin.

    fn, args = entry()
    heads = fn(*args)
"""

from __future__ import annotations

from collections.abc import Callable

import torch
from torch.func import functional_call

from pointcloudprocessing_tpu_torch.models.layers import require_device
from pointcloudprocessing_tpu_torch.models.pointnet import PointNet

NUM_CLASSES = 23
NUM_PARTS = 12


def entry(device="cuda") -> tuple[Callable, tuple]:
    """(fn, example_args) of one eval-mode PointNet step on ``device``."""
    device = require_device(device)
    model = PointNet(NUM_CLASSES, NUM_PARTS,
                     generator=torch.Generator().manual_seed(0),
                     device=device).eval()
    points = torch.zeros((8, 1024, 3), dtype=torch.float32, device=device)

    @torch.no_grad()
    def forward(state: dict[str, torch.Tensor], points: torch.Tensor):
        return functional_call(model, state, (points,))

    return forward, (dict(model.state_dict()), points)
