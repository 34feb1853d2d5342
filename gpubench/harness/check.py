"""The numbers that decide ``correct``: gaps between what the timed path
produced and what the reference computes from the same frames and weights.
The numbers that ``limits/<workload>.json`` names are held to their limits
there; the others are worked out for the record and not held (``PERF.md``
says why)."""

from __future__ import annotations

import dataclasses
import statistics

import numpy as np
import torch


@dataclasses.dataclass
class Compared:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        # NaN fails: a gap that is not a number is no agreement
        return self.value <= self.limit


def held(values: dict[str, float], limits: dict) -> list[Compared]:
    """Each number that ``limits`` names, beside its limit; a named number
    that ``values`` lacks raises."""
    return [Compared(k, float(values[k]), entry["limit"]) for k, entry in limits.items()]


def head_gaps(program: dict[str, torch.Tensor], reference: dict[str, torch.Tensor]
              ) -> dict[str, float]:
    """Largest absolute gap of each head: the classification and
    segmentation probabilities and the SE(3) transform."""
    names = {"classification_output": "cls_prob_gap",
             "segmentation_output": "seg_prob_gap", "se3": "se3_gap"}
    return {names[k]: (program[k].float() - reference[k].float()).abs().max().item()
            for k in names}


def norm_gaps(program: dict[str, torch.Tensor], reference: dict[str, torch.Tensor],
              counted: set[str], over=np.max) -> float:
    """Each leaf's gap between the program's norm and the reference's, over
    the reference's norm of that leaf or the median leaf's, whichever is
    larger, across the ``counted`` leaves: the worst (``over=np.max``, which
    keeps a NaN) or another statistic of them."""
    ref = {n: reference[n].double().norm().item() for n in counted}
    median = statistics.median(ref.values())
    return float(over([abs(program[n].double().norm().item() - ref[n]) / max(ref[n], median)
                 for n in counted]))


def moved_leaves(first_grads: dict[str, torch.Tensor], share: float = 1e-3) -> set[str]:
    """The leaves whose first gradient in the reference is not nought to
    rounding: a norm of at least ``share`` of the median leaf's."""
    norms = {n: g.double().norm().item() for n, g in first_grads.items()}
    median = statistics.median(norms.values())
    return {n for n, v in norms.items() if v >= share * median}
