"""Weights between the JAX package's Flax variables and the port's
PyTorch ``state_dict``.

The port's modules carry the Flax module names, so a parameter's path maps
one to one, and only the leaf names and layouts change:

- a Dense ``kernel`` (in, out) becomes ``weight`` (out, in);
- BatchNorm ``scale``/``bias`` become ``weight``/``bias``, and its
  ``batch_stats`` ``mean``/``var`` become ``running_mean``/``running_var``;
- a Dense ``bias`` and the T-Net ``w`` and ``b`` carry over as they are.

Both directions work on nested dicts of numpy arrays shaped like the Flax
``{"params", "batch_stats"}`` tree, and a round trip is bit-identical.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

_PARAM_TO_TORCH = {"kernel": "weight", "scale": "weight", "bias": "bias",
                   "w": "w", "b": "b"}
_STAT_TO_TORCH = {"mean": "running_mean", "var": "running_var"}
_STAT_TO_FLAX = {v: k for k, v in _STAT_TO_TORCH.items()}


def _leaves(tree: Mapping, prefix: tuple[str, ...] = ()):
    for name, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (name,))
        else:
            yield prefix + (name,), value


def state_dict_from_flax(variables: Mapping) -> dict[str, torch.Tensor]:
    """Flax ``{"params", "batch_stats"}`` numpy tree -> PyTorch state_dict."""
    sd: dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(variables["params"]):
        *mods, name = path
        if name not in _PARAM_TO_TORCH:
            raise KeyError(f"unmapped Flax parameter {'/'.join(path)}")
        arr = np.asarray(leaf)
        if name == "kernel":
            arr = arr.T
        sd[".".join([*mods, _PARAM_TO_TORCH[name]])] = torch.tensor(
            np.ascontiguousarray(arr)
        )
    for path, leaf in _leaves(variables.get("batch_stats", {})):
        *mods, name = path
        if name not in _STAT_TO_TORCH:
            raise KeyError(f"unmapped Flax batch statistic {'/'.join(path)}")
        sd[".".join([*mods, _STAT_TO_TORCH[name]])] = torch.tensor(
            np.asarray(leaf)
        )
    return sd


def flax_from_state_dict(sd: Mapping[str, torch.Tensor]) -> dict:
    """PyTorch state_dict -> Flax ``{"params", "batch_stats"}`` numpy tree."""
    variables: dict = {"params": {}, "batch_stats": {}}
    for key, tensor in sd.items():
        *mods, name = key.split(".")
        arr = tensor.detach().cpu().numpy()
        if name in _STAT_TO_FLAX:
            collection, leaf = "batch_stats", _STAT_TO_FLAX[name]
        elif name == "weight":
            # a 2-D weight is a Dense kernel, a 1-D one a BatchNorm scale
            collection, leaf = "params", "kernel" if arr.ndim == 2 else "scale"
            if arr.ndim == 2:
                arr = arr.T
        elif name in ("bias", "w", "b"):
            collection, leaf = "params", name
        else:
            raise KeyError(f"unmapped state_dict entry {key}")
        node = variables[collection]
        for mod in mods:
            node = node.setdefault(mod, {})
        node[leaf] = np.ascontiguousarray(arr)
    return variables
