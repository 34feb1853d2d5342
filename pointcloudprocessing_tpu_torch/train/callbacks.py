"""Training callbacks on torch checkpoints: early stopping, best
checkpointing, mid-stage resume and Ctrl-C handling
(``pointcloudprocessing_tpu/train/callbacks.py``).

- :class:`EarlyStopping`: Keras ``EarlyStopping(mode='min', patience,
  restore_best_weights=True)``; the best weights are kept as a host copy of
  the model's ``state_dict``.
- :class:`BestCheckpoint`: save-best-only. ``<stage>/best/model.pt`` holds
  the model's ``state_dict`` (parameters and running statistics) in one
  ``torch.save`` file, written to a temporary name and moved into place
  with ``os.replace``, so a reader sees the old file or the new one.
- :class:`ResumeCheckpoint`: ``<stage>/resume/`` holds the whole train
  state (model, Adam moments and count, step) in ``state_<epoch>.pt`` and
  ``meta.json`` (next epoch, history so far, early-stopping counters), so a
  killed stage continues where it stopped.
- :class:`CtrlCInterruptHandler`: the first SIGINT asks for a stop after
  the current epoch; the second exits.

A ``best/`` or ``resume/`` directory that the JAX package wrote (Orbax) is
refused with a message naming ``tools/convert_stage_to_torch.py``; it is
never read.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import sys
from typing import Any, Callable

import torch

from pointcloudprocessing_tpu_torch.core.constants import BEST_DIR, BEST_FILE, RESUME_DIR

_ORBAX_MESSAGE = (
    "{path} is not a checkpoint of the PyTorch port (no {file}; an Orbax "
    "checkpoint of the JAX package is a directory of its own format). "
    "Convert a JAX-trained stage with `python tools/convert_stage_to_torch.py "
    "<stage dir>` and serve it, or retrain the stage with the port."
)


def _host_state_dict(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """A CPU copy of the model's parameters and running statistics."""
    return {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}


def _atomic_save(obj, path: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


class EarlyStopping:
    def __init__(self, patience: int, print_func: Callable[[str], None] = print):
        self.patience = patience
        self.best = float("inf")
        self.best_epoch = -1
        self.best_state: dict[str, torch.Tensor] | None = None
        self.wait = 0
        self._print = print_func

    def update(self, epoch: int, monitor_value: float, state) -> bool:
        """Record this epoch; returns True when training should stop."""
        if monitor_value < self.best:
            self.best = monitor_value
            self.best_epoch = epoch
            self.best_state = _host_state_dict(state.model)
            self.wait = 0
            return False
        self.wait += 1
        if self.wait >= self.patience:
            self._print(
                f"Early stopping at epoch {epoch + 1}; best epoch was "
                f"{self.best_epoch + 1} (monitor {self.best:.6f})."
            )
            return True
        return False


class BestCheckpoint:
    """Save-best-only checkpointing of the model's ``state_dict``."""

    def __init__(self, directory: str, print_func: Callable[[str], None] = print):
        self.directory = os.path.abspath(directory)
        self.best = float("inf")
        self._print = print_func

    def update(self, epoch: int, monitor_value: float, state) -> None:
        if monitor_value >= self.best:
            return
        self.best = monitor_value
        path = os.path.join(self.directory, BEST_DIR)
        os.makedirs(path, exist_ok=True)
        _atomic_save(_host_state_dict(state.model), os.path.join(path, BEST_FILE))
        self._print(
            f"Epoch {epoch + 1}: monitor improved to {monitor_value:.6f}, "
            f"saving model to {path}"
        )


def load_checkpoint(directory: str, device="cpu") -> dict[str, torch.Tensor]:
    """Load a BestCheckpoint payload (the model's ``state_dict``) from
    ``<directory>/best/model.pt``; a ``best/`` of another format (the JAX
    package's Orbax) raises FileNotFoundError naming the converter."""
    best = os.path.join(os.path.abspath(directory), BEST_DIR)
    path = os.path.join(best, BEST_FILE)
    if not os.path.isfile(path):
        raise FileNotFoundError(_ORBAX_MESSAGE.format(path=best, file=BEST_FILE)
                                if os.path.isdir(best) else f"No checkpoint {path}")
    return torch.load(path, map_location=device, weights_only=True)


class ResumeCheckpoint:
    """Periodic whole-state checkpointing for mid-stage resume.

    Layout under ``<stage_dir>/resume/``: ``state_<epoch>.pt`` (the model's
    ``state_dict``, the Adam count and moments, the step) and ``meta.json``
    (next epoch, the state file's name, history lists, early-stopping
    counters). Written every ``period`` epochs and removed by :meth:`clear`
    when the stage completes, so finished stages never resume stale state.
    """

    def __init__(self, directory: str, period: int = 1,
                 print_func: Callable[[str], None] = print):
        self.directory = os.path.join(os.path.abspath(directory), RESUME_DIR)
        self.period = max(period, 1)
        self._print = print_func

    def save(self, epoch: int, state, history: dict, early: EarlyStopping) -> None:
        if (epoch + 1) % self.period:
            return
        os.makedirs(self.directory, exist_ok=True)
        # epoch-versioned state file + atomic meta replace: a crash at ANY
        # point leaves meta naming a fully written state (the previous pair
        # or the new one)
        state_file = f"state_{epoch + 1}.pt"
        opt = state.opt_state
        _atomic_save(
            {
                "model": _host_state_dict(state.model),
                "step": int(state.step),
                "count": int(opt.count),
                "mu": {k: v.detach().cpu() for k, v in opt.mu.items()},
                "nu": {k: v.detach().cpu() for k, v in opt.nu.items()},
            },
            os.path.join(self.directory, state_file),
        )
        meta = {
            "next_epoch": epoch + 1,
            "state_file": state_file,
            "history": {k: list(map(float, v)) for k, v in history.items()},
            "early": {
                "best": early.best,
                "best_epoch": early.best_epoch,
                "wait": early.wait,
            },
        }
        tmp = os.path.join(self.directory, "meta.json.tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, os.path.join(self.directory, "meta.json"))
        # drop superseded state files now that meta names the new one
        for name in os.listdir(self.directory):
            if name.startswith("state") and name != state_file:
                os.unlink(os.path.join(self.directory, name))

    def clear(self) -> None:
        shutil.rmtree(self.directory, ignore_errors=True)

    @staticmethod
    def exists(stage_dir: str) -> bool:
        return os.path.isfile(
            os.path.join(os.path.abspath(stage_dir), RESUME_DIR, "meta.json")
        )

    @staticmethod
    def load(stage_dir: str, state) -> tuple[Any, dict]:
        """Restore ``state`` (a freshly built TrainState: its model and Adam
        moments are overwritten in place) and return (state, meta)."""
        base = os.path.join(os.path.abspath(stage_dir), RESUME_DIR)
        with open(os.path.join(base, "meta.json")) as f:
            meta = json.load(f)
        if "state_file" not in meta:
            raise FileNotFoundError(
                _ORBAX_MESSAGE.format(path=base, file="state_<epoch>.pt"))
        device = next(state.model.parameters()).device
        payload = torch.load(os.path.join(base, meta["state_file"]),
                             map_location=device, weights_only=True)
        state.model.load_state_dict(payload["model"])
        opt = state.opt_state
        if set(payload["mu"]) != set(opt.mu):
            raise ValueError(
                f"{base}: the saved Adam moments cover other parameters than "
                "this stage trains (its freeze flags changed)")
        with torch.no_grad():
            for name in opt.mu:
                opt.mu[name].copy_(payload["mu"][name])
                opt.nu[name].copy_(payload["nu"][name])
        opt.count = payload["count"]
        state.step = payload["step"]
        return state, meta


# copied from pointcloudprocessing_tpu/train/callbacks.py::CtrlCInterruptHandler
class CtrlCInterruptHandler:
    """Two-stage SIGINT: graceful stop after the epoch, then hard exit."""

    def __init__(self, print_func: Callable[[str], None] = print):
        self.stop_requested = False
        self._print = print_func
        self._previous: Any = None

    def install(self) -> None:
        self._previous = signal.signal(signal.SIGINT, self._on_signal)

    def uninstall(self) -> None:
        if self._previous is not None:
            signal.signal(signal.SIGINT, self._previous)
            self._previous = None

    def _on_signal(self, sig, frame):
        if not self.stop_requested:
            self.stop_requested = True
            self._print(
                ">>> TRAINING INTERRUPT INITIATED BY USER <<<\n"
                "Training will stop after the current epoch.\n"
                "Press Ctrl+C again to force quit."
            )
        else:
            self._print(">>> FORCE QUIT INITIATED BY USER <<<")
            sys.exit(0)
