"""tqdm -> progress-bar bridge (``pointcloudprocessing_tpu/toolkit/tqdm_capture.py``;
API parity: utils/TQDMCapture.py:1-19)."""

from __future__ import annotations


# copied from pointcloudprocessing_tpu/toolkit/tqdm_capture.py::TQDMCapture
class TQDMCapture:
    """File-like sink for tqdm output; ``get_percent`` parses the 'NN%'
    fragment for progress bars."""

    def __init__(self):
        self.last = ""

    def write(self, msg) -> None:
        # keep the last non-empty line — tqdm finishes with a bare '\n' which
        # would otherwise wipe the final percentage (reference quirk fixed)
        stripped = msg.strip()
        if stripped:
            self.last = stripped

    def flush(self) -> None:
        pass

    def get_percent(self) -> int | None:
        if "%" in self.last:
            end_idx = self.last.find("%")
            try:
                return int(self.last[:end_idx])
            except ValueError:
                return None
        return None
