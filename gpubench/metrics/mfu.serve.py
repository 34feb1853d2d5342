"""``mfu.serve``: the model's share of the card's peak while serving: the
configuration's forward operations a cloud at the model's width, times the
clouds of the traced stretch, over the stretch's wall time and the dense
TF32 peak (``harness/roofline.py``), in %."""

from gpubench.harness.roofline import MFU_PEAK_OPS_PER_S


def read(reading):
    if reading.kind != "serve_stream":
        return None
    cell = reading.cell
    ops = cell.model.forward_flops(cell.config, cell.traffic["model_width"]) * reading.clouds
    return 100.0 * ops / reading.stretch.wall_s / MFU_PEAK_OPS_PER_S
