"""``mfu.train``: the train step's share of the card's peak: three times the
configuration's forward operations a cloud at the frames' width (forward,
and the backward's two products a forward product), times the clouds of the
traced stretch, over the stretch's wall time and the dense TF32 peak
(``harness/roofline.py``), in %."""

from gpubench.harness.roofline import MFU_PEAK_OPS_PER_S


def read(reading):
    if reading.kind != "train_step":
        return None
    cell = reading.cell
    width = cell.traffic["frames"]["width"]
    ops = 3.0 * cell.model.forward_flops(cell.config, width) * reading.clouds
    return 100.0 * ops / reading.stretch.wall_s / MFU_PEAK_OPS_PER_S
