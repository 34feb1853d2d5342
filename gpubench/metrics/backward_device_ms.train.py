"""``backward_device_ms.train``: device ms a train step of the rows given to
``pcp.train.backward`` (``harness/spans.py``). None where the stretch holds
no span."""

from gpubench.harness.spans import device_ms, has_spans


def read(reading):
    if reading.kind != "train_step" or not has_spans(reading):
        return None
    return device_ms(reading, ("pcp.train.backward",))
