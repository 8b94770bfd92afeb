"""Device milliseconds a step of the operations launched inside the
program's ``train/forward`` span (the model's forward pass, the loss
included; ``bench.yardstick.spans`` gives the attribution rule)."""
from bench.yardstick.spans import FORWARD, span_ms


def read(view):
    return span_ms(view, FORWARD)
