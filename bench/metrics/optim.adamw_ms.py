"""Device milliseconds a step of the operations launched inside the
program's ``train/optimizer`` span: the gradient norm (or clip), AdamW's
update and its application to the parameters."""
from bench.yardstick.spans import OPTIMIZER, span_ms


def read(view):
    return span_ms(view, OPTIMIZER)
