"""Device milliseconds a step of the operations launched inside the
program's ``moe/dispatch`` spans: each assignment's slot in the expert
buffers (a cumsum over the one-hot of the top-k choices) and the scatter
of the tokens' rows into them, in the forward pass and in the backward
pass's recompute of a checkpointed block."""
from bench.yardstick.spans import MOE_DISPATCH, span_ms


def read(view):
    return span_ms(view, MOE_DISPATCH)
