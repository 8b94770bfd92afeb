"""Device milliseconds a step of the operations launched inside the
program's ``mla/attend`` spans: latent attention's q-chunked scores, f32
softmax and values over every key, in the forward pass and in the
backward pass's recompute of a checkpointed layer (their gradients are
launched outside the span)."""
from bench.yardstick.mla_spans import ATTEND, span_ms


def read(view):
    return span_ms(view, ATTEND)
