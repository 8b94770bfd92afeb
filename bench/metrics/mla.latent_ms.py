"""Device milliseconds a step of the operations launched inside the
program's ``mla/latent`` spans: latent attention's query and latent
down-projections, the latent's RMSNorm, its up-projection to each head's
keys and values, the rotary positions and the keys' assembly, in the
forward pass and in the backward pass's recompute of a checkpointed
layer (their gradients are launched outside the span)."""
from bench.yardstick.mla_spans import LATENT, span_ms


def read(view):
    return span_ms(view, LATENT)
