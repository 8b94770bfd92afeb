"""Device milliseconds a step of the operations launched inside the
program's ``train/backward`` span (on the stepping thread, or on the
autograd engine's thread while the stepping thread waits in it) and in no
``covap_bucket_*`` span: the backward pass, its recompute included,
without the fused overlap's EF and collectives."""
from bench.yardstick.spans import BACKWARD, BUCKET_PREFIX, span_ms


def read(view):
    return span_ms(view, BACKWARD, exclude_prefix=BUCKET_PREFIX)
