"""The whole step's share of the card's peak, %: the FLOPs the steps need
(the configuration's reference module's ``step_flops``) over the wall time
of the traced run's untraced steps, over the dense bf16 peak times the
chips."""
from bench.yardstick.peaks import BF16_FLOPS


def read(view):
    ctx = view.context
    if not view.device or not ctx.get("untraced_steps") or ctx.get("untraced_s", 0) <= 0:
        return None
    flops = ctx["flops_per_step"] * ctx["untraced_steps"]
    return 100.0 * flops / ctx["untraced_s"] / (BF16_FLOPS * ctx["chips"])
