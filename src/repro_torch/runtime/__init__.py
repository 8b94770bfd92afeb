"""The adaptive runtime of ``repro.runtime``, as far as it is ported:
``transitions``, which carries the EF residuals across a re-plan
(``Trainer.replan``, and a resume into another interval).  The monitor,
the controller and the trace are not ported yet."""
from .transitions import TransitionReport, carry_comp_state, residual_norm

__all__ = ["TransitionReport", "carry_comp_state", "residual_norm"]
