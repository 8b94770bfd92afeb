"""Device time in the program's latent-attention spans, ``mla/latent`` and
``mla/attend`` (``repro_torch.models.attention.mla_train``), by the rule
of :mod:`.spans`: an operation belongs to every span holding its launch,
only launches inside a profiled step count, a time is a union of
intervals.

:data:`.spans.PREFIXES` names the program's spans that the frozen readers
know, and ``mla/`` is not among them; this module reads a view's spans
again with it added, once a view, and leaves :mod:`.spans` as it was."""
from __future__ import annotations

from . import spans

PREFIX = "mla/"
LATENT = "mla/latent"
ATTEND = "mla/attend"


def _spans(view) -> spans.Spans:
    sp = getattr(view, "_mla_spans", None)
    if sp is None:
        saved = spans.PREFIXES
        spans.PREFIXES = saved + (PREFIX,)
        try:
            sp = view._mla_spans = spans.Spans(view)
        finally:
            spans.PREFIXES = saved
    return sp


def span_ms(view, name: str) -> float | None:
    """Device ms a step of the operations in span ``name``; None when the
    trace has no such span or no device operation."""
    sp = _spans(view)
    if name not in sp.present or not view.device:
        return None
    return sp.ms(lambda names: name in names)
