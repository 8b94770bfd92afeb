"""The share of the MoE router's token-to-expert assignments that go to
the experts this chip holds, under an expert share: the counters
``moe/held`` over ``moe/assigned`` of the program this process ran
(``repro_torch.obs.spans``, read where the program loaded it; nothing is
imported of the program), over the profiled steps.  A layer that holds
every expert counts no ``moe/held``, and the metric is then absent.  It
describes the step's routed work: the seeded router sets it, and a change
of the program moves it only by changing the routing."""
import sys


def read(view):
    program = sys.modules.get("repro_torch.obs.spans")
    if program is None:
        return None
    totals = program.counters()
    if not totals.get("moe/assigned") or "moe/held" not in totals:
        return None
    return totals["moe/held"] / totals["moe/assigned"]
