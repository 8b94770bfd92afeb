"""The share of the MoE router's token-to-expert assignments dropped for
want of room in the expert's buffer: the counters ``moe/dropped`` over
``moe/assigned`` of the program this process ran (``repro_torch.obs.spans``,
read where the program loaded it; nothing is imported of the program),
which count only while a profiler records, so over the profiled steps.  A
checkpointed block counts again in its recompute, both counters alike."""
import sys


def read(view):
    program = sys.modules.get("repro_torch.obs.spans")
    if program is None:
        return None
    totals = program.counters()
    if not totals.get("moe/assigned"):
        return None
    return totals.get("moe/dropped", 0.0) / totals["moe/assigned"]
