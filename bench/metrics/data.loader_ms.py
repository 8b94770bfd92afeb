"""Host milliseconds a step spends in ``next(loader)`` (the data loader's
batch, made on the host and copied to the card), less the CUDA runtime's
copy and synchronisation calls inside it: those wait for the device's
queue to drain, so on a device-bound cell they would count the device's
time.  The mean over the profiled steps of the benchmark's own
``bench/loader`` spans."""
import bisect

from bench.yardstick.trace import LOADER_SPAN, SYNC_CALLS, length


def _waits(name: str) -> bool:
    return name.startswith("cudaMemcpy") or name in SYNC_CALLS


def read(view):
    spans = [e for e in view.spans if e["name"] == LOADER_SPAN]
    if not spans:
        return None
    host_us = 0.0
    for span in spans:
        lo, hi = span["ts"], span["ts"] + span["dur"]
        tid = span.get("tid")
        calls = view.calls_by_tid.get(tid, [])
        i = bisect.bisect_left(view.call_ts_by_tid.get(tid, []), lo)
        waits = []
        for c in calls[i:]:
            if c["ts"] >= hi:
                break
            if _waits(c["name"]):
                waits.append((c["ts"], min(c["ts"] + c.get("dur", 0.0), hi)))
        host_us += span["dur"] - length(waits)
    return host_us / len(spans) / 1e3
