"""Runtime calls a step in which the host waits for the device
(``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaEventSynchronize``, a synchronous ``cudaMemcpy``), from the trace's
runtime calls inside the profiled steps."""
from bench.yardstick.trace import SYNC_CALLS


def read(view):
    if not view.calls:
        return None
    return view.calls_named(lambda name: name in SYNC_CALLS) / view.n_steps
