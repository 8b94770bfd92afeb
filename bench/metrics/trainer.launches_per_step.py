"""Kernel launches the host issues a step (``cudaLaunchKernel`` and the
driver's ``cuLaunchKernel`` forms, graph launches too), from the trace's
runtime calls inside the profiled steps."""


def _launch(name: str) -> bool:
    return "LaunchKernel" in name or name in ("cudaGraphLaunch", "cuGraphLaunch")


def read(view):
    n = view.calls_named(_launch)
    return n / view.n_steps if n else None
