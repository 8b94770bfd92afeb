"""The share of a step in which no device operation runs on any stream:
1 - (the profiled steps' union of device intervals, a step) / (the wall
time of a step of the traced run's untraced steps).  The profiler's host
overhead stretches the profiled steps themselves, so their own wall time
would overstate the idle share of a host-bound step."""


def read(view):
    ctx = view.context
    if not view.device or not ctx.get("untraced_steps") or ctx.get("untraced_s", 0) <= 0:
        return None
    busy_s = view.busy_us() / 1e6 / view.n_steps
    return 1.0 - busy_s / (ctx["untraced_s"] / ctx["untraced_steps"])
