"""Device milliseconds a step of the matrix-product kernels (the
``matmul`` group of ``bench.yardstick.trace.GROUPS``)."""


def read(view):
    us = view.group_us().get("matmul")
    return us / 1e3 / view.n_steps if us else None
