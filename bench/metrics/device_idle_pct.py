"""The share of the traced window in which nothing ran on the device: 1 -
the union of kernel, copy and memset intervals over the window
(``chip_smoke.py::device_busy``'s union, copied into ``tracing.Trace``)."""


def read(run):
    if run.trace is None or not run.trace.device or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.window_s)
