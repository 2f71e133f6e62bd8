"""device_idle_frac (fraction): 1 - the union of the device's events
over the device-only traced stretch, both on the trace's clock
(``torch.profiler``; the stretch runs between two edge kernels)."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 1.0 - run.trace.busy_s / run.trace.window_s
