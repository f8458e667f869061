"""The device's idle share of the traced window, in %: 1 - (the union of
its kernel, copy and set intervals) / the window, averaged over the
cards the cell uses."""


def read(run):
    tr = run.trace
    if tr is None or not tr.window or not tr.ops:
        return None
    return 100.0 * (1.0 - tr.mean_busy_s(len(run.devices)) / tr.window_s)
