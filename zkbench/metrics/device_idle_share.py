"""The share of the traced window, in %, in which no operation ran on the
device (busy: the union of the device's intervals)."""


def read(run):
    t = run.trace
    if t is None or not t.window_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
