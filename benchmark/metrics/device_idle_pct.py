"""The share of the traced window, in %, in which no device operation
runs: one less the union of the device spans over the window."""


def read(run):
    td = run.trace
    if td is None or td.window_us <= 0:
        return None
    busy = td.busy()[1]
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / td.window_us)
