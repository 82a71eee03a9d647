"""The 95th percentile of the wall milliseconds of every call of the
window (host clock; each call returns once the device has drained)."""

import statistics


def read(run):
    ms = [s * 1e3 for s, _ in run.window.calls]
    if len(ms) < 20:
        return None
    return statistics.quantiles(ms, n=20)[18]
