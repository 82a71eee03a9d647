"""The step's share of its roofline, in %: the least time the card could
take for a step (its bytes, each input read once and each output written
once, at the peak bandwidth, or its operations at the peak rate, whichever
is longer) over the device time of every operation launched inside the
traced calls, a step."""


def read(run):
    td = run.trace
    if td is None or not td.steps or run.peak is None:
        return None
    device_s = sum(o.end - o.start for o in td.call_ops()) / 1e6 / td.steps
    if device_s <= 0:
        return None
    least = max(run.step_bytes / run.peak["bytes_per_s"],
                run.step_flops / run.peak["flops_per_s"])
    return 100.0 * least / device_s
