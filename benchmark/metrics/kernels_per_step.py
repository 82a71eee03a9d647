"""Device operations (kernels, copies, memsets) launched inside the traced
calls, of any origin, a step."""


def read(run):
    td = run.trace
    if td is None or not td.steps:
        return None
    n = len(td.call_ops())
    return n / td.steps if n else None
