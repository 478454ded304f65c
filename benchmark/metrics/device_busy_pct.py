"""The union of the device's kernel intervals over the traced slice's wall
time."""

import tracing


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr["window_s"] or not tr["ops"]:
        return None
    return 100.0 * tracing.busy_ns(tr["ops"], ("kernel",)) / 1e9 / tr["window_s"]
