"""Device time per block of every kernel that is not one of the port's
hand kernels (by the profiler's kernel names): the plain torch chains."""

import yardstick


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr["blocks"] or not tr["ops"]:
        return None
    ns = sum(d for name, _, d, kind in tr["ops"]
             if kind == "kernel" and yardstick.hand_kernel(name) is None)
    return ns / 1e6 / tr["blocks"]
