"""Mean wall time, from asking for it to its PCM on the host, of the
one-block calls that carry a tick's ``set_motion`` deltas."""


def read(ctx):
    times = [s for b, s, ctl in ctx["log"] if ctl and b == 1]
    if not times:
        return None
    return 1e3 * sum(times) / len(times)
