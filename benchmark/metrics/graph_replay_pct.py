"""Block-step calls of the window that replayed a CUDA graph, as a share
of all of them (captures, recaptures, replays and op-by-op calls), from
the driver's ``graph_counts``."""


def read(ctx):
    c = ctx["counts"]
    total = sum(c.get(k, 0) for k in ("captures", "recaptures", "replays", "eager"))
    if not total:
        return None
    return 100.0 * c.get("replays", 0) / total
