"""Device kernels per block in the traced slice."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr["blocks"] or not tr["ops"]:
        return None
    return sum(1 for o in tr["ops"] if o[3] == "kernel") / tr["blocks"]
