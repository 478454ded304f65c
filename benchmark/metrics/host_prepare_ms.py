"""Host time per block in the scenes' ``host_prepare`` (summed over the
scenes of a pack), timed by the harness's wrapper of each scene."""


def read(ctx):
    if "host_prepare" not in ctx["spans"] or not ctx["blocks"]:
        return None
    return 1e3 * ctx["spans"]["host_prepare"] / ctx["blocks"]
