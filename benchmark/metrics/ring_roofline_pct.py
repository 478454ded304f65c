"""The ring reads' (K2, K3) share of their roofline: the least time the
card needs for the traced blocks' buffered reads (``yardstick.ring_read_work``
at the cell's voices and frames) over the device time of the kernels that
did them."""

import yardstick


def read(ctx):
    tr, sh = ctx["trace"], ctx["shapes"]
    if not tr or sh.get("kind") != "spatial":
        return None
    dev = sum(d for name, _, d, kind in tr["ops"]
              if kind == "kernel" and yardstick.hand_kernel(name) == "K2/K3")
    if not dev:
        return None
    least = tr["blocks"] * yardstick.least_seconds(*yardstick.ring_read_work(sh["voices"], sh["n"]))
    return 100.0 * least / (dev / 1e9)
