"""The stream and Adapt kernels' (K4, K6, K7) share of their roofline:
the least time the card needs for the traced blocks' stream writes, Stream
steps and Adapt steps (``yardstick.place_work``, ``stream_step_work``,
``agc_work`` at the cell's shapes) over the device time of the kernels
that did them.  Nothing is read unless all three kinds ran."""

import yardstick

KINDS = ("K4", "K6", "K7")


def read(ctx):
    tr, sh = ctx["trace"], ctx["shapes"]
    if not tr or sh.get("kind") != "pack":
        return None
    dev = {k: 0 for k in KINDS}
    for name, _, d, kind in tr["ops"]:
        tag = yardstick.hand_kernel(name) if kind == "kernel" else None
        if tag in dev:
            dev[tag] += d
    if not all(dev.values()):
        return None
    B, n = tr["blocks"], sh["n"]
    calls = B / sh["blocks_per_call"]
    least = (calls * yardstick.least_seconds(*yardstick.place_work(sh["written_per_call"],
                                                                   sh["streams"]))
             + B * yardstick.least_seconds(*yardstick.stream_step_work(sh["streams"], n,
                                                                       sh["stream_ds"]))
             + B * yardstick.least_seconds(*yardstick.agc_work(sh["voices"], n)))
    return 100.0 * least / (sum(dev.values()) / 1e9)
