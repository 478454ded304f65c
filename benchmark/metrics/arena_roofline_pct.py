"""K6's arena steps' share of their roofline: the least time the card
needs for the traced blocks' sampler steps (``arena_work.arena_step_work``
at the cell's shapes, ``yardstick``'s peaks) over the device time of the
``arena_step_kernel`` launches that did them (tag K6; a sampler cell runs
no Stream step)."""

import arena_work
import yardstick


def read(ctx):
    tr, sh = ctx["trace"], ctx["shapes"]
    if not tr or sh.get("kind") != "sampler":
        return None
    dev = sum(d for name, _, d, kind in tr["ops"]
              if kind == "kernel" and yardstick.hand_kernel(name) == "K6")
    if not dev:
        return None
    least = tr["blocks"] * yardstick.least_seconds(*arena_work.arena_step_work(sh))
    return 100.0 * least / (dev / 1e9)
