"""Kilobytes (1000 bytes) a block the program copies from the host to the
card, by every route: the block steps' rows, pinned operand records and
pageable uploads (the program's counter ``h2d.bytes``), over the traced
slice."""

from oddio_tpu_torch.utils import profiler


def read(ctx):
    tr = ctx["trace"]
    rec = getattr(profiler, "recorded", None)
    if rec is None or not tr or not tr["blocks"]:
        return None
    hs = tr["spans"]  # the harness's spans of the slice bound it
    spans = rec(min(s[1] for s in hs), max(s[2] for s in hs)) if hs else rec()
    b = profiler.counted("h2d.bytes", spans)
    return None if b is None else b / 1e3 / tr["blocks"]
