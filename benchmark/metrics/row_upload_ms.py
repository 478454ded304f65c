"""Host ms a block packing the block steps' parameter rows into pinned
memory and issuing their copy to the card (the program's span
``steps.rows``, the wait for a free pinned slot inside it), over the
traced slice."""

from oddio_tpu_torch.utils import profiler


def read(ctx):
    tr = ctx["trace"]
    rec = getattr(profiler, "recorded", None)
    if rec is None or not tr or not tr["blocks"]:
        return None
    hs = tr["spans"]  # the harness's spans of the slice bound it
    spans = rec(min(s[1] for s in hs), max(s[2] for s in hs)) if hs else rec()
    sec, n = profiler.span_seconds("steps.rows", spans)
    return 1e3 * sec / tr["blocks"] if n else None
