"""Host ms a block in the pack's merge of its scenes' params into each
cell's (the program's span ``pack.merge``, the ingest chunks' merge
``pack.merge_ingest`` inside it), over the traced slice."""

from oddio_tpu_torch.utils import profiler


def read(ctx):
    tr = ctx["trace"]
    rec = getattr(profiler, "recorded", None)
    if rec is None or not tr or not tr["blocks"]:
        return None
    hs = tr["spans"]  # the harness's spans of the slice bound it
    spans = rec(min(s[1] for s in hs), max(s[2] for s in hs)) if hs else rec()
    sec, n = profiler.span_seconds("pack.merge", spans)
    return 1e3 * sec / tr["blocks"] if n else None
