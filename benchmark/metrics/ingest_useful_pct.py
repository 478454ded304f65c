"""The share of the stream ingest chunks' slots shipped to the card that
carry samples users wrote (the program's counters ``ingest.samples`` over
``ingest.slots``), over the traced slice."""

from oddio_tpu_torch.utils import profiler


def read(ctx):
    tr = ctx["trace"]
    rec = getattr(profiler, "recorded", None)
    if rec is None or not tr:
        return None
    hs = tr["spans"]  # the harness's spans of the slice bound it
    spans = rec(min(s[1] for s in hs), max(s[2] for s in hs)) if hs else rec()
    samples = profiler.counted("ingest.samples", spans)
    slots = profiler.counted("ingest.slots", spans)
    return 100.0 * (samples or 0) / slots if slots else None
