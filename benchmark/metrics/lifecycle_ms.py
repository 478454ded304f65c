"""Host ms a block in the voice lifecycle: the program's spans
``scene.play`` (each ``play``/``play_buffered``) and ``scene.sync`` (a
scene's sync, its wait inside) within each call's control (the
harness's ``control`` span) of the traced slice, the median call over
its blocks.  The median, not the sum: a full collection of Python's
cyclic GC (~0.26 s on the sampler's host) lands inside some slices' plays
and not others', and would swing a 4-call slice's sum by 2.5x."""

import statistics

from oddio_tpu_torch.utils import profiler


def read(ctx):
    tr = ctx["trace"]
    rec = getattr(profiler, "recorded", None)
    if rec is None or not tr or not tr["blocks"]:
        return None
    calls = [(a, b) for name, a, b in tr["spans"] if name == "control"]
    if not calls:
        return None
    spans = rec(calls[0][0], calls[-1][1])
    per = []
    for a, b in calls:
        inside = [sp for sp in spans if sp.start_ns >= a and sp.end_ns <= b]
        play, n_play = profiler.span_seconds("scene.play", inside)
        sync, n_sync = profiler.span_seconds("scene.sync", inside)
        if n_play or n_sync:
            per.append(play + sync)
    if not per:
        return None
    return 1e3 * statistics.median(per) * len(calls) / tr["blocks"]
