"""Run one benchmark cell with ``--trace 1`` and split the traced slice's
device idle time by the program's innermost span at each idle instant
(``oddio_tpu_torch.utils.profiler.idle_split``; "outside the program" is
the harness's or the caller's time).

    python3 tools/idle_split.py <checkout> --workload <cell> --seed <n> --seconds <s> --trace 1

``<checkout>`` is the root of a checkout holding ``BENCHMARK.json``,
``benchmark/`` and the port.  The benchmark's result line is printed as
``benchmark/run.py`` prints it; before it, on standard error, one line
``idle_split {json}``: the split in seconds, the slice's idle time over
the harness's spans of the slice, every program span's seconds, count,
longest and shortest, and every counter over the slice.  A program
without spans gives the whole idle time as "outside the program".
"""

import json
import runpy
import sys
from pathlib import Path

root = Path(sys.argv[1]).resolve()
sys.argv = [str(root / "benchmark" / "run.py")] + sys.argv[2:]
sys.path[:0] = [str(root / "benchmark"), str(root)]

import harness  # noqa: E402
import tracing  # noqa: E402

_read = harness.read_profile


def read_profile(prof, spans=()):
    trace = _read(prof, spans)
    from oddio_tpu_torch.utils import profiler

    lo, hi = min(s[1] for s in trace["spans"]), max(s[2] for s in trace["spans"])
    busy = [(s, s + d) for _, s, d, _ in trace["ops"]]
    inside = [(s, e) for s, e in busy if e > lo and s < hi]
    busy_s = tracing.busy_ns([("", max(s, lo), min(e, hi) - max(s, lo), "k")
                              for s, e in inside]) / 1e9
    out = {"slice_s": (hi - lo) / 1e9, "idle_s": (hi - lo) / 1e9 - busy_s}
    if hasattr(profiler, "idle_split"):
        prog = profiler.recorded(lo, hi)
        out["split"] = profiler.idle_split(busy, prog, lo, hi)
        per = {}
        for sp in prog:
            per.setdefault(sp.name, []).append((sp.end_ns - sp.start_ns) / 1e9)
        out["spans"] = {n: {"s": sum(d), "n": len(d), "max_s": max(d), "min_s": min(d)}
                        for n, d in sorted(per.items())}
        keys = sorted({k for sp in prog if sp.counts for k in sp.counts})
        out["counts"] = {k: profiler.counted(k, prog) for k in keys}
        out["dropped"] = profiler.dropped()
    else:
        out["split"] = {"outside the program": out["idle_s"]}
    print("idle_split " + json.dumps(out), file=sys.stderr, flush=True)
    return trace


harness.read_profile = read_profile
runpy.run_path(sys.argv[0], run_name="__main__")
