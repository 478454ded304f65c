"""Host spans kept by the harness, and the reading of a ``torch.profiler``
trace of a slice of the window: device operations, their busy union, and
the idle gaps between them with what the host was doing."""

from __future__ import annotations

import collections
import contextlib
import time

_NO_SPAN = contextlib.nullcontext()


class Spans:
    """Seconds and calls per span name, kept in memory; while ``record``
    is a list, each span's (name, start, end) on the wall clock in
    nanoseconds (the profiler's clock) is added to it.  Unless
    ``enabled`` (the traced run), a span times nothing and costs the
    window no more than entering a shared null context."""

    def __init__(self, enabled=True):
        self.enabled = bool(enabled)
        self.total = collections.Counter()
        self.count = collections.Counter()
        self.record = None

    def span(self, name):
        return self._span(name) if self.enabled else _NO_SPAN

    @contextlib.contextmanager
    def _span(self, name):
        t0 = time.perf_counter()
        w0 = time.time_ns() if self.record is not None else 0
        try:
            yield
        finally:
            self.total[name] += time.perf_counter() - t0
            self.count[name] += 1
            if self.record is not None:
                self.record.append((name, w0, time.time_ns()))

    def reset(self):
        self.total.clear()
        self.count.clear()


def _ns(ev, what):
    f = getattr(ev, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(1000 * getattr(ev, f"{what}_us")())


def read_profile(prof, spans=()):
    """Device operations of a finished profile, with the host ``spans``
    recorded beside it: ``{"ops": [(name, start_ns, dur_ns, kind)],
    "spans": [(name, start_ns, end_ns)]}``, ``kind`` "kernel", "memcpy" or
    "memset"."""
    import torch

    ops = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        name = ev.name()
        low = name.lower()
        kind = "memcpy" if low.startswith("memcpy") else "memset" if low.startswith(
            "memset") else "kernel"
        ops.append((name, _ns(ev, "start"), _ns(ev, "duration"), kind))
    ops.sort(key=lambda o: o[1])
    return {"ops": ops, "spans": list(spans)}


def busy_ns(ops, kinds=None):
    """The union of the intervals of ``ops`` (of ``kinds``, default all)."""
    total, end = 0, None
    for _, s, d, kind in ops:
        if kinds is not None and kind not in kinds:
            continue
        e = s + d
        if end is None or s >= end:
            total += d
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def breakdown(trace, top=10):
    """The device operations that took most time and the longest idle
    gaps between them, each named by the host span running at the gap's
    middle: ``{"device_ops": [[name, s]], "idle_gaps": [[name, s]]}``."""
    by = collections.Counter()
    for name, _, d, _ in trace["ops"]:
        by[name] += d
    gaps, end = [], None
    for _, s, d, _ in trace["ops"]:
        if end is not None and s > end:
            gaps.append((s - end, end, s))
        end = s + d if end is None else max(end, s + d)
    gaps.sort(reverse=True)
    spans = trace["spans"]
    named = []
    for g, a, b in gaps[:top]:
        mid = (a + b) // 2
        inner = [sp for sp in spans if sp[1] <= mid <= sp[2]]
        # the innermost span: the one that began last
        label = max(inner, key=lambda sp: sp[1])[0] if inner else "outside spans"
        named.append([label, g / 1e9])
    return {"device_ops": [[n, t / 1e9] for n, t in by.most_common(top)], "idle_gaps": named}
