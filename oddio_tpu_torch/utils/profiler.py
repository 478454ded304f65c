"""Rendering observability: xRT counters, a ``torch.profiler`` trace and
the program's own spans and counters (counterpart of
oddio_tpu/utils/profiler.py).

The reference has zero instrumentation (SURVEY.md §5 — "you hear
glitches"); this is the additive equivalent: wrap a Renderer's calls to
track how many times faster than real time it runs, and optionally capture
a device trace.  On a CUDA device a block's clock stops only after
``torch.cuda.synchronize``, so a block that leaves its audio on the device
(``render_frames_device``) is timed to the end of its kernels.

**Spans and counters.**  The engines mark their layers with ``span(name,
**attrs)`` and count work with ``count(name, k)``.  Both record only
while a ``torch.profiler`` session is active (any ``profile(...)``, or
``device_trace``): torch keeps a plain module bool for that,
``torch.autograd.profiler._is_profiler_enabled``, and outside a session a
span is that one attribute check and a shared null context.  A span keeps
its name, start and end on the clock of the profiler's kineto events
(``time.time_ns``, the wall clock, which kineto reports its events on),
the span open around it (``parent``) and the id of its root span
(``call``: every span of one ``render_frames_device`` call, or one pack
call, shares it).  A count adds to the innermost open span of its
thread.  Spans are kept in memory, up to ``CAPACITY``; beyond it they are
dropped and counted (``dropped()``).  ``recorded()`` returns them,
``clear()`` forgets them.  The names are listed in the README.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time

import torch
import torch.autograd.profiler as _tap

__all__ = ["XrtMeter", "device_trace", "span", "count", "recording", "recorded", "clear",
           "dropped", "span_seconds", "counted", "idle_split", "OUTSIDE", "Span", "CAPACITY"]

#: spans kept in memory at most; later ones are dropped and counted
CAPACITY = 200_000

_NULL = contextlib.nullcontext()


class _Stack(threading.local):
    def __init__(self):
        self.open = []


_stack = _Stack()
_ids = itertools.count(1)
_spans = []
_loose = collections.Counter()  # counts made with no span open
_dropped = [0]


class Span:
    """One span of the program: ``name``, ``attrs``, ``start_ns`` and
    ``end_ns`` (the profiler's clock), its ``id``, ``parent`` (the id of
    the span open around it on its thread, or None), ``call`` (its root
    span's id) and ``counts`` (name -> the sum of ``count`` calls made
    while it was the innermost open span; None where there were none)."""

    __slots__ = ("name", "attrs", "id", "parent", "call", "start_ns", "end_ns", "counts")

    def __init__(self, name, attrs):
        self.name, self.attrs, self.counts = name, attrs, None

    def __enter__(self):
        open_ = _stack.open
        self.id = next(_ids)
        if open_:
            top = open_[-1]
            self.parent, self.call = top.id, top.call
        else:
            self.parent, self.call = None, self.id
        open_.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        _stack.open.pop()
        if len(_spans) < CAPACITY:
            _spans.append(self)
        else:
            _dropped[0] += 1
        return False

    def __repr__(self):
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, call={self.call}, "
                f"{(self.end_ns - self.start_ns) / 1e6:.3f} ms, {self.counts})")


def recording():
    """Whether spans and counts are recorded now: a ``torch.profiler``
    session is active."""
    return _tap._is_profiler_enabled


def span(name, **attrs):
    """A context that records the span ``name`` (with ``attrs``) while a
    profiler session is active; else a shared null context."""
    if not _tap._is_profiler_enabled:
        return _NULL
    return Span(name, attrs)


def count(name, k=1):
    """Add ``k`` to the counter ``name`` of the innermost open span (of
    no span, where none is open) while a profiler session is active."""
    if not _tap._is_profiler_enabled:
        return
    open_ = _stack.open
    if not open_:
        _loose[name] += k
        return
    top = open_[-1]
    if top.counts is None:
        top.counts = collections.Counter()
    top.counts[name] += k


def recorded(start_ns=None, end_ns=None):
    """The spans recorded since the last ``clear()``, in the order they
    ended; with ``start_ns`` and ``end_ns``, those that lie between."""
    if start_ns is None:
        return list(_spans)
    return [sp for sp in _spans if sp.start_ns >= start_ns and sp.end_ns <= end_ns]


def dropped():
    """Spans dropped since the last ``clear()``: the buffer was full."""
    return _dropped[0]


def clear():
    """Forget every recorded span and count."""
    _spans.clear()
    _loose.clear()
    _dropped[0] = 0


def span_seconds(name, spans=None):
    """Seconds spent in the spans ``name`` (of ``spans``, default every
    recorded one), and how many there were."""
    spans = recorded() if spans is None else spans
    ns = n = 0
    for sp in spans:
        if sp.name == name:
            ns += sp.end_ns - sp.start_ns
            n += 1
    return ns / 1e9, n


def counted(name, spans=None):
    """The sum of the counter ``name`` and of every ``name.<route>`` over
    ``spans`` (default every recorded span and the counts made with no
    span open); None where none of them was counted."""
    prefix = name + "."
    tallies = [sp.counts for sp in (_spans if spans is None else spans)]
    if spans is None:
        tallies.append(_loose)
    vals = [v for c in tallies if c for k, v in c.items() if k == name or k.startswith(prefix)]
    return sum(vals) if vals else None


#: the name ``idle_split`` gives idle time while no span of the program is open
OUTSIDE = "outside the program"


def idle_split(busy, spans, start_ns, end_ns):
    """Split the idle time of a device over ``[start_ns, end_ns]`` by what
    the program's host code was doing: ``busy`` is the device's (start_ns,
    end_ns) intervals, ``spans`` the program's spans of one thread, on the
    same clock.  Each idle instant goes to the innermost span open then, or
    to ``OUTSIDE``.  Returns {name: seconds}, which sums to the idle time."""
    idle, cur = [], start_ns
    for s, e in sorted(busy):
        if s > cur:
            idle.append((cur, min(s, end_ns)))
        cur = max(cur, e)
        if cur >= end_ns:
            break
    if cur < end_ns:
        idle.append((cur, end_ns))
    # the timeline as pieces, each under one innermost span (spans nest)
    pieces, stack, cur = [], [], start_ns
    for sp in sorted(spans, key=lambda sp: (sp.start_ns, -sp.end_ns)):
        while stack and stack[-1].end_ns <= sp.start_ns:
            top = stack.pop()
            pieces.append((cur, top.end_ns, top.name))
            cur = max(cur, top.end_ns)
        pieces.append((cur, sp.start_ns, stack[-1].name if stack else OUTSIDE))
        cur = max(cur, sp.start_ns)
        stack.append(sp)
    while stack:
        top = stack.pop()
        pieces.append((cur, top.end_ns, top.name))
        cur = max(cur, top.end_ns)
    pieces.append((cur, max(cur, end_ns), OUTSIDE))
    out = collections.Counter()
    i = 0
    for a, b, name in pieces:
        while i < len(idle) and idle[i][1] <= a:
            i += 1
        j = i
        while j < len(idle) and idle[j][0] < b:
            lo, hi = max(a, idle[j][0]), min(b, idle[j][1])
            if hi > lo:
                out[name] += (hi - lo) / 1e9
            j += 1
    return dict(out)


class XrtMeter:
    """Tracks audio-seconds rendered vs wall-clock seconds spent.

    >>> meter = XrtMeter(rate=48000)
    >>> with meter.block(512):
    ...     out = renderer.render_block(512)   # doctest: +SKIP
    >>> meter.xrt()                            # doctest: +SKIP
    """

    def __init__(self, rate, device=None):
        self.rate = float(rate)
        self.device = None if device is None else torch.device(device)
        self.frames = 0
        self.wall = 0.0

    @contextlib.contextmanager
    def block(self, n):
        t0 = time.perf_counter()
        yield
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.wall += time.perf_counter() - t0
        self.frames += n

    def audio_seconds(self):
        return self.frames / self.rate

    def xrt(self):
        """Times-real-time achieved so far (> 1 means keeping up)."""
        return self.audio_seconds() / self.wall if self.wall else float("inf")

    def reset(self):
        self.frames = 0
        self.wall = 0.0


#: the Chrome trace's thread row of the program's spans
SPAN_TID = 1_000_000


@contextlib.contextmanager
def device_trace(logdir):
    """Capture a ``torch.profiler`` trace (the CPU, and the CUDA device when
    there is one) around a rendering region; writes a Chrome trace,
    ``trace.json``, into ``logdir``, with the program's spans of the
    region on a row of their own (``SPAN_TID``, category
    ``oddio_tpu_torch``) on the timeline of the device's events."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    mark = len(_spans)
    with profile(activities=acts) as prof:
        yield prof
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    _add_spans(path, _spans[mark:])


def _add_spans(path, spans):
    """Append ``spans`` to the Chrome trace at ``path`` as complete events:
    its timestamps are microseconds after ``baseTimeNanoseconds`` (0 where
    the trace has none) on the clock the spans were taken on."""
    with open(path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    events = trace.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": SPAN_TID,
                   "args": {"name": "oddio_tpu_torch spans"}})
    for sp in spans:
        args = {"id": sp.id, "parent": sp.parent, "call": sp.call, **sp.attrs}
        if sp.counts:
            args.update(sp.counts)
        events.append({"ph": "X", "cat": "oddio_tpu_torch", "name": sp.name, "pid": pid,
                       "tid": SPAN_TID, "ts": (sp.start_ns - base) / 1e3,
                       "dur": (sp.end_ns - sp.start_ns) / 1e3, "args": args})
    with open(path, "w") as f:
        json.dump(trace, f)
