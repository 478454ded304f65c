"""The benchmark's general part: it finds a cell's configuration, traffic
mix, per-layer metric readers and limits by the names in
``BENCHMARK.json``, builds the cell through the configuration's scene
driver, warms it, measures a window of ``--seconds``, checks what the
window produced against the plain reference and prints the result line.

A configuration ``<config>`` is ``configs/<config>.json`` (its sizes) with
its driver ``scenes/<config>.py``; a traffic mix ``<traffic>`` is
``traffic/<traffic>.json``; a per-layer metric ``<name>``
is read by ``metrics/<name>.py``; a cell's limits are
``limits/<cell>.json``.  Adding any of them is adding files.
"""

from __future__ import annotations

import importlib.util
import json
import statistics
import time
from pathlib import Path

from tracing import Spans, breakdown, busy_ns, read_profile

HERE = Path(__file__).resolve().parent
#: top-level module names no run may hold: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "oddio_tpu")


class BenchError(Exception):
    """A run that must end without a result."""


def forbidden_modules(names):
    """The top-level module names among ``names`` that a run may not hold,
    compared whole (``oddio_tpu_torch`` is not ``oddio_tpu``)."""
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_data(path):
    """A data file of parameters (JSON)."""
    if not path.exists():
        raise BenchError(f"no {path}")
    return json.loads(path.read_text())


class Cell:
    """Everything a run of one workload needs, found by name."""

    def __init__(self, spec, workload, root=HERE):
        self.root = Path(root)
        cells = {w["name"]: w for w in spec["workloads"]}
        if workload not in cells:
            raise BenchError(f"unknown workload {workload!r}; one of {sorted(cells)}")
        self.workload = cells[workload]
        self.name = workload
        cfg = {c["name"]: c for c in spec["configs"]}[self.workload["config"]]
        self.config = read_data(self.root.parent / cfg["file"])
        self.traffic = read_data(self.root / "traffic" / f"{self.workload['traffic']}.json")
        self.driver_mod = load_module(self.root / "scenes" / f"{self.workload['config']}.py",
                                      f"bench_scene_{self.workload['config'].replace('-', '_')}")
        limits = self.root / "limits" / f"{workload}.json"
        self.limits = read_data(limits) if limits.exists() else {}
        self.end_to_end = [m for m in spec["end_to_end"]
                           if "workloads" not in m or workload in m["workloads"]]
        self.per_layer = [m for m in spec["per_layer"]
                          if "workloads" not in m or workload in m["workloads"]]

    def reader(self, name):
        return load_module(self.root / "metrics" / f"{name}.py",
                           f"bench_metric_{name.replace('.', '_').replace('-', '_')}")


class Window:
    """A run's calls: each applies the traffic's control, dispatches one
    call of the driver, copies its PCM to pinned host memory, and (with
    ``in_flight``) waits for the call before it once the next is issued."""

    def __init__(self, driver, in_flight, spans):
        import torch

        self.torch = torch
        self.driver, self.in_flight, self.spans = driver, int(in_flight), spans
        self.slots = [None, None]
        self.pending = None
        self.call = 0  # calls issued since the scene was built
        self.keep = True
        self.log = []  # (blocks, seconds from ask to PCM on the host, control)

    def _issue(self):
        torch, drv = self.torch, self.driver
        with self.spans.span("control"):
            ctl = drv.control(self.call)
        t_ask = time.perf_counter()
        first = drv.block_index
        with self.spans.span("dispatch"):
            outs = drv.dispatch()
        with self.spans.span("copy"):
            total = sum(x.numel() for x in outs)
            k = self.call % 2
            buf = self.slots[k]
            if buf is None or buf.numel() < total:
                buf = self.slots[k] = torch.empty(total, dtype=outs[0].dtype,
                                                  pin_memory=outs[0].is_cuda)
            views, off = [], 0
            for x in outs:
                buf[off:off + x.numel()].copy_(x.reshape(-1), non_blocking=True)
                views.append((off, tuple(x.shape)))
                off += x.numel()
            ev = torch.cuda.Event() if outs[0].is_cuda else None
            if ev is not None:
                ev.record()
        self.call += 1
        return (buf, views, ev, t_ask, first, drv.block_index - first, ctl)

    def _finish(self, item):
        buf, views, ev, t_ask, first, nblocks, ctl = item
        with self.spans.span("wait"):
            if ev is not None:
                ev.synchronize()
        t_have = time.perf_counter()
        self.log.append((nblocks, t_have - t_ask, ctl))
        if self.keep:
            with self.spans.span("keep"):
                pieces = [buf[o:o + int(_prod(s))].numpy().reshape(s) for o, s in views]
                self.driver.keep(first, pieces)
        return t_have

    def step(self):
        """Issue one call; returns the time the newest PCM reached the host
        (None while a call is still in flight)."""
        item = self._issue()
        if not self.in_flight:
            return self._finish(item)
        prev, self.pending = self.pending, item
        return None if prev is None else self._finish(prev)

    def drain(self):
        t = None
        if self.pending is not None:
            t = self._finish(self.pending)
            self.pending = None
        return t


def _prod(shape):
    p = 1
    for s in shape:
        p *= s
    return p


def _pct_quantiles(values):
    return statistics.quantiles(values, n=100, method="inclusive")


def run_cell(cell, seed, seconds, trace, t0, device="cuda", emit=None, controls=()):
    """One run of ``cell``; returns the result object (the last line's).
    ``controls`` (torch dtypes) adds, under ``"controls"``, the numbers the
    reference computed at each of those precisions gives in the program's
    place: the control of the comparison, which the benchmark's own runs
    do not run."""
    import torch

    spans = Spans(enabled=trace)
    drv = cell.driver_mod.Driver(cell.config, cell.traffic, int(seed), device, spans)
    tr = cell.traffic
    win = Window(drv, tr.get("in_flight", 0), spans)
    # warm-up: the cell's own calls, the same pattern as the window's, so
    # every step key is captured and then replayed before the window
    win.keep = False
    for _ in range(int(tr["warm_calls"])):
        win.step()
    win.drain()
    cuda = device != "cpu" and torch.cuda.is_available()
    if cuda:
        torch.cuda.synchronize()
    win.keep = True
    counts0 = dict(drv.counts())
    keys0 = drv.step_keys()
    spans.reset()
    win.log.clear()
    first_block = drv.block_index
    t_start = time.perf_counter()
    setup_s = t_start - t0
    traced = None
    trace_at = t_start + 0.3 * seconds
    t_last = t_start
    while time.perf_counter() - t_start < seconds:
        if trace and traced is None and time.perf_counter() >= trace_at:
            traced = _traced_slice(win, tr, spans, cuda)
            continue
        t = win.step()
        if t is not None:
            t_last = t
    t = win.drain()
    if cuda:
        torch.cuda.synchronize()
    t_end = time.perf_counter() if t is None else max(t, t_last)
    if trace and traced is None:  # a window too short to reach the slice
        traced = _traced_slice(win, tr, spans, cuda)
    wall = t_end - t_start
    blocks = drv.block_index - first_block
    counts = {k: v - counts0.get(k, 0) for k, v in drv.counts().items()}
    new_keys = sorted(drv.step_keys() - keys0)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    n, rate = drv.block, drv.rate
    shapes = drv.shapes()
    # the reference runs once the window has closed and the program's
    # state is freed
    drv.free()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks, failed = drv.check(cell.limits, device if cuda else "cpu")
    ctl = {str(dt): drv.check(cell.limits, device if cuda else "cpu", round_to=dt)[0]
           for dt in controls}
    t_ref = time.perf_counter() - t_ref
    result = {"correct": None, "attempted": blocks, "failed": failed, "metrics": {}}
    if not trace:
        block_s = [s / b for b, s, _ in win.log for _ in range(b)]
        values = {
            "xrt": blocks * n / rate / wall,
            "setup_s": setup_s,
            "block_ms_p95": 1e3 * _pct_quantiles(block_s)[94] if len(block_s) > 1 else None,
        }
        for m in cell.end_to_end:
            v = values.get(m["name"])
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        ctx = {
            "cell": cell.name, "shapes": shapes, "layer": drv.layer,
            "spans": dict(spans.total), "span_calls": dict(spans.count),
            "log": list(win.log), "blocks": blocks, "counts": counts, "trace": traced,
        }
        for m in cell.per_layer:
            v = cell.reader(m["name"]).read(ctx)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    result["device"] = drv.device_info(peak)
    if trace and traced is not None:
        result["device"]["busy_s"] = traced["busy_s"]
        result["device"]["window_s"] = traced["window_s"]
        result["breakdown"] = traced["breakdown"]
    ok = all(v <= lim for v, lim in checks.values())
    result["correct"] = bool(ok and failed == 0)
    if controls:
        result["controls"] = {d: {k: v for k, (v, _) in c.items()} for d, c in ctl.items()}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    if emit is not None:
        emit(f"{cell.name}: seed {seed}, {blocks} blocks in {wall:.3f} s, setup {setup_s:.3f} s, "
             f"reference {t_ref:.3f} s, graph counts {counts}, step keys new in the window "
             f"{new_keys}")
    return result


def _traced_slice(win, tr, spans, cuda):
    """Run ``trace_calls`` calls under ``torch.profiler`` (the device's
    activity only, which leaves the host's pace alone; the harness's own
    spans are kept beside it), from a drained pipeline; returns its
    summary."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    win.drain()
    if cuda:
        torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    b0 = win.driver.block_index
    spans.record = []
    try:
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(int(tr["trace_calls"])):
                win.step()
            win.drain()
            if cuda:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        recorded = spans.record
    finally:
        spans.record = None
    trace = read_profile(prof, recorded)
    trace["window_s"] = wall
    trace["blocks"] = win.driver.block_index - b0
    trace["busy_s"] = busy_ns(trace["ops"]) / 1e9
    trace["breakdown"] = breakdown(trace)
    return trace
