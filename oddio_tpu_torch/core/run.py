"""Block renderers (counterpart of oddio_tpu/core/run.py).

Reference: oddio's src/lib.rs:90-93 — ``run(signal, rate, out)``
pulls one block from the signal graph.  A ``Renderer`` walks the graph on
the host once per block (advancing host state, producing per-block
parameters) and renders the block on the signal's device: an engine's own,
or for a standalone signal the Renderer's (the CUDA card unless the caller
passes ``device``).

The JAX package compiles one donated program per ``(archetype, kind, pack
spec)``: ``"single"`` (one block), ``"scan"`` (a run of equal-archetype
blocks) and ``("multi", nb)`` (fused idle groups).  Here a signal that
declares ``graph_capture`` (a SpatialScene of built-in chains in any
pool kind: the main path's, the samplers', the seek chains' and the
host-pool scene; a Mixer of BASELINE config 5's, config
4's, config 2's or the wavetable's voices, of host pools of such chains
or of capturing submixes; a wrapper chain of Reinhard, Tanh, MonoToStereo
or Downmix around either, which forwards it) gets one block step per
such key, in ``_steps``; the
protocol (``BlockSteps``) is the
Renderer's and a ScenePack's (``parallel/sharded.py``), which drives it
over each mesh cell's stacked state:

* a block's parameters ship as ONE packed float32 row (``_pack_row``, the
  JAX package's row: equal bit for bit for every leaf it packs; a
  FramesSignal's float64 time cursor, a leaf the JAX package does not
  keep, rides as two float32 words of its bit pattern; a stream ingest
  block's PCM rides in it), copied to the
  device with one non-blocking copy from pinned memory and unpacked
  inside the step by static slices and ``view(dtype)`` bitcasts; a run's
  rows go up in one copy;
* on a CUDA device a key's first dispatch runs the step eagerly (the
  warm-up: it builds the kernels, sizes their scratch, creates state keys,
  and renders its block); the second captures it as one
  ``torch.cuda.CUDAGraph`` (all of a driver's graphs on one card share
  one memory pool: a pack's cells replay in turn) and replays it, and
  later dispatches only replay.  A graph renders
  ``scan_unroll`` blocks of a run, or one fused idle group;
  ``scan_buckets`` quantises runs as the JAX package does;
* the counterpart of donation: every dispatch leaves each state leaf in
  the tensor ``device_collect`` handed out.  Leaves the step rebuilds are
  copied back inside the step; leaves it writes in place
  (``GRAPH_INPLACE``: the delay rings, the streams' rings) must stay where
  they are.  Each call's output is copied out of the step's buffers before
  the next call: the audio, and in a voice shard of a pack's mesh each
  pool's partial mix beside it (``parallel.context.voice_partials``).
  Before a replay the Renderer checks that ``device_collect`` still hands
  out the captured leaves; a leaf replaced outside the step (a bulk play,
  a restore, growth) makes it capture again (``graph_counts
  ["recaptures"]``).  A capture or replay that fails raises;
* on the CPU the same step runs through the same protocol, uncaptured.

Under ``eager()`` (the counterpart of ``jax.disable_jit()``), and for every
other signal, a dispatch is a Python loop over the same blocks, op by op,
with numpy parameters that pools upload where they use them, and the state
the render returns stored as it is.  Both ways keep the same block
boundaries, structure-event flushes and fused multi-block groups on idle
runs, and both render a run as of its own archetype (an engine's
``render_archetype``: the run is dispatched after the next block's
prepare).
"""

from __future__ import annotations

import contextlib
import gc
import threading

import numpy as np
import torch

from ..parallel.context import block_step, voice_partials
from ..utils.profiler import count, span
from ..utils.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from .hostmath import f32
from .signal import default_device, same_device

__all__ = ["Renderer", "BlockSteps", "run", "eager"]

#: minimum idle-run length before the fused multi-block dispatch engages
MULTI_MIN_BLOCKS = 16

_MODE = threading.local()


@contextlib.contextmanager
def eager():
    """Dispatch op by op inside the block (the counterpart of
    ``jax.disable_jit()``): no block step, no graph, numpy parameters.  The
    tests and the smoke hold the graphs against it.  Per thread."""
    prev = getattr(_MODE, "eager", False)
    _MODE.eager = True
    try:
        yield
    finally:
        _MODE.eager = prev


def eager_mode():
    """Whether this thread dispatches op by op (inside ``eager()``)."""
    return getattr(_MODE, "eager", False)


def _engine_device(signal):
    """The device of the first engine (Mixer, SpatialScene) inside a chain
    of wrappers, or None: ``Tanh(Reinhard(scene))`` renders where the
    scene lives."""
    stack = [signal]
    while stack:
        node = stack.pop()
        if node.device is not None:
            return node.device
        stack.extend(node.children().values())
    return None


# -- the packed parameter row (oddio_tpu/core/run.py:27-97) ---------------------


def _pack_spec(params):
    """``(treedef, ((shape, dtype-str), ...))`` of a params tree, or None
    when a leaf's dtype has no float32 bit-packing."""
    leaves, treedef = tree_flatten(params)
    spec = []
    for leaf in leaves:
        a = np.asarray(leaf)
        if not (a.dtype == np.float32 or a.dtype == np.float64 or a.dtype == np.bool_
                or (a.dtype.kind in "iu" and a.dtype.itemsize <= 8)):
            return None
        spec.append((a.shape, a.dtype.str))
    return treedef, tuple(spec)


def _words(dtype):
    """float32 words a leaf element of ``dtype`` takes in the row: two for
    a float64 (its 8 bytes), one for every other dtype."""
    return 2 if dtype == np.float64 else 1


def _pack_into(params, out):
    """Write one block's params into the float32 vector ``out`` (its
    length the row's): float32 as they are, bools as 0/1, integers as
    their int32 bit pattern (the JAX package's ``_pack_row``), float64
    (a FramesSignal's time cursor, which the JAX package does not keep) as
    its two 32-bit words, low word first; each leaf copied once, right
    after the one before."""
    off = 0
    for leaf in tree_flatten(params)[0]:
        a = np.asarray(leaf).reshape(-1)
        size = a.size * _words(a.dtype)
        dst = out[off:off + size]
        if a.dtype == np.float32 or a.dtype == np.bool_:
            dst[...] = a
        elif a.dtype == np.float64:
            dst.view(np.uint32)[...] = np.ascontiguousarray(a).view(np.uint32)
        else:
            dst.view(np.int32)[...] = a
        off += size


def _pack_row(params):
    """One block's params as a single float32 vector (``_pack_into``)."""
    leaves = [np.asarray(x) for x in tree_flatten(params)[0]]
    out = np.empty(sum(a.size * _words(a.dtype) for a in leaves), np.float32)
    _pack_into(params, out)
    return out


def _row_len(spec):
    return sum(int(np.prod(shape, dtype=np.int64)) * _words(np.dtype(dstr))
               for shape, dstr in spec)


def _join_f64(words):
    """(2m,) float32 words, low word first, as the m float64 they hold,
    bit for bit: the words are viewed as int32 and joined in int64 before
    the bitcast (a float32 slice at an odd offset cannot be viewed as
    float64)."""
    w = words.view(torch.int32).reshape(-1, 2).to(torch.int64)
    return ((w[:, 1] << 32) | (w[:, 0] & 0xFFFFFFFF)).view(torch.float64)


def _unpack_row(buf, treedef, spec):
    """The inverse of ``_pack_row`` on a (R,) float32 tensor: static slices
    and bitcasts (views of ``buf`` but for the bools and float64s), on the
    device, with no host read."""
    out = []
    off = 0
    for shape, dstr in spec:
        dt = np.dtype(dstr)
        size = int(np.prod(shape, dtype=np.int64)) * _words(dt)
        x = buf[off:off + size]
        if dt == np.float64:
            x = _join_f64(x)
        elif dt.kind in "iu":
            x = x.view(torch.int32)
        elif dt == np.bool_:
            x = x > 0.5
        out.append(x.reshape(shape))
        off += size
    return tree_unflatten(treedef, out)


def step_body(sig, kind, pack, n, k, dstate, ddata, rows, partials=False):
    """The block step of one key: ``k`` blocks whose packed rows are
    ``rows`` (k, R) (None when the params have no leaf), or with ``kind`` =
    ("multi", nb) one fused idle group.  Returns (state, (k, ...)) or
    (state, (1, ..., nb*n)): a block is (C, n), or a ScenePack's (S, C,
    n).  With ``partials`` (a voice shard of a pack's mesh) each block
    renders under ``voice_partials`` and the output is ``{"mix": (k, S,
    C, n), "parts": {pool name: (k, S, C, n)}}``, each pool's partial mix
    in render order.  Renders under ``block_step()``: no per-block value
    may come from the host."""
    with block_step():
        if isinstance(kind, tuple):
            d, block = sig.render_multi(dstate, ddata, n, kind[1])
            return d, block[None]
        d, blocks, parts = dstate, [], []
        for i in range(k):
            params = _unpack_row(rows[i] if rows is not None else None, *pack)
            part = {} if partials else None
            with voice_partials(part):
                d, block = sig.render(d, ddata, params, n)
            blocks.append(block)
            parts.append(part)
        if not partials:
            return d, torch.stack(blocks)
        return d, {"mix": torch.stack(blocks),
                   "parts": {name: torch.stack([p[name] for p in parts]) for name in parts[0]}}


def _same_storage(a, b):
    return (a is b or (a.data_ptr() == b.data_ptr() and a.shape == b.shape
                       and a.stride() == b.stride() and a.dtype == b.dtype))


def _copy_back(d0, d2, inplace, strict):
    """Copy the leaves of the step's returned state ``d2`` that it rebuilt
    into the collected state ``d0``'s tensors, in place.  Leaves named in
    ``inplace`` must come back in their own tensor.  Returns False (having
    copied nothing) when ``d2`` has a leaf ``d0`` lacks or another shape
    or dtype: the state's structure changed, which ``strict`` (a capture)
    refuses."""
    pairs = []

    def walk(a, b, path):
        if isinstance(b, dict):
            if not isinstance(a, dict):
                return False
            return all(k in a and walk(a[k], b[k], path + (k,)) for k in b)
        if not isinstance(a, torch.Tensor):
            return False
        if _same_storage(b, a):
            return True
        if path[-1] in inplace:
            raise RuntimeError(f"the block step moved the in-place state leaf {'/'.join(path)}")
        if a.shape != b.shape or a.dtype != b.dtype:
            return False
        pairs.append((a, b))
        return True

    if not walk(d0, d2, ()):
        if strict:
            raise RuntimeError("the block step changed the state's structure during a capture")
        return False
    targets = {a.data_ptr() for a, _ in pairs}
    # a rebuilt leaf that aliases another leaf copied back reads it first
    pairs = [(a, b.clone() if b.data_ptr() in targets else b) for a, b in pairs]
    for a, b in pairs:
        a.copy_(b)
    return True


def _own_leaves(d0, d2):
    """``d2`` with every leaf that is not one of ``d0``'s tensors cloned
    (it may view the step's row buffer, which the next block rewrites)."""
    held = {id(x) for x in tree_leaves(d0) if isinstance(x, torch.Tensor)}

    def own(x):
        if isinstance(x, dict):
            return {k: own(v) for k, v in x.items()}
        return x if id(x) in held or not isinstance(x, torch.Tensor) else x.clone()

    return own(d2)


def _launch_counters():
    """Every kernel wrapper's launch counter dict (their wrappers count on
    the host; a replayed graph calls none of them)."""
    from ..ops import agc, flat_kernels, ring_kernels, stream_kernels

    return (ring_kernels.LAUNCHES, stream_kernels.LAUNCHES, agc.LAUNCHES,
            flat_kernels.LAUNCHES)


class _RowUpload:
    """Packs rows straight into one of ``DEPTH`` reused pinned buffers and
    copies them to the device with ONE non-blocking copy (a buffer is
    rewritten once the copy that last read it has finished)."""

    DEPTH = 4

    def __init__(self):
        self._slots = []
        self._next = 0

    def __call__(self, pend, dst):
        """Pack the params ``pend`` into the rows of the (len(pend), R)
        device tensor ``dst``."""
        size = dst.numel()
        if not self._slots or self._slots[0][0].numel() < size:
            cap = max(size, 2 * self._slots[0][0].numel() if self._slots else 0)
            self._slots = [(torch.empty(cap, dtype=torch.float32, pin_memory=True),
                            torch.cuda.Event()) for _ in range(self.DEPTH)]
        host, done = self._slots[self._next]
        self._next = (self._next + 1) % self.DEPTH
        with span("steps.slot_wait"):
            done.synchronize()
        for row, params in zip(host.numpy()[:size].reshape(dst.shape), pend):
            _pack_into(params, row)
        dst.view(-1).copy_(host[:size], non_blocking=True)
        done.record()
        count("h2d.bytes.rows", 4 * size)


class _Step:
    """One key's block step for calls of ``k`` blocks of ``n`` frames (or
    one fused group): its static row buffer and, on a card, its graph."""

    def __init__(self, kind, pack, n, k, device):
        self.kind, self.pack, self.n, self.k = kind, pack, n, k
        R = 0 if pack is None else _row_len(pack[1])
        self.rows = torch.zeros((k, R), dtype=torch.float32, device=device) if R else None
        self.calls = 0
        self.captures = 0
        self.graph = None
        self.stale = False  # the graph reads leaves the state no longer holds
        self.out = None  # the graph's output buffers (a tensor, or partials' tree)
        self.leaves = None  # the state and data tensors of its warm-up or capture
        self.launches = None  # kernel launches per replay, per counter dict


class BlockSteps:
    """The block-step protocol, which a Renderer and a ScenePack both
    drive: one step per ``(archetype, kind, pack spec)`` key, each call's
    params one packed row, the warm-up, capture and replays of its CUDA
    graph, the check of the leaves a graph reads before each replay, the
    copy-back of rebuilt leaves (``GRAPH_INPLACE`` leaves stay), the
    launch counters and ``graph_counts``.  A driver gives it three things:
    the state (``_step_get``, and ``_step_set``, which stores a state tree
    after each dispatch), the read-only data (``_step_data``) and the
    signal whose ``render``/``render_multi`` a step calls (``_step_sig``,
    set in its constructor, which calls ``_init_steps``).  A driver that
    renders several lanes (a ScenePack's mesh cells, each over its own
    stack on its own device) names the one in progress (``_lane``): each
    lane has its own steps and staging buffers, and with
    ``step_partials`` its steps also return each pool's partial mix."""

    #: whether the steps render voice shards (``step_body``'s ``partials``)
    step_partials = False

    def _lane(self):
        """The lane whose steps a dispatch runs, a suffix of their keys:
        ``()``, one lane; a ScenePack's is its mesh cell in progress."""
        return ()

    def _init_steps(self, scan_unroll):
        #: blocks one block step renders per call (one graph replay): a
        #: run of equal-archetype blocks goes as calls of this many
        self.scan_unroll = max(1, int(scan_unroll))
        #: block steps: (archetype, kind, pack spec) + lane -> {(k, n): _Step}
        self._steps = {}
        #: calls of a block step: captured, captured again after a state
        #: leaf was replaced, replayed, and run op by op (CPU, warm-ups,
        #: ``eager()``, signals that are not captured; counted per block
        #: or fused group)
        self.graph_counts = {"captures": 0, "recaptures": 0, "replays": 0, "eager": 0}
        self._graph_pools = {}  # CUDA device index -> the graphs' memory pool there
        self._uploads = {}  # lane -> its pinned row uploads
        self._run_rows = {}  # lane -> device staging for a run's rows

    def _run_key(self, arch, kind, pend, n):
        """Dispatch the blocks ``pend`` (their params) of one archetype
        through the block step of key ``(arch, kind, pack)`` in the lane in
        progress, or with ``kind`` = ("multi", nb) ``len(pend)`` fused idle
        groups.  Returns the audio, (B, ...) blocks or groups, a tensor of
        its own (with ``step_partials``, the step's output tree of such
        tensors)."""
        dev = self._step_sig.device
        if isinstance(kind, tuple):
            pack, k = None, 1
        else:
            pack = _pack_spec(pend[0])
            if pack is None:
                raise ValueError(f"{type(self._step_sig).__name__} declares graph_capture but "
                                 "its params do not pack into one float32 row")
            k = self.scan_unroll if kind == "scan" else 1
        R = 0 if pack is None else _row_len(pack[1])
        steps = self._steps.setdefault((arch, kind, pack) + self._lane(), {})
        total = len(pend)
        staged = None
        if R and total > k:
            # a run's rows go up in one copy; each call takes its slice
            staged = self._stage(pend, R, dev)
        out = None
        i = 0
        while i < total:
            kc = min(k, total - i)
            step = steps.get((kc, n))
            if step is None:
                step = steps[(kc, n)] = _Step(kind, pack, n, kc, dev)
            if staged is not None:
                step.rows.copy_(staged[i:i + kc])
            elif R:
                self._rows_to(pend[i:i + kc], step.rows)
            block = self._call(step)
            if out is None:
                out = tree_map(lambda b: torch.empty((total,) + tuple(b.shape[1:]),
                                                     dtype=b.dtype, device=b.device), block)
            tree_map(lambda o, b, i=i, kc=kc: o[i:i + kc].copy_(b), out, block)
            i += kc
        self._step_set(self._step_get())
        return out

    def _rows_to(self, pend, dst):
        """Pack the params ``pend`` into the rows of the device tensor
        ``dst``: on a card through a pinned buffer and one copy, on the
        CPU in place (the span ``steps.rows``, a run's staged rows
        included)."""
        with span("steps.rows"):
            if dst.device.type != "cuda":
                for row, params in zip(dst.numpy(), pend):
                    _pack_into(params, row)
                return
            up = self._uploads.get(self._lane())
            if up is None:
                up = self._uploads[self._lane()] = _RowUpload()
            up(pend, dst)

    def _stage(self, pend, R, dev):
        """A run's rows on the device, one copy: a view of a staging buffer
        that grows to the longest run."""
        need = len(pend) * R
        buf = self._run_rows.get(self._lane())
        if buf is None or buf.numel() < need:
            buf = self._run_rows[self._lane()] = torch.empty(
                max(need, 2 * (0 if buf is None else buf.numel())), dtype=torch.float32,
                device=dev)
        dst = buf[:need].view(len(pend), R)
        self._rows_to(pend, dst)
        return dst

    def _eager_call(self, step, d0, dd):
        """One call of ``step`` op by op through the static-state protocol."""
        sig = self._step_sig
        d2, out = step_body(sig, step.kind, step.pack, step.n, step.k, d0, dd, step.rows,
                            self.step_partials)
        if not _copy_back(d0, d2, getattr(sig, "GRAPH_INPLACE", ()), False):
            # the state's structure changed (new keys or shapes): it is
            # stored as returned, and graphs on the old leaves recapture
            self._step_set(_own_leaves(d0, d2))
        return out

    def _call(self, step):
        """One call of ``step``, in the span of the way it ran:
        ``steps.eager``, ``steps.capture`` (a capture and its first replay)
        or ``steps.replay``."""
        with span("steps.call") as sp:
            out, how = self._step_call(step)
            if sp is not None:
                sp.name = "steps." + how
            return out

    def _step_call(self, step):
        d0, dd = self._step_get(), self._step_data()
        if self._step_sig.device.type != "cuda":
            self.graph_counts["eager"] += 1
            return self._eager_call(step, d0, dd), "eager"
        leaves = tree_leaves(d0) + tree_leaves(dd)
        if step.leaves is not None and not (
                len(leaves) == len(step.leaves)
                and all(a is b and a.shape == s for a, (b, s) in zip(leaves, step.leaves))):
            # a leaf was replaced outside the step since its warm-up or
            # capture (a graph would read stale addresses).  Same shapes:
            # capture (again) now; else run once op by op (scratch and
            # count tensors may have to grow: a pool grew between a key's
            # warm-up and its capture) and capture next time.  The stale
            # graph is kept until then: were every graph of the shared
            # memory pool dropped, the pool would be freed, and a capture
            # could not join it
            same = len(leaves) == len(step.leaves) and all(
                a.shape == s for a, (_, s) in zip(leaves, step.leaves))
            step.stale = True
            if not same:
                step.calls = 0
        if step.calls == 0:
            step.calls += 1
            step.leaves = [(x, x.shape) for x in leaves]
            self.graph_counts["eager"] += 1
            return self._eager_call(step, d0, dd), "eager"
        how = "replay"
        if step.graph is None or step.stale:
            self._capture(step, d0, dd, leaves)
            how = "capture"
        step.graph.replay()
        for counters, delta in zip(_launch_counters(), step.launches):
            for name, v in delta.items():
                counters[name] += v
        step.calls += 1
        self.graph_counts["replays"] += 1
        return step.out, how

    def _capture(self, step, d0, dd, leaves):
        """Capture ``step`` on the collected state ``d0`` as one CUDA graph
        (no work runs); its launches per replay are recorded and taken off
        the counters, which each replay adds them to."""
        sig = self._step_sig
        card = torch.cuda.current_device()  # the lane's card (``mesh_cell`` sets it)
        if card not in self._graph_pools:
            self._graph_pools[card] = torch.cuda.graph_pool_handle()
        counters = _launch_counters()
        before = [dict(c) for c in counters]
        graph = torch.cuda.CUDAGraph()
        # no cyclic collection inside the capture: one that frees another
        # engine's graphs (an engine or pack dropped in a reference cycle)
        # destroys them mid-capture, which invalidates this capture
        # (cudaErrorStreamCaptureInvalidated, ROADMAP Q3.12)
        gc_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._graph_pools[card],
                                  capture_error_mode="thread_local"):
                d2, out = step_body(sig, step.kind, step.pack, step.n, step.k, d0, dd,
                                    step.rows, self.step_partials)
                _copy_back(d0, d2, getattr(sig, "GRAPH_INPLACE", ()), True)
        finally:
            if gc_on:
                gc.enable()
        step.launches = []
        for c, b in zip(counters, before):
            step.launches.append({name: c[name] - b[name] for name in c if c[name] != b[name]})
            c.update(b)
        step.graph, step.out, step.stale = graph, out, False
        step.leaves = [(x, x.shape) for x in leaves]
        self.graph_counts["recaptures" if step.captures else "captures"] += 1
        step.captures += 1


class Renderer(BlockSteps):
    def __init__(self, signal, rate, sync_every=16, scan_unroll=1,
                 scan_buckets=None, device=None):
        if signal._moved:
            raise RuntimeError("signal was moved into an engine; render the engine")
        own = signal.device
        if own is None:
            own = _engine_device(signal)
        if own is None:
            # a standalone signal renders on the Renderer's device
            signal._set_device(default_device(device))
        else:
            if device is not None and not same_device(device, own):
                raise ValueError(f"the signal renders on {own}, not on {device}")
            if signal.device is None:
                # a wrapper chain around an engine renders on the engine's
                signal._set_device(own)
        self.signal = self._step_sig = signal
        self.rate = int(rate)
        # lib.rs:91: interval = 1.0 / sample_rate as f32
        self.interval = np.float32(1.0) / np.float32(self.rate)
        self._init_steps(scan_unroll)
        #: optional dispatch-size quantisation, e.g. (188, 47, 12, 3, 1):
        #: equal-archetype runs split greedily into these lengths, as the
        #: JAX package splits them (None: one dispatch per run)
        self.scan_buckets = (
            tuple(sorted(scan_buckets, reverse=True)) if scan_buckets else None
        )
        #: device-resident engines sync handle-visible state (is_finished,
        #: slot reclamation) every `sync_every` render_block calls; the copy
        #: is prefetched one block early
        self.sync_every = int(sync_every)
        self._since_sync = 0
        #: dispatches by kind ("single", "scan", ("multi", nb)) — the
        #: counterpart of the JAX Renderer's compiled-step keys
        self.dispatch_counts = {}

    # the block-step protocol's three things: the signal's state, its
    # data and its render (``_step_sig``)
    def _step_get(self):
        return self.signal.device_collect()

    def _step_set(self, d):
        self.signal.device_store(d)

    def _step_data(self):
        return self.signal.device_data()

    def _count(self, kind, k=1):
        self.dispatch_counts[kind] = self.dispatch_counts.get(kind, 0) + k

    def _stepped(self):
        """Whether dispatches go through the block steps."""
        return getattr(self.signal, "graph_capture", False) and not eager_mode()

    def render_block(self, n, interval=None):
        """Render one block of ``n`` frames; returns float32 numpy (n, C)."""
        with span("render.call"):
            return self._render_block(n, interval)

    def _render_block(self, n, interval):
        sig = self.signal
        with span("render.prepare"):
            params = sig.host_prepare(self.interval if interval is None else f32(interval), n)
        self._count("single")
        if self._stepped():
            block = self._run_key(sig.archetype(), "single", [params], n)[0]
        else:
            d, block = sig.render(sig.device_collect(), sig.device_data(), params, n)
            sig.device_store(d)
            self.graph_counts["eager"] += 1
        sync = getattr(sig, "sync", None)
        if sync is not None and self.sync_every > 0:
            self._since_sync += 1
            if self._since_sync == self.sync_every - 1:
                prefetch = getattr(sig, "sync_prefetch", None)
                if prefetch is not None:
                    prefetch()
            elif self._since_sync >= self.sync_every:
                sync()
                self._since_sync = 0
        return block.cpu().numpy().T

    # -- op-by-op dispatch ------------------------------------------------------------

    def _dispatch_eager(self, pend, block_size):
        """A run of equal-archetype blocks op by op; returns (B, C, n)."""
        sig = self.signal
        d, dd = sig.device_collect(), sig.device_data()
        blocks = []
        for p in pend:
            d, blk = sig.render(d, dd, p, block_size)
            blocks.append(blk)
        sig.device_store(d)
        self.graph_counts["eager"] += len(pend)
        return torch.stack(blocks)

    def _dispatch_multi_eager(self, groups, nb, block_size):
        sig = self.signal
        d, dd = sig.device_collect(), sig.device_data()
        blocks = []
        for _ in range(groups):
            d, blk = sig.render_multi(d, dd, block_size, nb)
            blocks.append(blk)
        sig.device_store(d)
        self.graph_counts["eager"] += groups
        return torch.stack(blocks)

    def _dispatch(self, pend, arch, block_size, consume):
        """Render a run of prepared blocks of equal archetype: idle runs of
        at least MULTI_MIN_BLOCKS go as fused nb-block groups where the
        signal allows (``host_multiblock``), the rest block by block.  A
        signal that defines ``render_archetype`` (an engine, a wrapper
        root) renders the run as of its own archetype, stepped or op by
        op: the run is dispatched after the next block's prepare, whose
        flags its pools then hold, so a step is its key's."""
        ra = getattr(self.signal, "render_archetype", None)
        with (ra(arch) if ra is not None else contextlib.nullcontext()):
            self._dispatch_run(pend, arch, block_size, consume)

    def _dispatch_run(self, pend, arch, block_size, consume):
        sig = self.signal
        stepped = self._stepped()
        mb = getattr(sig, "host_multiblock", None)
        if (
            mb is not None and len(pend) >= MULTI_MIN_BLOCKS
            and not tree_leaves(pend[0])
        ):
            nb = mb(self.interval, block_size)
            if nb >= 2 and len(pend) >= nb:
                groups = len(pend) // nb
                if stepped:
                    out = self._run_key(arch, ("multi", nb), [None] * groups, block_size)
                else:
                    out = self._dispatch_multi_eager(groups, nb, block_size)
                self._count(("multi", nb), groups)
                consume(out)  # (groups, C, nb*block_size)
                pend = pend[groups * nb :]
                if not pend:
                    return
        kind = "single" if len(pend) == 1 else "scan"
        if stepped:
            out = self._run_key(arch, kind, pend, block_size)
        else:
            out = self._dispatch_eager(pend, block_size)
        self._count(kind)
        consume(out)

    def _run_blocks(self, nblocks, block_size, consume):
        """Prepare + dispatch ``nblocks`` blocks, grouping runs of equal
        archetype.  A run is dispatched BEFORE any prepare that will apply
        state eagerly (``host_structure_event``), so every block renders
        against the state that produced its parameters."""
        sig = self.signal
        pend = []
        pend_arch = None

        def flush():
            nonlocal pend, pend_arch
            if not pend:
                return
            segs = [pend]
            if self.scan_buckets and len(pend) > 1:
                # the JAX package's greedy split (core/run.py:231-247)
                segs, i = [], 0
                while i < len(pend):
                    for b in self.scan_buckets:
                        if b <= len(pend) - i:
                            segs.append(pend[i : i + b])
                            i += b
                            break
                    else:  # no bucket fits (buckets lack 1): take the rest
                        segs.append(pend[i:])
                        i = len(pend)
            arch = pend_arch
            pend, pend_arch = [], None
            for seg in segs:
                self._dispatch(seg, arch, block_size, consume)

        event = getattr(sig, "host_structure_event", None)
        bulk = getattr(sig, "host_idle_bulk", None)
        for bi in range(nblocks):
            if pend and event is not None and event():
                flush()
            with span("render.prepare"):
                p = sig.host_prepare(self.interval, block_size)
            a = sig.archetype()
            if pend and a != pend_arch:
                flush()
            pend.append(p)
            pend_arch = a
            # run-length idle path: a block that prepared EMPTY params on an
            # engine whose pools all pass the idle gate proves every
            # remaining block of this call is the same (the host is
            # single-threaded: no control traffic arrives mid-call), so
            # their host_prepare is skipped; they still render one by one
            remaining = nblocks - bi - 1
            if (remaining and bulk is not None and not tree_leaves(p)
                    and bulk(self.interval, block_size, remaining)):
                pend.extend([p] * remaining)
                break
        flush()

    def render_frames(self, total, block_size=512):
        """Offline render of ``total`` frames in fixed blocks; returns
        float32 numpy (total, C)."""
        with span("render.call"):
            return self._render_frames(total, block_size)

    def _render_frames(self, total, block_size):
        nblocks, rem = divmod(total, block_size)
        pieces = []

        def consume(blocks):
            out = blocks.cpu().numpy()  # (B, C, n), n may be nb*block_size
            pieces.append(
                np.moveaxis(out, 1, 2).reshape(
                    out.shape[0] * out.shape[2], out.shape[1]
                )
            )

        if nblocks:
            self._run_blocks(nblocks, block_size, consume)
        if rem:
            pieces.append(self._render_block(rem, None))
        # device-resident engines sync handle-visible state once per batch
        sync = getattr(self.signal, "sync", None)
        if sync is not None:
            sync()
            self._since_sync = 0
        return pieces[0] if len(pieces) == 1 else np.concatenate(pieces)

    def render_frames_device(self, total, block_size=512, sync=True):
        """Offline render of ``total`` frames (a multiple of ``block_size``)
        that keeps the audio on the device: returns a list of (B, C, n)
        tensors, one per dispatch, without any host transfer or wait.

        ``sync=True`` starts the handle-state readback asynchronously; the
        next ``signal.sync()`` or handle query applies it (freed slots are
        reclaimed then, not here).  ``sync=False`` skips it."""
        nblocks, rem = divmod(total, block_size)
        if rem:
            raise ValueError("total must be a multiple of block_size")
        out = []
        with span("render.call"):
            self._run_blocks(nblocks, block_size, out.append)
            if sync:
                prefetch = getattr(self.signal, "sync_prefetch", None)
                if prefetch is not None:
                    prefetch()
                    self._since_sync = 0
        return out


def run(signal, sample_rate, n, device=None):
    """Populate and return an (n, C) float32 block from ``signal``
    (oddio::run, lib.rs:90-93), rendered on ``device`` (the CUDA card
    unless given; an engine renders on its own); keeps a Renderer cached on
    the signal so repeated calls stream correctly."""
    key = "_renderer_%d" % int(sample_rate)
    r = getattr(signal, key, None)
    if r is None:
        r = Renderer(signal, sample_rate, device=device)
        setattr(signal, key, r)
    return r.render_block(n)
