"""The core Signal protocol (counterpart of oddio_tpu/core/signal.py).

Reference: oddio's src/signal.rs:14-28 defines oddio's pull-based
``Signal`` trait.  As in the JAX package, a Signal here is a *template*
with three separated aspects:

* **host state** — small numpy arrays (shape = ``batch``) advanced once per
  block by ``host_prepare`` with the reference's exact arithmetic; control
  handles write them and the device observes the result at the next block.
* **device state** — a dict of torch tensors on the engine's device (delay
  rings, playback cursors), keyed exactly like the JAX package's pytrees.
* **render** — ``(dstate, ddata, params, n) -> (dstate', block)`` on
  tensors, channels-first ``(C, n)``.

Device-resident (``dr_*``) sources keep their whole playback state on the
device; engines then ship only sparse control deltas.  Streams carry a
per-block host->device ingest channel through the chain (``dr_ingest_*``,
routed through interval-preserving wrappers such as Adapt).  Host pools
hold a *batched* template (``clone_batched``): plays copy a spec's host
state into its slot (``write_slot``, ``device_reset_slot``) and a block
renders every slot at once (``render_host``, the counterpart of the JAX
package's ``jax.vmap(sig.render)``).  A standalone signal's ``render`` is
the one-voice case of the same code.  Faders take a pooled two-bank form
in host pools and a bank-bit form with the pools' fade lanes in
device-resident ones (ops/fader.py, core/drctrl.py).

Tensors live on the node's ``device``: a pool stamps its own on the batched
template, a ``Renderer`` the one it drives a standalone signal on.  With no
device given, the port runs on the CUDA card (``default_device``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.tree import tree_map

__all__ = ["Signal", "Engine", "ControlBlock", "default_device", "same_device"]


def default_device(device=None):
    """``device`` as a ``torch.device``; None means the CUDA card.  Without
    a card, None raises: the port never carries on quietly on the CPU, and
    a caller that wants the CPU (the tests) asks for it."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "oddio_tpu_torch runs on the CUDA card by default and "
            "torch.cuda.is_available() is false; pass device='cpu' to "
            "render on the CPU"
        )
    return torch.device("cuda")


def same_device(a, b):
    """Whether two device specs name the same device (``cuda`` is card 0)."""
    a, b = torch.device(a), torch.device(b)
    return a.type == b.type and (a.index or 0) == (b.index or 0)


class ControlBlock:
    """Routes control-handle writes to wherever a signal's host state lives
    (oddio's per-filter cross-thread cells).  Inside a device-resident pool
    writes become sparse control deltas, and the spec's own host field
    doubles as the handle-readable mirror."""

    def __init__(self, sig):
        self.sig = sig
        self._own = sig  # the signal whose handle this is
        self.idx = ()  # () indexes the 0-d arrays of a standalone signal
        self.pool = None
        self.gen = 0
        self._dr = None  # (pool, slot, gen, path) when in a DR pool

    def __getstate__(self):
        """A copy (pickled in a checkpoint) is detached: it routes to its
        own signal's fields, never into an engine's pools."""
        state = dict(self.__dict__)
        state.update(sig=self._own, idx=(), pool=None, gen=0, _dr=None)
        return state

    def rebind(self, sig, idx, pool, gen):
        """Point the handle's host fields at column ``idx`` of a batched
        signal (a stream pool's host mirror columns)."""
        self.sig = sig
        self.idx = idx
        self.pool = pool
        self.gen = gen

    def rebind_dr(self, pool, slot, gen, path):
        self._dr = (pool, slot, gen, path)

    def live(self):
        if self._dr is not None:
            pool, slot, gen, _ = self._dr
            return pool.slot_gen[slot] == gen
        return self.pool is None or self.pool.slot_gen[self.idx] == self.gen

    def _flush_sig(self):
        # stream mirrors may carry deferred idle ticks: replay them before
        # any handle read or write of a host field
        flush = getattr(self.sig, "_flush_tick_debt", None)
        if flush is not None:
            flush()

    def set(self, field, value):
        self._flush_sig()
        if self._dr is not None:
            pool, slot, gen, path = self._dr
            # like the reference's orphaned Arc'd atomics (gain.rs:130-139):
            # set-after-death still updates the mirror; only the device
            # delta is skipped when stale
            getattr(self.sig, field)[self.idx] = value  # handle mirror
            if pool.slot_gen[slot] == gen:
                pool.push_ctrl(path, field, slot, value)
            return
        if self.live():
            getattr(self.sig, field)[self.idx] = value

    def get(self, field, default=None):
        self._flush_sig()
        if self._dr is not None or self.live():
            return getattr(self.sig, field)[self.idx]
        return default


class Signal:
    """Base class for all signal templates."""

    #: number of output channels (1 = mono)
    channels = 1
    #: whether the signal supports deterministic time-shifted evaluation
    #: (oddio's ``Seek``, signal.rs:48-58)
    seekable = False
    #: device of this node's tensors (set on the whole chain by
    #: ``_set_device``: the pool's device, or the driving Renderer's)
    device = None

    def __init__(self):
        self.batch = ()
        self._moved = False  # set when played into an engine (Rust move semantics)
        self._dev = None  # this node's own device-state leaves

    # -- structure ---------------------------------------------------------

    def children(self):
        """Ordered mapping name -> child Signal."""
        return {}

    def _arch_extra(self):
        """Static config beyond channels, e.g. buffer sizes."""
        return ()

    def archetype(self):
        """Hashable structural key; equal archetypes can share a pool."""
        kids = tuple((k, c.archetype()) for k, c in self.children().items())
        return (type(self).__qualname__, self.channels, self._arch_extra(), kids)

    def host_batchable(self):
        """Whether this chain can stack into a multi-voice pool.  Engines
        themselves (SpatialScene) cannot."""
        return all(c.host_batchable() for c in self.children().values())

    # -- host state lifecycle -------------------------------------------------

    #: names of numpy host-state attributes, each shaped ``batch + extra``
    _host_fields = ()

    def _alloc_host(self, batch):
        """Allocate default host-state arrays for ``batch``.  Per-class."""
        raise NotImplementedError

    def _set_device(self, device):
        """Place this chain's tensors on ``device`` (before its first
        render)."""
        self.device = torch.device(device)
        for c in self.children().values():
            c._set_device(device)

    def clone_batched(self, V):
        """A batched (pool) template with the same structure: a host pool's
        voice columns, or the host mirrors of a device-resident stream
        pool."""
        new = object.__new__(type(self))
        Signal.__init__(new)
        new.batch = (V,)
        new.device = self.device
        new.channels = self.channels
        new._copy_static_from(self)
        new._alloc_host((V,))
        for k, c in self.children().items():
            setattr(new, k, c.clone_batched(V))
        return new

    def _copy_static_from(self, other):
        """Copy static (archetype-level) config when cloning.  Per-class."""

    def write_slot(self, i, spec, pool, gen):
        """Copy ``spec``'s (batch ()) host state into slot ``i`` of this
        batched template and rebind its controls (oddio's move of the
        signal into the Set)."""
        if spec._moved:
            raise RuntimeError("signal was already played (moved); construct a new one")
        spec._moved = True  # the recursion marks every node
        for f in self._host_fields:
            v = getattr(spec, f)
            getattr(self, f)[i] = v[()] if v.ndim == 0 else v
        cb = getattr(spec, "_cb", None)
        if cb is not None:
            cb.rebind(self, i, pool, gen)
        for mine, theirs in zip(self.children().values(), spec.children().values()):
            mine.write_slot(i, theirs, pool, gen)

    def grow_batched(self, new_V):
        """Grow this batched template in place (set.rs:57-63): host columns
        and, once allocated, its device leaves.  ControlBlocks stay valid
        because they reference the signal object, not the arrays.  Device
        state of DR pools grows with the pool."""
        add = new_V - self.batch[0]
        fresh = self.clone_batched(add)
        for f in self._host_fields:
            setattr(self, f, np.concatenate([getattr(self, f), getattr(fresh, f)]))
        if self._dev is not None:
            fresh_dev = fresh._own_device_init()
            self._dev = {
                k: torch.cat([v, fresh_dev[k]]) for k, v in self._dev.items()
            }
        for c in self.children().values():
            c.grow_batched(new_V)
        self.batch = (new_V,)

    # -- host per-block protocol ---------------------------------------------

    def host_prepare(self, interval, n, count=None):
        """Compute per-block device parameters and advance host state.
        Returns a dict of numpy arrays shaped ``batch + (...)``."""
        return {}

    def host_params_at(self, tshift, interval, n):
        """Parameters for a time-shifted, rate-warped read that does NOT
        advance host state.  Only for ``seekable`` signals."""
        raise NotImplementedError(f"{type(self).__name__} is not seekable")

    def host_seek(self, seconds):
        raise NotImplementedError(f"{type(self).__name__} is not seekable")

    def seek(self, seconds):
        """Public Seek API (signal.rs:48-58)."""
        if not self.seekable:
            raise NotImplementedError(f"{type(self).__name__} is not seekable")
        self.host_seek(seconds)

    def host_is_finished(self):
        """Per-voice finished flags (signal.rs:21-27), from host state."""
        return np.zeros(self.batch, dtype=bool)

    def host_structure_event(self):
        """True when the NEXT host_prepare applies state eagerly outside the
        per-block step; block-batching renderers dispatch first."""
        return any(c.host_structure_event() for c in self.children().values())

    # -- device state ---------------------------------------------------------

    def _own_device_init(self):
        """This node's own device-state leaves (tensors on ``device``,
        shapes including the batch)."""
        return {}

    def _own_slot_init(self, i):
        """Numpy row values that reset this node's own leaves at slot ``i``."""
        return {}

    def _own_device_data(self):
        """This node's read-only shared device tensors."""
        return {}

    def device_collect(self):
        if self._dev is None:
            self._dev = self._own_device_init()
        d = dict(self._dev)
        for k, c in self.children().items():
            d[k] = c.device_collect()
        return d

    def device_store(self, d):
        kids = self.children()
        self._dev = {k: v for k, v in d.items() if k not in kids}
        for k, c in kids.items():
            if k in d:
                c.device_store(d[k])

    def device_reset_slot(self, i):
        """Reset this chain's device leaves at pool slot ``i`` after a play,
        in place."""
        if self._dev is None:
            self._dev = self._own_device_init()
        for k, v in self._own_slot_init(i).items():
            leaf = self._dev[k]
            leaf[i] = torch.as_tensor(np.asarray(v), dtype=leaf.dtype).to(leaf.device)
        for c in self.children().values():
            c.device_reset_slot(i)

    def device_data(self):
        d = dict(self._own_device_data())
        for k, c in self.children().items():
            sub = c.device_data()
            if sub:
                d[k] = sub
        return d

    # -- device-resident (dr) mode ---------------------------------------------

    #: host-field names a control handle may write while the signal lives in
    #: a device-resident pool (sparse control deltas, core/drctrl.py)
    _dr_ctrl_fields = ()

    #: subset of _dr_ctrl_fields whose writes change how fast a sampler in
    #: the chain steps through its source; DR pools watching these
    #: re-derive their step bound (host_ds_bound)
    _dr_ds_fields = ()

    def host_ds_bound(self, interval):
        """Upper bound on the per-frame source step (samples/frame) of any
        sampler in this chain at ``interval`` seconds/frame, from the
        chain's current control mirrors.  DR pools use it to route stream
        reads through the resample kernel (ds <= RESAMPLE_DSMAX)."""
        return max(
            (c.host_ds_bound(interval) for c in self.children().values()),
            default=0.0,
        )

    def host_ema_bound(self, interval):
        """Upper bound on interval/tau over any Adapt in this chain; DR
        pools gate the closed-form AGC kernel on it (ops/agc.py)."""
        return max(
            (c.host_ema_bound(interval) for c in self.children().values()),
            default=0.0,
        )

    def dr_supported(self):
        return False

    def dr_needs_ingest(self):
        """Whether this chain needs a per-block host->device data channel
        while device-resident (Stream PCM ingest)."""
        return any(c.dr_needs_ingest() for c in self.children().values())

    #: True on wrappers whose ``dr_render`` passes (interval, n, count)
    #: unchanged to a single, structurally fixed child (Adapt): the
    #: condition for routing a pool's ingest channel through the node
    _dr_ingest_transparent = False

    def dr_ingest_ok(self):
        """True when a DR pool may take this chain with its ingest channel:
        at most one ingest-needing subtree, and every wrapper on the path to
        it interval-preserving.  Chains this rejects (Speed/Fader over a
        Stream) take the host pools."""
        ing = [c for c in self.children().values() if c.dr_needs_ingest()]
        if not ing:
            return True
        return (
            len(ing) == 1
            and self._dr_ingest_transparent
            and ing[0].dr_ingest_ok()
        )

    # Ingest plumbing: pools call these on the BATCHED proto chain; the
    # generic forms route through transparent wrappers to the Stream leaf,
    # which overrides them with the real channel logic.

    def dr_ingest_params(self):
        """Drain producer queues into this block's ingest chunk (or None)."""
        for c in self.children().values():
            if c.dr_needs_ingest():
                return c.dr_ingest_params()
        return None

    def dr_host_tick(self, interval, counts):
        """Advance host cursor mirrors by ``counts`` consumed frames."""
        for c in self.children().values():
            if c.dr_needs_ingest():
                c.dr_host_tick(interval, counts)

    def dr_ingest(self, state, ing):
        """Place the shipped chunk at the leaf's device write cursors,
        routed through the chain's state tree."""
        out = dict(state)
        for k, c in self.children().items():
            if c.dr_needs_ingest():
                out[k] = c.dr_ingest(state[k], ing)
        return out

    def dr_bind_slot(self, i, spec, pool, gen):
        """Adopt a played spec's host mirrors into slot ``i`` of this
        BATCHED proto chain; the Stream leaf overrides it."""
        for mine, theirs in zip(
            self.children().values(), spec.children().values()
        ):
            mine.dr_bind_slot(i, theirs, pool, gen)

    def dr_state_init(self, V):
        """Benign default device state for V slots (numpy tree)."""
        raise NotImplementedError

    def dr_slot_row(self, interval):
        """Row values (numpy tree, unbatched) encoding THIS spec's current
        host state for a play() into a dr pool sampled at ``interval``."""
        raise NotImplementedError

    def dr_default_row(self, interval):
        """Benign padding row, same tree structure as ``dr_slot_row``."""
        kids = self.children()
        row = {
            k: tree_map(lambda x: np.asarray(x[0]), v)
            for k, v in self.dr_state_init(1).items()
            if k not in kids
        }
        for k, c in kids.items():
            row[k] = c.dr_default_row(interval)
        return row

    def dr_render(self, state, ddata, interval, n, count):
        """Batched render: (state', samples (V, n)) advancing each voice by
        ``count`` (V,) frames at static ``interval`` seconds/frame."""
        raise NotImplementedError

    def dr_is_finished(self, state):
        leaf = next(iter(state.values()))
        return torch.zeros(leaf.shape[0], dtype=torch.bool, device=leaf.device)

    # -- device-resident Seek mode ----------------------------------------------

    def dr_seek_supported(self):
        return False

    def dr_warp_render(self, state, ddata, t0, dt, n):
        """Positional render for the DR seek path: ``n`` frames at source
        times ``cursor + t0 + j*dt`` for each of E reads (``t0``, ``dt``
        shaped (V, E)).  Returns samples (V, E, n); does NOT advance."""
        raise NotImplementedError

    def dr_advance(self, state, seconds):
        """Advance playback cursors by scalar ``seconds`` (spatial.rs:468)."""
        return state

    # -- device render ---------------------------------------------------------

    def render_host(self, dstate, ddata, params, n):
        """Batched render of a host pool's template: ``dstate`` holds its
        device leaves (leading axis V, on ``device``), ``params`` the numpy
        output of ``host_prepare`` (batch (V,)).  The counterpart of the
        JAX package's ``jax.vmap(sig.render)``; returns ``(dstate', (V, C,
        n))`` float32."""
        raise NotImplementedError(f"{type(self).__name__} has no batched render")

    def render(self, dstate, ddata, params, n):
        """Standalone render of a batch () signal, the one-voice case of
        ``render_host``.  Returns ``(dstate', block)`` with block ``(C, n)``
        float32."""
        d2, block = self.render_host(
            tree_map(lambda x: x[None], dstate), ddata,
            tree_map(lambda x: np.asarray(x)[None], params), n,
        )
        return tree_map(lambda x: x[0], d2), block[0]


class Engine(Signal):
    """A Signal that owns pools of voices (Mixer, SpatialScene).  It is
    built on its device and never stacks into a batched pool: played into
    another engine it is one voice (a submix, in a singleton pool), and
    under a wrapper (an Adapt over a Mixer) it renders as the one voice of
    the wrapper's standalone path."""

    #: set by a ScenePack on a submix's engine whose sibling scenes' engines
    #: ship control deltas this block (the scenes themselves take
    #: ``host_prepare``'s ``force``), so that every scene ships them
    _pack_force = False

    def host_batchable(self):
        return False

    def _set_device(self, device):
        """An engine keeps the device it was built on."""
        if not same_device(device, self.device):
            raise ValueError(f"the engine renders on {self.device}, not on {device}")

    def render_host(self, dstate, ddata, params, n):
        """The one-voice case a wrapper's standalone render hands down:
        drop the voice axis the wrapper added, render, put it back.  In a
        ScenePack the wrapper's S rows are the S scenes this engine renders
        stacked (``parallel.sharded``), so the state and params pass as
        they are."""
        from ..parallel.context import current_scenes

        if current_scenes() is not None:
            return self.render(dstate, ddata, params, n)
        d2, block = self.render(
            tree_map(lambda x: x[0], dstate), ddata,
            tree_map(lambda x: x[0], params), n,
        )
        return tree_map(lambda x: x[None], d2), block[None]
