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
device; engines then ship only sparse control deltas.  Streams, host pools
and fades are not in this package yet (ROADMAP P2.4, P3, P4), so the ingest
and slot-reset plumbing of the JAX base class has no counterpart here.
"""

from __future__ import annotations

import numpy as np

from ..utils.tree import tree_map

__all__ = ["Signal", "ControlBlock"]


class ControlBlock:
    """Routes control-handle writes to wherever a signal's host state lives
    (oddio's per-filter cross-thread cells).  Inside a device-resident pool
    writes become sparse control deltas, and the spec's own host field
    doubles as the handle-readable mirror."""

    def __init__(self, sig):
        self.sig = sig
        self.idx = ()  # () indexes the 0-d arrays of a standalone signal
        self._dr = None  # (pool, slot, gen, path) when in a DR pool

    def rebind_dr(self, pool, slot, gen, path):
        self._dr = (pool, slot, gen, path)

    def live(self):
        if self._dr is not None:
            pool, slot, gen, _ = self._dr
            return pool.slot_gen[slot] == gen
        return True

    def set(self, field, value):
        getattr(self.sig, field)[self.idx] = value  # handle mirror
        if self._dr is not None:
            pool, slot, gen, path = self._dr
            # like the reference's orphaned Arc'd atomics (gain.rs:130-139):
            # set-after-death still updates the mirror; only the device
            # delta is skipped when stale
            if pool.slot_gen[slot] == gen:
                pool.push_ctrl(path, field, slot, value)

    def get(self, field, default=None):
        return getattr(self.sig, field)[self.idx]


class Signal:
    """Base class for all signal templates."""

    #: number of output channels (1 = mono)
    channels = 1
    #: whether the signal supports deterministic time-shifted evaluation
    #: (oddio's ``Seek``, signal.rs:48-58)
    seekable = False

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
        """This node's own device-state leaves (tensors)."""
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

    def dr_supported(self):
        return False

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
        import torch

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

    def render(self, dstate, ddata, params, n):
        """Returns ``(dstate', block)`` with block ``(C, n)`` float32."""
        raise NotImplementedError
