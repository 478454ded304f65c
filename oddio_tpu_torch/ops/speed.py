"""Playback-rate scaling (counterpart of oddio_tpu/ops/speed.py).

Reference: oddio's src/speed.rs — multiplies the ``interval`` passed to
the inner signal by a dynamically adjustable factor (speed.rs:32-36),
un-smoothed.  On the host the interval is a per-voice array, so this is a
transform of the parameter flow; in a device-resident pool the factor is a
state column (``set_speed`` ships as a sparse delta) and the inner chain
re-derives its per-frame step from the per-voice warped interval each
block.  Over a FramesSignal or a Cycle on the arena route (``arena_chain``)
the innermost factor goes into the leaf's one-launch step
(``stream_kernels.arena_step``) instead of a torch product.  A Speed over a Stream is not device-resident capable (it warps the
timebase the stream's ingest mirrors follow, ``dr_ingest_ok``): it plays in
the host pools.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.frames import _pool_ds_small
from ..core.hostmath import f32, full
from ..core.signal import ControlBlock, Signal
from . import stream_kernels as SK

__all__ = ["Speed", "SpeedControl", "arena_chain", "chain_operands", "chain_state"]


def arena_chain(sig):
    """``(k, leaf)`` where ``sig`` is a chain of k >= 0 Speeds over a
    FramesSignal or a Cycle whose pool reads K6's arena form (the pool's
    archetype and step route, stamped by core/drctrl.py), so that one
    ``stream_kernels.arena_step`` launch is its whole step; else None."""
    k = 0
    while isinstance(sig, Speed):
        sig, k = sig.inner, k + 1
    if getattr(sig, "arena_kind", None) is None or not _pool_ds_small(sig):
        return None
    return k, sig


def chain_operands(k, state, ddata, interval):
    """A k-Speed chain's leaf state and data, and the interval and factor
    the kernel multiplies (speed.rs:32-36): the outer k - 1 factors applied
    here as the chain of ``Speed.dr_render``s applies them, the innermost
    handed to the kernel."""
    speed = None
    for _ in range(k):
        interval = SK.warped_interval(interval, speed)
        speed, state, ddata = state["speed"], state["inner"], ddata.get("inner", {})
    return state, ddata, interval, speed


def chain_state(k, state, leaf):
    """The chain's state with its leaf's replaced by ``leaf``."""
    if k == 0:
        return leaf
    return {"speed": state["speed"], "inner": chain_state(k - 1, state["inner"], leaf)}


class Speed(Signal):
    _host_fields = ("speed",)

    def __init__(self, signal):
        super().__init__()
        self.inner = signal
        self.channels = signal.channels
        self._alloc_host(())
        self.speed[()] = 1.0
        self._cb = ControlBlock(self)
        self.control = SpeedControl(self._cb)

    @classmethod
    def new(cls, signal):
        sig = cls(signal)
        return sig.control, sig

    def children(self):
        return {"inner": self.inner}

    def _alloc_host(self, batch):
        self.speed = full(batch, 1.0)

    def host_prepare(self, interval, n, count=None):
        interval = np.broadcast_to(f32(interval), self.batch).astype(np.float32)
        # speed.rs:32-36: inner.sample(interval * speed, out)
        return {
            "inner": self.inner.host_prepare(
                (interval * self.speed).astype(np.float32), n, count
            )
        }

    def host_is_finished(self):
        return self.inner.host_is_finished()

    def render_host(self, dstate, ddata, params, n):
        d2, block = self.inner.render_host(
            dstate.get("inner", {}), ddata.get("inner", {}), params["inner"], n
        )
        out = dict(dstate)
        out["inner"] = d2
        return out, block

    # -- device-resident mode ------------------------------------------------

    _dr_ctrl_fields = ("speed",)
    _dr_ds_fields = ("speed",)

    def host_ds_bound(self, interval):
        return self.inner.host_ds_bound(
            interval * abs(float(np.float32(self.speed[()])))
        )

    def host_ema_bound(self, interval):
        # the factor warps the inner timebase (speed.rs:32-36), so inner
        # Adapt alphas see the scaled interval
        return self.inner.host_ema_bound(
            interval * abs(float(np.float32(self.speed[()])))
        )

    def dr_supported(self):
        return self.inner.dr_supported()

    def dr_state_init(self, V):
        return {
            "speed": np.ones(V, np.float32),
            "inner": self.inner.dr_state_init(V),
        }

    def dr_slot_row(self, interval):
        return {
            "speed": np.float32(self.speed[()]),
            # the row encodes position state at the unwarped interval; the
            # warped step is re-derived on the device every block
            "inner": self.inner.dr_slot_row(interval),
        }

    def dr_render(self, state, ddata, interval, n, count):
        chain = arena_chain(self)
        if chain is not None:  # the whole chain's step is one launch
            k, leaf = chain
            ls, ld, iv, sp = chain_operands(k, state, ddata, interval)
            ls2, samples = SK.arena_step(ld["garena"], leaf.arena_kind, ls, iv, n, count,
                                         channels=leaf.channels, speed=sp)
            return chain_state(k, state, ls2), samples
        if isinstance(interval, torch.Tensor):
            warped = interval * state["speed"]
        else:
            warped = state["speed"] * float(np.float32(interval))
        d2, samples = self.inner.dr_render(
            state["inner"], ddata.get("inner", {}), warped, n, count
        )
        return {"speed": state["speed"], "inner": d2}, samples

    def dr_is_finished(self, state):
        return self.inner.dr_is_finished(state["inner"])


class SpeedControl:
    """speed.rs:44-55."""

    def __init__(self, cb):
        self._cb = cb

    def speed(self):
        return self._cb.get("speed", np.float32(1.0))

    def set_speed(self, factor):
        self._cb.set("speed", f32(factor))
