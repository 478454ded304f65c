"""Fixed and smoothed dynamic gain (counterpart of oddio_tpu/ops/gain.py).

Reference: oddio's src/gain.rs — ``FixedGain`` (gain.rs:9-51) scales by a
constant factor derived from decibels; ``Gain`` (gain.rs:58-127) follows a
shared control value with a 0.1 s linear ramp (``SMOOTHING_PERIOD``,
gain.rs:163) driven by the ``Smoothed`` helper (smooth.rs:26-78).

The ramp state (prev, next, progress) is host state in a host pool and
device state in a device-resident one; each block applies ``gain_i = prev
+ min(progress0 + i*inc, 1) * (next - prev)``, the closed form of the
reference's per-frame advance (gain.rs:118-121, smooth.rs:47-49), in the
JAX package's f32 operation order.  A handle's ``set_gain`` writes the
``shared`` field: a host column, or a sparse delta lane of a
device-resident pool (core/drctrl.py) with the ramp restart
(gain.rs:105-108) on the device at the next block.  Both gains pass the
block's interval and count to their one child unchanged, so a pool takes
``Gain(Stream)`` with its ingest channel (``dr_ingest_ok``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.drctrl import device_param
from ..core.hostmath import f32, full
from ..core.signal import ControlBlock, Signal

__all__ = ["FixedGain", "Gain", "GainControl"]

#: gain.rs:163 — seconds over which to smooth a change in gain
SMOOTHING_PERIOD = np.float32(0.1)


def _db_ratio(db):
    """gain.rs:18-23: 10^(db/20) in f32."""
    return np.power(f32(10.0), f32(db) / f32(20.0), dtype=np.float32)


def _frames(n, device):
    return torch.arange(n, dtype=torch.float32, device=device)


class FixedGain(Signal):
    """Constant gain in decibels; seekable when the inner signal is."""

    _dr_ingest_transparent = True
    _host_fields = ("gain",)

    def __init__(self, signal, db):
        super().__init__()
        self.inner = signal
        self.channels = signal.channels
        self.seekable = signal.seekable
        self._alloc_host(())
        self.gain[()] = _db_ratio(db)

    @classmethod
    def new(cls, signal, db):
        return cls(signal, db)

    def children(self):
        return {"inner": self.inner}

    def _alloc_host(self, batch):
        self.gain = full(batch, 1.0)

    def _copy_static_from(self, other):
        self.seekable = other.seekable

    def host_prepare(self, interval, n, count=None):
        return {
            "gain": self.gain.copy(),
            "inner": self.inner.host_prepare(interval, n, count),
        }

    def host_params_at(self, tshift, interval, n):
        return {
            "gain": self.gain.copy(),
            "inner": self.inner.host_params_at(tshift, interval, n),
        }

    def host_seek(self, seconds):
        self.inner.host_seek(seconds)

    def host_is_finished(self):
        return self.inner.host_is_finished()

    def render_host(self, dstate, ddata, params, n):
        d2, block = self.inner.render_host(
            dstate.get("inner", {}), ddata.get("inner", {}), params["inner"], n
        )
        g = device_param(params["gain"], block.device, torch.float32)
        out = dict(dstate)
        out["inner"] = d2
        return out, block * g[:, None, None]

    # -- device-resident mode ------------------------------------------------

    def dr_supported(self):
        return self.inner.dr_supported()

    def dr_state_init(self, V):
        return {
            "gain": np.ones(V, np.float32),
            "inner": self.inner.dr_state_init(V),
        }

    def dr_slot_row(self, interval):
        return {
            "gain": np.float32(self.gain[()]),
            "inner": self.inner.dr_slot_row(interval),
        }

    def dr_render(self, state, ddata, interval, n, count):
        d2, samples = self.inner.dr_render(
            state["inner"], ddata.get("inner", {}), interval, n, count
        )
        g = state["gain"].reshape((-1,) + (1,) * (samples.dim() - 1))
        return {"gain": state["gain"], "inner": d2}, samples * g

    def dr_is_finished(self, state):
        return self.inner.dr_is_finished(state["inner"])

    # -- device-resident Seek mode (gain.rs:44-51 forwards seek) ----------------

    def dr_seek_supported(self):
        return self.channels == 1 and self.inner.dr_seek_supported()

    def dr_warp_render(self, state, ddata, t0, dt, n):
        samples = self.inner.dr_warp_render(
            state["inner"], ddata.get("inner", {}), t0, dt, n
        )
        return samples * state["gain"][:, None, None]

    def dr_advance(self, state, seconds):
        return {
            "gain": state["gain"],
            "inner": self.inner.dr_advance(state["inner"], seconds),
        }


class Gain(Signal):
    """Dynamically controlled gain with 0.1 s smoothing (gain.rs:58-127)."""

    _dr_ingest_transparent = True
    _host_fields = ("shared", "prev", "next", "progress")

    def __init__(self, signal):
        super().__init__()
        self.inner = signal
        self.channels = signal.channels
        self._alloc_host(())
        self._cb = ControlBlock(self)
        self.control = GainControl(self._cb)

    @classmethod
    def new(cls, signal):
        sig = cls(signal)
        return sig.control, sig

    def children(self):
        return {"inner": self.inner}

    def _alloc_host(self, batch):
        self.shared = full(batch, 1.0)
        self.prev = full(batch, 1.0)
        self.next = full(batch, 1.0)
        self.progress = full(batch, 1.0)

    def set_gain(self, db):
        """Initial gain in dB; resets the ramp (gain.rs:76-83)."""
        self.set_amplitude_ratio(_db_ratio(db))

    def set_amplitude_ratio(self, factor):
        """gain.rs:90-93: store and reset Smoothed to the new value."""
        self.shared[...] = f32(factor)
        self.prev[...] = f32(factor)
        self.next[...] = f32(factor)
        self.progress[...] = 1.0

    def host_prepare(self, interval, n, count=None):
        interval = np.broadcast_to(f32(interval), self.batch).astype(np.float32)
        # gain.rs:105-108: notice a target change -> Smoothed::set (smooth.rs:57-64)
        changed = self.next != self.shared
        cur = (self.prev + self.progress * (self.next - self.prev)).astype(np.float32)
        self.prev = np.where(changed, cur, self.prev).astype(np.float32)
        self.next = np.where(changed, self.shared, self.next).astype(np.float32)
        self.progress = np.where(changed, np.float32(0.0), self.progress).astype(np.float32)
        inc = (interval / SMOOTHING_PERIOD).astype(np.float32)
        params = {
            "prev": self.prev.copy(),
            "next": self.next.copy(),
            "progress0": self.progress.copy(),
            "inc": inc,
            "inner": self.inner.host_prepare(interval, n, count),
        }
        cnt = np.broadcast_to(f32(n if count is None else count), self.batch)
        # closed form of gain.rs:118-121 / smooth.rs:47-49
        self.progress = np.minimum(
            (self.progress + cnt * inc).astype(np.float32), np.float32(1.0)
        )
        return params

    def host_is_finished(self):
        return self.inner.host_is_finished()

    def render_host(self, dstate, ddata, params, n):
        d2, block = self.inner.render_host(
            dstate.get("inner", {}), ddata.get("inner", {}), params["inner"], n
        )
        dev = block.device
        col = {k: device_param(params[k], dev, torch.float32)[:, None]
               for k in ("prev", "next", "progress0", "inc")}
        pr = torch.clamp_max(col["progress0"] + _frames(n, dev) * col["inc"], 1.0)
        gains = col["prev"] + pr * (col["next"] - col["prev"])
        out = dict(dstate)
        out["inner"] = d2
        return out, block * gains[:, None, :]

    # -- device-resident mode ------------------------------------------------
    # The whole Smoothed ramp (smooth.rs:26-78) lives on the device; a
    # handle's set_gain ships as a sparse delta into the ``shared`` leaf and
    # the ramp restart (gain.rs:105-108) happens there at the next block.

    _dr_ctrl_fields = ("shared",)

    def dr_supported(self):
        return self.inner.dr_supported()

    def dr_state_init(self, V):
        return {
            "shared": np.ones(V, np.float32),
            "prev": np.ones(V, np.float32),
            "next": np.ones(V, np.float32),
            "progress": np.ones(V, np.float32),
            "inner": self.inner.dr_state_init(V),
        }

    def dr_slot_row(self, interval):
        return {
            "shared": np.float32(self.shared[()]),
            "prev": np.float32(self.prev[()]),
            "next": np.float32(self.next[()]),
            "progress": np.float32(self.progress[()]),
            "inner": self.inner.dr_slot_row(interval),
        }

    def dr_render(self, state, ddata, interval, n, count):
        # gain.rs:105-108: notice a target change -> Smoothed::set
        shared, prev, nxt, prog = (
            state["shared"], state["prev"], state["next"], state["progress"]
        )
        changed = nxt != shared
        cur = prev + prog * (nxt - prev)
        prev = torch.where(changed, cur, prev)
        nxt = torch.where(changed, shared, nxt)
        prog = torch.where(changed, 0.0, prog)
        if isinstance(interval, torch.Tensor):  # per voice, under Speed
            inc = interval / float(SMOOTHING_PERIOD)
            inc_c = inc[:, None]
        else:
            inc = inc_c = float(np.float32(interval) / SMOOTHING_PERIOD)
        d2, samples = self.inner.dr_render(
            state["inner"], ddata.get("inner", {}), interval, n, count
        )
        # closed form of gain.rs:118-121 / smooth.rs:47-49
        pr = torch.clamp_max(prog[:, None] + _frames(n, prog.device) * inc_c, 1.0)
        gains = prev[:, None] + pr * (nxt - prev)[:, None]
        if samples.dim() == 3:  # frame-generic chains (frame.rs:67-79)
            gains = gains[:, None, :]
        prog2 = torch.clamp_max(prog + count.to(torch.float32) * inc, 1.0)
        return {
            "shared": shared, "prev": prev, "next": nxt, "progress": prog2,
            "inner": d2,
        }, samples * gains

    def dr_is_finished(self, state):
        return self.inner.dr_is_finished(state["inner"])


class GainControl:
    """Thread-safe control for a Gain filter (gain.rs:130-160)."""

    def __init__(self, cb):
        self._cb = cb

    def gain(self):
        """Current amplification in decibels (gain.rs:133-136)."""
        return np.float32(20.0) * np.log10(self.amplitude_ratio(), dtype=np.float32)

    def set_gain(self, db):
        self.set_amplitude_ratio(_db_ratio(db))

    def amplitude_ratio(self):
        return self._cb.get("shared", np.float32(1.0))

    def set_amplitude_ratio(self, factor):
        self._cb.set("shared", f32(factor))
