"""Looping playback of static frames (counterpart of oddio_tpu/ops/cycle.py).

Reference: oddio's src/cycle.rs — loops ``Frames`` end-to-end with linear
interpolation across the seam (cycle.rs:26-53); ``Seek`` wraps the f64
cursor with ``rem_euclid`` (cycle.rs:56-60).

Like FramesSignal, the f64 sample cursor is host state in a host pool; the
device computes positions ``(base + trunc(offset0 + i*ds)) mod len`` and
reads the seam pair ``(data[x], data[(x+1) mod len])`` from the arena.  A
device-resident pool reads the sound's looped region (the data repeated
past one block's span, core/frames.py) with K6's arena form, one launch a
step (``stream_kernels.arena_step``: <= 512-frame chunks whose cursor
re-wraps ``mod len`` between them, and the cursor's end state) or a seek
read (``arena_warp``); past the step bound it takes the exact modulo
gather of the plain arena, as the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.drctrl import device_param
from ..core.frames import _arena, _lerp, _pool_ds_small
from ..core.hostmath import f32, f64, full, rem_euclid
from ..core.signal import Signal
from . import stream_kernels as SK
from ._dev import device_split_ds, exact_positions, split_ds, top12

__all__ = ["Cycle"]


def _mod_gather(arena, off, length, x):
    """The seam pair (arena[off + x], arena[off + (x+1) mod len])."""
    last = arena.shape[0] - 1
    a = arena[torch.clamp(off + x, 0, last).to(torch.int64)]
    b = arena[torch.clamp(off + torch.remainder(x + 1, length), 0, last).to(torch.int64)]
    return a, b


class Cycle(Signal):
    seekable = True
    _host_fields = ("cursor", "off", "length", "rate", "loff")
    #: its device-resident step is ``stream_kernels.arena_step``'s "cycle"
    arena_kind = "cycle"

    def __init__(self, frames):
        super().__init__()
        self.channels = frames.channels
        self._alloc_host(())
        self.off[()] = frames.offset
        self.length[()] = len(frames)
        self.rate[()] = frames._rate
        # looped (seam-replicated) region for the DR read
        self.loff[()] = frames.loop_off()[0] if frames.channels == 1 else 0

    def _alloc_host(self, batch):
        self.cursor = full(batch, 0.0, np.float64)
        self.off = full(batch, 0, np.int32)
        self.length = full(batch, 1, np.int32)
        self.rate = full(batch, 1.0, np.float64)
        self.loff = full(batch, 0, np.int32)

    def _arch_extra(self):
        return (self.channels,)

    def host_ds_bound(self, interval):
        return float(np.max(np.float32(interval) * self.rate.astype(np.float32)))

    def _params_from_cursor(self, cursor, interval):
        # cycle.rs:27-30: ds = interval * rate() as f32; base = cursor as usize
        ds = (f32(interval) * self.rate.astype(np.float32)).astype(np.float32)
        base = np.trunc(cursor)
        offset0 = (cursor - base).astype(np.float32)
        ds_int, f_hi, f_lo = split_ds(ds)
        return {
            "base": np.clip(base, 0, 2**30).astype(np.int32),
            "offset0": offset0,
            "ds_int": ds_int,
            "f_hi": f_hi,
            "f_lo": f_lo,
            "off": self.off.copy(),
            "length": self.length.copy(),
        }

    def host_prepare(self, interval, n, count=None):
        interval = np.broadcast_to(f32(interval), self.batch).astype(np.float32)
        params = self._params_from_cursor(self.cursor, interval)
        cnt = np.broadcast_to(f64(n if count is None else count), self.batch)
        ds64 = (params["ds_int"].astype(np.float64) + params["f_hi"].astype(np.float64)
                + params["f_lo"].astype(np.float64))
        length = self.length.astype(np.float64)
        # the reference's end-of-loop state: the last accessed position
        # reduced mod len (cycle.rs:40-47), plus one step
        pos_last = (params["base"].astype(np.float64) + params["offset0"].astype(np.float64)
                    + (cnt - 1.0) * ds64)
        adv = rem_euclid(pos_last, length) + ds64
        self.cursor = np.where(
            cnt > 0, adv, np.broadcast_to(np.asarray(self.cursor, np.float64), cnt.shape)
        )
        return params

    def host_params_at(self, tshift, interval, n):
        interval = np.broadcast_to(f32(interval), self.batch).astype(np.float32)
        cursor = rem_euclid(
            self.cursor + f32(tshift).astype(np.float64) * self.rate,
            self.length.astype(np.float64),
        )
        return self._params_from_cursor(np.broadcast_to(cursor, self.batch), interval)

    def host_seek(self, seconds):
        """cycle.rs:56-60."""
        self.cursor = rem_euclid(
            self.cursor + f32(seconds).astype(np.float64) * self.rate,
            self.length.astype(np.float64),
        )

    def _own_device_data(self):
        d = {"arena": _arena(self.channels).device(self.device)}
        if self.channels == 1:
            d["garena"] = _arena(1).device_rows(self.device)
        return d

    def render_host(self, dstate, ddata, params, n):
        col = {k: device_param(params[k], self.device)
               for k in ("base", "offset0", "ds_int", "f_hi", "f_lo", "off", "length")}
        tr, fr = exact_positions(col["offset0"], col["ds_int"], col["f_hi"], col["f_lo"], n)
        length = col["length"][:, None]
        x = torch.remainder(col["base"][:, None] + tr, length)
        arena = ddata["arena"]
        a, b = _mod_gather(arena, col["off"][:, None], length, x)
        if arena.dim() == 1:
            return dstate, _lerp(a, b, fr)[:, None, :]
        return dstate, _lerp(a, b, fr[..., None]).permute(0, 2, 1)

    # -- device-resident mode ------------------------------------------------

    def dr_supported(self):
        return self.channels == 1

    def dr_state_init(self, V):
        return {
            "base": np.zeros(V, np.int32),
            "frac": np.zeros(V, np.float32),
            "off": np.zeros(V, np.int32),
            "loff": np.zeros(V, np.int32),
            "length": np.ones(V, np.int32),
            "rate": np.ones(V, np.float32),
            "r_hi": np.ones(V, np.float32),
            "ds_int": np.ones(V, np.int32),
            "f_hi": np.zeros(V, np.float32),
            "f_lo": np.zeros(V, np.float32),
        }

    def dr_slot_row(self, interval):
        ds = np.float32(np.float32(interval) * self.rate.astype(np.float32))
        ds_int, f_hi, f_lo = split_ds(ds)
        base = np.trunc(self.cursor)
        return {
            "base": np.int32(np.clip(base, 0, 2**30)),
            "frac": np.float32(self.cursor - base),
            "off": np.int32(self.off[()]),
            "loff": np.int32(self.loff[()]),
            "length": np.int32(self.length[()]),
            "rate": np.float32(self.rate[()]),
            "r_hi": top12(self.rate[()]),
            "ds_int": np.int32(ds_int),
            "f_hi": np.float32(f_hi),
            "f_lo": np.float32(f_lo),
        }

    def dr_render(self, state, ddata, interval, n, count):
        if _pool_ds_small(self):
            # the whole step in one launch: the looped region (data repeated
            # past the seam, so no <= 512-frame chunk's walk nor its seam
            # pair, cycle.rs:34-47, wraps; the cursor re-wraps mod len
            # between chunks) and the cursor's end state
            return SK.arena_step(ddata["garena"], "cycle", state, interval, n, count)
        split = SK.step_split("cycle", state, interval)
        tr, fr = exact_positions(state["frac"], *split, n)
        length = state["length"][:, None]
        x = torch.remainder(state["base"][:, None] + tr, length)
        a, b = _mod_gather(ddata["arena"], state["off"][:, None], length, x)
        # the cursor's end state as the host path's: the position of the
        # last frame reduced mod len, plus one step (cycle.rs:40-47)
        return SK.cycle_release(state, split, count), _lerp(a, b, fr)

    def dr_is_finished(self, state):
        b = state["base"]
        return torch.zeros(b.shape, dtype=torch.bool, device=b.device)

    # -- device-resident Seek mode (cycle.rs:56-60) -----------------------------
    # Cursor shifts wrap rem_euclid; positions ride the looped region so the
    # warped in-block walk never wraps.

    def dr_advance(self, state, seconds):
        t = torch.full(state["base"].shape + (1,), float(np.float32(seconds)),
                       dtype=torch.float32, device=state["base"].device)
        base2, o0 = SK.cycle_warp_cursor(state, t)
        out = dict(state)
        out["base"], out["frac"] = base2[:, 0], o0[:, 0]
        return out

    def dr_seek_supported(self):
        return (
            self.channels == 1
            and type(self).host_is_finished is Signal.host_is_finished
        )

    def dr_warp_render(self, state, ddata, t0, dt, n):
        if _pool_ds_small(self):
            return SK.arena_warp(ddata["garena"], "cycle", state, t0, dt, n)
        # heavy downsampling: exact mod-length arena gather
        base2, o0 = SK.cycle_warp_cursor(state, t0)
        ds_int, f_hi, f_lo = device_split_ds(dt * state["rate"][:, None])
        tr, fr = exact_positions(o0, ds_int, f_hi, f_lo, n)
        length = state["length"][:, None, None]
        x = torch.remainder(base2[:, :, None] + tr, length)
        a, b = _mod_gather(ddata["arena"], state["off"][:, None, None], length, x)
        return _lerp(a, b, fr)
