"""Static audio storage and playback (counterpart of oddio_tpu/core/frames.py).

Reference: oddio's src/frames.rs — ``Frames<T>`` is an immutable,
rate-tagged sample array (frames.rs:19-124) and ``FramesSignal`` plays it
from an f64 cursor with linear interpolation and zero-padding outside the
range (frames.rs:141-214), publishing its playback position for the
control half (frames.rs:223-248).

All ``Frames`` data lives in a per-channel-count **arena**, one
concatenated f32 array, so that a pool of voices playing different sounds
reads one array: each voice carries an (offset, length) pair into it.  The
layout is the JAX package's exactly: a plain arena for the host render and
the heavy-downsampling gather, and the **guarded** arena ("garena") for
the device-resident reads, which starts with one zero row and holds each
sound's *guarded* regions (``ARENA_GUARD`` zeros, the data, zeros to the
next 256-sample row; channel c of a C-channel sound at ``goff +
c*guard_stride(len)``) and *looped* regions (the data repeated past one
block's span, for Cycle).  The arena lives in numpy on the host and in one
tensor per device, re-uploaded when a new sound is added, so a pool always
reads the current arena: ``device_data`` is collected anew for every
dispatch.

The host keeps the f64 cursor and ships a (base:int32, offset0:f32, ds
split) decomposition per block, bit-faithful to the reference's ``s0 =
t*rate; base = s0 as isize`` split (frames.rs:177-189).  A device-resident
pool keeps the same f64 time cursor ``t`` on the device (Hopper has f64),
advanced as the reference advances it (``t += f64(interval) * count``,
frames.rs:198) and split into the trunc-form (base, frac) each block
reads from; the JAX package advances its f32-split cursor by ``count *
ds`` instead, which drifts from the reference by the f32 rounding of the
step (ROADMAP Q3.5).  A step is one launch of K6's arena form
(``stream_kernels.arena_step``: the step split, the rows, the read in
<= 512-frame chunks and the cursor release), a seek pool's warped read one
``arena_warp``; where a pool's step bound passes ``RESAMPLE_DSMAX``
(``_pool_ds_small`` false, stamped by core/drctrl.py) it reads with the
exact whole-arena gather instead, as the JAX package does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import stream_kernels as SK
from ..ops._dev import device_split_ds, exact_positions, split_ds, top12
from .drctrl import device_param
from .hostmath import EPS32, f32, f64, full
from .signal import ControlBlock, Signal

__all__ = ["Frames", "FramesSignal", "FramesSignalControl"]


#: row granularity of the guarded arena, and the zero-guard length around
#: each guarded region (ops/stream_kernels.py, whose step kernel reads them)
ARENA_ROW, ARENA_GUARD = SK.ARENA_ROW, SK.ARENA_GUARD
#: maximum read span a looped region must cover past its cursor
_LOOP_SPAN = ARENA_GUARD


def _row_pad(k):
    return (-k) % ARENA_ROW


def guard_stride(length):
    """Samples between consecutive channels' guarded regions of one sound
    (a pure function of its length: off_c = guard_off + c *
    guard_stride(len))."""
    return 2 * ARENA_GUARD + length + _row_pad(length)


class _Arena:
    """Concatenated storage for all Frames with a given channel count: the
    plain arena and the guarded arena (see the module docstring), on the
    host, with one tensor copy per device made on first use after a
    change."""

    def __init__(self, channels):
        self.channels = channels
        self._chunks = []  # numpy pieces of the plain arena
        self._total = 0
        # one leading zero row so a cursor biased a sample before a
        # region's start still lies in the array
        self._gchunks = [np.zeros(ARENA_ROW, np.float32)]
        self._gtotal = ARENA_ROW
        self._dev = {}  # device -> plain arena tensor
        self._gdev = {}  # device -> guarded arena tensor (rows, 256)

    def add(self, data):
        off = self._total
        self._chunks.append(data)
        self._total += data.shape[0]
        self._dev = {}
        return off

    def add_guarded(self, data):
        """Returns the guarded-arena sample index of data[0]."""
        z = np.zeros(ARENA_GUARD, np.float32)
        tail = np.zeros(ARENA_GUARD + _row_pad(len(data)), np.float32)
        self._gchunks += [z, data, tail]
        off = self._gtotal + ARENA_GUARD
        self._gtotal += len(z) + len(data) + len(tail)
        self._gdev = {}
        return off

    def add_looped(self, data):
        """Returns (offset of data[0], region length in samples)."""
        copies = 1 + -(-(_LOOP_SPAN + 2) // max(len(data), 1))
        rep = np.tile(data, copies)
        pad = np.zeros(_row_pad(len(rep)), np.float32)
        off = self._gtotal
        self._gchunks += [rep, pad]
        self._gtotal += len(rep) + len(pad)
        self._gdev = {}
        return off, len(rep)

    def device(self, device):
        """The plain arena on ``device``: (len,) mono, (len, C) else."""
        key = str(torch.device(device))
        t = self._dev.get(key)
        if t is None:
            if not self._chunks:
                shape = (1,) if self.channels == 1 else (1, self.channels)
                host = np.zeros(shape, np.float32)
            else:
                host = np.concatenate(self._chunks, axis=0)
            t = self._dev[key] = torch.tensor(host, device=device)
        return t

    def device_rows(self, device):
        """The guarded arena on ``device`` as (rows, 256) f32."""
        key = str(torch.device(device))
        t = self._gdev.get(key)
        if t is None:
            flat = np.concatenate(self._gchunks)
            t = self._gdev[key] = torch.tensor(flat.reshape(-1, ARENA_ROW), device=device)
        return t


_ARENAS = {}


def _arena(channels):
    if channels not in _ARENAS:
        _ARENAS[channels] = _Arena(channels)
    return _ARENAS[channels]


class Frames:
    """A sequence of static audio frames at a particular sample rate
    (frames.rs:12-124).  ``data`` is float32, shape (len,) mono or (len, C)."""

    def __init__(self, rate, data):
        data = f32(data)
        self.channels = 1 if data.ndim == 1 else int(data.shape[1])
        self._rate = np.float64(rate)  # f64 like the header (frames.rs:20)
        self.data = data
        self.arena = _arena(self.channels)
        self.offset = self.arena.add(data)
        self._guard_off = None  # lazy guarded region (FramesSignal)
        self._loop_off = None  # lazy looped region (Cycle)

    def guard_off(self):
        """Guarded-region offset of channel 0; the other channels follow
        at ``guard_stride(len)``."""
        if self._guard_off is None:
            if self.channels == 1:
                self._guard_off = self.arena.add_guarded(self.data)
            else:
                offs = [
                    self.arena.add_guarded(np.ascontiguousarray(self.data[:, c]))
                    for c in range(self.channels)
                ]
                stride = guard_stride(len(self))
                assert all(offs[c] == offs[0] + c * stride for c in range(self.channels))
                self._guard_off = offs[0]
        return self._guard_off

    def loop_off(self):
        if self._loop_off is None:
            if self.channels != 1:
                raise ValueError("looped regions are mono-only")
            self._loop_off = self.arena.add_looped(self.data)
        return self._loop_off

    @classmethod
    def from_slice(cls, rate, samples):
        """frames.rs:26-47."""
        return cls(rate, samples)

    @classmethod
    def from_iter(cls, rate, it):
        """frames.rs:50-77."""
        return cls(rate, np.fromiter(it, dtype=np.float32))

    def __len__(self):
        return int(self.data.shape[0])

    def rate(self):
        """Samples per second (frames.rs:80-82)."""
        return int(self._rate)

    def runtime(self):
        """Runtime in seconds (frames.rs:85-87)."""
        return len(self) / self._rate

    def interpolate(self, s):
        """Host-side frame interpolation at sample position ``s``
        (frames.rs:94-102): whole numbers hit exact samples, out-of-range
        positions yield 0."""
        x0 = int(np.trunc(s))
        fract = np.float32(np.float64(s) - np.float64(x0))
        a, b = self._get_pair(x0)
        return (a + fract * (b - a)).astype(np.float32)

    def _get_pair(self, s):
        """frames.rs:105-123."""
        zero = (np.zeros(self.data.shape[1:], np.float32) if self.data.ndim > 1
                else np.float32(0.0))
        n = len(self)
        a = self.data[s] if 0 <= s < n else zero
        b = self.data[s + 1] if 0 <= s + 1 < n else zero
        return a, b


def _arena_get(arena, off, length, s):
    """Zero-padded arena gather with get_pair's edge semantics
    (frames.rs:105-123): valid for 0 <= s < length, zero otherwise."""
    valid = (s >= 0) & (s < length)
    hi = torch.clamp_min(length - 1, 0)
    idx = off + torch.minimum(torch.clamp_min(s, 0), hi)
    v = arena[torch.clamp(idx, 0, arena.shape[0] - 1).to(torch.int64)]
    if arena.dim() > 1:
        valid = valid[..., None]
    return torch.where(valid, v, 0.0)


def _lerp(a, b, t):
    """frame::lerp (frame.rs:39-41): a + t*(b-a), elementwise."""
    return a + t * (b - a)


def _pool_ds_small(node):
    """The pool's read route, stamped by core/drctrl.py: True where every
    live voice's step fits K6's arena form."""
    return getattr(node, "_pool_ds_small", True)


class FramesSignal(Signal):
    """An audio signal backed by static samples (frames.rs:141-214)."""

    seekable = True
    _host_fields = ("t", "off", "length", "rate", "goff")
    #: its device-resident step is ``stream_kernels.arena_step``'s "frames"
    arena_kind = "frames"

    def __init__(self, frames, start_seconds=0.0):
        super().__init__()
        self.channels = frames.channels
        self._alloc_host(())
        self.t[()] = np.float64(start_seconds)
        self.off[()] = frames.offset
        self.length[()] = len(frames)
        self.rate[()] = frames._rate
        # guarded region for the DR read (channel c of a multi-channel
        # sound at goff + c*guard_stride(length))
        self.goff[()] = frames.guard_off()
        self._cb = ControlBlock(self)
        self.control = FramesSignalControl(self._cb)

    @classmethod
    def new(cls, frames, start_seconds=0.0):
        """frames.rs:152-169 — returns (control, signal)."""
        sig = cls(frames, start_seconds)
        return sig.control, sig

    def _alloc_host(self, batch):
        self.t = full(batch, 0.0, np.float64)
        self.off = full(batch, 0, np.int32)
        self.length = full(batch, 1, np.int32)
        self.rate = full(batch, 1.0, np.float64)
        self.goff = full(batch, ARENA_GUARD, np.int32)

    def _arch_extra(self):
        return (self.channels,)

    def _params_from_t(self, t, interval):
        s0 = t * self.rate  # f64 (frames.rs:177)
        base = np.trunc(s0)  # `s0 as isize` truncates toward zero
        ds = (f32(interval) * self.rate.astype(np.float32)).astype(np.float32)
        # the reference's fast path (frames.rs:180-187) renders |ds-1| <= eps
        # as an exact unit step; snapping reproduces that exactly
        ds = np.where(np.abs(ds - np.float32(1.0)) <= EPS32, np.float32(1.0), ds)
        offset0 = (s0 - base).astype(np.float32)
        base_i = np.clip(base, -(2**30), 2**30).astype(np.int32)
        ds_int, f_hi, f_lo = split_ds(ds)
        return {
            "base": base_i,
            "offset0": offset0,
            "ds_int": ds_int,
            "f_hi": f_hi,
            "f_lo": f_lo,
            "off": self.off.copy(),
            "length": self.length.copy(),
        }

    def host_prepare(self, interval, n, count=None):
        interval = np.broadcast_to(f32(interval), self.batch).astype(np.float32)
        params = self._params_from_t(self.t, interval)
        cnt = np.broadcast_to(f64(n if count is None else count), self.batch)
        # frames.rs:198: t += f64::from(interval) * out.len()
        self.t = self.t + interval.astype(np.float64) * cnt
        return params

    def host_params_at(self, tshift, interval, n):
        interval = np.broadcast_to(f32(interval), self.batch).astype(np.float32)
        t = self.t + f32(tshift).astype(np.float64)  # seek(): t += f64::from(seconds)
        return self._params_from_t(np.broadcast_to(t, self.batch), interval)

    def host_seek(self, seconds):
        """frames.rs:209-214."""
        self.t = self.t + f32(seconds).astype(np.float64)

    def host_is_finished(self):
        """frames.rs:204-206: t >= (len - 1) / rate."""
        return self.t >= (self.length.astype(np.float64) - 1.0) / self.rate

    def host_ds_bound(self, interval):
        return float(np.max(np.float32(interval) * self.rate.astype(np.float32)))

    # control-side views (frames.rs:229-248)
    def _playback_position(self):
        return np.trunc(self.t * self.rate) / self.rate

    def _control_finished(self):
        pos = np.trunc(self.t * self.rate)
        return (pos >= 0) & (pos >= self.length.astype(np.float64))

    def _own_device_data(self):
        a = _arena(self.channels)
        return {"arena": a.device(self.device), "garena": a.device_rows(self.device)}

    def render_host(self, dstate, ddata, params, n):
        col = {k: device_param(params[k], self.device)
               for k in ("base", "offset0", "ds_int", "f_hi", "f_lo", "off", "length")}
        tr, fr = exact_positions(col["offset0"], col["ds_int"], col["f_hi"], col["f_lo"], n,
                                 signed=True)
        s = col["base"][:, None] + tr
        arena = ddata["arena"]
        off, length = col["off"][:, None], col["length"][:, None]
        a = _arena_get(arena, off, length, s)
        b = _arena_get(arena, off, length, s + 1)
        if arena.dim() == 1:
            return dstate, _lerp(a, b, fr)[:, None, :]
        return dstate, _lerp(a, b, fr[..., None]).permute(0, 2, 1)

    # -- device-resident mode ----------------------------------------------------

    def dr_supported(self):
        return True

    def dr_state_init(self, V):
        return {
            "t": np.zeros(V, np.float64),  # the reference's cursor, seconds
            "base": np.zeros(V, np.int32),
            "frac": np.zeros(V, np.float32),
            "off": np.zeros(V, np.int32),
            "goff": np.full(V, ARENA_GUARD, np.int32),
            "length": np.ones(V, np.int32),
            "rate": np.ones(V, np.float32),
            "r_hi": np.ones(V, np.float32),
            "ds_int": np.ones(V, np.int32),
            "f_hi": np.zeros(V, np.float32),
            "f_lo": np.zeros(V, np.float32),
        }

    def dr_slot_row(self, interval):
        # the f32-quantized step is the semantic step (frames.rs:178); its
        # split is exact, so the device cursor never drifts
        ds = np.float32(np.float32(interval) * self.rate.astype(np.float32))
        if abs(ds - np.float32(1.0)) <= EPS32:
            ds = np.float32(1.0)
        ds_int, f_hi, f_lo = split_ds(ds)
        s0 = self.t * self.rate
        base = np.trunc(s0)
        return {
            "t": np.float64(self.t[()]),
            "base": np.int32(np.clip(base, -(2**30), 2**30)),
            "frac": np.float32(s0 - base),
            "off": np.int32(self.off[()]),
            "goff": np.int32(self.goff[()]),
            "length": np.int32(self.length[()]),
            "rate": np.float32(self.rate[()]),
            "r_hi": top12(self.rate[()]),
            "ds_int": np.int32(ds_int),
            "f_hi": np.float32(f_hi),
            "f_lo": np.float32(f_lo),
        }

    def dr_render(self, state, ddata, interval, n, count):
        if _pool_ds_small(self):
            # the whole step in one launch: the step split, the guarded
            # rows (their zero pads carry frames.rs:105-123's edge
            # semantics; channel c's region at goff + c*guard_stride(len)),
            # the read in <= 512-frame chunks (any n, signal.rs:19) and the
            # f64 cursor's release
            return SK.arena_step(ddata["garena"], "frames", state, interval, n, count,
                                 channels=self.channels)
        # heavy downsampling: the exact whole-arena gather
        # (frames.rs:176-201 resamples at any ratio)
        ds_int, f_hi, f_lo = SK.step_split("frames", state, interval)
        tr, fr = exact_positions(state["frac"], ds_int, f_hi, f_lo, n, signed=True)
        s = state["base"][:, None] + tr
        arena = ddata["arena"]
        off, length = state["off"][:, None], state["length"][:, None]
        a = _arena_get(arena, off, length, s)
        b = _arena_get(arena, off, length, s + 1)
        if arena.dim() > 1:
            samples = _lerp(a, b, fr[..., None]).permute(0, 2, 1)  # (V, C, n)
        else:
            samples = _lerp(a, b, fr)
        # frames.rs:198: t += f64::from(interval) * out.len()
        return SK.frames_release(state, interval, count), samples

    def dr_is_finished(self, state):
        """frames.rs:204-206: s >= len - 1 (s = base + frac, frac in (-1,1))."""
        return (state["base"] >= state["length"] - 1) & ~(
            (state["base"] == state["length"] - 1) & (state["frac"] < 0)
        )

    # -- device-resident Seek mode (frames.rs:209-214) -----------------------------
    # The spatial seek path samples at cursor + t0 + j*dt per ear, through
    # the same arena read, from the time cursor shifted as the host seek
    # path shifts it (``t + f64(t0)``, then the reference's split).

    def dr_seek_supported(self):
        return (
            self.channels == 1
            and type(self).host_is_finished is FramesSignal.host_is_finished
        )

    def dr_warp_render(self, state, ddata, t0, dt, n):
        if _pool_ds_small(self):
            return SK.arena_warp(ddata["garena"], "frames", state, t0, dt, n)
        # heavy downsampling: exact whole-arena gather
        base2, o0 = SK.split_t(state["t"][:, None] + t0.to(torch.float64),
                               state["rate"][:, None])
        ds_int, f_hi, f_lo = device_split_ds(SK.snap_unit(dt * state["rate"][:, None]))
        tr, fr = exact_positions(o0, ds_int, f_hi, f_lo, n, signed=True)
        s = base2[:, :, None] + tr
        arena = ddata["arena"]
        off = state["off"][:, None, None]
        length = state["length"][:, None, None]
        return _lerp(_arena_get(arena, off, length, s),
                     _arena_get(arena, off, length, s + 1), fr)

    def dr_advance(self, state, seconds):
        """The end-of-block seek (spatial.rs:468, frames.rs:209-214)."""
        return SK.at_t(state, state["t"] + float(np.float32(seconds)))


class FramesSignalControl:
    """Playback-position readout (frames.rs:223-248)."""

    def __init__(self, cb):
        self._cb = cb

    def _dr_cursor(self):
        """(base, length, rate) for a voice in a device-resident pool, read
        from the pool's state (one small readback per query, the analogue
        of the reference's position atomic); None before its play lands."""
        pool, slot, gen, path = self._cb._dr
        if pool.slot_gen[slot] != gen or pool.state is None:
            return None
        if any(slot_i == slot for slot_i, _ in pool.pending_plays):
            return None
        t = pool.state["inner"]
        for k in path:
            t = t[k]
        return (float(t["base"][slot]), float(t["length"][slot]), float(t["rate"][slot]))

    def playback_position(self):
        if not self._cb.live():
            return 0.0
        if self._cb._dr is not None:
            cur = self._dr_cursor()
            if cur is None:  # before the play: the spec mirror is current
                return float(self._cb.sig._playback_position()[self._cb.idx])
            base, _, rate = cur
            return base / rate
        return float(self._cb.sig._playback_position()[self._cb.idx])

    def is_finished(self):
        if not self._cb.live():
            return True
        if self._cb._dr is not None:
            cur = self._dr_cursor()
            if cur is None:
                return bool(self._cb.sig._control_finished()[self._cb.idx])
            base, length, _ = cur
            return base >= 0 and base >= length
        return bool(self._cb.sig._control_finished()[self._cb.idx])
