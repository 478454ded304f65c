"""Stream ring kernels, for Hopper (counterpart of the JAX package's
``strip_place`` and ``strip_resample`` in oddio_tpu/ops/pallas_ring.py).

A stream voice's ring is ``size_pad`` floats per channel row; pools view
their ``(V, C*R, 128)`` ring state as ``(V*C, size_pad)`` rows.  Both
kernels address that ring directly: on the TPU each needed a row-strip
gather (and, for the write, a scatter back), which on the GPU is an index
modulo ``size_pad``.

* ``ring_place`` (K4, for ``strip_place`` on the stream ingest path,
  oddio_tpu/ops/stream.py ``_write_pool``): in place,
  ``ring[r, (wpos[v] + j) mod size_pad] = chunk[r, j]`` for
  ``j < wcount[v]``, ``v = r // channels`` (the kernel maps a voice's
  cursor to its channel rows).  ``wcount`` includes the zero-termination
  column.  ``ring_place_record`` is the host buffered pool's ring write
  (oddio_tpu/spatial.py:526): the cursor ``128*wrow + extra_w`` and the
  count ``n_write`` read inside the kernel from the pool's operand record
  (``ring_kernels.voice_record``).
* K6, for ``strip_resample`` on the stream read, with the torch ops
  around it: per row, the step split of ``ops._dev.device_split_ds``
  (``ds_int``, ``f_hi``, ``f_lo``) computed in the kernel from the step,
  then the strided fractional read ``lerp(ring[(start + p_j) mod
  size_pad], ring[(start + p_j + 1) mod size_pad], fr_j)`` with
  ``p_j``/``fr_j`` from the exact split-ds f32 position math of
  ``_resample_kernel`` (truncate-toward-zero adjustment for a negative
  offset), zeroed where the unadjusted whole position is past ``len``
  (the underrun padding of stream.rs:41-49).  Two forms: ``stream_step``,
  a device-resident pool's whole Stream step, takes the pool's (V,)
  ``t``, ``rate``, ``start``, ``len`` and ``count`` and the host interval
  (``ds = rate*interval``) and also writes the cursor release of
  stream.rs:63-69 to new (V,) tensors; ``ring_resample`` takes the (V,)
  ``ds`` a host pool ships.
* K6's arena form (oddio_tpu/core/frames.py ``_dr_resample``), the
  sampler reads: ``arena_resample``, the read alone, the same position
  math from the row's cursor ``(xg, o0)`` and exact step split, read in
  place from the flat guarded or looped sample arena at ``clamp(xg - 1,
  lo, hi) + 1 + p_j`` and the next sample, with no row-window gather; and
  the whole steps the paths launch, one launch each: ``arena_step``, a
  device-resident FramesSignal or Cycle step under zero or more Speeds
  (the step split, the rows, the read in <= WARP_CHUNK-frame chunks, the
  cursor release), ``arena_warp``, a seek pool's warped read, and
  ``fader_step``, a whole Fader over such a chain (both banks and the
  crossfade).  Their plain versions are the torch chains of
  ``FramesSignal``/``Cycle``/``Speed``/``Fader.dr_render`` and the seek
  reads over ``arena_resample_plain``.

A wrapper runs the plain PyTorch version for tensors on the CPU and
launches the CUDA kernel of ``csrc/stream_kernels.cu`` for tensors on a
CUDA device; it never falls back from one to the other.  Each launch adds
one to ``LAUNCHES[name]``.  Cursors stay device tensors: no host reads.
The wrappers check their operands in full once per signature (shapes,
strides, dtypes, devices) and by that signature after.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.hostmath import EPS32
from ._build import lib
from ._dev import chunked_frames, device_advance, device_split_ds, warp_shift
from .ring_kernels import (
    REC_FIELDS, REC_WORDS, _VALIDATED, _check, _check_contig, _cuda_device, _ptr,
    _raise_rc, _signature, _stream_ptr, record_fields,
)

__all__ = [
    "RESAMPLE_W",
    "RESAMPLE_DSMAX",
    "RESAMPLE_NMAX",
    "LAUNCHES",
    "reset_launches",
    "ring_place",
    "ring_place_plain",
    "ring_place_record",
    "ring_place_record_plain",
    "record_cursor",
    "ring_resample",
    "ring_resample_plain",
    "release_plain",
    "stream_step",
    "stream_step_plain",
    "arena_resample",
    "arena_resample_plain",
    "ARENA_ROW",
    "ARENA_GUARD",
    "arena_step",
    "arena_step_plain",
    "arena_warp",
    "arena_warp_plain",
    "fader_step",
    "fader_step_plain",
    "fade_mix_plain",
]

#: read window of the TPU kernel's sub-block gather; it sizes the routing
#: check ``S_req <= size_pad`` (Stream.render_batched), kept as it is so
#: both packages route the same streams to the kernel
RESAMPLE_W = 768
#: per-frame step bound of the kernel path
RESAMPLE_DSMAX = 4.0
#: block-size bound of the kernel path
RESAMPLE_NMAX = 640

#: threads per CUDA block of K4 (PLACE_THREADS in csrc/stream_kernels.cu)
PLACE_THREADS = 256

#: launches per kernel since the last reset (CUDA launches only)
LAUNCHES = {"ring_place": 0, "ring_resample": 0, "arena_resample": 0, "arena_step": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _rows_i32(x, R, name, dev):
    _check(x, name, torch.int32, (R,), dev)
    _check_contig(x, name)


# --- K4: ring place ---------------------------------------------------------


def _rows_of(x, C):
    """A per-voice (V,) column as per-row (V*C,): row r takes voice r // C."""
    return x if C == 1 else x.repeat_interleave(C)


def ring_place_plain(ring, chunk, wpos, wcount, channels=1):
    """Plain version of K4, in place; returns ``ring``.  Lanes at
    ``j >= wcount`` rewrite the ring's own values (no positions repeat
    within a row, since ``mw <= size_pad``), so the scatter needs no
    host-side mask."""
    R, size = ring.shape
    mw = chunk.shape[1]
    wpos, wcount = _rows_of(wpos, channels), _rows_of(wcount, channels)
    j = torch.arange(mw, dtype=torch.int64, device=ring.device)
    idx = torch.remainder(wpos.to(torch.int64)[:, None] + j, size)
    keep = j[None, :] < wcount.to(torch.int64)[:, None]
    vals = torch.where(keep, chunk, torch.gather(ring, 1, idx))
    ring.scatter_(1, idx, vals)
    return ring


def record_cursor(rec):
    """K4's write cursor and count of an operand record (the host pool's):
    ``(128*wrow + extra_w, n_write)``, (V,) int32 each."""
    f = record_fields(rec)
    return f["wrow"] * 128 + f["extra_w"], f["n_write"]


def ring_place_record_plain(ring, chunk, rec):
    """Plain version of K4's record form."""
    return ring_place_plain(ring, chunk, *record_cursor(rec))


def _group(mw):
    """Threads per ring row: a power of two in [32, PLACE_THREADS] near one
    float4 store per thread."""
    return max(32, min(PLACE_THREADS, 1 << (max(1, -(-mw // 4)).bit_length() - 1)))


def _place_launch(ring, chunk, pos, count, C):
    """Launch K4: ``pos`` = (wrow pointer, wadd pointer or None, row_mul,
    voice stride), ``count`` = (pointer, voice stride)."""
    R, size = ring.shape
    mw = chunk.shape[1]
    rc = lib("stream_kernels").ring_place(
        ring.data_ptr(), chunk.data_ptr(), chunk.stride(0), *pos, *count, R, size, mw,
        C, _group(mw), _stream_ptr(ring.device),
    )
    LAUNCHES["ring_place"] += 1
    _raise_rc(rc, "ring_place")
    return ring


def _check_place(ring, chunk, V, C):
    """K4's ring and chunk: (V*C, size_pad) and (V*C, mw <= size_pad) f32
    on one device, unit-stride rows."""
    if ring.dim() != 2:
        raise ValueError("ring must be an (R, size_pad) tensor")
    R, size = ring.shape
    dev = ring.device
    _check(ring, "ring", torch.float32, (R, size), dev)
    if C < 1 or R != V * C:
        raise ValueError(f"{R} ring rows are not {V} voices x {C} channels")
    if chunk.dim() != 2 or chunk.shape[0] != R:
        raise ValueError(f"chunk must be (R, mw), got {tuple(chunk.shape)}")
    mw = chunk.shape[1]
    if mw > size:
        raise ValueError(f"chunk width {mw} exceeds the ring's {size}")
    _check(chunk, "chunk", torch.float32, (R, mw), dev)
    if dev.type != "cpu":
        _cuda_device(ring)
        _check_contig(ring, "ring")
        if chunk.stride(1) != 1:
            raise ValueError("chunk rows must be unit-stride")


def ring_place(ring, chunk, wpos, wcount, channels=1):
    """K4 (oddio_tpu/ops/pallas_ring.py ``strip_place``, as the stream pool
    ingest uses it): ring (R, size_pad) f32, chunk (R, mw) f32 with
    mw <= size_pad, wpos and wcount (R / channels,) int32: ring row r
    takes voice ``r // channels``'s cursor and count (a voice's channel
    rows are consecutive).  Writes ``chunk[r, :wcount]`` at ``wpos``
    onward, wrapping; in place."""
    key = (_signature(ring, chunk, wpos, wcount), channels)
    if key not in _VALIDATED:
        V = ring.shape[0] // max(channels, 1) if ring.dim() == 2 else 0
        _check_place(ring, chunk, V, channels)
        _rows_i32(wpos, V, "wpos", ring.device)
        _rows_i32(wcount, V, "wcount", ring.device)
        _VALIDATED.add(key)
    if ring.device.type == "cpu":
        return ring_place_plain(ring, chunk, wpos, wcount, channels)
    if chunk.shape[0] == 0 or chunk.shape[1] == 0:
        return ring
    return _place_launch(ring, chunk, (wpos.data_ptr(), None, 1, 1), (wcount.data_ptr(), 1),
                         channels)


def ring_place_record(ring, chunk, rec):
    """K4's cursor form, as the host buffered pool writes its rings: ring
    (V, L), chunk (V, mw) f32, rec (V, REC_WORDS) the pool's operand
    record; writes ``chunk[v, :n_write]`` at ``(128*wrow + extra_w) mod
    L`` onward, the cursor and count read inside the kernel.  Checks run
    once per (shapes, strides, dtypes, devices)."""
    key = _signature(ring, chunk, rec)
    if key not in _VALIDATED:
        V = rec.shape[0]
        _check_place(ring, chunk, V, 1)
        _check(rec, "rec", torch.float32, (V, REC_WORDS), ring.device)
        _check_contig(rec, "rec")
        _VALIDATED.add(key)
    if ring.device.type == "cpu":
        return ring_place_record_plain(ring, chunk, rec)
    if chunk.shape[1] == 0:
        return ring
    b, F = rec.data_ptr(), REC_FIELDS
    return _place_launch(ring, chunk,
                         (b + 4 * F["wrow"], b + 4 * F["extra_w"], 128, REC_WORDS),
                         (b + 4 * F["n_write"], REC_WORDS), 1)


# --- K6: ring resample and the Stream step ---------------------------------


def _positions(t, ds_int, f_hi, f_lo, n):
    """The kernel's f32 position math (``_resample_kernel``,
    pallas_ring.py:1153-1172): unadjusted whole positions (for the
    underrun mask), and the trunc-form read positions and fractions."""
    t_f = torch.arange(n, dtype=torch.float32, device=t.device)
    H = t_f * f_hi[:, None]  # exact f32 product for t < 4096 (12-bit f_hi)
    Hf = torch.floor(H)
    u = (H - Hf) + (t[:, None] + t_f * f_lo[:, None])
    fl_u = torch.floor(u)
    fr = u - fl_u
    wr = t_f * ds_int.to(torch.float32)[:, None] + Hf + fl_u
    adjust = (wr < 0.0) & (fr > 0.0)
    p = torch.where(adjust, wr + 1.0, wr).to(torch.int64)
    fr = torch.where(adjust, fr - 1.0, fr)
    return wr.to(torch.int32), p, fr


def ring_resample_plain(ring, t, ds, start, len_, n):
    """Plain version of K6's read: the step split (``device_split_ds``),
    then the strided lerp with the underrun mask: (R, n) samples."""
    size = ring.shape[1]
    whole, p, fr = _positions(t, *device_split_ds(ds), n)
    idx = torch.remainder(start.to(torch.int64)[:, None] + p, size)
    a = torch.gather(ring, 1, idx)
    b = torch.gather(ring, 1, torch.remainder(idx + 1, size))
    s = a + fr * (b - a)
    return torch.where(whole < len_[:, None], s, 0.0)


def release_plain(t, rate, interval, count, start, len_, size_pad):
    """The Stream step's cursor release (stream.rs:63-69) in torch, the
    device twin of the host mirror ``Stream._tick_math``: ``count`` frames
    at ``rate*interval`` release the whole samples consumed.  Returns new
    (t', len', start')."""
    iv = float(np.float32(interval))
    cf = count.to(torch.float32)
    nxt = t + (cf * iv) * rate
    tc = torch.minimum(nxt, len_.to(torch.float32))
    released = torch.trunc(tc).to(torch.int32)
    return (tc - released.to(torch.float32), len_ - released,
            torch.remainder(start + released, size_pad))


def stream_step_plain(ring, t, rate, interval, count, start, len_, n):
    """Plain version of K6's DR form: the read at ``ds = rate*interval``
    and the release.  Returns (samples (R, n), t', len', start')."""
    iv = float(np.float32(interval))
    samp = ring_resample_plain(ring, t, rate * iv, start, len_, n)
    return (samp,) + release_plain(t, rate, interval, count, start, len_, ring.shape[1])


def _check_resample(ring, cols, ints, count, n):
    if not isinstance(ring, torch.Tensor) or ring.dim() != 2:
        raise ValueError("ring must be an (R, size_pad) tensor")
    R, size = ring.shape
    dev = ring.device
    _check(ring, "ring", torch.float32, (R, size), dev)
    for x, nm in cols:
        _check(x, nm, torch.float32, (R,), dev)
        _check_contig(x, nm)
    for x, nm in ints:
        _rows_i32(x, R, nm, dev)
    if count is not None:
        if not isinstance(count, torch.Tensor) or count.dtype != torch.int32:
            raise TypeError("count must be an int32 tensor")
        if count.device != dev or tuple(count.shape) not in ((), (1,), (R,)):
            raise ValueError(f"count must be a 0-d, (1,) or ({R},) tensor on {dev}")
        _check_contig(count, "count")
    if not 1 <= n <= 4096:
        raise ValueError(f"n={n} outside [1, 4096] (exact split products)")
    if dev.type != "cpu":
        _cuda_device(ring)
        _check_contig(ring, "ring")
        if R > 65535:
            raise ValueError(f"{R} rows: the kernel's grid takes at most 65535")


def _resample_launch(ring, t, step, iv, start, len_, count, n):
    """Launch K6: the ds form (``count`` None) or the DR form.  Returns
    (out,) or (out, t', len', start')."""
    R, size = ring.shape
    dev = ring.device
    out = torch.empty((R, n), dtype=torch.float32, device=dev)
    cur = () if count is None else (torch.empty_like(t), torch.empty_like(len_),
                                     torch.empty_like(start))
    if R == 0:
        return (out,) + cur
    ptrs = [None] * 3 if count is None else [x.data_ptr() for x in cur]
    rc = lib("stream_kernels").ring_resample(
        ring.data_ptr(), t.data_ptr(), step.data_ptr(), iv, start.data_ptr(),
        len_.data_ptr(), _ptr(count), 0 if count is None or count.numel() == 1 else 1,
        out.data_ptr(), *ptrs, R, size, n, _stream_ptr(dev),
    )
    LAUNCHES["ring_resample"] += 1
    _raise_rc(rc, "ring_resample")
    return (out,) + cur


def ring_resample(ring, t, ds, start, len_, n):
    """K6 (oddio_tpu/ops/pallas_ring.py ``strip_resample``, with the step
    split and the stream read's underrun mask fused), as a host pool's
    stream read ships its step: ring (R, size_pad) f32; t (read offset in
    (-1, 1)) and ds (R,) f32; start, len (R,) int32.  Returns (R, n): the
    lerp at ``start + trunc(t + j*ds)`` (the split-ds exact positions),
    0 where the whole position is at or past ``len``.  Checks run once
    per (shapes, strides, dtypes, devices)."""
    key = ("resample", n, _signature(ring, t, ds, start, len_))
    if key not in _VALIDATED:
        _check_resample(ring, ((t, "t"), (ds, "ds")), ((start, "start"), (len_, "len")),
                        None, n)
        _VALIDATED.add(key)
    if ring.device.type == "cpu":
        return ring_resample_plain(ring, t, ds, start, len_, n)
    return _resample_launch(ring, t, ds, 0.0, start, len_, None, n)[0]


def stream_step(ring, t, rate, interval, count, start, len_, n):
    """K6's DR form: one device-resident Stream step (oddio_tpu/ops/
    stream.py ``dr_render``: the read at ``ds = rate*interval`` and the
    release of stream.rs:63-69) in one launch.  ring (R, size_pad) f32;
    t, rate (R,) f32; interval a host number; count int32 0-d, (1,) or
    (R,), the frames consumed; start, len (R,) int32.  Returns (samples
    (R, n), t', len', start'), the cursors new tensors, term for term
    the host mirror ``Stream._tick_math``."""
    key = ("step", n, _signature(ring, t, rate, start, len_, count))
    if key not in _VALIDATED:
        _check_resample(ring, ((t, "t"), (rate, "rate")),
                        ((start, "start"), (len_, "len")), count, n)
        if not isinstance(interval, (float, int, np.floating)):
            raise TypeError("interval must be a host number")
        _VALIDATED.add(key)
    if ring.device.type == "cpu":
        return stream_step_plain(ring, t, rate, interval, count, start, len_, n)
    return _resample_launch(ring, t, rate, float(np.float32(interval)), start, len_, count, n)


# --- K6's arena form: the sampler reads ----------------------------------------


def arena_resample_plain(garena, xg, lo, hi, o0, ds_int, f_hi, f_lo, n):
    """Plain version of K6's arena form: (R, n) lerps of the flat arena at
    ``clamp(xg - 1, lo, hi) + 1 + p_j`` and the next sample, ``p_j`` and
    the fractions from ``_positions`` (trunc form for a negative ``o0``);
    a read that would leave the arena takes its nearest end, as the
    kernel's does."""
    flat = garena.reshape(-1)
    xc = torch.clamp(xg - 1, lo, hi).to(torch.int64)
    _, p, fr = _positions(o0, ds_int, f_hi, f_lo, n)
    idx = torch.clamp(xc[:, None] + 1 + p, 0, flat.numel() - 2)
    a = flat[idx]
    b = flat[idx + 1]
    return a + fr * (b - a)


def arena_resample(garena, xg, lo, hi, o0, ds_int, f_hi, f_lo, n):
    """K6's arena form (oddio_tpu/ops/pallas_ring.py ``strip_resample`` as
    oddio_tpu/core/frames.py ``_dr_resample`` calls it, without its window
    gather): garena the guarded/looped sample arena, f32, contiguous, any
    shape (read flat); xg, lo, hi, ds_int (R,) int32; o0, f_hi, f_lo (R,)
    f32.  Returns (R, n): row r's lerp at ``clamp(xg - 1, lo, hi) + 1 +
    trunc(o0 + j*ds)`` (the split-ds exact positions) and the next
    sample; n <= RESAMPLE_NMAX.  The regions' guards and loop copies keep
    every read inside its region for ds <= RESAMPLE_DSMAX; past that, a
    read that would leave the arena takes its nearest end.  Checks run
    once per (shapes, strides, dtypes, devices)."""
    key = ("arena", n, _signature(garena, xg, lo, hi, o0, ds_int, f_hi, f_lo))
    if key not in _VALIDATED:
        _check_arena(garena, (xg, lo, hi, ds_int), (o0, f_hi, f_lo), n)
        _VALIDATED.add(key)
    if garena.device.type == "cpu":
        return arena_resample_plain(garena, xg, lo, hi, o0, ds_int, f_hi, f_lo, n)
    R = xg.shape[0]
    out = torch.empty((R, n), dtype=torch.float32, device=garena.device)
    if R == 0:
        return out
    rc = lib("stream_kernels").arena_resample(
        garena.data_ptr(), garena.numel(), xg.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        o0.data_ptr(), ds_int.data_ptr(), f_hi.data_ptr(), f_lo.data_ptr(),
        out.data_ptr(), R, n, _stream_ptr(garena.device),
    )
    LAUNCHES["arena_resample"] += 1
    _raise_rc(rc, "arena_resample")
    return out


def _check_arena(garena, ints, floats, n):
    if not isinstance(garena, torch.Tensor):
        raise TypeError("garena must be a tensor")
    dev = garena.device
    if garena.dtype != torch.float32:
        raise TypeError(f"garena must be torch.float32, got {garena.dtype}")
    _check_contig(garena, "garena")
    if garena.numel() < 2:
        raise ValueError("garena holds no region")
    R = ints[0].shape[0] if isinstance(ints[0], torch.Tensor) and ints[0].dim() == 1 else -1
    if R < 0:
        raise ValueError("xg must be an (R,) int32 tensor")
    for x, nm in zip(ints, ("xg", "lo", "hi", "ds_int")):
        _rows_i32(x, R, nm, dev)
    for x, nm in zip(floats, ("o0", "f_hi", "f_lo")):
        _check(x, nm, torch.float32, (R,), dev)
        _check_contig(x, nm)
    if not 1 <= n <= RESAMPLE_NMAX:
        raise ValueError(f"n={n} outside [1, {RESAMPLE_NMAX}] (the span the arena's guards "
                         f"cover)")
    if dev.type != "cpu":
        _cuda_device(garena)


# --- K6's arena form, whole steps: FramesSignal, Cycle, seek reads, Fader -----------

#: row granularity of the guarded arena (core/frames.py)
ARENA_ROW = 256
#: zero-guard length around each guarded region: covers a whole block's
#: read span (RESAMPLE_NMAX * RESAMPLE_DSMAX) plus cursor slack, so reads
#: outside a sound hit literal zeros (frames.rs:105-123) with no masking
ARENA_GUARD = 3072

#: the leaf state columns a step reads, in the kernel's LeafOps order
#: (t, base, frac, roff, len, rate, r_hi, ds_int, f_hi, f_lo); None: unread
_LEAF_COLS = {
    "frames": ("t", "base", "frac", "goff", "length", "rate", None, "ds_int", "f_hi", "f_lo"),
    "cycle": (None, "base", "frac", "loff", "length", "rate", "r_hi", "ds_int", "f_hi", "f_lo"),
}
_COL_DTYPES = {"t": torch.float64, "base": torch.int32, "frac": torch.float32,
               "goff": torch.int32, "loff": torch.int32, "length": torch.int32,
               "rate": torch.float32, "r_hi": torch.float32, "ds_int": torch.int32,
               "f_hi": torch.float32, "f_lo": torch.float32}
_FADE_COLS = (("prog", torch.float32), ("inc", torch.float32), ("fading", torch.bool),
              ("flip", torch.bool))


def split_t(t, rate):
    """The reference's per-block split of the f64 time cursor
    (frames.rs:177-189): ``s0 = t*rate``, ``base = trunc(s0)`` (clipped to
    +-2^30), ``frac = f32(s0 - trunc(s0))``, the trunc-form pair."""
    s0 = t * rate.to(torch.float64)
    b = torch.trunc(s0)
    return torch.clamp(b, -(2**30), 2**30).to(torch.int32), (s0 - b).to(torch.float32)


def at_t(state, t):
    """A FramesSignal leaf's state with its time cursor at ``t``."""
    out = dict(state)
    out["t"] = t
    out["base"], out["frac"] = split_t(t, state["rate"])
    return out


def floor_advance(cur, n_c, ds_int, f_hi, f_lo):
    """Advance a trunc-form (base, o) chunk cursor by ``n_c`` frames: to
    floor form, then ``device_advance`` (whose floor-form result is a
    valid trunc-form cursor)."""
    b, o = cur
    neg = o < 0
    return device_advance(
        b - neg.to(torch.int32), torch.where(neg, o + 1.0, o), n_c, ds_int, f_hi, f_lo,
    )


def snap_unit(ds):
    """frames.rs:180-187's fast path: a step within eps32 of 1 renders as an
    exact unit step."""
    return torch.where(torch.abs(ds - 1.0) <= float(EPS32), 1.0, ds)


def warped_interval(interval, speed):
    """The interval a Speed hands its inner (speed.rs:32-36), as
    ``Speed.dr_render`` forms it; ``speed`` None: ``interval``."""
    if speed is None:
        return interval
    if isinstance(interval, torch.Tensor):
        return interval * speed
    return speed * float(np.float32(interval))


def step_split(kind, state, interval):
    """A leaf's step split: the slot row's exact host split for the pool's
    static interval (a host number), or re-derived on the device from a
    per-voice interval (Speed chains), FramesSignal with the unit-step snap,
    Cycle without (cycle.rs:27-30)."""
    if not isinstance(interval, torch.Tensor):
        return state["ds_int"], state["f_hi"], state["f_lo"]
    ds = state["rate"] * interval
    return device_split_ds(snap_unit(ds) if kind == "frames" else ds)


def frames_release(state, interval, count):
    """A FramesSignal leaf's new state: frames.rs:198's ``t +=
    f64(interval) * count`` on its f64 cursor, then its split."""
    if isinstance(interval, torch.Tensor):
        iv = interval.to(torch.float64)
    else:
        iv = float(np.float32(interval))
    return at_t(state, state["t"] + iv * count.to(torch.float64))


def cycle_release(state, split, count):
    """A Cycle leaf's new state, as the host path's end of block: the
    position of the last frame reduced mod len, plus one step
    (cycle.rs:40-47); unchanged where ``count <= 0``."""
    ds_int, f_hi, f_lo = split
    cm1 = torch.clamp_min(count - 1, 0)
    b1, f1 = device_advance(state["base"], state["frac"], cm1, ds_int, f_hi, f_lo)
    b1 = torch.remainder(b1, state["length"])
    b2, f2 = device_advance(b1, f1, torch.ones_like(count), ds_int, f_hi, f_lo)
    keep = count <= 0
    out = dict(state)
    out["base"] = torch.where(keep, state["base"], b2)
    out["frac"] = torch.where(keep, state["frac"], f2)
    return out


def cycle_warp_cursor(state, t0):
    """A Cycle leaf's cursors (base2, o0) shifted by (V, E) second-offsets,
    wrapped rem_euclid (cycle.rs:56-60); the sample shift t0*rate is the
    split product of ``warp_shift`` (ops/_dev.py), as in the JAX package."""
    si, sf = warp_shift(state["rate"], state["r_hi"], t0)
    u = state["frac"][:, None] + sf
    uf = torch.floor(u)
    base2 = state["base"][:, None] + si + uf.to(torch.int32)
    return torch.remainder(base2, state["length"][:, None]), u - uf


def _walk_plain(garena, roff, lo, hi, split, cur, n, cyc_len=None):
    """The arena read of (R,) rows at ``roff + b``, clamped to [lo, hi]:
    ``arena_resample_plain`` in <= WARP_CHUNK-frame chunks, the cursor moved
    between them as ``floor_advance`` (FramesSignal) or ``device_advance``
    then ``remainder(., cyc_len)`` (Cycle)."""
    def ev(c, n_c):
        b, o = c
        return arena_resample_plain(garena, roff + b, lo, hi, o, *split, n_c)

    def adv(c, n_c):
        if cyc_len is None:
            return floor_advance(c, n_c, *split)
        b2, o2 = device_advance(*c, n_c, *split)
        return torch.remainder(b2, cyc_len), o2

    return chunked_frames(ev, adv, cur, n)


def _guarded_rows(goff, length, C):
    """A C-channel FramesSignal's rows: channel c's guarded region at
    ``goff + c*guard_stride(len)``, voice-major, and each row's length."""
    if C == 1:
        return goff, length
    stride = 2 * ARENA_GUARD + length + torch.remainder(-length, ARENA_ROW)
    rows = (goff[:, None]
            + torch.arange(C, dtype=torch.int32, device=stride.device) * stride[:, None])
    return rows.reshape(-1), length.repeat_interleave(C)


def arena_step_plain(garena, kind, state, interval, n, count, channels=1, speed=None):
    """Plain version of ``arena_step``: the torch chain of a FramesSignal
    or Cycle leaf's device-resident step."""
    interval = warped_interval(interval, speed)
    split = step_split(kind, state, interval)
    cur = (state["base"], state["frac"])
    if kind == "cycle":
        loff, length = state["loff"], state["length"]
        samples = _walk_plain(garena, loff, loff - 1, loff + length - 1, split, cur, n, length)
        return cycle_release(state, split, count), samples
    C = channels
    goff, length = _guarded_rows(state["goff"], state["length"], C)
    if C > 1:
        split = tuple(x.repeat_interleave(C) for x in split)
        cur = tuple(x.repeat_interleave(C) for x in cur)
    samples = _walk_plain(garena, goff, goff - ARENA_GUARD, goff + length, split, cur, n)
    if C > 1:
        samples = samples.reshape(-1, C, n)
    return frames_release(state, interval, count), samples


def arena_warp_plain(garena, kind, state, t0, dt, n):
    """Plain version of ``arena_warp``: a seek pool's warped read of a
    mono FramesSignal or Cycle leaf, (V, E, n)."""
    V, E = t0.shape
    if kind == "frames":
        base2, o0 = split_t(state["t"][:, None] + t0.to(torch.float64), state["rate"][:, None])
        split = device_split_ds(snap_unit(dt * state["rate"][:, None]))
        roff = state["goff"].repeat_interleave(E)
        lo, hi = roff - ARENA_GUARD, roff + state["length"].repeat_interleave(E)
        cyc_len = None
    else:
        base2, o0 = cycle_warp_cursor(state, t0)
        split = device_split_ds(dt * state["rate"][:, None])
        roff = state["loff"].repeat_interleave(E)
        cyc_len = state["length"].repeat_interleave(E)
        lo, hi = roff - 1, roff + cyc_len - 1
    split = tuple(x.reshape(-1) for x in split)
    samples = _walk_plain(garena, roff, lo, hi, split, (base2.reshape(-1), o0.reshape(-1)), n,
                          cyc_len)
    return samples.reshape(V, E, n)


def fade_ramp(progress0, inc, n):
    """fader.rs:57-63: the progress ramp (V, n), clamped at 1."""
    j = torch.arange(n, dtype=torch.float32, device=progress0.device)
    return torch.clamp_max(progress0[:, None] + j * inc[:, None], 1.0)


def _voice_mask(m, like):
    """A per-voice (V,) mask shaped to broadcast against ``like``."""
    return m.reshape(m.shape + (1,) * (like.dim() - 1))


def fade_mix_plain(fstate, sa, sb, n, count):
    """A device-resident Fader's crossfade of its two banks' samples ``sa``
    and ``sb`` (fader.rs:38-70): the completion check at block start flips
    the active-bank bit, then ``old*sqrt(1 - p) + new*sqrt(p)`` on fading
    voices, ``old`` elsewhere.  Returns (the Fader's new prog, inc,
    fading and flip, the mixed samples)."""
    done = fstate["fading"] & (fstate["prog"] >= 1.0)
    flip = torch.logical_xor(fstate["flip"], done)
    fading = fstate["fading"] & ~done
    fl = _voice_mask(flip, sa)
    old = torch.where(fl, sb, sa)
    new = torch.where(fl, sa, sb)
    p = fade_ramp(fstate["prog"], fstate["inc"], n)
    if sa.dim() == 3:
        p = p[:, None, :]
    f2 = _voice_mask(fading, sa)
    wa = torch.where(f2, torch.sqrt(1.0 - p), 1.0)
    wb = torch.where(f2, torch.sqrt(p), 0.0)
    prog2 = torch.clamp_max(fstate["prog"] + count.to(torch.float32) * fstate["inc"], 1.0)
    core = {"prog": prog2, "inc": fstate["inc"], "fading": fading, "flip": flip}
    return core, old * wa + new * wb


def fader_step_plain(garena, kind, fstate, banks, intervals, n, count, channels=1,
                     speeds=(None, None)):
    """Plain version of ``fader_step``: both banks' steps, then the
    crossfade."""
    (a2, sa), (b2, sb) = (
        arena_step_plain(garena, kind, st, iv, n, count, channels, sp)
        for st, iv, sp in zip(banks, intervals, speeds))
    core, samples = fade_mix_plain(fstate, sa, sb, n, count)
    return core, a2, b2, samples


def _opt_sig(*xs):
    """``_signature`` that lets None and host numbers through."""
    return tuple(None if x is None else type(x) if not isinstance(x, torch.Tensor)
                 else (x.shape, x.stride(), x.dtype, x.device) for x in xs)


def _leaf_cols(kind, state):
    if kind not in _LEAF_COLS:
        raise ValueError(f"kind must be 'frames' or 'cycle', got {kind!r}")
    return [None if k is None else state[k] for k in _LEAF_COLS[kind]]


def _check_col(x, name, dtype, shape, dev):
    _check(x, name, dtype, shape, dev)
    _check_contig(x, name)


def _check_step(garena, kind, leaves, intervals, speeds, count, n, C, fstate=None, warp=None):
    """The step operands, once per signature: the arena, each bank's leaf
    columns (V,), the intervals (host numbers or (V,) f32), the Speed
    factors, count, n, the Fader's state and the seek offsets (V, E)."""
    if not isinstance(garena, torch.Tensor) or garena.dtype != torch.float32:
        raise TypeError("garena must be a float32 tensor")
    _check_contig(garena, "garena")
    if garena.numel() < 2:
        raise ValueError("garena holds no region")
    dev = garena.device
    base = leaves[0].get("base")
    if not isinstance(base, torch.Tensor) or base.dim() != 1:
        raise ValueError("the leaf state's base must be a (V,) tensor")
    V = base.shape[0]
    for st in leaves:
        for k in _LEAF_COLS[kind]:
            if k is not None and (warp is None or k not in ("ds_int", "f_hi", "f_lo")):
                _check_col(st[k], k, _COL_DTYPES[k], (V,), dev)
    for iv in intervals:
        if isinstance(iv, torch.Tensor):
            _check_col(iv, "interval", torch.float32, (V,), dev)
        elif not isinstance(iv, (float, int, np.floating)):
            raise TypeError("interval must be a host number or a (V,) float32 tensor")
    for sp in speeds:
        if sp is not None:
            _check_col(sp, "speed", torch.float32, (V,), dev)
    if count is not None:
        if not isinstance(count, torch.Tensor) or count.dtype != torch.int32:
            raise TypeError("count must be an int32 tensor")
        if count.device != dev or tuple(count.shape) not in ((), (1,), (V,)):
            raise ValueError(f"count must be a 0-d, (1,) or ({V},) tensor on {dev}")
        _check_contig(count, "count")
    if fstate is not None:
        for k, dt in _FADE_COLS:
            _check_col(fstate[k], k, dt, (V,), dev)
    if warp is not None:
        t0, dt_ = warp
        if not isinstance(t0, torch.Tensor) or t0.dim() != 2 or t0.shape[0] != V:
            raise ValueError(f"t0 must be a ({V}, E) tensor")
        _check_col(t0, "t0", torch.float32, tuple(t0.shape), dev)
        _check_col(dt_, "dt", torch.float32, tuple(t0.shape), dev)
    if kind == "cycle" and C != 1:
        raise ValueError("Cycle reads mono looped regions: channels must be 1")
    if C < 1 or not isinstance(n, int) or n < 1:
        raise ValueError(f"n={n} and channels={C} must be positive")
    if dev.type != "cpu":
        _cuda_device(garena)


def _step_launch(garena, kind, form, leaves, intervals, speeds, count, n, C, E=0,
                 fstate=None, warp=None):
    """Launch ``arena_step`` (csrc/stream_kernels.cu) in ``form`` 0 (a leaf
    step), 1 (a seek read) or 2 (a Fader); returns (new leaf states, new
    Fader columns or None, samples)."""
    dev = garena.device
    V = leaves[0]["base"].shape[0]
    rows = E if form == 1 else C
    out = torch.empty((V, rows, n) if rows > 1 or form == 1 else (V, n),
                      dtype=torch.float32, device=dev)
    new, bank_ptrs = [], []
    for st, iv, sp in zip(leaves, intervals, speeds):
        cols = _leaf_cols(kind, st)
        if form == 1:
            rel = [None] * 3
        else:
            rel = [torch.empty_like(st["t"]) if kind == "frames" else None,
                   torch.empty_like(st["base"]), torch.empty_like(st["frac"])]
            st2 = dict(st)
            if kind == "frames":
                st2["t"] = rel[0]
            st2["base"], st2["frac"] = rel[1], rel[2]
            new.append(st2)
        bank_ptrs += [_ptr(x) for x in cols]
        bank_ptrs += [_ptr(iv if isinstance(iv, torch.Tensor) else None), _ptr(sp)]
        bank_ptrs += [_ptr(x) for x in rel]
    if len(leaves) == 1:
        bank_ptrs += [0] * 15
    fcols = None
    if fstate is not None:
        fcols = {"prog": torch.empty_like(fstate["prog"]), "inc": fstate["inc"],
                 "fading": torch.empty_like(fstate["fading"]),
                 "flip": torch.empty_like(fstate["flip"])}
    f_in = [fstate[k] for k, _ in _FADE_COLS] if fstate is not None else [None] * 4
    f_out = [fcols[k] for k in ("prog", "fading", "flip")] if fcols is not None else [None] * 3
    t0, dt = warp if warp is not None else (None, None)
    ptrs = [garena.data_ptr(), _ptr(count), _ptr(t0), _ptr(dt)] + [_ptr(x) for x in f_in]
    ptrs += [_ptr(x) for x in f_out] + [out.data_ptr()] + bank_ptrs
    ptrs = np.array([0 if p is None else p for p in ptrs], dtype=np.uint64)
    if out.numel() == 0:
        return new, fcols, out
    host_iv = next((iv for iv in intervals if isinstance(iv, (float, int, np.floating))), 0.0)
    s_count = 0 if count is None or count.numel() == 1 else 1
    rc = lib("stream_kernels").arena_step(
        ptrs.ctypes.data, garena.numel(), float(np.float32(host_iv)), s_count,
        int(kind == "cycle"), form, V, C, E, n, ARENA_GUARD, ARENA_ROW, _stream_ptr(dev),
    )
    LAUNCHES["arena_step"] += 1
    _raise_rc(rc, "arena_step")
    return new, fcols, out


def arena_step(garena, kind, state, interval, n, count, channels=1, speed=None):
    """K6's arena form as a whole device-resident step, one launch: a
    FramesSignal (``kind`` "frames", ``channels`` C) or Cycle ("cycle",
    mono) leaf's step split, rows, chunked read of the guarded or looped
    arena ``garena`` (f32, contiguous, read flat) and cursor release, as
    ``FramesSignal.dr_render``/``Cycle.dr_render`` and a Speed chain over
    either compute them.  ``state`` the leaf's (V,) columns; ``interval``
    a host number (the slot rows' split) or a (V,) f32 tensor; ``speed``
    the innermost Speed's (V,) factor or None; ``count`` int32 0-d, (1,)
    or (V,).  Returns (the leaf's new state: its cursor in new tensors,
    the samples (V, n) or (V, C, n)).  Checks run once per signature."""
    key = ("arena_step", kind, channels, n, _opt_sig(garena, count, interval, speed,
                                                    *_leaf_cols(kind, state)))
    if key not in _VALIDATED:
        _check_step(garena, kind, (state,), (interval,), (speed,), count, n, channels)
        _VALIDATED.add(key)
    if garena.device.type == "cpu":
        return arena_step_plain(garena, kind, state, interval, n, count, channels, speed)
    new, _, out = _step_launch(garena, kind, 0, (state,), (interval,), (speed,), count, n,
                               channels)
    return new[0], out


def arena_warp(garena, kind, state, t0, dt, n):
    """K6's arena form as a seek pool's whole warped read, one launch: a
    mono FramesSignal or Cycle leaf read at its cursor shifted by the
    (V, E) second-offsets ``t0`` with per-frame steps ``dt * rate``
    (``dr_warp_render``).  Returns (V, E, n)."""
    key = ("arena_warp", kind, n, _opt_sig(garena, t0, dt, *_leaf_cols(kind, state)))
    if key not in _VALIDATED:
        _check_step(garena, kind, (state,), (), (), None, n, 1, warp=(t0, dt))
        _VALIDATED.add(key)
    if garena.device.type == "cpu":
        return arena_warp_plain(garena, kind, state, t0, dt, n)
    return _step_launch(garena, kind, 1, (state,), (None,), (None,), None, n, 1,
                        E=t0.shape[1], warp=(t0, dt))[2]


def fader_step(garena, kind, fstate, banks, intervals, n, count, channels=1,
               speeds=(None, None)):
    """K6's arena form as a whole device-resident Fader step over a chain
    of Speeds over a FramesSignal or Cycle, one launch: both banks' steps
    (``banks`` the two leaf states, ``intervals`` and ``speeds`` each
    bank's, as ``arena_step`` takes them) and the crossfade of
    ``fade_mix_plain`` on the Fader's (V,) prog, inc, fading and flip in
    ``fstate``.  A voice that is not fading reads only its active bank
    (the other's weight is 0; its cursor is released all the same), so
    the samples equal the plain version's but for the sign of an exact
    zero.  Returns (the Fader's new prog, inc, fading, flip; bank a's and
    b's new leaf states; the samples (V, n) or (V, C, n))."""
    key = ("fader_step", kind, channels, n,
           _opt_sig(garena, count, *intervals, *speeds, *(fstate[k] for k, _ in _FADE_COLS),
                    *_leaf_cols(kind, banks[0]), *_leaf_cols(kind, banks[1])))
    if key not in _VALIDATED:
        _check_step(garena, kind, banks, intervals, speeds, count, n, channels, fstate=fstate)
        if isinstance(intervals[0], torch.Tensor) != isinstance(intervals[1], torch.Tensor) or (
                not isinstance(intervals[0], torch.Tensor)
                and np.float32(intervals[0]) != np.float32(intervals[1])):
            raise ValueError("both banks' intervals must be one host number, or two tensors")
        _VALIDATED.add(key)
    if garena.device.type == "cpu":
        return fader_step_plain(garena, kind, fstate, banks, intervals, n, count, channels,
                                speeds)
    new, core, out = _step_launch(garena, kind, 2, banks, intervals, speeds, count, n,
                                  channels, fstate=fstate)
    return core, new[0], new[1], out
