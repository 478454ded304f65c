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
* K6's arena form, ``arena_resample``, the sampler reads of FramesSignal,
  Cycle and the spatial seek pool (oddio_tpu/core/frames.py
  ``_dr_resample``): the same position math from the row's cursor
  ``(xg, o0)`` and exact step split, read in place from the flat guarded
  or looped sample arena at ``clamp(xg - 1, lo, hi) + 1 + p_j`` and the
  next sample, with no row-window gather.

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

from ._build import lib
from ._dev import device_split_ds
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
LAUNCHES = {"ring_place": 0, "ring_resample": 0, "arena_resample": 0}


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
