"""Stream ring kernels, for Hopper (counterpart of the JAX package's
``strip_place`` and ``strip_resample`` in oddio_tpu/ops/pallas_ring.py).

A stream voice's ring is ``size_pad`` floats per channel row; pools view
their ``(V, C*R, 128)`` ring state as ``(V*C, size_pad)`` rows.  Both
kernels address that ring directly: on the TPU each needed a row-strip
gather (and, for the write, a scatter back), which on the GPU is an index
modulo ``size_pad``.

* ``ring_place`` (K4, for ``strip_place`` on the stream ingest path,
  oddio_tpu/ops/stream.py ``_write_pool``): in place,
  ``ring[r, (wpos[r] + j) mod size_pad] = chunk[r, j]`` for
  ``j < wcount[r]``.  ``wcount`` includes the zero-termination column.
* ``ring_resample`` (K6, for ``strip_resample`` on the stream read,
  ``render_batched``): per row, the strided fractional read
  ``lerp(ring[(start + p_j) mod size_pad], ring[(start + p_j + 1) mod
  size_pad], fr_j)`` with ``p_j``/``fr_j`` from the exact split-ds f32
  position math of ``_resample_kernel`` (truncate-toward-zero adjustment
  for a negative offset), zeroed where the unadjusted whole position is
  past ``len`` (the underrun padding of stream.rs:41-49).

A wrapper runs the plain PyTorch version for tensors on the CPU and
launches the CUDA kernel of ``csrc/stream_kernels.cu`` for tensors on a
CUDA device; it never falls back from one to the other.  Each launch adds
one to ``LAUNCHES[name]``.  Cursors stay device tensors: no host reads.
"""

from __future__ import annotations

import torch

from .ring_kernels import _check, _check_contig, _cuda_device, _ptr, _raise_rc, _stream_ptr

__all__ = [
    "RESAMPLE_W",
    "RESAMPLE_DSMAX",
    "RESAMPLE_NMAX",
    "LAUNCHES",
    "reset_launches",
    "ring_place",
    "ring_place_plain",
    "ring_resample",
    "ring_resample_plain",
]

#: read window of the TPU kernel's sub-block gather; it sizes the routing
#: check ``S_req <= size_pad`` (Stream.render_batched), kept as it is so
#: both packages route the same streams to the kernel
RESAMPLE_W = 768
#: per-frame step bound of the kernel path
RESAMPLE_DSMAX = 4.0
#: block-size bound of the kernel path
RESAMPLE_NMAX = 640

#: launches per kernel since the last reset (CUDA launches only)
LAUNCHES = {"ring_place": 0, "ring_resample": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _rows_i32(x, R, name, dev):
    _check(x, name, torch.int32, (R,), dev)
    _check_contig(x, name)


# --- K4: ring place ---------------------------------------------------------


def ring_place_plain(ring, chunk, wpos, wcount):
    """Plain version of K4, in place; returns ``ring``.  Lanes at
    ``j >= wcount`` rewrite the ring's own values (no positions repeat
    within a row, since ``mw <= size_pad``), so the scatter needs no
    host-side mask."""
    R, size = ring.shape
    mw = chunk.shape[1]
    j = torch.arange(mw, dtype=torch.int64, device=ring.device)
    idx = torch.remainder(wpos.to(torch.int64)[:, None] + j, size)
    keep = j[None, :] < wcount.to(torch.int64)[:, None]
    vals = torch.where(keep, chunk, torch.gather(ring, 1, idx))
    ring.scatter_(1, idx, vals)
    return ring


def ring_place(ring, chunk, wpos, wcount):
    """K4 (oddio_tpu/ops/pallas_ring.py ``strip_place``, as the stream pool
    ingest uses it): ring (R, size_pad) f32, chunk (R, mw) f32 with
    mw <= size_pad, wpos and wcount (R,) int32.  Writes
    ``chunk[r, :wcount[r]]`` at ``wpos[r]`` onward, wrapping; in place."""
    if not isinstance(ring, torch.Tensor) or ring.dim() != 2:
        raise ValueError("ring must be an (R, size_pad) tensor")
    R, size = ring.shape
    dev = ring.device
    _check(ring, "ring", torch.float32, (R, size), dev)
    if chunk.dim() != 2 or chunk.shape[0] != R:
        raise ValueError(f"chunk must be (R, mw), got {tuple(chunk.shape)}")
    mw = chunk.shape[1]
    if mw > size:
        raise ValueError(f"chunk width {mw} exceeds the ring's {size}")
    _check(chunk, "chunk", torch.float32, (R, mw), dev)
    _rows_i32(wpos, R, "wpos", dev)
    _rows_i32(wcount, R, "wcount", dev)
    if dev.type == "cpu":
        return ring_place_plain(ring, chunk, wpos, wcount)
    _cuda_device(ring)
    _check_contig(ring, "ring")
    if chunk.stride(1) != 1:
        raise ValueError("chunk rows must be unit-stride")
    if R == 0 or mw == 0:
        return ring
    from ._build import lib

    rc = lib("stream_kernels").ring_place(
        _ptr(ring), _ptr(chunk), chunk.stride(0), _ptr(wpos), _ptr(wcount),
        R, size, mw, _stream_ptr(dev),
    )
    LAUNCHES["ring_place"] += 1
    _raise_rc(rc, "ring_place")
    return ring


# --- K6: ring resample ------------------------------------------------------


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


def ring_resample_plain(ring, t, ds_int, f_hi, f_lo, start, len_, n):
    """Plain version of K6: (R, n) samples."""
    size = ring.shape[1]
    whole, p, fr = _positions(t, ds_int, f_hi, f_lo, n)
    idx = torch.remainder(start.to(torch.int64)[:, None] + p, size)
    a = torch.gather(ring, 1, idx)
    b = torch.gather(ring, 1, torch.remainder(idx + 1, size))
    s = a + fr * (b - a)
    return torch.where(whole < len_[:, None], s, 0.0)


def ring_resample(ring, t, ds_int, f_hi, f_lo, start, len_, n):
    """K6 (oddio_tpu/ops/pallas_ring.py ``strip_resample``, with the stream
    read's underrun mask fused): ring (R, size_pad) f32; t (read offset in
    (-1, 1)), f_hi, f_lo (R,) f32 and ds_int (R,) int32 (the split step,
    ``ops._dev.device_split_ds``); start, len (R,) int32.  Returns (R, n):
    the lerp at ``start + trunc(t + j*ds)``, 0 where the whole position is
    at or past ``len``."""
    if not isinstance(ring, torch.Tensor) or ring.dim() != 2:
        raise ValueError("ring must be an (R, size_pad) tensor")
    R, size = ring.shape
    dev = ring.device
    _check(ring, "ring", torch.float32, (R, size), dev)
    for x, nm in ((t, "t"), (f_hi, "f_hi"), (f_lo, "f_lo")):
        _check(x, nm, torch.float32, (R,), dev)
        _check_contig(x, nm)
    for x, nm in ((ds_int, "ds_int"), (start, "start"), (len_, "len")):
        _rows_i32(x, R, nm, dev)
    if n < 1 or n > 4096:
        raise ValueError(f"n={n} outside [1, 4096] (exact split products)")
    if dev.type == "cpu":
        return ring_resample_plain(ring, t, ds_int, f_hi, f_lo, start, len_, n)
    _cuda_device(ring)
    _check_contig(ring, "ring")
    out = torch.empty((R, n), dtype=torch.float32, device=dev)
    if R == 0:
        return out
    from ._build import lib

    rc = lib("stream_kernels").ring_resample(
        _ptr(ring), _ptr(t), _ptr(ds_int), _ptr(f_hi), _ptr(f_lo),
        _ptr(start), _ptr(len_), _ptr(out), R, size, n, _stream_ptr(dev),
    )
    LAUNCHES["ring_resample"] += 1
    _raise_rc(rc, "ring_resample")
    return out
