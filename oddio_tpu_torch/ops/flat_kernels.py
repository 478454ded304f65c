"""Flat-window and flat-ring kernels, for Hopper (counterpart of three
kernels of oddio_tpu/ops/pallas_ring.py that no path of either package
calls: the JAX package keeps them as K2's test reference, a superseded
append and a probe).

* ``window_select`` (K8, for ``window_select``/``_select_flat_kernel``):
  both ears' fractional reads from ONE flat window per voice, ``a_j =
  windows[v, extra_e + j + kk_j]`` and the next sample, lerped by
  ``fr_j`` (the exact split-ds positions of K2), the ramp ``g0 + j·dg``
  with the mask folded in, summed over voices into (2, n).  It is K2's
  wide-window form with no realign (``rowshift`` 0, the window at column
  0), no cursor advance and no frozen flags, and its CUDA kernel runs K2's
  design (``window_select_flat`` in ``csrc/ring_kernels.cu`` on the
  flat-window select of ``csrc/select_read.cuh``).
* ``flat_append_aligned`` (K9): the (V, W) slab, W a multiple of
  ``APPEND_PW`` = 512, copied into every row of a flat ring (V, rowlen) at
  page ``pcol`` and again at page ``pmir``, in place
  (``csrc/flat_kernels.cu``, on K1's slab append in
  ``csrc/append.cuh``).
* ``dma_window_select`` (K10): K8's reads with the kernel fetching each
  voice's window itself from the flat ring, at ``v*rowlen + rstart_v +
  extra_e + j + kk_j`` of ``ring.reshape(-1)``; the mask multiplies
  after the ramp, ``(s·(g0 + j·dg))·mask``, summed in voice order with
  no matvec (``csrc/flat_kernels.cu``, on the same flat-window select as
  K8).  The TPU kernel fetches two 1024-sample pages from ``v*rowlen +
  1024*floor(rstart_v/1024)`` of the flat ring, so a window past the end
  of row v reads row v+1; the port reads the same flat addresses.  Where
  that fetch leaves the tensor (the last voice's window past its row end,
  a negative start) the plain version raises and the kernel trips a
  device-side assert: a host check would read ``rstart`` back every
  call.

K8 and K10 are one launch each: the wrapper passes every operand's
pointer and strides, so a view that is not contiguous is read in place,
and allocates only the output (the cluster sum's scratch and tickets are
``ring_kernels._cluster_scratch``'s, shared with K2/K3 and K5).  Their
voices are summed in a fixed order (32-voice blocks, the blocks of a
cluster in rank order, then the clusters), so two calls on the same
inputs are bit-equal; the plain versions sum in another order, which the
tolerances (``window_select_tolerance``, ``dma_tolerance``) state.

The TPU layout helpers (``_pad_v``, ``_tile_for``, the 128-lane gathers,
the MXU matvec, the DMA semaphores) have no counterpart.  A wrapper runs
the plain version for tensors on the CPU and launches the kernel for
tensors on a CUDA device, never falling back from one to the other; each
launch adds one to ``LAUNCHES[name]``.
"""

from __future__ import annotations

import numpy as np
import torch

from ._build import lib
from .ring_kernels import (
    MIX_TOL_SIGMAS,
    SELECT_SB,
    _check,
    _check_contig,
    _cluster_scratch,
    _cuda_device,
    _mix_rows,
    _positions,
    _ptr,
    _raise_rc,
    _signature,
    _stream_ptr,
    ear_samples,
    mix_tolerance,
    select_window,
)

__all__ = [
    "APPEND_PW",
    "SELECT_W",
    "LAUNCHES",
    "reset_launches",
    "window_select",
    "window_select_plain",
    "window_select_samples",
    "window_select_tolerance",
    "flat_append_aligned",
    "flat_append_aligned_plain",
    "DMA_FETCH",
    "dma_window_select",
    "dma_window_select_plain",
    "dma_tolerance",
]

#: K9's page width (pallas_ring.py ``APPEND_PW``)
APPEND_PW = 512
#: K8's default table width (pallas_ring.py ``SELECT_W``): without
#: ``emax2`` the staggers reach ``SELECT_W - SELECT_SB - 2K - 1``
SELECT_W = 384
#: K10's per-voice fetch (two 1024-sample pages)
DMA_FETCH = 2048

#: launches per kernel since the last reset (CUDA launches only)
LAUNCHES = {"window_select": 0, "flat_append": 0, "dma_window_select": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --- K8: flat-window select -----------------------------------------------------


def _k8_emax2(emax2, K):
    return SELECT_W - SELECT_SB - 2 * K - 1 if emax2 is None else emax2


def _k8_operands(scal, gain0, d_gain, maskf, extra):
    """Per-ear operand rows in K2's layout: scal (V, 4), the mask-folded
    gains [g0, dg]·mask (V, 2), the staggers (V, 1)."""
    scal01 = [scal[:, e].contiguous() for e in range(2)]
    g01 = [(torch.stack([gain0[:, e], d_gain[:, e]], dim=-1) * maskf[:, None]).contiguous()
           for e in range(2)]
    e01 = [extra[:, e:e + 1].contiguous() for e in range(2)]
    return scal01, g01, e01


def window_select_samples(windows, scal, extra, n, K):
    """K8's per-ear reads before gains: two (V, n)."""
    zero = torch.zeros(windows.shape[0], dtype=torch.int32, device=windows.device)
    return [ear_samples(windows, 0, zero, 1, scal[:, e], extra[:, e:e + 1], None, n, K)
            for e in range(2)]


def window_select_plain(windows, scal, gain0, d_gain, maskf, extra, *, n, K,
                        emax2=None):
    """Plain version of K8: the reads as a gather, the mix in the JAX
    reference's matvec form (``_mix_rows``).  (2, n)."""
    _, g01, _ = _k8_operands(scal, gain0, d_gain, maskf, extra)
    return _mix_rows(window_select_samples(windows, scal, extra, n, K), g01, n)


def window_select_tolerance(windows, scal, gain0, d_gain, maskf, extra, *, n, K):
    """Elementwise tolerance on |kernel - plain| for K8's (2, n):
    ``ring_kernels.mix_tolerance`` on its reads (the same sums in another
    order)."""
    _, g01, _ = _k8_operands(scal, gain0, d_gain, maskf, extra)
    return mix_tolerance(window_select_samples(windows, scal, extra, n, K), g01, n)


def _flat_strides(scal, gain0, d_gain, maskf, extra, rstart=None):
    """The operands' element strides in the kernel's order (select_read.cuh
    ``flat_ops``), as the int64 host array it takes."""
    return np.array([*scal.stride(), *gain0.stride(), *d_gain.stride(), *maskf.stride(),
                     *extra.stride(), 0 if rstart is None else rstart.stride(0)], np.int64)


def _flat_launch(name, entry, src, row, ops, strides, V, n, K, emax2, words):
    """Launch K8 or K10 (``entry``) on ``src`` with row stride ``row`` and
    ``ops`` = (scal, gain0, d_gain, maskf, extra, rstart or None) read
    where they lie; the one allocation is the (2, n) output."""
    dev = src.device
    part, ticket = _cluster_scratch(dev, V, -(-n // SELECT_SB), words)
    out = torch.empty((2, n), dtype=torch.float32, device=dev)
    ptrs = np.array([0 if x is None else x.data_ptr() for x in ops], dtype=np.uint64)
    rc = entry(src.data_ptr(), row, ptrs.ctypes.data, strides.ctypes.data, _ptr(part),
               _ptr(ticket), out.data_ptr(), V, n, K, emax2, _stream_ptr(dev))
    LAUNCHES[name] += 1
    _raise_rc(rc, name)
    return out


#: the K8/K10 calls checked so far, by (kernel, operand signatures, n, K,
#: emax2): the operands' strides as the kernel takes them
_CHECKED = {}


def window_select(windows, scal, gain0, d_gain, maskf, extra, *, n, K,
                  emax2=None):
    """K8 (oddio_tpu/ops/pallas_ring.py ``window_select``).

    windows (V, S) f32 with S >= ``select_window(n, emax2, K)``; scal (V,
    2, 4) packed cursor scalars [frac, f_hi, f_lo, ds_int]; gain0, d_gain
    (V, 2) f32; maskf (V,) f32 (0/1, folded into the gains); extra (V, 2)
    int32 staggers below ``emax2`` (default ``SELECT_W - 128 - 2K - 1``).
    Returns the mixed (2, n).  On the card any strides are read in place
    (the windows' rows unit-stride), in one launch; a stagger outside
    ``[0, emax2)`` trips a device-side assert.  The checks run once per
    (shapes, strides, dtypes, devices, n, K, emax2)."""
    ops = (windows, scal, gain0, d_gain, maskf, extra)
    E2 = _k8_emax2(emax2, K)
    key = ("window_select", _signature(*ops), n, K, E2)
    strides = _CHECKED.get(key)
    if strides is None:
        if windows.dim() != 2:
            raise ValueError("windows must be a (V, S) tensor")
        V, S = windows.shape
        dev = windows.device
        _check(windows, "windows", torch.float32, (V, S), dev)
        _check(scal, "scal", torch.float32, (V, 2, 4), dev)
        _check(gain0, "gain0", torch.float32, (V, 2), dev)
        _check(d_gain, "d_gain", torch.float32, (V, 2), dev)
        _check(maskf, "maskf", torch.float32, (V,), dev)
        _check(extra, "extra", torch.int32, (V, 2), dev)
        if not 1 <= n <= 4096 or V < 1:
            raise ValueError(f"empty select or n={n} outside [1, 4096]")
        WIN = select_window(n, E2, K)
        if S < WIN:
            raise ValueError(f"window width {S} < select window {WIN}")
        if dev.type != "cpu":
            _cuda_device(windows)
            if windows.stride(1) != 1 or S >= 2**31:
                raise ValueError("windows rows must be unit-stride, narrower than 2^31")
        strides = _CHECKED[key] = _flat_strides(*ops[1:])
    if windows.device.type == "cpu":
        return window_select_plain(windows, scal, gain0, d_gain, maskf, extra,
                                   n=n, K=K, emax2=emax2)
    return _flat_launch("window_select", lib("ring_kernels").window_select_flat, windows,
                        windows.stride(0), (*ops[1:], None), strides, windows.shape[0], n,
                        K, E2, 4 * SELECT_SB)


# --- K9: aligned flat append ------------------------------------------------------


def _check_pair(pair):
    if not isinstance(pair, torch.Tensor) or pair.shape != (2,) or pair.dtype != torch.int32:
        raise ValueError("without pmir, pcol must be a (2,) int32 tensor [pcol, pmir]")


def _page_pair(pcol, pmir):
    """``pcol`` alone may be the [pcol, pmir] pair as a (2,) tensor."""
    if pmir is not None:
        return pcol, pmir
    _check_pair(pcol)
    return pcol[0], pcol[1]


def _check_pages(pages, W, rowlen):
    for p in pages:
        c = p * APPEND_PW
        if c < 0 or c + W > rowlen:
            raise IndexError(f"flat_append_aligned: page {p} leaves the ring row")


def flat_append_aligned_plain(ring, samples, pcol, pmir=None):
    """Plain version of K9: two slice assignments, in place (reads the
    page numbers to the host)."""
    W = samples.shape[1]
    pages = [int(p) for p in _page_pair(pcol, pmir)]
    _check_pages(pages, W, ring.shape[1])
    for p in pages:
        ring[:, p * APPEND_PW:p * APPEND_PW + W] = samples
    return ring


def _page_leg(p, name, device, W, rowlen):
    """One page as the kernel takes it: (pointer or None, value).  A CUDA
    int32 scalar passes as it is (no host read); a host int, or a CPU
    tensor, by value after a bounds check."""
    if isinstance(p, torch.Tensor) and p.device.type != "cpu":
        if p.device != device:
            raise ValueError(f"{name} on {p.device}, the ring on {device}")
        if p.dtype != torch.int32 or p.numel() != 1:
            raise TypeError(f"{name} must be an int32 scalar, got {p.dtype} {tuple(p.shape)}")
        return p.data_ptr(), 0
    p = int(p)
    _check_pages((p,), W, rowlen)
    return None, p


def flat_append_aligned(ring, samples, pcol, pmir=None):
    """K9 (oddio_tpu/ops/pallas_ring.py ``flat_append_aligned``): write
    ``samples`` (V, W), W a multiple of ``APPEND_PW``, into ``ring`` (V,
    rowlen) at column ``pcol*APPEND_PW`` and again at ``pmir*APPEND_PW``,
    in place; returns ``ring``.  pcol/pmir are ints or int32 scalar
    tensors, or ``pcol`` alone is the (2,) int32 pair [pcol, pmir]; device
    pages go to the kernel as they are (no stack, no host read), host ints
    by value.  A page whose span leaves the row fails (the plain version
    and the wrapper, for host ints, raise; the kernel trips a device-side
    assert for pages on the device).  On the card the ring's rows must be
    16-byte aligned (rowlen a multiple of 4): the kernel writes them with
    16-byte stores."""
    if not isinstance(ring, torch.Tensor) or not isinstance(samples, torch.Tensor):
        raise TypeError("ring and samples must be tensors")
    rs, ss = ring.shape, samples.shape
    if len(rs) != 2:
        raise ValueError(f"ring must be a (V, rowlen) tensor, got {tuple(rs)}")
    V, rowlen = rs
    if len(ss) != 2 or ss[0] != V or ss[1] % APPEND_PW or not 0 < ss[1] <= rowlen:
        raise ValueError(f"samples must be (V, W) with W % {APPEND_PW} == 0 and "
                         f"0 < W <= rowlen, got {tuple(ss)} for a ring {tuple(rs)}")
    if ring.dtype is not torch.float32 or samples.dtype is not torch.float32:
        raise TypeError(f"ring and samples must be float32, got {ring.dtype}, {samples.dtype}")
    dev = ring.device
    if samples.device != dev:
        raise ValueError(f"samples is on {samples.device}, the ring on {dev}")
    W = ss[1]
    if dev.type == "cpu":
        return flat_append_aligned_plain(ring, samples, pcol, pmir)
    _cuda_device(ring)
    if not ring.is_contiguous() or ring.data_ptr() % 16 or rowlen % 4 \
            or samples.stride(1) != 1:
        raise ValueError("ring must be contiguous with 16-byte aligned rows (rowlen % 4 == 0), "
                         "samples rows unit-stride")
    if pmir is None:
        _check_pair(pcol)
        if pcol.device != dev or not pcol.is_contiguous():
            raise ValueError(f"the page pair must be contiguous on {dev}, got {pcol.device}")
        p0 = pcol.data_ptr()
        p1, v0, v1 = p0 + 4, 0, 0
    else:
        p0, v0 = _page_leg(pcol, "pcol", dev, W, rowlen)
        p1, v1 = _page_leg(pmir, "pmir", dev, W, rowlen)
    rc = lib("flat_kernels").flat_append(
        ring.data_ptr(), rowlen, samples.data_ptr(), samples.stride(0), p0, p1, v0, v1,
        V, W, _stream_ptr(dev),
    )
    LAUNCHES["flat_append"] += 1
    _raise_rc(rc, "flat_append")
    return ring


# --- K10: select with its own window fetch ---------------------------------------


def _fetch_check(ring, rstart):
    """The TPU kernel's fetch, [v*rowlen + 1024*floor(rstart/1024), +2048)
    of the flat ring, must lie inside the tensor (plain version)."""
    V, rowlen = ring.shape
    lo = (torch.arange(V, device=ring.device) * rowlen
          + 1024 * torch.div(rstart.long(), 1024, rounding_mode="floor"))
    bad = (lo < 0) | (lo + DMA_FETCH > V * rowlen)
    if bool(bad.any()):
        v = int(bad.nonzero()[0, 0])
        raise IndexError(f"dma_window_select: voice {v}'s window fetch leaves the ring")


def _dma_products(ring, rstart, scal, gain0, d_gain, maskf, extra, n, K):
    """The per-voice summands ``(s·(g0 + j·dg))·mask``, (V, 2, n), with the
    reads at the flat addresses ``v*rowlen + rstart + extra_e + j + kk_j``."""
    V, rowlen = ring.shape
    flat = ring.reshape(-1)
    j = torch.arange(n, dtype=torch.int64, device=ring.device)
    jn = j.to(torch.float32)
    base = torch.arange(V, device=ring.device) * rowlen + rstart.long()
    outs = []
    for e in range(2):
        kk, fr = _positions(scal[:, e], n, K)
        idx = (base + extra[:, e].long())[:, None] + j + kk.long()
        a, b = flat[idx], flat[idx + 1]
        s = a + fr * (b - a)
        gains = gain0[:, e:e + 1] + jn * d_gain[:, e:e + 1]
        outs.append((s * gains) * maskf[:, None])
    return torch.stack(outs, dim=1)


def dma_window_select_plain(ring, rstart, scal, gain0, d_gain, maskf, extra, *,
                            n, K, emax2):
    """Plain version of K10: the flat-address reads as a gather, the
    summands in the TPU kernel's order, a float32 sum over voices.
    (2, n)."""
    _fetch_check(ring, rstart)
    return _dma_products(ring, rstart, scal, gain0, d_gain, maskf, extra, n, K).sum(dim=0)


def dma_tolerance(ring, rstart, scal, gain0, d_gain, maskf, extra, *, n, K):
    """Elementwise tolerance on |kernel - plain| for K10's (2, n): both
    add the same float32 summands x_v in different orders, so (as for
    ``ring_kernels.strip_tolerance``) ``MIX_TOL_SIGMAS`` times the
    random-walk scale ``2^-24·sqrt(Σ x_k² + P_k²)`` of the sum's
    roundings, P_k the running sums in voice order."""
    x = _dma_products(ring, rstart, scal, gain0, d_gain, maskf, extra, n, K).double()
    walk = (x.square() + x.cumsum(0).square()).sum(0).sqrt()
    return MIX_TOL_SIGMAS * 2.0**-24 * walk


def dma_window_select(ring, rstart, scal, gain0, d_gain, maskf, extra, *, n, K,
                      emax2):
    """K10 (oddio_tpu/ops/pallas_ring.py ``dma_window_select``).

    ring (V, rowlen) f32, rowlen a multiple of 1024; rstart (V,) int32 each
    voice's window base column; extra (V, 2) int32 per-ear staggers below
    ``emax2``; scal (V, 2, 4), gain0/d_gain (V, 2), maskf (V,) as
    ``window_select``.  Requires ``7*128 + select_window(n, 127 + emax2,
    K) <= 2048`` (the window fits the two-page fetch).  Returns (2, n).  On
    the card the ring must be contiguous, the other operands may have any
    strides (read in place), in one launch; a fetch outside the ring or a
    stagger outside ``[0, emax2)`` trips a device-side assert.  The checks
    run once per (shapes, strides, dtypes, devices, n, K, emax2)."""
    ops = (ring, rstart, scal, gain0, d_gain, maskf, extra)
    key = ("dma_window_select", _signature(*ops), n, K, emax2)
    strides = _CHECKED.get(key)
    if strides is None:
        if ring.dim() != 2:
            raise ValueError("ring must be a (V, rowlen) tensor")
        V, rowlen = ring.shape
        dev = ring.device
        if rowlen % 1024:
            raise ValueError(f"rowlen {rowlen} must be a multiple of 1024")
        _check(ring, "ring", torch.float32, (V, rowlen), dev)
        _check(rstart, "rstart", torch.int32, (V,), dev)
        _check(scal, "scal", torch.float32, (V, 2, 4), dev)
        _check(gain0, "gain0", torch.float32, (V, 2), dev)
        _check(d_gain, "d_gain", torch.float32, (V, 2), dev)
        _check(maskf, "maskf", torch.float32, (V,), dev)
        _check(extra, "extra", torch.int32, (V, 2), dev)
        if not 1 <= n <= 4096 or V < 1:
            raise ValueError(f"empty select or n={n} outside [1, 4096]")
        WR = select_window(n, 127 + emax2, K)
        if 128 * 7 + WR > DMA_FETCH:
            raise ValueError(f"window {WR} too wide for the {DMA_FETCH}-sample fetch")
        if dev.type != "cpu":
            _cuda_device(ring)
            _check_contig(ring, "ring")
        strides = _CHECKED[key] = _flat_strides(*ops[2:], rstart)
    if ring.device.type == "cpu":
        return dma_window_select_plain(ring, rstart, scal, gain0, d_gain, maskf,
                                       extra, n=n, K=K, emax2=emax2)
    return _flat_launch("dma_window_select", lib("flat_kernels").dma_window_select, ring,
                        ring.shape[1], (*ops[2:], rstart), strides, ring.shape[0], n, K,
                        emax2, 2 * SELECT_SB)
