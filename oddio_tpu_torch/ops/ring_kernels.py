"""Delay-ring kernels of the buffered spatial pools, for Hopper (counterpart
of oddio_tpu/ops/pallas_ring.py).

Four of the JAX package's Pallas kernels sit on the buffered pools' paths;
each has a plain PyTorch version here and a hand-written CUDA kernel, K1-K3
in ``csrc/ring_kernels.cu`` (the device-resident pool) and K5 in
``csrc/select_kernel.cu`` (the host pool):

* ``rows_append`` (K1, for ``rows_append_dma``): in-place copy of a
  ``(V, W)`` slab into every voice's rows-native ring ``(V, RPV, 128)`` at
  row ``r0`` and again at row ``rmir0`` (mirror upkeep or a dump row);
  ``rows_append_cursor`` derives both rows inside the kernel from the
  pool's write cursor, as the buffered pool calls it.  Its CUDA kernel is
  the slab append of ``csrc/append.cuh``, shared with K9.
* ``ring_select_ears`` (K2, for ``window_select_tiles_ears`` and the read
  preparation of oddio_tpu/spatial.py ``_windows_read``): the pool's
  two-ear read straight from its ring.  From each block's read operands
  as ``_BufferedPoolDR._advance_block`` leaves them (per-ear cursor,
  split step, gains, frozen flag, the mask) it rebuilds the shared-ear
  window start and staggers, reads ``a + fr*(b - a)`` at positions from
  the exact split-ds math, ramps the gains and sums over voices into
  ``(2, n)``; the family sub-pass reads the voices its list names.  One
  launch per read, read chunks included.
* ``ring_select_multi`` (K3, for ``window_select_tiles_multi`` and
  ``render_multi``'s superwindow): K2 for ``nb`` fused blocks, each read
  wrapped modulo the ring as the granule-wise superwindow gather wrapped
  it, with the coarse-shift clamp kept.
* ``strip_select`` (K5, for ``strip_select``): the host buffered pool's
  read, each voice's ring ``(V, L)`` addressed directly at ``128*rrow +
  extra_e`` onward (mod L), with the TPU kernel's per-sub-block walk
  clamp ``min(kk - kmin, SELECT_R - 1)``; gain-ramped, masked and summed
  over voices into ``(2, n)``, in one launch.  ``strip_select_record``
  reads the same operands from the host pool's per-voice operand record
  (``voice_record``: one (V, 20)-word row per voice, shipped with one
  copy per block, which K4's record form reads too).

K1, K2 and K5's record form also take a ScenePack's scene axis: the V rows
are S scenes of V/S voices each, K1 writes each scene at its own row pair
and K2 and K5 mix each scene apart into (S, 2, n); one launch per call
whatever S is.  K8
(``window_select``, ``ops/flat_kernels.py``) and K10 run K2's design on
flat windows (``csrc/select_read.cuh``).

A wrapper runs the plain version for tensors on the CPU and launches the
kernel for tensors on a CUDA device; it never falls back from one to the
other.  Each launch adds one to ``LAUNCHES[name]``.

The wide-window functions (``ear_samples``, ``window_select_ears_plain``,
``window_select_multi_plain``) keep the JAX kernels' interface: a window
per voice gathered beforehand, indexed at ``128*rowshift + extra_e + j +
kk_j`` with the realign's clamp of ``rowshift`` into ``[0, H)``.  They are
the reference the tests hold the ring-direct plain versions to.  The TPU
kernels' layout helpers (voice padding to 8 rows, the log-step row
realign, the 128-lane table gathers, the MXU matvec) have no counterpart.

Voice sums: the plain versions mix in the JAX reference's matvec form,
``(g0·S)_j + j·(dg·S)_j``.  The K2/K3 CUDA kernel computes the same two
sums per ear, adding 32-voice blocks within a thread block cluster, then
the clusters, each in a fixed order; K5 sums its ramped summands the same
way.  Kernel and plain version differ only by the order of the voice sum;
the tolerances ``mix_tolerance`` and ``strip_tolerance`` state for that
are sized to how rounding errors of a float32 sum really grow, so that
they fail a kernel that drops a voice or keeps its partial sums in bf16.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ._build import lib
from ._dev import device_advance

__all__ = [
    "PAGE",
    "SELECT_SB",
    "LAUNCHES",
    "select_tables",
    "select_window",
    "rows_append",
    "rows_append_plain",
    "rows_append_cursor",
    "rows_append_cursor_plain",
    "cursor_rows",
    "window_select_ears_plain",
    "window_select_multi_plain",
    "ear_samples",
    "mix_tolerance",
    "ear_starts",
    "ring_select_ears",
    "ring_select_ears_plain",
    "ring_select_ears_tolerance",
    "ring_select_multi",
    "ring_select_multi_plain",
    "ring_select_multi_tolerance",
    "multi_rows",
    "SELECT_R",
    "strip_positions",
    "strip_samples",
    "strip_select",
    "strip_select_plain",
    "strip_select_record",
    "strip_select_record_plain",
    "strip_tolerance",
    "strip_record_tolerance",
    "REC_WORDS",
    "REC_FIELDS",
    "voice_record",
    "record_fields",
    "record_operands",
]

PAGE = 1024  # ring page size (samples)
SELECT_SB = 128  # frames per sub-block in the read kernels
#: K2/K3's, K5's and K8/K10's voices per CUDA block (RS_VC in
#: csrc/ring_kernels.cu, VC in csrc/select_kernel.cu, FS_VC in
#: csrc/select_read.cuh)
SELECT_CHUNK = 32
#: most blocks one K3 read may fuse (MAX_NB in csrc/ring_kernels.cu)
MAX_NB = 8
#: multiples of the rounding-walk scale |kernel - plain| may reach
#: (``mix_tolerance``)
MIX_TOL_SIGMAS = 8.0

#: CUDA blocks per thread block cluster along the voice axis of K2/K3, K5
#: and K8/K10 (RS_CL in csrc/ring_kernels.cu, CL_MAX in
#: csrc/select_kernel.cu, FS_CL in csrc/select_read.cuh)
CLUSTER_MAX = 8
#: per device: the cluster-partial scratch and zeroed tickets that K2/K3,
#: K5 and K8/K10 share (their launches are ordered on the stream, and the
#: last cluster of each sum leaves its ticket zeroed)
_CLUSTER_SCRATCH = {}

#: K5's residual doppler-walk clamp per sub-block (``SELECT_R``,
#: pallas_ring.py:258): a read lands at most SELECT_R - 1 past the
#: sub-block's smallest walk offset
SELECT_R = 16

_F32, _I32 = torch.float32, torch.int32

#: launches per kernel since the last reset (CUDA launches only)
#: ("append" counts every K1 launch, "append_cursor" those of them through
#: the cursor form; "strip_select" every K5 launch, "strip_select_scenes"
#: those of them through the scene form)
LAUNCHES = {"append": 0, "append_cursor": 0, "select_ears": 0, "select_multi": 0,
            "strip_select": 0, "strip_select_scenes": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _cluster_scratch(dev, vps, slots, words):
    """(part, ticket) for a launch whose voice sum runs over thread block
    clusters of ``SELECT_CHUNK``-voice blocks (K2/K3, K5, K8/K10): ``slots``
    (scene, sub-block) sums of ``words`` floats per cluster and a zeroed
    ticket each; None, None when one cluster holds each scene's ``vps``
    voices (the kernel then writes its output directly)."""
    blocks = -(-vps // SELECT_CHUNK)
    cl = min(CLUSTER_MAX, 1 << (blocks - 1).bit_length())
    clusters = -(-blocks // cl)
    if clusters == 1:
        return None, None
    part, ticket = _CLUSTER_SCRATCH.get(dev, (None, None))
    grow_part = part is None or part.numel() < slots * clusters * words
    grow_ticket = ticket is None or ticket.numel() < slots  # grows (a fill launch) past 4096
    if (grow_part or grow_ticket) and torch.device(dev).type == "cuda" \
            and torch.cuda.is_current_stream_capturing():
        # scratch made during a CUDA graph capture would live in the graph's
        # private pool and alias later launches: the Renderer's eager
        # warm-up of every step key sizes it first
        raise RuntimeError("cluster scratch grew during a CUDA graph capture")
    if grow_part:
        part = torch.empty(slots * clusters * words, dtype=_F32, device=dev)
    if grow_ticket:
        ticket = torch.zeros(max(slots, 4096), dtype=_I32, device=dev)
    _CLUSTER_SCRATCH[dev] = (part, ticket)
    return part, ticket


def select_tables(emax2, K=64, SB=SELECT_SB):
    """Lookup-table width (a multiple of 128) one sub-block's reads span:
    extra (< emax2) + lane (< SB) + doppler walk (<= 2K) + 1 (lerp)."""
    return -(-(emax2 + SB + 2 * K + 1) // 128) * 128


def select_window(n, emax2, K=64, SB=SELECT_SB):
    """Total per-voice window width for an n-frame block."""
    nsb = -(-n // SB)
    return (nsb - 1) * SB + select_tables(emax2, K, SB)


# --- checks -------------------------------------------------------------------


def _check(x, name, dtype, shape, device):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(x).__name__}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")


def _check_contig(x, name):
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _cuda_device(x):
    if x.device.type != "cuda":
        raise ValueError(
            f"ring kernels run on CUDA tensors or on the CPU (plain version); "
            f"got a tensor on {x.device}"
        )


#: the current CUDA stream's raw handle for a device index, without
#: building a ``torch.cuda.Stream`` (PyTorch's own kernels' launch path)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream_ptr(device):
    """The current stream of a CUDA ``device`` as the int the ctypes
    ``c_void_p`` arguments take."""
    if _raw_stream is not None:
        idx = device.index
        return _raw_stream(torch.cuda.current_device() if idx is None else idx)
    return torch.cuda.current_stream(device).cuda_stream


def _ptr(x):
    """A tensor's data pointer as the int (None: null) a ``c_void_p``
    argument takes."""
    return None if x is None else x.data_ptr()


def _raise_rc(rc, name):
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")


# --- K1: rows append ------------------------------------------------------------


def _rows_index(r0, rmir0, device):
    """(S, 2) int32 tensor of [r0, rmir0] pairs, one per scene, for the
    plain version: ints and 0-d tensors give S = 1, (S,) tensors S
    scenes."""
    parts = [
        r.reshape(-1).to(device=device, dtype=torch.int32)
        if isinstance(r, torch.Tensor)
        else torch.tensor([int(r)], dtype=torch.int32, device=device)
        for r in (r0, rmir0)
    ]
    if parts[0].shape != parts[1].shape:
        raise ValueError("r0 and rmir0 must name the same number of scenes")
    return torch.stack(parts, dim=1)


def _scene_count(V, S):
    if S < 1 or V % S:
        raise ValueError(f"{V} voice rows do not split into {S} scenes")
    return V // S


def rows_append_plain(ring3, slab, r0, rmir0):
    """Plain version of K1: ``ring3[v, r:r+W/128] = slab[v]`` for r in
    (r0, rmir0) of voice v's scene, in place."""
    V, RPV, PW = ring3.shape
    W = slab.shape[1]
    rows = _rows_index(r0, rmir0, ring3.device).to(torch.int64)
    vps = _scene_count(V, rows.shape[0])
    rows = rows.repeat_interleave(vps, dim=0)  # (V, 2)
    flat = ring3.view(V, RPV * PW)
    lanes = torch.arange(W, dtype=torch.int64, device=ring3.device)
    for leg in range(2):
        cols = (rows[:, leg] * PW)[:, None] + lanes
        if bool((cols[:, -1] >= RPV * PW).any()) or bool((cols[:, 0] < 0).any()):
            raise IndexError("rows_append: a leg leaves the ring")
        flat.scatter_(1, cols, slab)
    return ring3


def cursor_rows(start, FP, cap, M):
    """The rows K1's cursor form writes at, derived from the pool's write
    cursor ``start`` as oddio_tpu/spatial.py derives them beside
    ``rows_append_dma``: ``r0 = (FP + start) // 128`` and ``rm = (FP +
    where(start < M, start + cap, cap + M)) // 128``, floor division."""
    r0 = torch.div(FP + start, 128, rounding_mode="floor")
    rm = torch.div(FP + torch.where(start < M, start + cap, cap + M), 128,
                   rounding_mode="floor")
    return r0, rm


def rows_append_cursor_plain(ring3, slab, start, FP, cap, M):
    """Plain version of K1's cursor form: ``rows_append_plain`` at
    ``cursor_rows(start, FP, cap, M)``."""
    return rows_append_plain(ring3, slab, *cursor_rows(start, FP, cap, M))


def _append_operands(ring3, slab):
    """Check K1's ring and slab with a few cheap reads (K1 runs every
    block); returns (V, RPV, nr, device)."""
    if not isinstance(ring3, torch.Tensor) or not isinstance(slab, torch.Tensor):
        raise TypeError("ring3 and slab must be tensors")
    rs, ss = ring3.shape, slab.shape
    if len(rs) != 3 or rs[2] != 128:
        raise ValueError(f"ring3 must be a (V, RPV, 128) tensor, got {tuple(rs)}")
    if len(ss) != 2 or ss[0] != rs[0] or ss[1] % 128 or not 0 < ss[1] <= 128 * rs[1]:
        raise ValueError(f"slab must be (V, W) with W % 128 == 0 and 0 < W <= 128*RPV, "
                         f"got {tuple(ss)} for a ring {tuple(rs)}")
    if ring3.dtype is not _F32 or slab.dtype is not _F32:
        raise TypeError(f"ring3 and slab must be float32, got {ring3.dtype}, {slab.dtype}")
    dev = ring3.device
    if slab.device != dev:
        raise ValueError(f"slab is on {slab.device}, ring3 on {dev}")
    if dev.type != "cpu":
        _cuda_device(ring3)
        if not ring3.is_contiguous() or ring3.data_ptr() % 16 or slab.stride(1) != 1:
            raise ValueError("ring3 must be contiguous and 16-byte aligned, slab rows unit-stride")
    return rs[0], rs[1], ss[1] // 128, dev


def _device_int32(x, name, device):
    """A device int32 tensor of at most one dimension, as the kernel reads
    it: (pointer, count)."""
    if x.dtype is not _I32:
        raise TypeError(f"{name} must be int32, got {x.dtype}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, the ring on {device}")
    if x.dim() > 1 or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 0-d or (S,) tensor")
    return x.data_ptr(), x.numel()


def _row_leg(r, name, device, RPV, nr):
    """One leg's rows as the kernel takes them: (pointer or None, value,
    scenes).  A CUDA tensor passes as it is (no host read); a host int, or
    a one-value CPU tensor, by value after a bounds check."""
    if isinstance(r, torch.Tensor) and r.device.type != "cpu":
        ptr, S = _device_int32(r, name, device)
        return ptr, 0, S
    if isinstance(r, torch.Tensor) and r.numel() != 1:
        raise ValueError(f"{name} is on the CPU, the ring on {device}")
    r = int(r)
    if r < 0 or r + nr > RPV:
        raise IndexError(f"rows_append: {name} = {r} leaves the ring")
    return None, r, 1


def rows_append(ring3, slab, r0, rmir0):
    """K1 (oddio_tpu/ops/pallas_ring.py ``rows_append_dma``): write ``slab``
    (V, W), W a multiple of 128, into every voice of ``ring3`` (V, RPV, 128)
    at row ``r0`` and at row ``rmir0``, in place; returns ``ring3``.

    Scene axis (ScenePack): ``r0``/``rmir0`` are ints, 0-d tensors (one
    scene) or (S,) int32 tensors, one pair per scene, and the V rows are S
    scenes of V/S voices each, in order.  Device rows go to the kernel as
    they are, host ints by value.  A row outside ``[0, RPV - W/128]``
    fails: the plain version and the wrapper (host ints) raise, the kernel
    trips a device-side assert (device rows: a host check would stall
    every block)."""
    V, RPV, nr, dev = _append_operands(ring3, slab)
    if dev.type == "cpu":
        return rows_append_plain(ring3, slab, r0, rmir0)
    p0, v0, s0 = _row_leg(r0, "r0", dev, RPV, nr)
    p1, v1, s1 = _row_leg(rmir0, "rmir0", dev, RPV, nr)
    if s0 != s1:
        raise ValueError("r0 and rmir0 must name the same number of scenes")
    vps = _scene_count(V, s0)
    rc = lib("ring_kernels").rows_append(
        ring3.data_ptr(), slab.data_ptr(), slab.stride(0), p0, p1, v0, v1,
        V, RPV, nr, vps, _stream_ptr(dev),
    )
    LAUNCHES["append"] += 1
    _raise_rc(rc, "rows_append")
    return ring3


def rows_append_cursor(ring3, slab, start, FP, cap, M):
    """K1's cursor form: ``rows_append`` at the rows ``cursor_rows(start,
    FP, cap, M)``, derived inside the kernel from the pool's write cursor
    ``start`` (0-d or (S,) int32, one per scene; FP, cap, M host ints: the
    front pad, the ring modulus, the mirror width), so the caller launches
    nothing to compute them.  Counts in ``LAUNCHES["append"]`` and
    ``LAUNCHES["append_cursor"]``."""
    V, RPV, nr, dev = _append_operands(ring3, slab)
    if not isinstance(start, torch.Tensor) or start.dim() > 1:
        raise ValueError("start must be a 0-d or (S,) int32 tensor")
    if dev.type == "cpu":
        if start.dtype != torch.int32:
            raise TypeError(f"start must be int32, got {start.dtype}")
        return rows_append_cursor_plain(ring3, slab, start, FP, cap, M)
    ptr, S = _device_int32(start, "start", dev)
    vps = _scene_count(V, S)
    rc = lib("ring_kernels").rows_append_cursor(
        ring3.data_ptr(), slab.data_ptr(), slab.stride(0), ptr, FP, cap, M,
        V, RPV, nr, vps, _stream_ptr(dev),
    )
    LAUNCHES["append"] += 1
    LAUNCHES["append_cursor"] += 1
    _raise_rc(rc, "rows_append_cursor")
    return ring3


# --- the wide-window reads (the JAX kernels' interface; the tests' reference) ----


def _positions(scal, n, K):
    """Exact read positions (``_positions_sb``, pallas_ring.py:265) for
    frames 0..n-1: kk = clip(whole - j + K, 0, 2K) as f32, fr in [0, 1)."""
    o0 = scal[:, 0:1]
    f_hi = scal[:, 1:2]
    f_lo = scal[:, 2:3]
    dsm1 = scal[:, 3:4] - 1.0  # ds_int - 1 (exact small int as f32)
    t_f = torch.arange(n, dtype=torch.float32, device=scal.device)
    H = t_f * f_hi  # exact f32 product for t < 4096 (12-bit f_hi)
    Hf = torch.floor(H)
    u = (H - Hf) + (o0 + t_f * f_lo)
    fl_u = torch.floor(u)
    fr = u - fl_u
    kk = torch.clamp(t_f * dsm1 + Hf + fl_u + float(K), 0.0, float(2 * K))
    return kk, fr


def ear_samples(wide, col0, rowshift, H, scal, extra, frz, n, K):
    """(V, n) fractional reads of one ear, before gains: a_j =
    win[extra + j + kk_j], b_j the next sample, s = a + fr*(b - a), with
    win = wide[v, col0 + 128*clamp(rowshift, 0, H-1):].  A voice whose
    frz > 0 repeats its j = 0 sample (a fully offset-clamped, ds = 0 read)."""
    shift = rowshift.to(torch.int64).clamp(0, H - 1)
    kk, fr = _positions(scal, n, K)
    j = torch.arange(n, dtype=torch.int64, device=wide.device)
    idx = (col0 + 128 * shift)[:, None] + extra.to(torch.int64) + j[None, :] + kk.to(torch.int64)
    a = torch.gather(wide, 1, idx)
    b = torch.gather(wide, 1, idx + 1)
    s = a + fr * (b - a)
    if frz is not None:
        s = torch.where(frz > 0.0, s[:, :1], s)
    return s


def _mix_rows(samps, gs, n):
    """Voice mix in the JAX reference's matvec form (``_mix_rows``,
    pallas_ring.py:550): (g0·S)_j + j·(dg·S)_j per ear -> (2, n)."""
    jn = torch.arange(n, dtype=torch.float32, device=samps[0].device)
    rows = []
    for samp, g in zip(samps, gs):
        m0 = g[:, 0] @ samp
        m1 = g[:, 1] @ samp
        rows.append(m0 + jn * m1)
    return torch.stack(rows)


def _per_scene(fn, samps, gs, n, scenes):
    """``fn(samps, gs, n)`` over each scene's rows: (S, 2, n), or fn's own
    (2, n) when ``scenes`` is None."""
    if scenes is None:
        return fn(samps, gs, n)
    vps = _scene_count(samps[0].shape[0], scenes)
    return torch.stack([
        fn([x[s * vps:(s + 1) * vps] for x in samps],
           [g[s * vps:(s + 1) * vps] for g in gs], n)
        for s in range(scenes)
    ])


def mix_tolerance(samps, gs, n, scenes=None):
    """Elementwise tolerance on |kernel - plain| for one block's voice mix
    (2, n), from the per-ear samples ``samps`` (V, n) and gains ``gs``
    (V, 2); with ``scenes``, per scene: (S, 2, n).

    Both versions round the same V products g·s and add them in float32,
    in different orders.  Each rounding errs by at most 2^-24 of its result,
    with a sign that varies from one rounding to the next, so a sum's error
    grows like a random walk over its roundings: its scale is
    ``2^-24·sqrt(Σ_k x_k² + P_k²)`` over the products x_k and the running
    sums P_k (voice order, in float64).  The tolerance is
    ``MIX_TOL_SIGMAS`` times that scale for the g0 sum and for j times the
    dg sum, plus both sides' roundings of the final ``m0 + j·m1``.  The
    worst-case bound ``2(V-1)·2^-24·Σ|g·s|`` grows with V instead and,
    at 4096 voices, passes a kernel that drops a voice."""
    return _per_scene(_mix_tolerance, samps, gs, n, scenes)


def _mix_tolerance(samps, gs, n):
    u = 2.0**-24
    jn = torch.arange(n, dtype=torch.float64, device=samps[0].device)
    rows = []
    for samp, g in zip(samps, gs):
        s = samp.double()
        walk, total = [], []
        for col in range(2):
            x = g[:, col].double()[:, None] * s
            walk.append((x.square() + x.cumsum(0).square()).sum(0).sqrt())
            total.append(x.sum(0).abs())
        rows.append(u * (
            MIX_TOL_SIGMAS * (walk[0] + jn * walk[1])
            + 2.0 * (total[0] + 2.0 * jn * total[1])
        ))
    return torch.stack(rows)


def _geometry(S2, n, K, emax2, hmax):
    WIN = select_window(n, emax2, K)
    if S2 < WIN:
        raise ValueError(f"window span {S2} < select window {WIN}")
    H = (S2 - WIN) // 128 + 1
    if hmax is not None:
        H = min(H, hmax)
    return WIN, H


def window_select_ears_plain(wide, rowshift, scal01, g01, e01, *, n, K,
                             emax2, hmax=None, frz01=None, scenes=None):
    """Plain version of K2, same signature as the JAX wrapper; with
    ``scenes``, each scene's rows mixed apart, as S single-scene calls."""
    _, H = _geometry(wide.shape[1], n, K, emax2, hmax)
    samps = [
        ear_samples(wide, 0, rowshift, H, scal01[e], e01[e],
                    None if frz01 is None else frz01[e], n, K)
        for e in range(2)
    ]
    return _per_scene(_mix_rows, samps, g01, n, scenes)


def window_select_multi_plain(wide, rowshift, scal01, g01, e01, frz01, *, n,
                              K, emax2, nb, row0s, hs):
    """Plain version of K3: nb K2 reads from one superwindow per voice,
    block b at the static column 128*row0s[b] with shift rowshift[:, b]."""
    WIN = select_window(n, emax2, K)
    outs = []
    for b in range(nb):
        if 128 * row0s[b] + WIN + 128 * (hs[b] - 1) > wide.shape[1]:
            raise ValueError(f"block {b} window leaves the superwindow")
        samps = [
            ear_samples(
                wide, 128 * row0s[b], rowshift[:, b], hs[b],
                scal01[e][:, 4 * b : 4 * b + 4], e01[e][:, b : b + 1],
                frz01[e][:, b : b + 1], n, K,
            )
            for e in range(2)
        ]
        outs.append(_mix_rows(
            samps, [g01[e][:, 2 * b : 2 * b + 2] for e in range(2)], n
        ))
    return torch.cat(outs, dim=-1)


# --- K2/K3: ring select (the device-resident buffered pool's read) --------------


def ear_starts(base_c, cap, DMAX, K, FP):
    """The shared-ear window start ``rstart`` (a ring column) and the
    per-ear staggers ``dstart`` (the two ears' starts differ by at most
    the inter-ear distance ``DMAX``), from the ears' int32 read cursors,
    as oddio_tpu/spatial.py ``_windows_read`` derives them."""
    ob0 = torch.remainder(base_c[0], cap)
    ob1 = torch.remainder(base_c[1], cap)
    dlr = torch.remainder(ob0 - ob1, cap)
    l_ahead = dlr <= DMAX
    cm = torch.where(l_ahead, ob1, ob0)
    dstart = [
        torch.where(l_ahead, dlr, 0).clamp(0, DMAX),
        torch.where(l_ahead, 0, cap - dlr).clamp(0, DMAX),
    ]
    return torch.remainder(cm - K, cap) + FP, dstart


def _scal(frac, split):
    """One ear's packed cursor scalars [frac, f_hi, f_lo, ds_int] (V, 4)."""
    ds, fh, fl = split
    return torch.stack([frac, fh, fl, ds.to(_F32)], dim=-1)


def _ring_samples(flat, q, scal, frz, n, K, wrap=None):
    """(V, n) reads of one ear from the flat ring: ``a`` at the int64 flat
    index ``q + kk_j`` ((V, n) ``q``: frame j's index before the walk),
    ``b`` at the next, ``s = a + fr*(b - a)``; a voice whose frz > 0
    repeats its j = 0 sample (``ear_samples``' arithmetic).  With ``wrap``
    = (row offsets (V, 1), FP, cap), ``q + kk_j`` is an offset past column
    FP of the voice's row, wrapped modulo cap, and so is the next (K3)."""
    kk, fr = _positions(scal, n, K)
    q = q + kk.to(torch.int64)
    if wrap is None:
        ia, ib = q, q + 1
    else:
        rowoff, FP, cap = wrap
        ia = rowoff + FP + torch.remainder(q, cap)
        ib = rowoff + FP + torch.remainder(q + 1, cap)
    a = flat[ia]
    b = flat[ib]
    s = a + fr * (b - a)
    if frz is not None:
        s = torch.where(frz[:, None] > 0.0, s[:, :1], s)
    return s


def _ears_reads(ring, ro, n, K, R, DMAX, FP, cap, tight, sub_idx, sub_on):
    """K2's reads chunk by chunk, as the pool made them: per chunk of at
    most R frames, (the per-ear (Vr, n_c) samples, the per-ear (Vr, 2)
    mask-folded gains [g0, dg], n_c)."""
    V = ring.shape[0]
    flat = ring.reshape(-1)
    rowlen = flat.numel() // V
    base_c, frac_c = list(ro["base_c"]), list(ro["frac_c"])
    split_c, frz_c = ro["split_c"], ro["frz_c"]
    p_gain_c, d_gain_c, maskf = ro["p_gain_c"], ro["d_gain_c"], ro["maskf"]
    if sub_idx is None:
        rows = torch.arange(V, dtype=torch.int64, device=ring.device)
        if tight is not None:
            maskf = maskf * tight
    else:
        # the sub-pass: the listed voices, read at every frame
        rows = sub_idx.to(torch.int64)
        base_c = [b[rows] for b in base_c]
        frac_c = [f[rows] for f in frac_c]
        split_c = [tuple(x[rows] for x in s) for s in split_c]
        p_gain_c = [g[rows] for g in p_gain_c]
        d_gain_c = [g[rows] for g in d_gain_c]
        maskf = maskf[rows] * sub_on
        frz_c = None
    for j0 in range(0, n, R):
        n_c = min(R, n - j0)
        j = torch.arange(n_c, dtype=torch.int64, device=ring.device)
        rstart, dstart = ear_starts(base_c, cap, DMAX, K, FP)
        samps, g01 = [], []
        for e in range(2):
            samps.append(_ring_samples(
                flat, (rows * rowlen + rstart + dstart[e])[:, None] + j,
                _scal(frac_c[e], split_c[e]), None if frz_c is None else frz_c[e], n_c, K,
            ))
            g0_e = (p_gain_c[e] + float(j0) * d_gain_c[e]) * maskf
            g01.append(torch.stack([g0_e, d_gain_c[e] * maskf], dim=-1))
        yield samps, g01, n_c
        if j0 + n_c < n:
            for e in range(2):
                base_c[e], frac_c[e] = device_advance(base_c[e], frac_c[e], n_c, *split_c[e])


def _multi_reads(ring, ros, n, K, DMAX, FP, cap, row0s, hs):
    """K3's reads block by block, as ``render_multi`` made them: per block,
    (the per-ear (V, n) samples, the per-ear (V, 2) gains sliced from the
    group's (V, 2*nb) rows)."""
    V = ring.shape[0]
    flat = ring.reshape(-1)
    rowoff = torch.arange(V, dtype=torch.int64, device=ring.device)[:, None] * (flat.numel() // V)
    j = torch.arange(n, dtype=torch.int64, device=ring.device)
    qs, scal, g01 = [], ([], []), ([], [])
    for b, ro in enumerate(ros):
        rstart, dstart = ear_starts(ro["base_c"], cap, DMAX, K, FP)
        if b == 0:
            rstart0 = rstart
            base_col = torch.div(rstart0, 1024, rounding_mode="floor") * 1024
        rel = torch.remainder(rstart - rstart0, cap)
        rsh = torch.div(rstart0 - base_col + rel, 128, rounding_mode="floor") - row0s[b]
        sh = rsh.to(torch.int64).clamp(0, hs[b] - 1)
        q0 = base_col - FP + 128 * (row0s[b] + sh) + torch.remainder(rstart, 128)
        qs.append([(q0 + dstart[e])[:, None] + j for e in range(2)])
        for e in range(2):
            scal[e].append(_scal(ro["frac_c"][e], ro["split_c"][e]))
            g01[e].append(torch.stack([ro["p_gain_c"][e] * ro["maskf"],
                                       ro["d_gain_c"][e] * ro["maskf"]], dim=-1))
    g01 = [torch.cat(g, dim=-1) for g in g01]
    for b, ro in enumerate(ros):
        samps = [_ring_samples(flat, qs[b][e], scal[e][b], ro["frz_c"][e], n, K,
                               wrap=(rowoff, FP, cap)) for e in range(2)]
        yield samps, [g[:, 2 * b:2 * b + 2] for g in g01]


def multi_rows(adv, K, nb):
    """``render_multi``'s static coarse rows and shift ranges for a fused
    group of ``nb`` blocks, each advancing ``adv`` frames at walk bound K:
    block b's window base lies within [b*(adv - K), b*(adv + K)] past
    block 0's, plus block 0's in-granule remainder (< 1024).  (row0s,
    hs), as ``ring_select_multi`` takes them."""
    row0s = [max(0, int(np.floor(b * (adv - K) / 128))) for b in range(nb)]
    return row0s, [int(1023 + b * (adv + K)) // 128 - row0s[b] + 1 for b in range(nb)]


def ring_select_ears_plain(ring, ro, *, n, K, R, DMAX, FP, cap, tight=None,
                           sub_idx=None, sub_on=None, scenes=None):
    """Plain version of K2: the reads gathered straight from the ring, the
    mix in the JAX reference's matvec form, per read chunk.  Equal bit for
    bit to the parent's window gather fed to ``window_select_ears_plain``.
    (2, n), or (S, 2, n) with ``scenes``."""
    parts = [_per_scene(_mix_rows, samps, g01, n_c, scenes)
             for samps, g01, n_c in _ears_reads(ring, ro, n, K, R, DMAX, FP, cap,
                                                 tight, sub_idx, sub_on)]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def ring_select_ears_tolerance(ring, ro, *, n, K, R, DMAX, FP, cap, tight=None,
                               sub_idx=None, sub_on=None, scenes=None):
    """Elementwise tolerance on |kernel - plain| for K2's mix:
    ``mix_tolerance`` on its reads, per chunk (and per scene)."""
    return torch.cat([_per_scene(_mix_tolerance, samps, g01, n_c, scenes)
                      for samps, g01, n_c in _ears_reads(ring, ro, n, K, R, DMAX, FP, cap,
                                                          tight, sub_idx, sub_on)], dim=-1)


def ring_select_multi_plain(ring, ros, *, n, K, DMAX, FP, cap, row0s, hs):
    """Plain version of K3: each block's reads gathered from the ring at
    ``FP + q mod cap`` (the granule-wise superwindow's wrap), mixed as
    ``window_select_multi_plain`` mixes them.  (2, nb*n)."""
    return torch.cat([_mix_rows(samps, g01, n) for samps, g01 in
                      _multi_reads(ring, ros, n, K, DMAX, FP, cap, row0s, hs)], dim=-1)


def ring_select_multi_tolerance(ring, ros, *, n, K, DMAX, FP, cap, row0s, hs):
    """Elementwise tolerance on |kernel - plain| for K3's (2, nb*n)."""
    return torch.cat([_mix_tolerance(samps, g01, n) for samps, g01 in
                      _multi_reads(ring, ros, n, K, DMAX, FP, cap, row0s, hs)], dim=-1)


#: K2/K3's coarse geometry (row0 0, shift range 8) and K3's, as the int32
#: host arrays the entry point takes
_READ_GEO = {}


def _read_geo(row0s, hs):
    key = (tuple(row0s), tuple(hs))
    geo = _READ_GEO.get(key)
    if geo is None:
        geo = _READ_GEO[key] = np.array(list(row0s) + list(hs), dtype=np.int32)
    return geo


def _block_operands(ro, tight, frozen):
    """One block's operand tensors in the kernel's order (RS_PTRS): per
    ear base, frac, ds_int, f_hi, f_lo, gain, d_gain, frozen flag (or
    None); then the mask and ``tight`` (or None)."""
    ops = []
    for e in range(2):
        ops += [ro["base_c"][e], ro["frac_c"][e], *ro["split_c"][e], ro["p_gain_c"][e],
                ro["d_gain_c"][e], ro["frz_c"][e] if frozen else None]
    return ops + [ro["maskf"], tight]


#: the kernel's dtype for each of a block's operands, in that order
_BLOCK_DTYPES = (_I32, _F32, _I32, _F32, _F32, _F32, _F32, _F32) * 2 + (_F32, _F32)


def _check_read(ring, ops, V, Vr, n, R, K, DMAX, FP, cap, scenes, sub):
    """The checks of a K2/K3 call (once per signature): the ring, each
    block's (V,) operands, the sub-pass list, the geometry."""
    if not isinstance(ring, torch.Tensor) or ring.dim() != 3 or ring.shape[2] != 128:
        raise ValueError("ring must be a (V, RPV, 128) tensor")
    dev = ring.device
    _check(ring, "ring", _F32, tuple(ring.shape), dev)
    for k, x in enumerate(ops):
        if x is not None:
            nm = f"read operand {k % len(_BLOCK_DTYPES)} of block {k // len(_BLOCK_DTYPES)}"
            _check(x, nm, _BLOCK_DTYPES[k % len(_BLOCK_DTYPES)], (V,), dev)
            _check_contig(x, nm)
    if sub is not None:
        _check(sub[0], "sub_idx", _I32, (Vr,), dev)
        _check(sub[1], "sub_on", _F32, (Vr,), dev)
        _check_contig(sub[0], "sub_idx")
        _check_contig(sub[1], "sub_on")
        if scenes is not None:
            raise ValueError("a sub-pass reads one scene")
    _scene_count(Vr, 1 if scenes is None else scenes)
    rowlen = ring.shape[1] * 128
    if not 1 <= n or R < SELECT_SB or R % SELECT_SB or R > 4096:
        raise ValueError(f"n={n}, R={R}: R must be a multiple of {SELECT_SB} up to 4096")
    if FP < 0 or cap < 1 or DMAX < 0 or K < 0 or FP + cap > rowlen:
        raise ValueError(f"ring geometry FP={FP} cap={cap} outside a row of {rowlen}")
    if dev.type != "cpu":
        _cuda_device(ring)
        _check_contig(ring, "ring")


def _read_launch(name, ring, ops, geo, sub, Vr, scenes, n, R, K, DMAX, FP, cap, wrap, nb):
    """Launch the K2/K3 kernel: (S, 2, nb*n)."""
    dev = ring.device
    S = 1 if scenes is None else scenes
    part, ticket = _cluster_scratch(dev, Vr // S, S * nb * -(-n // SELECT_SB), 4 * SELECT_SB)
    out = torch.empty((S, 2, nb * n), dtype=_F32, device=dev)
    ptrs = np.array([0 if x is None else x.data_ptr() for x in ops], dtype=np.uint64)
    sub_idx, sub_on = (None, None) if sub is None else sub
    rc = lib("ring_kernels").ring_select(
        ring.data_ptr(), ring.shape[1] * 128, ring.shape[0], ptrs.ctypes.data, geo.ctypes.data,
        _ptr(sub_idx), _ptr(sub_on), _ptr(part), _ptr(ticket), out.data_ptr(),
        Vr, Vr // S, n, R, K, DMAX, FP, cap, wrap, nb, _stream_ptr(dev),
    )
    LAUNCHES[name] += 1
    _raise_rc(rc, name)
    return out


def _read_signature(ring, ops, sub):
    return tuple(None if x is None else (x.shape, x.stride(), x.dtype, x.device)
                 for x in (ring, *ops, *(sub or ())))


def ring_select_ears(ring, ro, *, n, K, R, DMAX, FP, cap, tight=None, sub_idx=None,
                     sub_on=None, scenes=None):
    """K2 (oddio_tpu/ops/pallas_ring.py ``window_select_tiles_ears`` with
    the read preparation of oddio_tpu/spatial.py ``_windows_read``): the
    device-resident buffered pool's two-ear read, straight from its ring.

    ring (V, RPV, 128) f32: each voice's row, front pad ``FP``, ring
    modulus ``cap``, then the mirror; ``ro``: one block's read operands
    as ``_BufferedPoolDR._advance_block`` leaves them (``base_c``,
    ``frac_c``, ``split_c``, ``p_gain_c``, ``d_gain_c``, ``frz_c``,
    ``maskf``; (V,) tensors); K the walk bound, R the read chunk (a
    multiple of 128; each chunk reads at the cursor advanced to it), DMAX
    the inter-ear stagger bound.  The main pass multiplies the mask by
    ``tight`` (V,) where given and honours the frozen flags; the family
    sub-pass (``sub_idx`` (Vs,) int32 pool voices, ``sub_on`` (Vs,) 0/1)
    reads the listed voices at every frame.  Returns (2, n), or with
    ``scenes`` = S the V rows' S scenes mixed apart, (S, 2, n); one launch
    whatever n, R and S are.  The read must stay inside each row: the
    pool's tiers keep ``select_window(R, 127 + DMAX, K) <= M``."""
    sub = None if sub_idx is None else (sub_idx, sub_on)
    ops = _block_operands(ro, tight, sub is None)
    V = ring.shape[0]
    Vr = V if sub is None else sub_idx.shape[0]
    key = ("ears", _read_signature(ring, ops, sub), n, K, R, DMAX, FP, cap, scenes)
    if key not in _VALIDATED:
        _check_read(ring, ops, V, Vr, n, R, K, DMAX, FP, cap, scenes, sub)
        if FP + cap + select_window(min(R, n), 127 + DMAX, K) > ring.shape[1] * 128:
            raise ValueError("the read leaves the ring's row past its mirror")
        _VALIDATED.add(key)
    kw = dict(n=n, K=K, R=R, DMAX=DMAX, FP=FP, cap=cap)
    if ring.device.type == "cpu":
        return ring_select_ears_plain(ring, ro, tight=tight, sub_idx=sub_idx, sub_on=sub_on,
                                      scenes=scenes, **kw)
    out = _read_launch("select_ears", ring, ops, _read_geo((0,), (8,)), sub, Vr, scenes,
                       n, R, K, DMAX, FP, cap, 0, 1)
    return out[0] if scenes is None else out


def ring_select_multi(ring, ros, *, n, K, DMAX, FP, cap, row0s, hs):
    """K3 (oddio_tpu/ops/pallas_ring.py ``window_select_tiles_multi`` with
    oddio_tpu/spatial.py ``render_multi``'s superwindow): ``nb =
    len(ros)`` fused blocks of n frames, block b read from the ring at its
    own operands (``ros[b]``, as ``ring_select_ears`` takes them), its
    coarse shift relative to block 0's granule minus the static
    ``row0s[b]``, clamped into ``[0, hs[b])``, every read wrapped modulo
    ``cap``.  Returns (2, nb*n), in one launch."""
    nb = len(ros)
    if not 1 <= nb <= MAX_NB or len(row0s) != nb or len(hs) != nb:
        raise ValueError(f"nb={nb} blocks (at most {MAX_NB}), {len(row0s)} row0s, {len(hs)} hs")
    ops = [x for ro in ros for x in _block_operands(ro, None, True)]
    V = ring.shape[0]
    R = -(-n // SELECT_SB) * SELECT_SB
    key = ("multi", _read_signature(ring, ops, None), n, K, DMAX, FP, cap, tuple(row0s),
           tuple(hs))
    if key not in _VALIDATED:
        _check_read(ring, ops, V, V, n, R, K, DMAX, FP, cap, None, None)
        _VALIDATED.add(key)
    if ring.device.type == "cpu":
        return ring_select_multi_plain(ring, ros, n=n, K=K, DMAX=DMAX, FP=FP, cap=cap,
                                       row0s=row0s, hs=hs)
    return _read_launch("select_multi", ring, ops, _read_geo(row0s, hs), None, V, None,
                        n, R, K, DMAX, FP, cap, 1, nb)[0]


# --- K5: strip select (the host buffered pool's read) ---------------------------


def strip_positions(scal, n, K):
    """K5's read offsets for one ear (``_ear_pipeline``, pallas_ring.py:313):
    per 128-frame sub-block, ``kk = clip(whole - j + K, 0, 2K)``, its minimum
    over the whole sub-block (frames past ``n`` included, as the TPU kernel
    computes them), and the offset ``kmin + min(kk - kmin, SELECT_R - 1)``.
    ``scal`` (V, 4).  Returns (offset (V, n) int64, fr (V, n))."""
    V = scal.shape[0]
    nsb = -(-n // SELECT_SB)
    kk, fr = _positions(scal, nsb * SELECT_SB, K)
    kk = kk.to(torch.int64).view(V, nsb, SELECT_SB)
    kmin = kk.min(dim=2, keepdim=True).values
    off = kmin + torch.clamp(kk - kmin, max=SELECT_R - 1)
    return off.reshape(V, nsb * SELECT_SB)[:, :n], fr[:, :n]


def strip_samples(ring, rrow, extra, scal, n, K):
    """(V, 2, n) fractional reads of both ears before gains: ``a_j =
    ring[v, (128*rrow + extra_e + j + offset_j) mod L]``, ``b_j`` the next
    sample (mod L), ``s = a + fr*(b - a)``."""
    V, L = ring.shape
    j = torch.arange(n, dtype=torch.int64, device=ring.device)
    base = 128 * rrow.to(torch.int64)
    outs = []
    for e in range(2):
        off, fr = strip_positions(scal[:, e], n, K)
        idx = torch.remainder(
            (base + extra[:, e].to(torch.int64))[:, None] + j + off, L
        )
        a = torch.gather(ring, 1, idx)
        b = torch.gather(ring, 1, torch.remainder(idx + 1, L))
        outs.append(a + fr * (b - a))
    return torch.stack(outs, dim=1)


def _strip_products(ring, rrow, extra, scal, gain0, d_gain, maskf, n, K):
    """The per-voice summands ``(s * (g0 + j*dg)) * mask``, (V, 2, n)."""
    jn = torch.arange(n, dtype=torch.float32, device=ring.device)
    gains = gain0[:, :, None] + jn * d_gain[:, :, None]
    s = strip_samples(ring, rrow, extra, scal, n, K)
    return s * gains * maskf[:, None, None]


def strip_select_plain(ring, rrow, extra, scal, gain0, d_gain, maskf, *, n, K):
    """Plain version of K5: the same index formula as a torch gather, the
    lerp, ramp and mask, and a float32 sum over voices.  (2, n)."""
    return _strip_products(ring, rrow, extra, scal, gain0, d_gain, maskf, n, K).sum(dim=0)


def strip_tolerance(ring, rrow, extra, scal, gain0, d_gain, maskf, *, n, K):
    """Elementwise tolerance on |kernel - plain| for K5's (2, n) mix.  Both
    versions form the same float32 summands x_v, each rounded op by op, and
    add them in different orders; the error of such a sum grows like a
    random walk over its roundings, scale ``2^-24·sqrt(Σ_k x_k² + P_k²)``
    with P_k the running sums in voice order (``mix_tolerance``'s argument).
    The tolerance is ``MIX_TOL_SIGMAS`` times that scale; a dropped voice or
    an unclamped walk moves the sum by whole summands and fails it."""
    x = _strip_products(ring, rrow, extra, scal, gain0, d_gain, maskf, n, K).double()
    walk = (x.square() + x.cumsum(0).square()).sum(0).sqrt()
    return MIX_TOL_SIGMAS * 2.0**-24 * walk


# --- the host buffered pool's operand record ----------------------------------

#: 32-bit words of one voice's operand record; int32 fields ride as their
#: bits in the float32 row
REC_WORDS = 20
#: word offsets: K5's read row, per-ear starts (2), mask, cursor scalars
#: (2 x [frac, f_hi, f_lo, ds_int]), gains at frame 0 (2) and steps (2);
#: K4's write row, start within it, and count
REC_FIELDS = {"rrow": 0, "extra_r": 1, "wrow": 3, "extra_w": 4, "n_write": 5,
              "mask": 6, "scal": 8, "gain0": 16, "d_gain": 18}


def voice_record(rrow, extra_r, scal, gain0, d_gain, maskf, wrow=0, extra_w=0,
                 n_write=0):
    """The (V, REC_WORDS) float32 operand record of K5's operands (as
    ``strip_select`` takes them) and K4's write cursor ``128*wrow +
    extra_w`` and count ``n_write``; numpy arrays give a numpy record (the
    host pool packs it so), tensors a tensor on their device."""
    V = rrow.shape[0]
    if isinstance(rrow, np.ndarray):
        rec = np.zeros((V, REC_WORDS), np.int32)
        f = rec.view(np.float32)
    else:
        rec = torch.zeros((V, REC_WORDS), dtype=_I32, device=rrow.device)
        f = rec.view(_F32)
    F = REC_FIELDS
    rec[:, F["rrow"]] = rrow
    rec[:, F["extra_r"]:F["extra_r"] + 2] = extra_r
    rec[:, F["wrow"]] = wrow
    rec[:, F["extra_w"]] = extra_w
    rec[:, F["n_write"]] = n_write
    f[:, F["mask"]] = maskf
    f[:, F["scal"]:F["scal"] + 8] = scal.reshape(V, 8)
    f[:, F["gain0"]:F["gain0"] + 2] = gain0
    f[:, F["d_gain"]:F["d_gain"] + 2] = d_gain
    return f


def record_fields(rec):
    """A record's fields as tensors: {name: (V,) or (V, k) view}, ``scal``
    (V, 2, 4)."""
    ri = rec.view(_I32)
    F = REC_FIELDS
    V = rec.shape[0]
    return {
        "rrow": ri[:, F["rrow"]], "extra_r": ri[:, F["extra_r"]:F["extra_r"] + 2],
        "wrow": ri[:, F["wrow"]], "extra_w": ri[:, F["extra_w"]],
        "n_write": ri[:, F["n_write"]], "mask": rec[:, F["mask"]],
        "scal": rec[:, F["scal"]:F["scal"] + 8].reshape(V, 2, 4),
        "gain0": rec[:, F["gain0"]:F["gain0"] + 2],
        "d_gain": rec[:, F["d_gain"]:F["d_gain"] + 2],
    }


def record_operands(rec):
    """K5's operands of a record, in ``strip_select``'s order: (rrow,
    extra, scal, gain0, d_gain, maskf)."""
    f = record_fields(rec)
    return tuple(f[k] for k in ("rrow", "extra_r", "scal", "gain0", "d_gain", "mask"))


def _per_scene_rows(fn, ring, rec, n, scenes):
    """``fn(ring, rec, n)`` over each scene's rows of a record call: (S,
    2, n), or fn's own (2, n) when ``scenes`` is None."""
    return _per_scene(lambda r, q, n_: fn(r[0], q[0], n_), [ring], [rec], n, scenes)


def strip_select_record_plain(ring, rec, *, n, K, scenes=None):
    """Plain version of K5's record form: ``strip_select_plain`` on the
    record's fields, each scene's rows apart with ``scenes``."""
    return _per_scene_rows(
        lambda r, q, n_: strip_select_plain(r, *record_operands(q), n=n_, K=K),
        ring, rec, n, scenes)


def strip_record_tolerance(ring, rec, *, n, K, scenes=None):
    """``strip_tolerance`` for K5's record form, per scene with
    ``scenes``."""
    return _per_scene_rows(
        lambda r, q, n_: strip_tolerance(r, *record_operands(q), n=n_, K=K),
        ring, rec, n, scenes)


# --- K5 launch -------------------------------------------------------------------

#: signatures (shapes, strides, dtypes, devices, n, K) the K5 and K4
#: wrappers have validated: a call with one of them skips the field-by-
#: field checks, any other is checked in full
_VALIDATED = set()


def _signature(*xs):
    """What a wrapper's checks read of its tensors: shape, strides, dtype
    and device of each."""
    try:
        return tuple((x.shape, x.stride(), x.dtype, x.device) for x in xs)
    except AttributeError:
        raise TypeError("kernel operands must be tensors") from None


def _strip_launch(ring, fields, n, K, S=1):
    """Launch K5 on ``ring`` with its operand fields as (pointer, voice
    stride in words) pairs: rrow, extra, scal, (gain0, d_gain) sharing
    one stride, mask; the V rows are ``S`` scenes.  (S, 2, n)."""
    V, L = ring.shape
    dev = ring.device
    (rr, s_rr), (ex, s_ex), (sc, s_sc), (g0, dg, s_g), (mk, s_mk) = fields
    part, ticket = _cluster_scratch(dev, V // S, S * -(-n // SELECT_SB), 2 * SELECT_SB)
    out = torch.empty((S, 2, n), dtype=_F32, device=dev)
    can_stage = int(ring.data_ptr() % 16 == 0 and L % 4 == 0)
    rc = lib("select_kernel").strip_select(
        ring.data_ptr(), L, can_stage, rr, s_rr, ex, s_ex, sc, s_sc, g0, dg, s_g,
        mk, s_mk, _ptr(part), _ptr(ticket), out.data_ptr(), V, V // S, n, K,
        _stream_ptr(dev),
    )
    LAUNCHES["strip_select"] += 1
    _raise_rc(rc, "strip_select")
    return out


def _check_select_n(n, V, L):
    if not 1 <= n <= 4096:
        raise ValueError(f"n={n} outside [1, 4096] (exact split products)")
    if V < 1 or L < 2:
        raise ValueError("empty select")


def strip_select(ring, rrow, extra, scal, gain0, d_gain, maskf, *, n, K):
    """K5 (oddio_tpu/ops/pallas_ring.py ``strip_select``), reading the
    rings directly.

    ring (V, L) f32: each voice's delay ring; rrow (V,) int32 and extra
    (V, 2) int32: each ear's read window starts at ``128*rrow + extra_e``
    (the JAX package's row strip and in-strip start); scal (V, 2, 4) f32
    packed cursor scalars [frac, f_hi, f_lo, ds_int]; gain0, d_gain (V, 2)
    f32; maskf (V,) f32; K the walk bound.  Returns the mixed (2, n).
    ``strip_select_record`` takes the same operands packed in one record,
    as the host pool ships them."""
    ops = (ring, rrow, extra, scal, gain0, d_gain, maskf)
    key = (_signature(*ops), n, K)
    if key not in _VALIDATED:
        if ring.dim() != 2:
            raise ValueError("ring must be a (V, L) tensor")
        V, L = ring.shape
        dev = ring.device
        _check(ring, "ring", _F32, (V, L), dev)
        _check(rrow, "rrow", _I32, (V,), dev)
        _check(extra, "extra", _I32, (V, 2), dev)
        _check(scal, "scal", _F32, (V, 2, 4), dev)
        _check(gain0, "gain0", _F32, (V, 2), dev)
        _check(d_gain, "d_gain", _F32, (V, 2), dev)
        _check(maskf, "maskf", _F32, (V,), dev)
        _check_select_n(n, V, L)
        if dev.type != "cpu":
            _cuda_device(ring)
            for x, nm in zip(ops, ("ring", "rrow", "extra", "scal", "gain0", "d_gain",
                                   "maskf")):
                _check_contig(x, nm)
        _VALIDATED.add(key)
    if ring.device.type == "cpu":
        return strip_select_plain(ring, rrow, extra, scal, gain0, d_gain, maskf, n=n, K=K)
    return _strip_launch(ring, ((rrow.data_ptr(), 1), (extra.data_ptr(), 2),
                                (scal.data_ptr(), 8), (gain0.data_ptr(), d_gain.data_ptr(), 2),
                                (maskf.data_ptr(), 1)), n, K)[0]


def strip_select_record(ring, rec, *, n, K, scenes=None):
    """K5 on the host pool's operand record: ``strip_select`` with its
    operands read from ``rec`` (V, REC_WORDS) f32 (``voice_record``'s
    layout), one pointer per field at the record's row stride.  Returns
    (2, n), or with ``scenes`` = S the V rows' S scenes (V/S voices each,
    any count) mixed apart, (S, 2, n); one launch whatever S is.  The
    operands' checks run once per (shapes, strides, dtypes, devices, n, K,
    scenes)."""
    key = (_signature(ring, rec), n, K, scenes)
    if key not in _VALIDATED:
        if ring.dim() != 2:
            raise ValueError("ring must be a (V, L) tensor")
        V, L = ring.shape
        dev = ring.device
        _check(ring, "ring", _F32, (V, L), dev)
        _check(rec, "rec", _F32, (V, REC_WORDS), dev)
        _check_select_n(n, V, L)
        _scene_count(V, 1 if scenes is None else scenes)
        if dev.type != "cpu":
            _cuda_device(ring)
            _check_contig(ring, "ring")
            _check_contig(rec, "rec")
        _VALIDATED.add(key)
    if ring.device.type == "cpu":
        return strip_select_record_plain(ring, rec, n=n, K=K, scenes=scenes)
    b, F = rec.data_ptr(), REC_FIELDS
    out = _strip_launch(ring, ((b + 4 * F["rrow"], REC_WORDS),
                               (b + 4 * F["extra_r"], REC_WORDS),
                               (b + 4 * F["scal"], REC_WORDS),
                               (b + 4 * F["gain0"], b + 4 * F["d_gain"], REC_WORDS),
                               (b + 4 * F["mask"], REC_WORDS)), n, K,
                        1 if scenes is None else scenes)
    if scenes is None:
        return out[0]
    LAUNCHES["strip_select_scenes"] += 1
    return out
