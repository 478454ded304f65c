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
* ``window_select_ears`` (K2, for ``window_select_tiles_ears``): per voice
  and ear, fractional reads ``a + fr*(b - a)`` at positions rebuilt from 4
  scalars with the exact split-ds math, gain-ramped and summed over voices
  into ``(2, n)``.
* ``window_select_multi`` (K3, for ``window_select_tiles_multi``): K2 for
  ``nb`` consecutive blocks read from one superwindow per voice.
* ``strip_select`` (K5, for ``strip_select``): the host buffered pool's
  read, each voice's ring ``(V, L)`` addressed directly at ``128*rrow +
  extra_e`` onward (mod L), with the TPU kernel's per-sub-block walk
  clamp ``min(kk - kmin, SELECT_R - 1)``; gain-ramped, masked and summed
  over voices into ``(2, n)``.

K1 and K2 also take a ScenePack's scene axis: the V rows are S scenes of
V/S voices each, K1 writes each scene at its own row pair and K2 mixes
each scene apart into (S, 2, n); one launch per call whatever S is.  K8
(``window_select``, ``ops/flat_kernels.py``) shares K2's CUDA body.

A wrapper runs the plain version for tensors on the CPU and launches the
kernel for tensors on a CUDA device; it never falls back from one to the
other.  Each launch adds one to ``LAUNCHES[name]``.

The TPU kernels' layout helpers (voice padding to 8 rows, the log-step
row realign, the 128-lane table gathers, the MXU matvec) have no
counterpart: on the GPU the realign is an index offset,
``idx = 128*rowshift + extra_e + j + kk_j``.  The realign's clamp of
``rowshift`` into ``[0, H)`` is kept, so out-of-contract shifts read what
the TPU kernel reads.

Voice sums: the plain version mixes in the JAX reference's matvec form,
``(g0·S)_j + j·(dg·S)_j``.  The CUDA kernel computes the same two sums per
16-voice chunk, then adds the chunks in a fixed order (deterministic, no
atomics).  The two differ only by the order of the voice sum; the
tolerance ``mix_tolerance`` states for that is sized to how rounding
errors of a float32 sum really grow, so that it fails a kernel that drops
a voice or keeps its partial sums in bf16.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import lib

__all__ = [
    "PAGE",
    "SELECT_SB",
    "LAUNCHES",
    "select_tables",
    "select_window",
    "pack_select_scalars",
    "rows_append",
    "rows_append_plain",
    "rows_append_cursor",
    "rows_append_cursor_plain",
    "cursor_rows",
    "window_select_ears",
    "window_select_ears_plain",
    "window_select_multi",
    "window_select_multi_plain",
    "ear_samples",
    "mix_tolerance",
    "SELECT_R",
    "strip_positions",
    "strip_samples",
    "strip_select",
    "strip_select_plain",
    "strip_tolerance",
]

PAGE = 1024  # ring page size (samples)
SELECT_SB = 128  # frames per sub-block in the read kernels
#: voices summed per CUDA block before the fixed-order chunk reduction
#: (must match VC in csrc/ring_kernels.cu)
VOICE_CHUNK = 16
#: most blocks one multi-block select may fuse (MAX_NB in the .cu)
MAX_NB = 8
#: multiples of the rounding-walk scale |kernel - plain| may reach
#: (``mix_tolerance``)
MIX_TOL_SIGMAS = 8.0

#: K5's residual doppler-walk clamp per sub-block (``SELECT_R``,
#: pallas_ring.py:258): a read lands at most SELECT_R - 1 past the
#: sub-block's smallest walk offset
SELECT_R = 16

_F32, _I32 = torch.float32, torch.int32

#: launches per kernel since the last reset (CUDA launches only)
#: ("append" counts every K1 launch, "append_cursor" those of them through
#: the cursor form)
LAUNCHES = {"append": 0, "append_cursor": 0, "select_ears": 0, "select_multi": 0,
            "strip_select": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def select_tables(emax2, K=64, SB=SELECT_SB):
    """Lookup-table width (a multiple of 128) one sub-block's reads span:
    extra (< emax2) + lane (< SB) + doppler walk (<= 2K) + 1 (lerp)."""
    return -(-(emax2 + SB + 2 * K + 1) // 128) * 128


def select_window(n, emax2, K=64, SB=SELECT_SB):
    """Total per-voice window width for an n-frame block."""
    nsb = -(-n // SB)
    return (nsb - 1) * SB + select_tables(emax2, K, SB)


def pack_select_scalars(offset_frac, ds_int, f_hi, f_lo):
    """Pack per-(voice, ear) cursor scalars [frac, f_hi, f_lo, ds_int]
    (ds_int rides as f32, exact below 2^23)."""
    return torch.stack(
        [offset_frac, f_hi, f_lo, ds_int.to(torch.float32)], dim=-1
    )


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


# --- K2/K3: ear selects -----------------------------------------------------------


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


def _select_cuda(name, wide, rowshift, scal01, g01, e01, frz01, n, K, nb,
                 col0s, hcaps, scenes=1):
    """Validate the (V, k*nb) operands and launch the select kernel pair
    (per-chunk partial sums, then the fixed-order chunk reduction).
    Returns (scenes, 2, nb*n)."""
    V, S2 = wide.shape
    dev = wide.device
    _cuda_device(wide)
    if nb > MAX_NB:
        raise ValueError(f"nb={nb} > MAX_NB={MAX_NB}")
    if n < 1 or V < 1:
        raise ValueError("empty select")
    vps = _scene_count(V, scenes)
    if wide.stride(1) != 1:
        raise ValueError("wide rows must be unit-stride")
    _check(wide, "wide", torch.float32, (V, S2), dev)
    _check(rowshift, "rowshift", torch.int32, (V, nb), dev)
    for e in range(2):
        _check(scal01[e], f"scal01[{e}]", torch.float32, (V, 4 * nb), dev)
        _check(g01[e], f"g01[{e}]", torch.float32, (V, 2 * nb), dev)
        _check(e01[e], f"e01[{e}]", torch.int32, (V, nb), dev)
        for x, nm in ((scal01[e], "scal01"), (g01[e], "g01"), (e01[e], "e01")):
            _check_contig(x, nm)
        if frz01 is not None:
            _check(frz01[e], f"frz01[{e}]", torch.float32, (V, nb), dev)
            _check_contig(frz01[e], "frz01")
    _check_contig(rowshift, "rowshift")
    nchunks = scenes * -(-vps // VOICE_CHUNK)
    part = torch.empty(nb * nchunks * 4 * n, dtype=torch.float32, device=dev)
    out = torch.empty((scenes, 2, nb * n), dtype=torch.float32, device=dev)
    c0 = (ctypes.c_int * MAX_NB)(*col0s)
    hc = (ctypes.c_int * MAX_NB)(*hcaps)
    f0, f1 = (None, None) if frz01 is None else frz01
    L = lib("ring_kernels")
    rc = L.window_select(
        _ptr(wide), wide.stride(0), S2, _ptr(rowshift),
        _ptr(scal01[0]), _ptr(scal01[1]), _ptr(g01[0]), _ptr(g01[1]),
        _ptr(e01[0]), _ptr(e01[1]), _ptr(f0), _ptr(f1),
        _ptr(part), _ptr(out), V, vps, n, K, nb, c0, hc, _stream_ptr(dev),
    )
    LAUNCHES[name] += 1
    _raise_rc(rc, name)
    return out


def window_select_ears(wide, rowshift, scal01, g01, e01, *, n, K, emax2,
                       hmax=None, frz01=None, scenes=None):
    """K2 (oddio_tpu/ops/pallas_ring.py ``window_select_tiles_ears``).

    wide (V, S2): each voice's read window embedded at column
    128*rowshift (rowshift (V,) int32, clamped into [0, H)); scal01: two
    (V, 4) packed cursor rows; g01: two (V, 2) [gain0, d_gain] rows with
    the voice mask folded in; e01: two (V, 1) int32 per-ear staggers;
    frz01: optional two (V, 1) f32 frozen flags.  Returns (2, n).

    Scene axis (ScenePack): with ``scenes`` = S, the V rows are S scenes of
    V/S voices each, in order, and each scene's voices are summed apart,
    as a vmapped ``pallas_call`` sums them: returns (S, 2, n), in one
    launch whatever S is."""
    V, S2 = wide.shape
    WIN, H = _geometry(S2, n, K, emax2, hmax)
    if wide.device.type == "cpu":
        return window_select_ears_plain(
            wide, rowshift, scal01, g01, e01, n=n, K=K, emax2=emax2,
            hmax=hmax, frz01=frz01, scenes=scenes,
        )
    pad = [0] * (MAX_NB - 1)
    out = _select_cuda(
        "select_ears", wide, rowshift.reshape(V, 1), scal01, g01, e01,
        frz01, n, K, 1, [0] + pad, [H] + pad, 1 if scenes is None else scenes,
    )
    return out[0] if scenes is None else out


def window_select_multi(wide, rowshift, scal01, g01, e01, frz01, *, n, K,
                        emax2, nb, row0s, hs):
    """K3 (oddio_tpu/ops/pallas_ring.py ``window_select_tiles_multi``).

    wide (V, S2s) superwindow; rowshift (V, nb) int32 per-block coarse
    shifts relative to the static ``row0s[b]`` (clamped into [0, hs[b]));
    scal01/g01/e01/frz01: per-ear (V, nb*4) / (V, nb*2) / (V, nb) int32 /
    (V, nb) f32 per-block operand rows.  Returns (2, nb*n)."""
    WIN = select_window(n, emax2, K)
    for b in range(nb):
        if 128 * row0s[b] + WIN + 128 * (hs[b] - 1) > wide.shape[1]:
            raise ValueError(f"block {b} window leaves the superwindow")
    if wide.device.type == "cpu":
        return window_select_multi_plain(
            wide, rowshift, scal01, g01, e01, frz01, n=n, K=K, emax2=emax2,
            nb=nb, row0s=row0s, hs=hs,
        )
    pad = [0] * (MAX_NB - nb)
    return _select_cuda(
        "select_multi", wide, rowshift, scal01, g01, e01, frz01, n, K, nb,
        [128 * r for r in row0s] + pad, list(hs) + pad,
    )[0]


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


def strip_select(ring, rrow, extra, scal, gain0, d_gain, maskf, *, n, K):
    """K5 (oddio_tpu/ops/pallas_ring.py ``strip_select``), reading the
    rings directly.

    ring (V, L) f32: each voice's delay ring; rrow (V,) int32 and extra
    (V, 2) int32: each ear's read window starts at ``128*rrow + extra_e``
    (the JAX package's row strip and in-strip start); scal (V, 2, 4) f32
    packed cursor scalars [frac, f_hi, f_lo, ds_int]; gain0, d_gain (V, 2)
    f32; maskf (V,) f32; K the walk bound.  Returns the mixed (2, n)."""
    if not isinstance(ring, torch.Tensor) or ring.dim() != 2:
        raise ValueError("ring must be a (V, L) tensor")
    V, L = ring.shape
    dev = ring.device
    _check(ring, "ring", torch.float32, (V, L), dev)
    _check(rrow, "rrow", torch.int32, (V,), dev)
    _check(extra, "extra", torch.int32, (V, 2), dev)
    _check(scal, "scal", torch.float32, (V, 2, 4), dev)
    _check(gain0, "gain0", torch.float32, (V, 2), dev)
    _check(d_gain, "d_gain", torch.float32, (V, 2), dev)
    _check(maskf, "maskf", torch.float32, (V,), dev)
    if not 1 <= n <= 4096:
        raise ValueError(f"n={n} outside [1, 4096] (exact split products)")
    if V < 1 or L < 2:
        raise ValueError("empty select")
    if dev.type == "cpu":
        return strip_select_plain(ring, rrow, extra, scal, gain0, d_gain, maskf, n=n, K=K)
    _cuda_device(ring)
    for x, nm in ((ring, "ring"), (rrow, "rrow"), (extra, "extra"), (scal, "scal"),
                  (gain0, "gain0"), (d_gain, "d_gain"), (maskf, "maskf")):
        _check_contig(x, nm)
    nchunks = -(-V // VOICE_CHUNK)
    part = torch.empty(nchunks * 2 * n, dtype=torch.float32, device=dev)
    out = torch.empty((2, n), dtype=torch.float32, device=dev)
    rc = lib("select_kernel").strip_select(
        _ptr(ring), L, _ptr(rrow), _ptr(extra), _ptr(scal), _ptr(gain0),
        _ptr(d_gain), _ptr(maskf), _ptr(part), _ptr(out), V, n, K,
        _stream_ptr(dev),
    )
    LAUNCHES["strip_select"] += 1
    _raise_rc(rc, "strip_select")
    return out
