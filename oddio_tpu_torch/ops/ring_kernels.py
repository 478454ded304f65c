"""Delay-ring kernels of the buffered spatial pool, for Hopper (counterpart
of oddio_tpu/ops/pallas_ring.py).

Three of the JAX package's Pallas kernels sit on the buffered pool's path;
each has a plain PyTorch version here and a hand-written CUDA kernel in
``csrc/ring_kernels.cu``:

* ``rows_append`` (K1, for ``rows_append_dma``): in-place copy of a
  ``(V, W)`` slab into every voice's rows-native ring ``(V, RPV, 128)`` at
  row ``r0`` and again at row ``rmir0`` (mirror upkeep or a dump row).
* ``window_select_ears`` (K2, for ``window_select_tiles_ears``): per voice
  and ear, fractional reads ``a + fr*(b - a)`` at positions rebuilt from 4
  scalars with the exact split-ds math, gain-ramped and summed over voices
  into ``(2, n)``.
* ``window_select_multi`` (K3, for ``window_select_tiles_multi``): K2 for
  ``nb`` consecutive blocks read from one superwindow per voice.

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

__all__ = [
    "PAGE",
    "SELECT_SB",
    "LAUNCHES",
    "select_tables",
    "select_window",
    "pack_select_scalars",
    "rows_append",
    "rows_append_plain",
    "window_select_ears",
    "window_select_ears_plain",
    "window_select_multi",
    "window_select_multi_plain",
    "ear_samples",
    "mix_tolerance",
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

#: launches per kernel since the last reset (CUDA launches only)
LAUNCHES = {"append": 0, "select_ears": 0, "select_multi": 0}


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


def _stream_ptr(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _ptr(x):
    return ctypes.c_void_p(x.data_ptr()) if x is not None else ctypes.c_void_p(0)


def _raise_rc(rc, name):
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")


# --- K1: rows append ------------------------------------------------------------


def _rows_index(r0, rmir0, device):
    """(2,) int32 device tensor [r0, rmir0]; device scalars stay on the
    device (no host read), host ints are uploaded."""
    parts = [
        r.reshape(()).to(device=device, dtype=torch.int32)
        if isinstance(r, torch.Tensor)
        else torch.tensor(int(r), dtype=torch.int32, device=device)
        for r in (r0, rmir0)
    ]
    return torch.stack(parts)


def rows_append_plain(ring3, slab, r0, rmir0):
    """Plain version of K1: ``ring3[:, r:r+W/128] = slab`` for r in (r0,
    rmir0), in place.  r0/rmir0 are ints or int32 scalar tensors."""
    V, RPV, PW = ring3.shape
    nr = slab.shape[1] // PW
    src = slab.reshape(V, nr, PW)
    rows = _rows_index(r0, rmir0, ring3.device).to(torch.int64)
    lanes = torch.arange(nr, dtype=torch.int64, device=ring3.device)
    for leg in range(2):
        ring3.index_copy_(1, rows[leg] + lanes, src)
    return ring3


def rows_append(ring3, slab, r0, rmir0):
    """K1 (oddio_tpu/ops/pallas_ring.py ``rows_append_dma``): write ``slab``
    (V, W), W a multiple of 128, into every voice of ``ring3`` (V, RPV, 128)
    at row ``r0`` and at row ``rmir0``, in place; returns ``ring3``.  A row
    outside ``[0, RPV - W/128]`` fails: the plain version raises, the
    kernel trips a device-side assert (the rows live on the device, and a
    host check would stall every block)."""
    if not isinstance(ring3, torch.Tensor) or ring3.dim() != 3:
        raise ValueError("ring3 must be a (V, RPV, 128) tensor")
    V, RPV, PW = ring3.shape
    dev = ring3.device
    _check(ring3, "ring3", torch.float32, (V, RPV, 128), dev)
    if slab.dim() != 2 or slab.shape[0] != V or slab.shape[1] % 128:
        raise ValueError(f"slab must be (V, W) with W % 128 == 0, got {tuple(slab.shape)}")
    _check(slab, "slab", torch.float32, slab.shape, dev)
    nr = slab.shape[1] // 128
    if nr > RPV:
        raise ValueError("slab wider than a ring row span")
    if dev.type == "cpu":
        return rows_append_plain(ring3, slab, r0, rmir0)
    _cuda_device(ring3)
    _check_contig(ring3, "ring3")
    if ring3.data_ptr() % 16:
        raise ValueError("ring3 must be 16-byte aligned")
    if slab.stride(1) != 1:
        raise ValueError("slab rows must be unit-stride")
    rows = _rows_index(r0, rmir0, dev)
    from ._build import lib

    L = lib()
    rc = L.rows_append(
        _ptr(ring3), _ptr(slab), slab.stride(0), _ptr(rows),
        V, RPV, nr, _stream_ptr(dev),
    )
    LAUNCHES["append"] += 1
    _raise_rc(rc, "rows_append")
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


def mix_tolerance(samps, gs, n):
    """Elementwise tolerance on |kernel - plain| for one block's voice mix
    (2, n), from the per-ear samples ``samps`` (V, n) and gains ``gs``
    (V, 2).

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
                             emax2, hmax=None, frz01=None):
    """Plain version of K2, same signature as the JAX wrapper."""
    _, H = _geometry(wide.shape[1], n, K, emax2, hmax)
    samps = [
        ear_samples(wide, 0, rowshift, H, scal01[e], e01[e],
                    None if frz01 is None else frz01[e], n, K)
        for e in range(2)
    ]
    return _mix_rows(samps, g01, n)


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
                 col0s, hcaps):
    """Validate the (V, k*nb) operands and launch the select kernel pair
    (per-chunk partial sums, then the fixed-order chunk reduction)."""
    V, S2 = wide.shape
    dev = wide.device
    _cuda_device(wide)
    if nb > MAX_NB:
        raise ValueError(f"nb={nb} > MAX_NB={MAX_NB}")
    if n < 1 or V < 1:
        raise ValueError("empty select")
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
    nchunks = -(-V // VOICE_CHUNK)
    part = torch.empty(nb * nchunks * 4 * n, dtype=torch.float32, device=dev)
    out = torch.empty((2, nb * n), dtype=torch.float32, device=dev)
    c0 = (ctypes.c_int * MAX_NB)(*col0s)
    hc = (ctypes.c_int * MAX_NB)(*hcaps)
    f0, f1 = (None, None) if frz01 is None else frz01
    from ._build import lib

    L = lib()
    rc = L.window_select(
        _ptr(wide), wide.stride(0), S2, _ptr(rowshift),
        _ptr(scal01[0]), _ptr(scal01[1]), _ptr(g01[0]), _ptr(g01[1]),
        _ptr(e01[0]), _ptr(e01[1]), _ptr(f0), _ptr(f1),
        _ptr(part), _ptr(out), V, n, K, nb, c0, hc, _stream_ptr(dev),
    )
    LAUNCHES[name] += 1
    _raise_rc(rc, name)
    return out


def window_select_ears(wide, rowshift, scal01, g01, e01, *, n, K, emax2,
                       hmax=None, frz01=None):
    """K2 (oddio_tpu/ops/pallas_ring.py ``window_select_tiles_ears``).

    wide (V, S2): each voice's read window embedded at column
    128*rowshift (rowshift (V,) int32, clamped into [0, H)); scal01: two
    (V, 4) packed cursor rows; g01: two (V, 2) [gain0, d_gain] rows with
    the voice mask folded in; e01: two (V, 1) int32 per-ear staggers;
    frz01: optional two (V, 1) f32 frozen flags.  Returns (2, n)."""
    V, S2 = wide.shape
    WIN, H = _geometry(S2, n, K, emax2, hmax)
    if wide.device.type == "cpu":
        return window_select_ears_plain(
            wide, rowshift, scal01, g01, e01, n=n, K=K, emax2=emax2,
            hmax=hmax, frz01=frz01,
        )
    pad = [0] * (MAX_NB - 1)
    return _select_cuda(
        "select_ears", wide, rowshift.reshape(V, 1), scal01, g01, e01,
        frz01, n, K, 1, [0] + pad, [H] + pad,
    )


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
    )
