"""Device-side cursor helpers shared by the ops (counterpart of
oddio_tpu/ops/_dev.py).

Every function is a term-for-term torch twin of its jnp original: eager
torch rounds each op separately (no fused multiply-add), which is what the
exact split-ds arithmetic relies on.  ``jnp.mod`` maps to
``torch.remainder`` (sign of the divisor) and ``astype(int32)`` to
``.to(torch.int32)`` (truncation toward zero).  ``split_ds`` and ``top12``
stay host-side numpy.
"""

from __future__ import annotations

import numpy as np
import torch


def split_ds(ds):
    """Host-side exact decomposition of a step ``ds`` into
    ``(ds_int:int32, f_hi:f32, f_lo:f32)`` with ``ds == ds_int + f_hi +
    f_lo`` exactly, ``f_hi`` holding at most 12 mantissa bits of the
    fraction (see oddio_tpu/ops/_dev.py for why)."""
    ds64 = np.asarray(ds, np.float64)
    ds_int = np.floor(ds64).astype(np.int32)
    f = ds64 - ds_int  # exact in f64
    f_hi = (np.floor(f * 4096.0) / 4096.0).astype(np.float32)  # 12-bit, exact
    f_lo = (f - f_hi).astype(np.float32)
    return ds_int, f_hi, f_lo


def exact_positions(offset0, ds_int, f_hi, f_lo, n, signed=False):
    """Near-exact cursor positions ``offset0 + i*ds`` decomposed as
    ``(whole:int32, fract:f32)`` per frame, shapes (..., n).  ``offset0``
    lies in (-1, 1); ``signed=True`` gives the reference's toward-zero form
    for negative positions (frames.rs:189-196)."""
    dev = offset0.device
    i_f = torch.arange(n, dtype=torch.float32, device=dev)
    i_i = torch.arange(n, dtype=torch.int32, device=dev)
    H = i_f * f_hi[..., None]  # exact
    g = offset0[..., None] + i_f * f_lo[..., None]
    Hint = H.to(torch.int32)  # H >= 0 when f_hi >= 0
    u = (H - Hint.to(torch.float32)) + g
    fl_u = torch.floor(u)
    r = u - fl_u
    whole = i_i * ds_int[..., None] + Hint + fl_u.to(torch.int32)
    if not signed:
        return whole, r
    adjust = (whole < 0) & (r > 0)
    whole = torch.where(adjust, whole + 1, whole)
    fract = torch.where(adjust, r - 1.0, r)
    return whole, fract


def device_split_ds(ds):
    """Device variant of split_ds for f32 steps known only on the device
    (the decomposition of the f32 value is exact)."""
    ds_int = torch.floor(ds)
    f = ds - ds_int
    f_hi = torch.floor(f * 4096.0) * float(np.float32(1.0 / 4096.0))
    f_lo = f - f_hi
    return ds_int.to(torch.int32), f_hi, f_lo


def masked_voice_sum(mask, x, scenes=None):
    """Sum of ``x`` (V, ...) over the voices where ``mask`` (V,) holds,
    accumulated in float64 and rounded once to float32: garbage in free
    slots never reaches the output, and the sum does not depend on the
    device's reduction order (CPU and CUDA add in different orders, which
    moves a float32 sum of a few hundred voices by up to ~1e-5).  With
    ``scenes`` = S the V rows are S scenes of V/S voices, summed apart
    into (S, ...)."""
    m = mask.reshape(mask.shape + (1,) * (x.dim() - 1))
    x = torch.where(m, x, 0.0)
    if scenes is None:
        return x.sum(dim=0, dtype=torch.float64).to(torch.float32)
    x = x.reshape((scenes, -1) + x.shape[1:])
    return x.sum(dim=1, dtype=torch.float64).to(torch.float32)


def scene_sum(x, scenes=None):
    """Float32 sum of ``x`` (V, ...) over voices, or with ``scenes`` = S
    over each scene's V/S rows apart, into (S, ...)."""
    if scenes is None:
        return x.sum(dim=0)
    return x.reshape((scenes, -1) + x.shape[1:]).sum(dim=1)


def per_voice(x, V):
    """A per-scene (S,) tensor repeated for each scene's V/S voice rows
    (an (1,) tensor broadcasts as it is)."""
    return x if x.shape[0] == 1 else x.repeat_interleave(V // x.shape[0])


def device_advance(base, frac, count, ds_int, f_hi, f_lo):
    """Advance an (int32 base, f32 frac) cursor by ``count*ds`` with
    near-exact arithmetic (count < 4096; an int or an int32 tensor).
    Returns floor-normalized (base', frac' in [0,1))."""
    if isinstance(count, torch.Tensor):
        cf = count.to(torch.float32)
    else:
        cf = float(count)
    H = cf * f_hi  # exact
    Hfl = torch.floor(H)
    u = (H - Hfl) + (frac + cf * f_lo)
    fl = torch.floor(u)
    base2 = base + count * ds_int + Hfl.to(torch.int32) + fl.to(torch.int32)
    return base2, u - fl


#: Taylor coefficients of sin(pi*r) on r in [-1/2, 1/2] (f64-derived,
#: rounded to f32 exactly like the JAX package's constants)
_SINPI_C = tuple(
    float(np.float32(c))
    for c in (
        3.141592653589793, -5.16771278004997, 2.550164039877345,
        -0.5992645293207921, 0.08214588661112823,
        -0.007370430945714351, 0.00046630280576761255,
    )
)


def sin_turns(x):
    """``sin(2*pi*x)`` for already-wrapped phase ``x`` in [0, 1): the
    quarter-wave odd polynomial of the JAX package, same op order."""
    h = x + x  # half-turns in [0, 2)
    k = torch.floor(h + 0.5)  # nearest integer: 0, 1 or 2
    r = h - k  # [-1/2, 1/2]
    sign = 1.0 - 2.0 * (k - 2.0 * torch.floor(k * 0.5))  # (-1)^k
    r2 = r * r
    p = r2 * _SINPI_C[6] + _SINPI_C[5]
    for c in _SINPI_C[4::-1]:
        p = p * r2 + c
    return sign * r * p


def top12(x):
    """f32 with the mantissa truncated to its top 12 bits (host numpy)."""
    xi = np.asarray(x, np.float32).view(np.int32)
    return (xi & ~np.int32(0xFFF)).view(np.float32)


#: frames per position-walk chunk: windows stay bounded and the 12-bit
#: split products stay exact (t < 4096) for ANY block size
WARP_CHUNK = 512


def chunked_frames(eval_chunk, advance, cursor, n, chunk=WARP_CHUNK):
    """Evaluate a per-frame position walk in <=chunk-frame pieces along the
    last axis: ``eval_chunk(cursor, n_c) -> (..., n_c)`` renders one piece,
    ``advance(cursor, n_c) -> cursor`` moves to the next chunk start."""
    if n <= chunk:
        return eval_chunk(cursor, n)
    parts = []
    for j0 in range(0, n, chunk):
        n_c = min(chunk, n - j0)
        parts.append(eval_chunk(cursor, n_c))
        if j0 + n_c < n:
            cursor = advance(cursor, n_c)
    return torch.cat(parts, dim=-1)


def device_top12(x):
    """Device twin of top12 (mantissa split through an int32 bit view)."""
    xi = x.contiguous().view(torch.int32)
    return (xi & ~0xFFF).view(torch.float32)


def warp_shift(rate, r_hi, t):
    """Near-exact sample shift ``t * rate`` for f32 seconds ``t`` against a
    per-voice f32 ``rate`` pre-split as ``r_hi = top12(rate)``.  Broadcasts
    ``t``'s trailing axes; returns (shift_int:int32, frac in [0,1))."""
    extra = t.ndim - rate.ndim
    r = rate.reshape(rate.shape + (1,) * extra)
    rh = r_hi.reshape(r_hi.shape + (1,) * extra)
    rl = r - rh  # exact (<= 12 residual mantissa bits)
    ti = device_top12(t)
    tl = t - ti  # exact
    A = ti * rh  # exact
    rest = ti * rl + tl * r  # exact + near-exact terms; sums round
    Af = torch.floor(A)
    u = (A - Af) + rest
    uf = torch.floor(u)
    return (Af + uf).to(torch.int32), u - uf


def to_trunc_form(base, frac):
    """Renormalize a floor-form cursor (frac in [0,1)) to the reference's
    truncate-toward-zero form (frames.rs:189-196)."""
    neg = (base < 0) & (frac > 0)
    return torch.where(neg, base + 1, base), torch.where(neg, frac - 1.0, frac)
