"""Fused AGC (Adapt) step kernel, for Hopper (counterpart of
oddio_tpu/ops/pallas_agc.py and the ops around it in the JAX package's
``Adapt.dr_render``).

Reference: oddio's src/adapt.rs:69-88 — per frame, an exponential moving
average of the squared summed-channel level (``avg' = avg*(1-a) + a*s^2``,
``a = 1 - exp(-interval/tau)``) drives a gain pulling the average peak
into [low, high], capped at ``max_gain``.  Like the JAX package's kernel,
K7 evaluates it in closed form, with no sequential recurrence:

    c_i    = min(i+1, count)          live frames through i (count freezes
                                      the carry, adapt.rs:69-75)
    M_i    = exp(c_i * log1p(-a))     the decay prefix
    csum_i = sum_{k<=i} live_k * a*s_k^2/M_k       (inclusive prefix)
    prev_i = exp(min(i, count)*lg) * (avg0 + csum_i - term_i)
    avg2_i = a*s_i^2 + (1-a)*prev_i,  gain_i as adapt.rs:76-86
    carry  = exp(min(n, count)*lg) * (avg0 + csum_{n-1})

valid while ``n * interval/tau <= EMA_GATE`` (the exp arguments stay in
[-32, 32]); DR pools track that bound on the host at the block length
they render (at least ``EMA_NMAX``) and route other taus to the Adapt
scan (ops/adapt.py ``_ema_gain``).

``agc_step`` is one whole Adapt step of a device-resident pool: from the
inner's samples (V, n) or (V, C, n) and the pool's per-voice columns, the
output ``samples * gain`` and the new carry, for any block length up to
``AGC_NMAX``.  It runs the plain PyTorch version (``agc_step_plain``: the
torch chain of alpha, the channel sum, the port of
``ema_gain_closed`` and the gain multiply) for tensors on the CPU and
launches the CUDA kernel of ``csrc/agc_kernel.cu`` for tensors on a CUDA
device; it never falls back from one to the other.  Each launch adds one
to ``LAUNCHES["agc_gains"]``.  The two add the prefix terms in different
orders (``torch.cumsum`` against the kernel's lane-serial sums and
shuffle scan); ``agc_tolerance`` states the bound that follows.
"""

from __future__ import annotations

import numpy as np
import torch

from .ring_kernels import (_VALIDATED, _check, _check_contig, _cuda_device, _raise_rc,
                           _signature, _stream_ptr)

__all__ = [
    "EMA_NMAX",
    "EMA_GATE",
    "AGC_NMAX",
    "AGC_CN_MAX",
    "LAUNCHES",
    "reset_launches",
    "agc_fits",
    "agc_step",
    "agc_step_plain",
    "agc_tolerance",
]

_SQRT2 = float(np.sqrt(np.float32(2.0), dtype=np.float32))

#: least frame count the pools' closed-form gate is computed at (a pool
#: that renders longer blocks computes it at its own block length)
EMA_NMAX = 512
#: max n * interval/tau the closed form accepts: exp arguments stay in
#: [-32, 32]
EMA_GATE = 32.0
#: longest block the kernel takes (AGC_NMAX in csrc/agc_kernel.cu)
AGC_NMAX = 544
#: most channels x frames per voice the kernel stages (AGC_CN_MAX there)
AGC_CN_MAX = 1536
#: multiples of the rounding-walk scale the two prefix orders may differ by
#: (``agc_tolerance``)
AGC_TOL_SIGMAS = 8.0

#: launches since the last reset (CUDA launches only)
LAUNCHES = {"agc_gains": 0}


def reset_launches():
    LAUNCHES["agc_gains"] = 0


def _alpha(interval, tau):
    """adapt.rs:70: 1 - exp(-interval/tau), with one f32 division (a Python
    scalar over a tensor would take a reciprocal and a product) and no
    host-to-device copy (the numerator is filled on the device).  Under
    Speed ``interval`` is a per-voice tensor."""
    if isinstance(interval, torch.Tensor):
        return 1.0 - torch.exp(-interval / tau)
    return 1.0 - torch.exp(torch.full_like(tau, -float(np.float32(interval))) / tau)


def _columns(avg0, tau, interval, count, low, high, max_gain):
    """The per-voice AGC operands as (V, 1) columns: (avg0, alpha,
    log1p(-alpha), count as f32, low, high, max_gain)."""
    alpha = _alpha(interval, tau)
    cnt = count.to(torch.int32).expand(avg0.shape).to(torch.float32)
    return tuple(c[:, None] for c in (avg0, alpha, torch.log1p(-alpha), cnt, low, high,
                                      max_gain))


def _level(samples):
    """The summed-channel level (adapt.rs:73): (V, n)."""
    return samples if samples.dim() == 2 else samples.sum(dim=1)


def _gain(avg2, low, high, max_gain):
    """adapt.rs:76-86: pull sqrt(2)*sqrt(avg2) into [low, high]."""
    avg_peak = torch.sqrt(avg2) * _SQRT2
    return torch.where(
        avg_peak < low,
        torch.minimum(low / avg_peak, max_gain),
        torch.where(avg_peak > high, high / avg_peak, 1.0),
    )


def _closed_form(s, cols, n):
    """The closed form over (V, n) (the port of ``ema_gain_closed``,
    oddio_tpu/ops/pallas_agc.py:58) on ``_columns``: (gains (V, n), carry
    (V,))."""
    avg0, a, lg, cnt_f, low, high, max_gain = cols
    s2 = s * s
    i_f = torch.arange(n, dtype=torch.float32, device=s.device)
    live = i_f < cnt_f
    M = torch.exp(torch.minimum(i_f + 1.0, cnt_f) * lg)
    terms = torch.where(live, (a * s2) / M, 0.0)
    csum = torch.cumsum(terms, dim=-1)
    carry = M[:, -1] * (avg0[:, 0] + csum[:, -1])
    prev = torch.exp(torch.minimum(i_f, cnt_f) * lg) * (avg0 + (csum - terms))
    avg2 = s2 * a + prev * (1.0 - a)
    return _gain(avg2, low, high, max_gain), carry


def _apply(samples, gain):
    """One gain per frame scales every channel (adapt.rs:84-86)."""
    return samples * (gain if samples.dim() == 2 else gain[:, None, :])


def agc_step_plain(samples, avg0, tau, interval, count, low, high, max_gain, n):
    """Plain version of K7: the Adapt step's torch chain (alpha, the
    channel sum, the closed form, the gain multiply).  Returns (samples *
    gain, carry (V,))."""
    cols = _columns(avg0, tau, interval, count, low, high, max_gain)
    gain, carry = _closed_form(_level(samples), cols, n)
    return _apply(samples, gain), carry


def agc_fits(samples, n):
    """True when the kernel takes a block of ``samples`` (V, n) or (V, C,
    n): 1 <= n <= AGC_NMAX and C*n <= AGC_CN_MAX."""
    C = 1 if samples.dim() == 2 else samples.shape[1]
    return 1 <= n <= AGC_NMAX and C * n <= AGC_CN_MAX


def _check_step(samples, cols, interval, count, n):
    if not isinstance(samples, torch.Tensor) or samples.dim() not in (2, 3):
        raise ValueError("samples must be a (V, n) or (V, C, n) tensor")
    V, dev = samples.shape[0], samples.device
    _check(samples, "samples", torch.float32, tuple(samples.shape), dev)
    if samples.shape[-1] != n or not agc_fits(samples, n):
        raise ValueError(
            f"samples {tuple(samples.shape)} at n={n}: the kernel takes "
            f"1 <= n <= {AGC_NMAX} frames and channels x n <= {AGC_CN_MAX}")
    for x, nm in cols:
        _check(x, nm, torch.float32, (V,), dev)
        _check_contig(x, nm)
    if isinstance(interval, torch.Tensor):
        _check(interval, "interval", torch.float32, (V,), dev)
    elif not isinstance(interval, (float, int, np.floating)):
        raise TypeError(f"interval must be a number or a (V,) tensor, got "
                        f"{type(interval).__name__}")
    if not isinstance(count, torch.Tensor) or count.dtype != torch.int32:
        raise TypeError("count must be an int32 tensor")
    if count.device != dev or tuple(count.shape) not in ((), (1,), (V,)):
        raise ValueError(f"count must be a 0-d, (1,) or ({V},) tensor on {dev}, "
                         f"got {tuple(count.shape)} on {count.device}")
    _check_contig(count, "count")
    if dev.type != "cpu":
        _cuda_device(samples)
        _check_contig(samples, "samples")


def agc_step(samples, avg0, tau, interval, count, low, high, max_gain, n):
    """K7 (oddio_tpu/ops/pallas_agc.py ``agc_gains`` with the Adapt step's
    ops around it): one device-resident Adapt step.

    samples (V, n) or (V, C, n) f32, the inner's block; avg0 (the carried
    average-squared level), tau, low, high, max_gain (V,) f32, the pool's
    columns; interval a host number, or a (V,) f32 tensor under Speed;
    count an int32 0-d, (1,) or (V,) tensor, the frames that advance the
    carry.  1 <= n <= AGC_NMAX, C*n <= AGC_CN_MAX.  Returns (samples *
    gain, a new tensor of samples' shape; carry (V,)).  Checks run once
    per (shapes, strides, dtypes, devices)."""
    cols = ((avg0, "avg0"), (tau, "tau"), (low, "low"), (high, "high"),
            (max_gain, "max_gain"))
    per_voice = isinstance(interval, torch.Tensor)
    try:
        key = ("agc", n, per_voice, _signature(samples, count, *(x for x, _ in cols))
               + (_signature(interval) if per_voice else ()))
    except TypeError:
        key = None
    if key not in _VALIDATED:
        _check_step(samples, cols, interval, count, n)
        _VALIDATED.add(key)
    dev = samples.device
    if dev.type == "cpu":
        return agc_step_plain(samples, avg0, tau, interval, count, low, high, max_gain, n)
    V = samples.shape[0]
    C = 1 if samples.dim() == 2 else samples.shape[1]
    out = torch.empty_like(samples)
    carry = torch.empty((V,), dtype=torch.float32, device=dev)
    if V == 0:
        return out, carry
    from ._build import lib

    if per_voice:
        iv_p, iv, s_iv = interval.data_ptr(), 0.0, interval.stride(0)
    else:
        iv_p, iv, s_iv = None, float(np.float32(interval)), 0
    rc = lib("agc_kernel").agc_step(
        samples.data_ptr(), out.data_ptr(), avg0.data_ptr(), tau.data_ptr(), iv_p, iv,
        s_iv, count.data_ptr(), 0 if count.numel() == 1 else 1, low.data_ptr(),
        high.data_ptr(), max_gain.data_ptr(), carry.data_ptr(), V, C, n, _stream_ptr(dev),
    )
    LAUNCHES["agc_gains"] += 1
    _raise_rc(rc, "agc_step")
    return out, carry


def _tolerance(s, cols, n):
    """The gain and carry bounds of ``agc_tolerance`` from the level ``s``
    (V, n) and ``_columns``, in float64; also the float64 gains."""
    u = 2.0**-24
    d = s.double()
    avg0, a, lg, cnt, low, high, mg = (c.double() for c in cols)
    i_f = torch.arange(n, dtype=torch.float64, device=s.device)
    live = i_f < cnt
    s2 = d * d
    M = torch.exp(torch.minimum(i_f + 1.0, cnt) * lg)
    terms = torch.where(live, a * s2 / M, 0.0)
    P = torch.cumsum(terms, dim=-1)
    dP = (AGC_TOL_SIGMAS * torch.sqrt(i_f + 1.0) + 6.0) * u * P
    Mp = torch.exp(torch.minimum(i_f, cnt) * lg)
    prev = Mp * (avg0 + P - terms)
    avg2 = s2 * a + prev * (1.0 - a)
    d_avg2 = (1.0 - a) * (Mp * dP + 6.0 * u * prev) + 4.0 * u * avg2
    peak = torch.sqrt(avg2) * np.sqrt(2.0)
    gain = torch.where(
        peak < low, torch.minimum(low / peak, mg),
        torch.where(peak > high, high / peak, 1.0),
    )
    tol_g = gain * (d_avg2 / (2.0 * avg2.clamp_min(1e-300)) + 6.0 * u)
    Ml = M[:, -1]
    carry = Ml * (avg0[:, 0] + P[:, -1])
    tol_c = Ml * dP[:, -1] + 6.0 * u * carry
    return tol_g, tol_c, gain


def agc_tolerance(samples, avg0, tau, interval, count, low, high, max_gain, n):
    """Elementwise tolerances ``(output (samples' shape), carry (V,))`` on
    |kernel - plain| for K7, in float64 from the same inputs (alpha and
    its log as the plain chain rounds them).

    The two versions evaluate the same closed form and differ in the order
    of the prefix sum (and by a few ulps of ``exp`` where the two libraries
    differ).  The prefix terms are nonnegative, so every partial sum of any
    order is at most the true inclusive prefix ``P_i``; each of the ``i``
    additions behind ``csum_i`` rounds by at most ``2^-24`` of it, with a
    sign that varies, so the error of ``csum_i`` grows like a random walk
    of scale ``2^-24·sqrt(i+1)·P_i``.  The tolerance takes
    ``AGC_TOL_SIGMAS`` times that scale, plus ``6·2^-24·P_i`` for the
    exclusive prefix's subtraction and the ``exp`` differences, carries it
    through ``prev = M'·(avg0 + excl)`` and ``avg2 = a·s² + (1-a)·prev``,
    and maps it to the gain by ``|dgain| <= gain·|davg2|/(2·avg2)`` (the
    gain is ``c/sqrt(avg2)`` or constant, continuous at the clamps), with
    ``6·2^-24`` relative for the roundings after ``avg2``.  An output
    sample ``x·gain`` may then differ by ``|x|`` times that gain bound
    plus one rounding of the product.  Where the terms are alike, an
    inclusive prefix in place of the exclusive one errs by about
    ``P_i/(i+1)``, some 100 times this bound at i = 511."""
    cols = _columns(avg0, tau, interval, count, low, high, max_gain)
    tol_g, tol_c, gain = _tolerance(_level(samples), cols, n)
    tol_x = (tol_g + 2.0**-24 * (gain + tol_g))
    if samples.dim() == 3:
        tol_x = tol_x[:, None, :]
    return samples.double().abs() * tol_x, tol_c
