"""Fused AGC (Adapt) gain kernel, for Hopper (counterpart of
oddio_tpu/ops/pallas_agc.py).

Reference: oddio's src/adapt.rs:69-88 — per frame, an exponential moving
average of the squared summed-channel level (``avg' = avg*(1-a) + a*s^2``)
drives a gain pulling the average peak into [low, high], capped at
``max_gain``.  Like the JAX package's kernel, K7 evaluates it in closed
form, with no sequential recurrence:

    c_i    = min(i+1, count)          live frames through i (count freezes
                                      the carry, adapt.rs:69-75)
    M_i    = exp(c_i * log1p(-a))     the decay prefix
    csum_i = sum_{k<=i} live_k * a*s_k^2/M_k       (inclusive prefix)
    prev_i = exp(min(i, count)*lg) * (avg0 + csum_i - term_i)
    avg2_i = a*s_i^2 + (1-a)*prev_i,  gain_i as adapt.rs:76-86
    carry  = exp(min(n, count)*lg) * (avg0 + csum_{n-1})

valid while ``EMA_NMAX * interval/tau <= EMA_GATE`` (the exp arguments stay
in [-32, 32]); DR pools track that bound on the host and route other taus
to the Adapt scan (ops/adapt.py ``_ema_gain``).

``agc_gains`` runs the plain PyTorch version (``agc_gains_plain``, the
port of ``ema_gain_closed``) for tensors on the CPU and launches the CUDA
kernel of ``csrc/agc_kernel.cu`` for tensors on a CUDA device; it never
falls back from one to the other.  Each launch adds one to
``LAUNCHES["agc_gains"]``.  The two add the prefix terms in different
orders (``torch.cumsum`` against the kernel's warp-shuffle scan);
``agc_tolerance`` states the bound that follows.
"""

from __future__ import annotations

import numpy as np
import torch

from .ring_kernels import _check, _check_contig, _cuda_device, _ptr, _raise_rc, _stream_ptr

__all__ = [
    "EMA_NMAX",
    "EMA_GATE",
    "LAUNCHES",
    "reset_launches",
    "pack_agc_scalars",
    "agc_gains",
    "agc_gains_plain",
    "agc_tolerance",
]

_SQRT2 = float(np.sqrt(np.float32(2.0), dtype=np.float32))

#: frame bound the pools' closed-form gate is computed at (blocks longer
#: than this take the scan)
EMA_NMAX = 512
#: max EMA_NMAX * interval/tau the closed form accepts: exp arguments stay
#: in [-32, 32]
EMA_GATE = 32.0
#: multiples of the rounding-walk scale the two prefix orders may differ by
#: (``agc_tolerance``)
AGC_TOL_SIGMAS = 8.0

#: launches since the last reset (CUDA launches only)
LAUNCHES = {"agc_gains": 0}


def reset_launches():
    LAUNCHES["agc_gains"] = 0


def pack_agc_scalars(avg0, alpha, count, low, high, max_gain):
    """Pack the per-voice AGC scalars into one (V, 8) operand:
    [avg0, alpha, log1p(-alpha), count, low, high, max_gain, 0]."""
    lg = torch.log1p(-alpha)
    return torch.stack(
        [avg0, alpha, lg, count.to(torch.float32), low, high, max_gain,
         torch.zeros_like(avg0)],
        dim=-1,
    )


def _gain(avg2, low, high, max_gain):
    """adapt.rs:76-86: pull sqrt(2)*sqrt(avg2) into [low, high]."""
    avg_peak = torch.sqrt(avg2) * _SQRT2
    return torch.where(
        avg_peak < low,
        torch.minimum(low / avg_peak, max_gain),
        torch.where(avg_peak > high, high / avg_peak, 1.0),
    )


def _closed_form(avg0, s, a, lg, cnt_f, low, high, max_gain, n):
    """The closed form over (V, n), per-voice columns shaped (V, 1)."""
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


def agc_gains_plain(s, scal, n):
    """Plain version of K7 on the packed scalars: the port of
    ``ema_gain_closed`` (oddio_tpu/ops/pallas_agc.py:58)."""
    c = [scal[:, k : k + 1] for k in range(7)]
    avg0, a, lg, cnt_f, low, high, mg = c
    return _closed_form(avg0, s, a, lg, cnt_f, low, high, mg, n)


def agc_gains(s, scal, n):
    """K7 (oddio_tpu/ops/pallas_agc.py ``agc_gains``): ``s`` (V, n)
    summed-channel levels, ``scal`` (V, 8) from ``pack_agc_scalars``; n a
    multiple of 128, at most EMA_NMAX.  Returns (gains (V, n), carry (V,))."""
    if not isinstance(s, torch.Tensor) or s.dim() != 2:
        raise ValueError("s must be a (V, n) tensor")
    V = s.shape[0]
    dev = s.device
    if n % 128 or not 0 < n <= EMA_NMAX:
        raise ValueError(f"n={n} must be a multiple of 128 in (0, {EMA_NMAX}]")
    _check(s, "s", torch.float32, (V, n), dev)
    _check(scal, "scal", torch.float32, (V, 8), dev)
    if dev.type == "cpu":
        return agc_gains_plain(s, scal, n)
    _cuda_device(s)
    _check_contig(s, "s")
    _check_contig(scal, "scal")
    gains = torch.empty((V, n), dtype=torch.float32, device=dev)
    carry = torch.empty((V,), dtype=torch.float32, device=dev)
    if V == 0:
        return gains, carry
    from ._build import lib

    rc = lib("agc_kernel").agc_gains(
        _ptr(s), _ptr(scal), _ptr(gains), _ptr(carry), V, n, _stream_ptr(dev)
    )
    LAUNCHES["agc_gains"] += 1
    _raise_rc(rc, "agc_gains")
    return gains, carry


def agc_tolerance(s, scal, n):
    """Elementwise tolerances ``(gains (V, n), carry (V,))`` on
    |kernel - plain| for K7, in float64 from the same inputs.

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
    ``6·2^-24`` relative for the roundings after ``avg2``.  Where the
    terms are alike, an inclusive prefix in place of the exclusive one errs
    by about ``P_i/(i+1)``, some 100 times this bound at i = 511."""
    u = 2.0**-24
    d = s.double()
    sc = scal.double()
    avg0, a, lg, cnt, low, high, mg = (sc[:, k : k + 1] for k in range(7))
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
    return tol_g, tol_c
