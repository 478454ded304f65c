"""Automatic gain control (counterpart of oddio_tpu/ops/adapt.py).

Reference: oddio's src/adapt.rs — per frame, an exponential moving average
of the squared summed-channel level with time constant ``tau``
(``alpha = 1 - exp(-interval/tau)``, adapt.rs:70-75) drives a gain pulling
the average peak into [low, high], capped at ``max_gain`` (adapt.rs:76-86).

The EMA is a linear recurrence, an affine map per frame, so it runs as a
scan of the maps ``(m, b) = (1-a_i, a_i*s_i^2)`` composed as
``(m1*m2, b1*m2 + b2)``: here a Hillis-Steele scan, log2(n) steps of whole
tensor ops, where the JAX package uses ``lax.associative_scan``.  Frames at
``i >= count`` compose as the identity, freezing the carry.

In device-resident pools whose every tau passes the closed-form gate at
the block length the pool renders (``_pool_ema_fast``, stamped by the
pool, core/drctrl.py), each Adapt step is one K7 launch (``ops/agc.py``
``agc_step``: alpha, the channel sum, the closed form and the gain
multiply) for any block the kernel takes, up to ``AGC_NMAX`` frames: the
buffered pools' 513-frame renders included, where the JAX package takes
its scan (its kernel needs a multiple of 128 frames).  Other taus, and
``render_host``, take the scan, which is plain torch on any device, as
it is plain XLA in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.drctrl import device_param
from ..core.hostmath import f32, full
from ..core.signal import Signal
from .agc import _alpha, _apply, _gain, _level, agc_fits, agc_step

__all__ = ["Adapt", "AdaptOptions"]

_SQRT2 = np.sqrt(np.float32(2.0), dtype=np.float32)


def _ema_gain(avg0, s, alpha, count, low, high, max_gain, n):
    """EMA + gain over the frame axis (last axis of ``s``).

    ``avg0`` (V,): the carried average-squared level; ``s`` (V, n):
    summed-channel levels; ``alpha/low/high/max_gain`` (V,); ``count`` (V,)
    consumed-frame bound.  Returns (gains (V, n), carry (V,)).  Frames past
    ``count`` compose as the identity map (the carry freezes) while their
    output gain still sees a one-step EMA from the frozen carry.

    The scan composes maps in another order than the JAX package's
    associative scan; the two, and both against the sequential f32 loop,
    agree to a few ulps of each composed map (tests/test_torch_agc.py)."""
    s2 = s * s
    i_n = torch.arange(n, dtype=torch.int64, device=s.device)
    live = i_n < count.to(torch.int64)[:, None]
    a = alpha[:, None]
    a_eff = torch.where(live, a, 0.0)
    m = 1.0 - a_eff
    b = a_eff * s2
    d = 1
    while d < n:  # inclusive Hillis-Steele scan: frame i composes [i-d, i]
        m, b = (
            torch.cat([m[:, :d], m[:, :-d] * m[:, d:]], dim=1),
            torch.cat([b[:, :d], b[:, :-d] * m[:, d:] + b[:, d:]], dim=1),
        )
        d *= 2
    # exclusive carries: prev_i = composition of frames [0, i) applied to avg0
    m_prev = torch.cat([torch.ones_like(m[:, :1]), m[:, :-1]], dim=1)
    b_prev = torch.cat([torch.zeros_like(b[:, :1]), b[:, :-1]], dim=1)
    prev = m_prev * avg0[:, None] + b_prev
    avg2 = s2 * a + prev * (1.0 - a)  # true alpha: outputs past count too
    gain = _gain(avg2, low[:, None], high[:, None], max_gain[:, None])
    carry = m[:, -1] * avg0 + b[:, -1]
    return gain, carry


def _scan_step(samples, avg0, tau, interval, count, low, high, max_gain, n):
    """The Adapt step through the scan: (samples * gain, carry (V,))."""
    cnt = count.to(torch.int32).expand(avg0.shape)
    gain, avg = _ema_gain(avg0, _level(samples), _alpha(interval, tau), cnt,
                          low, high, max_gain, n)
    return _apply(samples, gain), avg


class AdaptOptions:
    """adapt.rs:36-61."""

    def __init__(self, tau=0.1, max_gain=np.inf, low=None, high=None):
        self.tau = np.float32(tau)
        self.max_gain = np.float32(max_gain)
        self.low = np.float32(0.1) / _SQRT2 if low is None else np.float32(low)
        self.high = np.float32(0.5) / _SQRT2 if high is None else np.float32(high)


class Adapt(Signal):
    _host_fields = ("tau", "max_gain", "low", "high", "avg0")
    _dr_ingest_transparent = True

    def __init__(self, signal, initial_rms, options=None):
        super().__init__()
        options = options or AdaptOptions()
        self.inner = signal
        self.channels = signal.channels
        self._alloc_host(())
        self.tau[()] = options.tau
        self.max_gain[()] = options.max_gain
        self.low[()] = options.low
        self.high[()] = options.high
        # adapt.rs:25-31: avg_squared = initial_rms^2
        self.avg0[()] = np.float32(initial_rms) * np.float32(initial_rms)

    def children(self):
        return {"inner": self.inner}

    def _alloc_host(self, batch):
        self.tau = full(batch, 0.1)
        self.max_gain = full(batch, 1.0)
        self.low = full(batch, 0.1)
        self.high = full(batch, 0.5)
        self.avg0 = full(batch, 1.0)

    def _own_device_init(self):
        return {"avg": torch.tensor(self.avg0, device=self.device)}

    def _own_slot_init(self, i):
        return {"avg": np.float32(self.avg0[i])}

    def host_prepare(self, interval, n, count=None):
        interval = np.broadcast_to(f32(interval), self.batch).astype(np.float32)
        # adapt.rs:70: alpha = 1 - exp(-interval / tau)
        alpha = (np.float32(1.0) - np.exp(-interval / self.tau)).astype(np.float32)
        cnt = np.broadcast_to(
            np.asarray(n if count is None else count, np.int32), self.batch
        )
        return {
            "alpha": alpha,
            "max_gain": self.max_gain.copy(),
            "low": self.low.copy(),
            "high": self.high.copy(),
            "count": cnt.copy(),
            "inner": self.inner.host_prepare(interval, n, count),
        }

    def host_is_finished(self):
        return self.inner.host_is_finished()

    def host_ema_bound(self, interval):
        """Max interval/tau in this chain (DR pools gate K7 on
        max(n, EMA_NMAX) * bound <= EMA_GATE at their block length n)."""
        tau = float(np.min(self.tau)) if getattr(self.tau, "ndim", 0) else float(self.tau)
        own = float(np.float32(interval)) / max(tau, 1e-30)
        return max(own, self.inner.host_ema_bound(interval))

    def _arch_extra(self):
        # the pool-stamped closed-form flag selects the gain path
        return (bool(getattr(self, "_pool_ema_fast", False)),)

    def render_host(self, dstate, ddata, params, n):
        d2, block = self.inner.render_host(
            dstate.get("inner", {}), ddata.get("inner", {}), params["inner"], n
        )
        s = torch.sum(block, dim=1)  # (V, n) sum of channels (adapt.rs:73)
        col = {k: device_param(params[k], self.device)
               for k in ("alpha", "count", "low", "high", "max_gain")}
        gain, avg = _ema_gain(
            dstate["avg"], s, col["alpha"], col["count"], col["low"],
            col["high"], col["max_gain"], n,
        )
        return {"avg": avg, "inner": d2}, block * gain[:, None, :]

    # -- device-resident mode ------------------------------------------------
    # The option columns join the EMA carry in the pool state; the gains come
    # from K7 or the scan, batched over the whole pool.

    def dr_supported(self):
        return self.inner.dr_supported()

    def dr_state_init(self, V):
        return {
            "tau": np.full(V, 0.1, np.float32),
            "max_gain": np.ones(V, np.float32),
            "low": np.full(V, 0.1, np.float32),
            "high": np.full(V, 0.5, np.float32),
            "avg": np.ones(V, np.float32),
            "inner": self.inner.dr_state_init(V),
        }

    def dr_slot_row(self, interval):
        return {
            "tau": np.float32(self.tau[()]),
            "max_gain": np.float32(self.max_gain[()]),
            "low": np.float32(self.low[()]),
            "high": np.float32(self.high[()]),
            "avg": np.float32(self.avg0[()]),
            "inner": self.inner.dr_slot_row(interval),
        }

    def dr_render(self, state, ddata, interval, n, count):
        d2, samples = self.inner.dr_render(
            state["inner"], ddata.get("inner", {}), interval, n, count
        )
        # the level is the summed-channel frame (adapt.rs:73); one gain per
        # frame scales every channel (adapt.rs:84-86)
        args = (samples, state["avg"], state["tau"], interval, count,
                state["low"], state["high"], state["max_gain"], n)
        if getattr(self, "_pool_ema_fast", False) and agc_fits(samples, n):
            out, avg = agc_step(*args)
        else:
            out, avg = _scan_step(*args)
        st = dict(state)
        st["avg"], st["inner"] = avg, d2
        return st, out

    def dr_is_finished(self, state):
        return self.inner.dr_is_finished(state["inner"])
