"""Sine oscillator (counterpart of oddio_tpu/ops/sine.py).

Reference: oddio's src/sine.rs — emits ``sin(i*interval*freq +
phase)`` per frame and wraps the phase modulo TAU after each block.  The
host side (f64 phase, exact split-ds cycle steps) is the JAX package's
numpy code unchanged; the device side runs on tensors.

Device-resident mode keeps a 48-bit fixed-point cycle accumulator in two
24-bit int32 limbs (``acc_a`` in 2^-24 cycles, ``acc_b`` in 2^-48),
advanced with exact integer limb arithmetic, so the cursor never drifts.
Under Speed the pool interval becomes a per-voice tensor, and the step is
re-derived on the device each block.
Integer ``//`` and ``%`` there are floor division and divisor-sign
remainder (``torch.div(..., rounding_mode="floor")``, ``torch.remainder``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.drctrl import _upload
from ..core.hostmath import TAU32, f32, full, rust_rem
from ..core.signal import Signal
from ._dev import (
    chunked_frames,
    device_advance,
    device_split_ds,
    exact_positions,
    sin_turns,
    split_ds,
)

__all__ = ["Sine"]

_INV_TAU = float(np.float32(1.0 / np.float64(TAU32)))
_M24 = 1 << 24
_P24 = float(np.float32(2.0**-24))
_P48 = float(np.float32(2.0**-48))
_T24 = float(2.0**24)


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


class Sine(Signal):
    seekable = True
    _host_fields = ("phase", "freq")

    def __init__(self, phase=0.0, frequency_hz=440.0):
        super().__init__()
        self._alloc_host(())
        self.phase[()] = f32(phase)
        # sine.rs:19-22: frequency stored in radians per second
        self.freq[()] = f32(frequency_hz) * TAU32

    @classmethod
    def new(cls, phase, frequency_hz):
        return cls(phase, frequency_hz)

    def _alloc_host(self, batch):
        # f64 host phase, f32 TAU modulus (sine.rs:25-28)
        self.phase = full(batch, 0.0, np.float64)
        self.freq = full(batch, 0.0)

    def _seek_to(self, t):
        # sine.rs:25-28
        self.phase = rust_rem(
            self.phase + np.float64(1.0) * np.asarray(t, np.float64) * self.freq,
            np.float64(TAU32),
        )

    def host_prepare(self, interval, n, count=None):
        interval = np.broadcast_to(f32(interval), self.batch).astype(np.float32)
        params = self._cycle_params(interval)
        cnt = n if count is None else count
        cnt = np.broadcast_to(f32(cnt), self.batch)
        # sine.rs:38-39: seek_to(interval * out.len() as f32)
        self._seek_to((interval * cnt).astype(np.float32))
        return params

    def _cycle_params(self, interval):
        """Per-frame phase in cycles with the exact-split decomposition."""
        tau = np.float64(TAU32)
        dc = interval.astype(np.float64) * (self.freq.astype(np.float64) / tau)
        dc_int, f_hi, f_lo = split_ds(dc)
        c0 = (self.phase / tau).astype(np.float32)
        return {
            "c0": np.broadcast_to(c0, self.batch).astype(np.float32),
            "dc_int": np.broadcast_to(dc_int, self.batch).astype(np.int32),
            "f_hi": np.broadcast_to(f_hi, self.batch).astype(np.float32),
            "f_lo": np.broadcast_to(f_lo, self.batch).astype(np.float32),
        }

    def host_params_at(self, tshift, interval, n):
        interval = np.broadcast_to(f32(interval), self.batch).astype(np.float32)
        saved = self.phase
        self.phase = rust_rem(
            self.phase + np.asarray(f32(tshift), np.float64) * self.freq,
            np.float64(TAU32),
        )
        params = self._cycle_params(interval)
        self.phase = saved
        return params

    def host_seek(self, seconds):
        self._seek_to(f32(seconds))

    def render_host(self, dstate, ddata, params, n):
        # sine.rs:34-40: sin(TAU * frac(c0 + i*dc)), near-exact positions
        t = {k: _upload(params[k], self.device) for k in ("c0", "dc_int", "f_hi", "f_lo")}
        _, frac = exact_positions(t["c0"], t["dc_int"], t["f_hi"], t["f_lo"], n)
        return dstate, sin_turns(frac)[:, None, :]

    # -- device-resident mode ------------------------------------------------

    def dr_supported(self):
        # DR reproduces the default never-finishes semantics only
        return type(self).host_is_finished is Signal.host_is_finished

    def dr_state_init(self, V):
        return {
            "freq": np.zeros(V, np.float32),
            "cyc": np.zeros(V, np.float32),  # wrapped phase in cycles [0,1)
            "dc_int": np.zeros(V, np.int32),
            "f_hi": np.zeros(V, np.float32),
            "f_lo": np.zeros(V, np.float32),
            "step_l": np.zeros((V, 4), np.int32),  # 12-bit limbs of frac(dc)
            "acc_a": np.zeros(V, np.int32),
            "acc_b": np.zeros(V, np.int32),
        }

    def dr_slot_row(self, interval):
        tau = np.float64(TAU32)
        c0 = np.float64(np.mod(self.phase[()] / tau, 1.0))
        dc = np.float64(interval) * (np.float64(self.freq[()]) / tau)
        dc_int, f_hi, f_lo = split_ds(dc)
        f48 = np.floor((dc - np.floor(dc)) * np.float64(2**48))
        a48 = np.floor(c0 * np.float64(2**48))
        limbs = np.array(
            [np.mod(np.floor(f48 / 2.0 ** (36 - 12 * i)), 4096) for i in range(4)],
            np.int32,
        )
        return {
            "freq": np.float32(self.freq[()]),
            "cyc": np.float32(c0),
            "dc_int": np.int32(dc_int),
            "f_hi": np.float32(f_hi),
            "f_lo": np.float32(f_lo),
            "step_l": limbs,
            "acc_a": np.int32(np.floor(a48 / 2.0**24)),
            "acc_b": np.int32(np.mod(a48, 2.0**24)),
        }

    @staticmethod
    def _acc_c0(state):
        return (
            state["acc_a"].to(torch.float32) * _P24
            + state["acc_b"].to(torch.float32) * _P48
        )

    @staticmethod
    def _acc_advance(state, count):
        """Advance the 48-bit cycle accumulator by ``count`` frames (< 4096)
        of frac(dc), exactly: every product is <= 24 bits, integer cycles
        drop, carries propagate between the limbs."""
        c = count.to(torch.int32)
        Ah, Al, Bh, Bl = (state["step_l"][:, i] for i in range(4))
        cAh, cAl, cBh, cBl = c * Ah, c * Al, c * Bh, c * Bl
        lowB = torch.remainder(cBh, 4096) * 4096 + cBl
        carB = _fdiv(cBh, 4096) + _fdiv(lowB, _M24)
        lowB = torch.remainder(lowB, _M24)
        # overflow past 2^24 is whole cycles
        lowA = torch.remainder(torch.remainder(cAh, 4096) * 4096 + cAl, _M24)
        b2 = state["acc_b"] + lowB
        a2 = torch.remainder(state["acc_a"] + lowA + carB + _fdiv(b2, _M24), _M24)
        return a2, torch.remainder(b2, _M24)

    def dr_render(self, state, ddata, interval, n, count):
        out = dict(state)
        c0 = self._acc_c0(state)
        if not isinstance(interval, torch.Tensor):
            # static pool interval: the slot row's exact f64-derived step
            _, frac = exact_positions(
                c0, state["dc_int"], state["f_hi"], state["f_lo"], n
            )
            out["acc_a"], out["acc_b"] = self._acc_advance(state, count)
            out["cyc"] = self._acc_c0(out)
            return out, sin_turns(frac)
        # per-voice interval under Speed (speed.rs:32-36): the step is
        # re-derived on the device; its f32 quantization costs <= n*eps*dc
        # per block, and the advance re-quantizes onto the 48-bit
        # accumulator (no drift beyond the f32 step itself)
        dc = state["freq"] * interval * _INV_TAU
        dc_int, f_hi, f_lo = device_split_ds(dc)
        _, frac = exact_positions(c0, dc_int, f_hi, f_lo, n)
        cf = count.to(torch.float32)
        H = cf * f_hi  # exact
        adv = (H - torch.floor(H)) + cf * f_lo
        adv = adv - torch.floor(adv)
        a48 = torch.floor(adv * _T24)
        lo48 = torch.floor((adv * _T24 - a48) * _T24)
        b2 = state["acc_b"] + lo48.to(torch.int32)
        a2 = torch.remainder(
            state["acc_a"] + a48.to(torch.int32) + _fdiv(b2, _M24), _M24
        )
        out["acc_a"], out["acc_b"] = a2, torch.remainder(b2, _M24)
        out["cyc"] = self._acc_c0(out)
        return out, sin_turns(frac)

    def dr_is_finished(self, state):
        return torch.zeros(
            state["freq"].shape, dtype=torch.bool, device=state["freq"].device
        )

    # -- device-resident Seek mode --------------------------------------------

    def dr_seek_supported(self):
        return self.dr_supported()

    def dr_warp_render(self, state, ddata, t0, dt, n):
        fcyc = state["freq"] * _INV_TAU  # cycles per second
        # time-shifted start phase in cycles: cyc + t0*fcyc, wrapped (the f32
        # product rounds like the reference's own f32 seek, sine.rs:25-28)
        oc = t0 * fcyc[:, None]  # (V, E)
        oc = oc - torch.floor(oc)
        c0 = state["cyc"][:, None] + oc
        c0 = c0 - torch.floor(c0)
        dc = dt * fcyc[:, None]  # warped cycles per frame (V, E)
        dc_int, f_hi, f_lo = device_split_ds(dc)

        def ev(c0_c, n_c):
            _, frac = exact_positions(c0_c, dc_int, f_hi, f_lo, n_c)
            return sin_turns(frac)

        def adv(c0_c, n_c):
            _, f2 = device_advance(
                torch.zeros_like(dc_int), c0_c, n_c, dc_int, f_hi, f_lo
            )
            return f2

        return chunked_frames(ev, adv, c0, n)

    def dr_advance(self, state, seconds):
        adv = state["freq"] * float(np.float32(seconds) * np.float32(_INV_TAU))
        cyc2 = state["cyc"] + (adv - torch.floor(adv))
        out = dict(state)
        out["cyc"] = cyc2 - torch.floor(cyc2)
        return out
