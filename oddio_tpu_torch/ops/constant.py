"""Constant signal (counterpart of oddio_tpu/ops/constant.py).

Reference: oddio's src/constant.rs — emits a fixed frame forever; "useful
for testing".  Seekable (trivially deterministic).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.drctrl import device_param
from ..core.hostmath import f32, full
from ..core.signal import Signal

__all__ = ["Constant"]


class Constant(Signal):
    seekable = True
    _host_fields = ("value",)

    def __init__(self, frame):
        super().__init__()
        v = f32(np.atleast_1d(frame))
        self.channels = int(v.shape[0])
        self._alloc_host(())
        self.value[()] = v

    @classmethod
    def new(cls, frame):
        return cls(frame)

    def _alloc_host(self, batch):
        self.value = full(batch, 0.0, extra=(self.channels,))

    def _copy_static_from(self, other):
        self.channels = other.channels

    def _arch_extra(self):
        return (self.channels,)

    def host_prepare(self, interval, n, count=None):
        return {"value": self.value.copy()}

    def host_params_at(self, tshift, interval, n):
        return {"value": self.value.copy()}

    def host_seek(self, seconds):
        pass  # constant.rs:21-23

    def render_host(self, dstate, ddata, params, n):
        v = device_param(params["value"], self.device, torch.float32)  # (V, C)
        return dstate, v[:, :, None].expand(v.shape + (n,))

    # -- device-resident mode ------------------------------------------------
    # Subclasses with their own finish rule (test doubles overriding
    # host_is_finished) take the host pools: the DR path only reproduces
    # the default never-finishes behavior.

    def _dr_finish_default(self):
        return type(self).host_is_finished is Signal.host_is_finished

    def dr_supported(self):
        return self._dr_finish_default()

    def dr_state_init(self, V):
        if self.channels == 1:
            return {"value": np.zeros(V, np.float32)}
        return {"value": np.zeros((V, self.channels), np.float32)}

    def dr_slot_row(self, interval):
        v = np.asarray(self.value, np.float32).reshape(self.channels)
        return {"value": v[0] if self.channels == 1 else v}

    def dr_render(self, state, ddata, interval, n, count):
        v = state["value"]
        return state, v[..., None].expand(v.shape + (n,))

    def dr_is_finished(self, state):
        v = state["value"]
        return torch.zeros(v.shape[0], dtype=torch.bool, device=v.device)

    # -- device-resident Seek mode (seek is a no-op, constant.rs:21-23) --------

    def dr_seek_supported(self):
        return self.channels == 1 and self._dr_finish_default()

    def dr_warp_render(self, state, ddata, t0, dt, n):
        V, E = t0.shape
        return state["value"][:, None, None].expand(V, E, n)
