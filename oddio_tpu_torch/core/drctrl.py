"""Sparse control deltas for device-resident pools (counterpart of
oddio_tpu/core/drctrl.py).

Handle writes queue ``(slot, value)`` on the host (last-wins per slot, like
the reference's atomics, gain.rs:103-108) and ship as bounded per-block
delta lanes; overflow beyond ``k_ctrl`` carries to the next block.

The JAX package pads every delta array to a fixed lane count and lets the
scatter drop the padding lanes (``mode="drop"``).  Torch's index_put
rejects out-of-range rows, so the host, which knows which lanes are
padding (index == capacity), filters them before the upload: the device
sees only real lanes.  Fades (Fader) are not in this package yet
(ROADMAP P4), so the fade-lane machinery has no counterpart here; nor
do the samplers' step-bound and the AGC gate stamps (``_ds_small``,
``_ds_tier``, ``_ema_fast``), which come with their readers (P3, P4).

The handle-state readback packs the ``mask`` and ``stopped`` columns into
one uint8 bit array on the device (shifts and a sum; torch has no
``packbits``), copied to the host asynchronously where the device allows.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["DRCtrlMixin", "walk_ctrl_keys", "rows_scatter", "host_lanes"]


def walk_ctrl_keys(proto):
    """Ordered (path, field) pairs for every controllable host field in the
    chain; ``path`` is the tuple of child keys from the pool root."""
    keys = []

    def walk(node, path):
        for f in getattr(node, "_dr_ctrl_fields", ()):
            keys.append((path, f))
        for k, c in node.children().items():
            walk(c, path + (k,))

    walk(proto, ())
    return keys


def host_lanes(idx, V):
    """Host-side lane filter: (kept positions, their row indices) for a
    padded numpy index array whose padding lanes hold ``V``."""
    idx = np.asarray(idx)
    keep = idx < V
    return keep, idx[keep].astype(np.int64)


def _upload(x, device, dtype=None):
    """Copy a numpy value into a fresh tensor on ``device`` (never aliasing
    the host array: state tensors are updated in place)."""
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def rows_scatter(state, rows, idx):
    """Scatter play rows into a state tree, in place.  ``rows`` (numpy, one
    row per real lane) may be a strict SUBTREE of ``state``; ``idx`` is a
    filtered int64 index tensor."""
    if isinstance(rows, dict):
        out = dict(state)
        for k, rv in rows.items():
            out[k] = rows_scatter(state[k], rv, idx)
        return out
    state[idx] = _upload(rows, state.device, state.dtype)
    return state


def _sync_digest(mask, stopped):
    """Pack the two handle-visible bool columns into one uint8 bit array
    (big-endian bit order, like np.packbits): the readback of a 4096-voice
    pool is 1 KB in one transfer instead of 8 KB in two."""
    bits = torch.cat([mask, stopped]).to(torch.uint8)
    pad = (-bits.shape[0]) % 8
    if pad:
        bits = torch.cat([bits, bits.new_zeros(pad)])
    w = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8,
                     device=bits.device)
    return (bits.view(-1, 8) * w).sum(dim=1, dtype=torch.uint8)


class DRCtrlMixin:
    """Shared by device-resident voice pools."""

    #: per-block delta-channel capacity per controllable field
    k_ctrl = 64

    # -- packed handle-state sync ------------------------------------------

    def _state_key(self):
        m = self.state["mask"]
        return (id(m), m._version)

    def _sync_start(self):
        """Begin the device->host copy of the packed (mask, stopped) digest
        for the CURRENT state version (asynchronous on CUDA)."""
        st = self.state
        if st is None:
            return
        packed = _sync_digest(st["mask"], st["stopped"])
        event = None
        if packed.is_cuda:
            host = torch.empty(packed.shape, dtype=torch.uint8, pin_memory=True)
            host.copy_(packed, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            packed = host
        self._sync_pack = (self._state_key(), packed, event)

    def _sync_read(self):
        """(mask, stopped) numpy bool columns of the current state, via the
        packed digest (reusing a prefetched one when still current)."""
        pk = getattr(self, "_sync_pack", None)
        if pk is None or pk[0] != self._state_key():
            self._sync_start()
            pk = self._sync_pack
        self._sync_pack = None
        if pk[2] is not None:
            pk[2].synchronize()
        bits = np.unpackbits(pk[1].numpy())
        V = self.state["mask"].shape[0]
        return bits[:V].astype(bool), bits[V : 2 * V].astype(bool)

    def _init_ctrl(self, proto):
        self.ctrl_keys = walk_ctrl_keys(proto)
        self.pending_ctrl = {k: {} for k in self.ctrl_keys}

    def _rebind_ctrl(self, spec, slot, gen, prefix=()):
        """Point every control handle in ``spec``'s chain at this pool."""

        def walk(node, path):
            cb = getattr(node, "_cb", None)
            if cb is not None:
                cb.rebind_dr(self, slot, gen, path)
            for k, c in node.children().items():
                walk(c, path + (k,))

        walk(spec, prefix)

    def push_ctrl(self, path, field, slot, value):
        self.pending_ctrl[(path, field)][slot] = np.float32(value)

    def _ctrl_pending_any(self):
        return any(self.pending_ctrl.values())

    def _ctrl_delta_params(self, params):
        """Pack one (idx, val) pair per controllable field (padded; overflow
        beyond k_ctrl carries to the next block)."""
        for j, key in enumerate(self.ctrl_keys):
            pend = self.pending_ctrl[key]
            items = list(pend.items())[: self.k_ctrl]
            for s, _ in items:
                del pend[s]
            idx = np.full(self.k_ctrl, self.capacity, np.int32)
            val = np.zeros(self.k_ctrl, np.float32)
            for t, (s, v) in enumerate(items):
                idx[t] = s
                val[t] = v
            params[f"ctrl_idx{j}"] = idx
            params[f"ctrl_val{j}"] = val
        return params

    def _ctrl_apply(self, inner_state, params):
        """Scatter queued control writes into the inner state tree, in
        place (applied after plays, so a write lands on its voice)."""
        if "ctrl_idx0" not in params or not self.ctrl_keys:
            return inner_state
        from ..parallel.context import localize_index

        for j, (path, field) in enumerate(self.ctrl_keys):
            t = inner_state
            for k in path:
                t = t[k]
            leaf = t[field]
            V = leaf.shape[0]
            keep, rows = host_lanes(localize_index(params[f"ctrl_idx{j}"], V), V)
            if rows.size:
                leaf[_upload(rows, leaf.device)] = _upload(
                    params[f"ctrl_val{j}"][keep], leaf.device, leaf.dtype
                )
        return inner_state
