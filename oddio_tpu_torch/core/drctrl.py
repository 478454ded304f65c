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

__all__ = ["DRCtrlMixin", "walk_ctrl_keys", "rows_scatter", "host_lanes", "read_handle_state"]


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


def _at_path(node, path):
    for k in path:
        node = node.children()[k]
    return node


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


def read_handle_state(mask, stopped):
    """(mask, stopped) numpy bool columns of two device columns, through
    one packed digest and one (waiting) copy."""
    bits = np.unpackbits(_sync_digest(mask, stopped).cpu().numpy())
    V = mask.shape[0]
    return bits[:V].astype(bool), bits[V : 2 * V].astype(bool)


class DRCtrlMixin:
    """Shared by device-resident voice pools."""

    #: per-block delta-channel capacity per controllable field
    k_ctrl = 64

    #: set by a ScenePack holding this pool's state: called before any
    #: change of ``state`` outside the pack's render (growth, eager plays),
    #: so that the pack's carried state comes back first
    _unpack_hook = None

    #: per-block params holding slot indices (padding lanes hold the
    #: capacity), beside one ``ctrl_idx{j}`` per controllable field: a
    #: ScenePack maps them to stacked rows
    INDEX_PARAMS = ()
    #: per-block params holding one value per scene: a ScenePack stacks
    #: them (every other param is per lane, and concatenated)
    SCENE_PARAMS = ()

    def params_index_keys(self):
        """Every per-block param key that holds slot indices."""
        return self.INDEX_PARAMS + tuple(f"ctrl_idx{j}" for j in range(len(self.ctrl_keys)))

    def cursor_params(self):
        """This block's scene-level cursor params, shipped or not (a
        ScenePack ships every scene's when any scene ships its own); none
        for a pool without a shared ring cursor."""
        return {}

    def _pull_pack(self):
        if self._unpack_hook is not None:
            self._unpack_hook()

    # -- packed handle-state sync ------------------------------------------

    def sync(self):
        """Pull mask/stopped back from the device; reclaim freed slots."""
        if self.state is None:
            return
        self._sync_apply(*self._sync_read())

    def _sync_apply(self, mask, stopped):
        """Reclaim the slots whose voice the device has stopped and
        dropped (mixer.rs:129-147: one scan late); slots with a play
        still queued keep their claim.  ``mask``/``stopped`` are numpy
        bool columns of at least ``capacity`` rows."""
        cap = self.capacity
        free = self.mask_host & stopped[:cap] & ~mask[:cap]
        for i, _ in self.pending_plays:
            free[i] = False
        idx = np.nonzero(free)[0]
        if idx.size:
            self.mask_host[idx] = False
            self.stopped_host[idx] = True
            self.slot_gen[idx] += 1
            self._free.extend(idx.tolist())
            self._on_freed()

    def _on_freed(self):
        """Hook: slots were reclaimed at a sync."""

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
        #: live slots' spec chains (their control mirrors stay current:
        #: ControlBlock.set always writes the spec's own field); they feed
        #: host_ds_bound / host_ema_bound
        self._slot_specs = {}
        self._ds_fields = {
            k for k in self.ctrl_keys
            if k[1] in getattr(_at_path(proto, k[0]), "_dr_ds_fields", ())
        }
        self._ds_dirty = True
        self._ds_small = True
        self._ema_fast = False
        #: no fader in the pool has pending or in-flight fades (always true
        #: until fades are ported, ROADMAP P4)
        self._fade_quiet = True

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
        if (path, field) in self._ds_fields:
            self._ds_dirty = True

    # -- read-path flags (step bound, AGC gate) ------------------------------

    def _track_spec(self, slot, spec):
        """Keep a played spec for the bound queries."""
        self._slot_specs[int(slot)] = spec
        self._ds_dirty = True

    def _ds_bound_small(self, interval):
        """True when every live voice's per-frame source step fits the
        stream resample kernel; also sets ``_ema_fast`` and ``_ds_tier``.
        Recomputed only after plays or step-class control writes."""
        if self._ds_dirty or getattr(self, "_ds_interval", None) != interval:
            from ..ops import agc, stream_kernels

            b = 0.0
            be = 0.0
            for slot, spec in self._slot_specs.items():
                if self.mask_host[slot]:
                    b = max(b, spec.host_ds_bound(interval))
                    be = max(be, spec.host_ema_bound(interval))
            self._ds_small = bool(b <= stream_kernels.RESAMPLE_DSMAX)
            # every live Adapt tau admits the closed-form AGC kernel
            self._ema_fast = bool(agc.EMA_NMAX * be <= agc.EMA_GATE)
            # window tier of the step bound; 1e-5 absorbs the one-ulp f32
            # wobble of rate-matched ratios
            self._ds_tier = 1 if b <= 1.0 + 1e-5 else 2 if b <= 2.0 else 4
            self._ds_dirty = False
            self._ds_interval = interval
        return self._ds_small

    def _ds_flag_sync(self, interval):
        """Resolve the pool's read-path flags and stamp them onto every node
        of the proto chain (part of the pool archetype)."""
        small = self._ds_bound_small(float(interval))
        self._stamp_flags(small, self._ds_tier, self._ema_fast)
        return small

    def _stamp_flags(self, small, tier, fast):
        """Stamp read-path flags onto the pool and every node of its proto
        chain (a ScenePack stamps the pack-wide ones on the pool that
        renders the pack)."""
        self._ds_small, self._ds_tier, self._ema_fast = small, tier, fast
        if (getattr(self.proto, "_pool_ds_small", True) != small
                or getattr(self.proto, "_pool_ds_tier", 4) != tier
                or getattr(self.proto, "_pool_ema_fast", None) is not fast):
            stack = [self.proto]
            while stack:
                node = stack.pop()
                node._pool_ds_small = small
                node._pool_ds_tier = tier
                node._pool_ema_fast = fast
                stack.extend(node.children().values())

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
