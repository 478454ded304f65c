"""Sparse control deltas for device-resident pools (counterpart of
oddio_tpu/core/drctrl.py).

Handle writes queue ``(slot, value)`` on the host (last-wins per slot, like
the reference's atomics, gain.rs:103-108) and ship as bounded per-block
delta lanes; overflow beyond ``k_ctrl`` carries to the next block.

The JAX package pads every delta array to a fixed lane count and lets the
scatter drop the padding lanes (``mode="drop"``).  Torch's index_put
rejects out-of-range rows, so play, motion and control lanes go through
``drop_lanes``/``scatter_drop_``: every lane is applied on the device,
with fixed shapes and no host read, and a padding lane (an index outside
``[0, V)``) rewrites a row some real lane writes with that lane's value,
so it changes nothing (a captured block step reads its lanes from the
device).  Fades ride their own lanes (``k_fade`` per fader
path and block): ``fade_to`` on a device-resident voice queues the target
(``push_fade``), the host releases it into a lane once the voice's fade
mirrors say it is idle (``_fade_tick``, which mirrors the device's
progress exactly, so the device is never read for it), and the device
writes the target's row into the fader's inactive bank (``_fade_apply``:
the same drop lanes, each lane's bank its row's flip bit), as the JAX
package applies them with ``mode="drop"``.  The pools stamp their
read-path flags on the proto chain (``_ds_small``, ``_ds_tier``,
``_ema_fast``); the AGC gate is computed at the block length the pool
renders, so 513-frame buffered renders take K7 too.

The handle-state readback packs the ``mask`` and ``stopped`` columns into
one uint8 bit array on the device (shifts and a sum; torch has no
``packbits``), copied to the host asynchronously where the device allows.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.context import RenderDevice, current_cell, in_block_step
from ..utils.profiler import count
from ..utils.tree import tree_fill, tree_stack

__all__ = ["DRCtrlMixin", "PinnedUpload", "walk_ctrl_keys", "walk_fade_paths", "host_lanes",
           "drop_lanes", "scatter_drop_", "scatter_rows_drop_", "device_param",
           "read_handle_state"]


def _dr_children(node):
    """Children as addressed in the DR state tree (a fader exposes both
    banks, though its spec carries one)."""
    f = getattr(node, "dr_ctrl_children", None)
    return f() if f is not None else node.children()


def walk_ctrl_keys(proto):
    """Ordered (path, field) pairs for every controllable host field in the
    chain; ``path`` is the tuple of child keys from the pool root."""
    keys = []

    def walk(node, path):
        for f in getattr(node, "_dr_ctrl_fields", ()):
            keys.append((path, f))
        for k, c in _dr_children(node).items():
            walk(c, path + (k,))

    walk(proto, ())
    return keys


def walk_fade_paths(proto):
    """Paths of fade-capable (Fader) nodes in the chain, outermost first."""
    out = []

    def walk(node, path):
        if getattr(node, "dr_fade_capable", lambda: False)():
            out.append(path)
        for k, c in _dr_children(node).items():
            walk(c, path + (k,))

    walk(proto, ())
    return out


def _at_path(node, path):
    """Walk a spec chain by DR-state path (a fader's banks both map to
    its ``a``)."""
    for k in path:
        node = _dr_children(node)[k]
    return node


def _set_path(tree, path, value):
    """``tree`` with the subtree at ``path`` replaced (new dicts along the
    path, the tensors shared)."""
    if not path:
        return value
    t = dict(tree)
    t[path[0]] = _set_path(t[path[0]], path[1:], value)
    return t


def _state_at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def host_lanes(idx, V):
    """Host-side lane filter: (kept positions, their row indices) for a
    padded numpy index array whose padding lanes hold ``V``."""
    idx = np.asarray(idx)
    keep = idx < V
    return keep, idx[keep].astype(np.int64)


def drop_lanes(idx, V):
    """The device plan of a padded lane array ``idx`` (a tensor; real lanes
    hold distinct rows in ``[0, V)``, padding lanes anything else) for
    ``scatter_drop_``: ``(row per lane, source lane per lane, whether any
    lane is real)``.  A padding lane targets the first real lane's row and
    takes that lane's value; with no real lane every lane targets row 0
    (and ``scatter_drop_`` writes row 0's own value).  Fixed shapes, no
    host read: the JAX package's ``mode="drop"`` without a data-dependent
    count."""
    idx = idx.to(torch.int64).reshape(-1)
    valid = (idx >= 0) & (idx < V)
    anyv = valid.any()
    # (1,) tensors throughout: indexing with a 0-d tensor reads it on the host
    first = valid.to(torch.int32).argmax().reshape(1)
    lane = torch.arange(idx.shape[0], dtype=torch.int64, device=idx.device)
    rows = torch.where(valid, idx, torch.where(anyv, idx.index_select(0, first), 0))
    return rows, torch.where(valid, lane, first), anyv


def scatter_drop_(leaf, lanes, vals, keep=None):
    """``leaf[idx] = vals`` in place over the real lanes of a ``drop_lanes``
    plan; ``vals`` (lanes, ...) or one row broadcast to every lane.  Every
    write to a row carries the same value, so duplicate rows are
    deterministic.  ``keep``, a (lanes,) bool tensor, writes only where it
    is True and the row's old value elsewhere (the JAX package's
    ``where(wrote, upd, state)`` after its drop scatter: a row mask
    gathered at the lanes' rows, so a padding lane keeps what its real
    lane keeps, and False on every lane of a plan with no real lane).
    Returns ``leaf``."""
    rows, src, anyv = lanes
    v = vals.to(leaf.dtype)
    if v.dim() == leaf.dim():
        v = v[src]
    if keep is None:
        v = torch.where(anyv, v, leaf[0])
    else:
        v = torch.where(keep.reshape((-1,) + (1,) * (leaf.dim() - 1)), v, leaf[rows])
    leaf.index_put_((rows,), v.expand((rows.shape[0],) + tuple(leaf.shape[1:])))
    return leaf


def scatter_rows_drop_(state, rows, lanes, keep=None):
    """Write a tree of play or fade rows (numpy, or tensors a block step
    unpacked from its row; one row per lane, a subtree of ``state``) into
    ``state``'s leaves in place over the real lanes of a ``drop_lanes``
    plan ``lanes``, where the (lanes,) ``keep`` allows (``scatter_drop_``).
    Returns ``state``."""
    if isinstance(rows, dict):
        for k, r in rows.items():
            scatter_rows_drop_(state[k], r, lanes, keep)
        return state
    return scatter_drop_(state, lanes, device_param(rows, state.device, state.dtype), keep)


def _upload(x, device, dtype=None):
    """Copy a numpy value into a fresh tensor on ``device`` (never aliasing
    the host array: state tensors are updated in place).  To a card the
    copy is asynchronous: from pageable memory the driver stages the bytes
    before the call returns, and the stream orders the copy before the
    kernels that read it, so the host does not wait for the device."""
    t = torch.tensor(np.asarray(x), dtype=dtype)
    if torch.device(device).type != "cuda":
        return t
    count("h2d.bytes.pageable", t.nbytes)
    return t.to(device, non_blocking=True)


def device_param(x, device, dtype=None, upload=None):
    """A per-block parameter as a tensor on ``device``: a Renderer's block
    step hands the render tensors unpacked from its one row on the device
    (returned as they are, cast where ``dtype`` asks); a numpy value (an
    engine or pack dispatched op by op) is uploaded, through ``upload``
    where given (a ``PinnedUpload``).  Inside a block step
    (``block_step``; a CUDA graph may replay it) no parameter may come
    from the host: a numpy value there raises."""
    if isinstance(x, torch.Tensor):
        return x if dtype is None or x.dtype == dtype else x.to(dtype)
    if in_block_step():
        raise RuntimeError("a block step took a per-block value from the host")
    return _upload(x, device, dtype) if upload is None else upload(x)


class PinnedUpload:
    """Ships one host array per call to ``device`` with ONE non_blocking
    copy, through a ring of ``DEPTH`` reused pinned buffers (the host
    buffered pool's per-block operand record).  A pinned buffer is
    rewritten only once the copy that last read it has finished (its
    event); each slot reuses its device tensor too, which the stream
    orders after the kernels that read it last.  Each cell of a pack's
    mesh has a ring of its own (``parallel.context.mesh_cell``), on the
    cell's device.  Off CUDA it is a plain copy (a fresh tensor, never
    aliasing the array)."""

    DEPTH = 4
    device = RenderDevice()

    def __init__(self, device):
        self.device = torch.device(device)
        self._rings = {}  # mesh cell key (None outside a pack's mesh) -> [slots, next]

    def __call__(self, arr):
        dev = self.device
        if dev.type != "cuda":
            return torch.tensor(arr, device=dev)
        cell = current_cell()
        key = None if cell is None else cell[0]
        ring = self._rings.get(key)
        if ring is None or ring[0][0][1].shape != arr.shape or ring[0][0][1].device != dev:
            dtype = torch.from_numpy(arr[:0]).dtype
            ring = self._rings[key] = [[
                (torch.empty(arr.shape, dtype=dtype, pin_memory=True),
                 torch.empty(arr.shape, dtype=dtype, device=dev),
                 torch.cuda.Event())
                for _ in range(self.DEPTH)], 0]
        slots, i = ring
        host, out, done = slots[i]
        ring[1] = (i + 1) % self.DEPTH
        done.synchronize()
        host.numpy()[...] = arr
        out.copy_(host, non_blocking=True)
        done.record()
        count("h2d.bytes.pinned", host.nbytes)
        return out


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

    #: the pool's device; inside a pack's mesh cell, the cell's
    device = RenderDevice()

    #: per-block delta-channel capacity per controllable field
    k_ctrl = 64
    #: per-block fade-start lanes per fader path
    k_fade = 8

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

    #: per-block params whose leaves carry a leading voice axis (dense
    #: per-voice payloads: a stream's ingest chunk); every other param is
    #: per lane or per scene
    VOICE_PARAMS = ("ing",)
    #: state leaves that hold one value per scene, not per voice: a
    #: ScenePack gives each voice shard of a scene group the group's whole
    SCENE_STATE = ()

    def params_voice_axes(self, params):
        """Which of this block's param leaves carry a leading voice axis
        (the JAX package's ``params_voice_axes`` for one pool)."""
        return {k: tree_fill(v, k in self.VOICE_PARAMS) for k, v in params.items()}

    def state_voice_axes(self, state):
        """Which state leaves carry a leading voice axis (the JAX
        package's ``device_state_voice_axes`` for one pool)."""
        return {k: tree_fill(v, k not in self.SCENE_STATE) for k, v in state.items()}

    def params_index_keys(self):
        """Every per-block param key that holds slot indices."""
        return (self.INDEX_PARAMS
                + tuple(f"ctrl_idx{j}" for j in range(len(self.ctrl_keys)))
                + tuple(f"fade_idx{j}" for j in range(len(self.fade_paths))))

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

    #: bumped by the engine's ``device_store``: a replayed block step
    #: rewrites the state in place without touching the tensors' versions
    _store_epoch = 0

    def _state_key(self):
        m = self.state["mask"]
        return (id(m), m._version, self._store_epoch)

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
        self.fade_paths = walk_fade_paths(proto)
        #: path -> slot -> (spec, duration, gen); last-wins per slot while
        #: a fade is in flight (fader.rs:38-47's waiting command)
        self.pending_fades = {p: {} for p in self.fade_paths}
        V = self.capacity
        #: host mirrors of each fader's device state: progress advances by
        #: exactly count*inc per block, so the host decides when a waiting
        #: fade may start without reading the device
        self._fade_prog = {p: np.ones(V, np.float32) for p in self.fade_paths}
        self._fade_inc = {p: np.zeros(V, np.float32) for p in self.fade_paths}
        self._fade_fading = {p: np.zeros(V, bool) for p in self.fade_paths}
        self._fade_flip = {p: np.zeros(V, bool) for p in self.fade_paths}
        #: durations of mid-fade plays whose inc resolves at the first tick
        #: (the pool interval may be unknown at play time); -1 = none
        self._fade_dur = {p: np.full(V, -1.0, np.float32) for p in self.fade_paths}
        #: live slots' spec chains (their control mirrors stay current:
        #: ControlBlock.set always writes the spec's own field); they feed
        #: host_ds_bound / host_ema_bound
        self._slot_specs = {}
        self._extra_specs = {}  # (slot, fade path, bank) -> fade target spec
        self._extra_by_slot = {}  # slot -> {(fade path, bank): fade target spec}
        #: each slot's step and AGC bounds over its specs, refreshed only for
        #: the slots a play, a step-class write or a fade touched
        self._ds_slot = np.zeros(V)
        self._ema_slot = np.zeros(V)
        self._ds_stale = set()
        self._ds_fields = {
            k for k in self.ctrl_keys
            if k[1] in getattr(_at_path(proto, k[0]), "_dr_ds_fields", ())
        }
        self._ds_dirty = True
        self._ds_small = True
        self._ema_fast = False
        #: no fader in the pool has pending, in-flight or unresolved fades:
        #: ``_fade_tick`` is then an exact no-op and the idle path may skip
        #: it (cleared by push_fade and by a mid-fade play)
        self._fade_quiet = True

    def _ctrl_grow(self, old, new):
        """Extend the fade mirrors to a grown capacity."""
        ext = new - old
        for p in self.fade_paths:
            for mirror, fill in ((self._fade_prog, 1.0), (self._fade_inc, 0.0),
                                 (self._fade_dur, -1.0)):
                mirror[p] = np.concatenate([mirror[p], np.full(ext, fill, np.float32)])
            for mirror in (self._fade_fading, self._fade_flip):
                mirror[p] = np.concatenate([mirror[p], np.zeros(ext, bool)])
        self._ds_slot = np.concatenate([self._ds_slot, np.zeros(ext)])
        self._ema_slot = np.concatenate([self._ema_slot, np.zeros(ext)])

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
            self._ds_stale.add(int(slot))
            self._ds_dirty = True

    def _set_extra(self, slot, path, bank, spec):
        """Keep a released fade target for the bound queries, keyed per
        bank: the bank it replaces drops out, the other bank (the fade's
        outgoing signal, audible through the crossfade) stays."""
        slot = int(slot)
        self._extra_specs[(slot, path, bank)] = spec
        self._extra_by_slot.setdefault(slot, {})[(path, bank)] = spec
        self._ds_stale.add(slot)
        self._ds_dirty = True

    # -- fade lanes ------------------------------------------------------------

    def push_fade(self, path, slot, gen, spec, duration):
        """fade_to on a DR voice (fader.rs:86-93): queued per (fader,
        slot), last-wins while a fade is in flight."""
        if self.slot_gen[slot] != gen:
            return
        if spec.archetype() != _at_path(self.proto, path).a.archetype():
            raise ValueError("pooled fade targets must share the inner archetype")
        stack = [spec]
        while stack:  # Rust move semantics, recursively
            s = stack.pop()
            if s._moved:
                raise RuntimeError(
                    "fade target was already played (moved); construct a new one"
                )
            s._moved = True
            stack.extend(s.children().values())
        self.pending_fades[path][int(slot)] = (spec, float(duration), gen)
        self._fade_quiet = False

    def _fade_claim_reset(self, slot):
        """A reclaimed slot's queued fades and fade targets must not leak
        onto the next tenant."""
        for p in self.fade_paths:
            self.pending_fades[p].pop(int(slot), None)
            for bank in ("a", "b"):
                self._extra_specs.pop((int(slot), p, bank), None)
        self._extra_by_slot.pop(int(slot), None)
        self._ds_stale.add(int(slot))

    def _fade_mirror_on_play(self, slot, spec):
        """Seed the fade mirrors from the played spec's host state."""
        for p in self.fade_paths:
            node, ok = spec, True
            for k in p:
                kids = node.children()
                if k not in kids:
                    ok = False
                    break
                node = kids[k]
            if ok and node.b is not None:
                self._fade_prog[p][slot] = np.float32(node.progress[()])
                self._fade_fading[p][slot] = True
                self._fade_dur[p][slot] = np.float32(node.duration[()])
                self._fade_quiet = False
            else:
                self._fade_prog[p][slot] = np.float32(1.0)
                self._fade_fading[p][slot] = False
                self._fade_dur[p][slot] = -1.0
            self._fade_inc[p][slot] = np.float32(0.0)
            self._fade_flip[p][slot] = False

    def _fade_pending_any(self):
        return any(self.pending_fades.values())

    def _fade_tick(self, params, interval, count):
        """Per-block fader bookkeeping, mirroring the device exactly:
        release waiting fades on idle voices into padded lanes (when
        ``params`` is not None), emulate the start-of-block completion
        flips, and advance the progress mirrors by ``count`` frames."""
        if not self.fade_paths:
            return
        iv = np.float32(interval)
        cf = np.float32(count)
        for j, path in enumerate(self.fade_paths):
            prog = self._fade_prog[path]
            inc = self._fade_inc[path]
            fading = self._fade_fading[path]
            flip = self._fade_flip[path]
            # resolve mid-fade plays' inc now that the interval is known
            dur = self._fade_dur[path]
            pend_dur = dur >= 0.0
            if pend_dur.any():
                inc[pend_dur] = iv / np.maximum(dur[pend_dur], iv)
                dur[pend_dur] = -1.0
            if params is not None:
                idx = np.full(self.k_fade, self.capacity, np.int32)
                incv = np.zeros(self.k_fade, np.float32)
                rows = []
                pend = self.pending_fades[path]
                t = 0
                for slot in sorted(pend):
                    if t >= self.k_fade:
                        break
                    if pend[slot][2] != self.slot_gen[slot]:
                        del pend[slot]  # the voice died; the command drops
                        continue
                    if fading[slot] and prog[slot] < 1.0:
                        continue  # waits until idle (fader.rs:38-47)
                    spec, dur_s, _ = pend.pop(slot)
                    # the device's targeted-slot resolution of a completed
                    # but unflipped fade (_fade_apply)
                    if fading[slot]:
                        flip[slot] = ~flip[slot]
                        fading[slot] = False
                    inc_s = np.float32(iv / max(np.float32(dur_s), iv))
                    # the target lands in the INACTIVE bank and its handles
                    # bind there for good: completion only flips the bit
                    bank = "a" if flip[slot] else "b"
                    self._rebind_ctrl(spec, slot, int(self.slot_gen[slot]), path + (bank,))
                    idx[t] = slot
                    incv[t] = inc_s
                    rows.append(spec.dr_slot_row(interval))
                    self._set_extra(slot, path, bank, spec)
                    prog[slot] = 0.0
                    inc[slot] = inc_s
                    fading[slot] = True
                    t += 1
                default = _at_path(self.proto, path).a.dr_default_row(interval)
                rows = rows + [default] * (self.k_fade - len(rows))
                params[f"fade_idx{j}"] = idx
                params[f"fade_inc{j}"] = incv
                params[f"fade_row{j}"] = tree_stack(rows)
            # start-of-block completion flips for untargeted slots, then the
            # end-of-block progress advance (as Fader.dr_render)
            done = fading & (prog >= 1.0)
            np.logical_xor(flip, done, out=flip)
            fading &= ~done
            np.minimum(prog + cf * inc, np.float32(1.0), out=prog)
        self._fade_quiet = not any(
            self.pending_fades[p] or self._fade_fading[p].any()
            or (self._fade_dur[p] >= 0.0).any()
            for p in self.fade_paths
        )

    def _fade_apply(self, inner_state, params):
        """Write released fade starts into the fader nodes' state subtrees
        (after plays and control deltas) as the JAX package does, with
        drop lanes: a targeted slot's completed fade resolves first, so a
        new fade never lands on an unflipped one; the target's row goes
        into the inactive bank (each lane's bank is its row's flip bit),
        and the slot's progress restarts.  Every lane applies on the device and nothing
        is read on the host, so ``eager()`` and a block step run the same
        ops."""
        if not self.fade_paths or "fade_idx0" not in params:
            return inner_state
        from ..parallel.context import localize_index

        for j, path in enumerate(self.fade_paths):
            sub = dict(_state_at(inner_state, path))
            V = sub["prog"].shape[0]
            dev = sub["prog"].device
            lanes = drop_lanes(device_param(localize_index(params[f"fade_idx{j}"], V), dev), V)
            true = torch.ones((), dtype=torch.bool, device=dev)
            tgt = scatter_drop_(torch.zeros_like(sub["fading"]), lanes, true)
            res = tgt & sub["fading"] & (sub["prog"] >= 1.0)
            flip = torch.logical_xor(sub["flip"], res)
            rows = params[f"fade_row{j}"]
            # every lane's row is a target (the JAX package's tgt & flip):
            # the bank a lane writes is its row's flip bit, gathered once
            into_a = flip[lanes[0]]
            scatter_rows_drop_(sub["a"], rows, lanes, into_a & lanes[2])
            scatter_rows_drop_(sub["b"], rows, lanes, ~into_a & lanes[2])
            sub["flip"] = flip
            # in place, as the control deltas
            scatter_drop_(sub["prog"], lanes, torch.zeros((), dtype=sub["prog"].dtype,
                                                          device=dev))
            scatter_drop_(sub["inc"], lanes,
                          device_param(params[f"fade_inc{j}"], dev, sub["inc"].dtype))
            sub["fading"] = scatter_drop_(sub["fading"] & ~res, lanes, true)
            inner_state = _set_path(inner_state, path, sub)
        return inner_state

    # -- read-path flags (step bound, AGC gate) ------------------------------

    def _track_spec(self, slot, spec):
        """Keep a played spec for the bound queries."""
        self._slot_specs[int(slot)] = spec
        self._ds_stale.add(int(slot))
        self._ds_dirty = True

    def _ds_bound_small(self, interval, n):
        """True when every live voice's per-frame source step fits the
        stream resample kernel; also sets ``_ema_fast`` (every live Adapt
        tau admits the closed-form AGC kernel at the pool's block length
        ``n``, or at ``EMA_NMAX`` frames where that is longer) and
        ``_ds_tier``.  Recomputed only after plays, step-class
        control writes or a change of interval or block length."""
        if (self._ds_dirty or getattr(self, "_ds_interval", None) != interval
                or getattr(self, "_ds_n", None) != n):
            from ..ops import agc, stream_kernels

            if getattr(self, "_ds_interval", None) != interval:
                self._ds_stale.update(self._slot_specs)  # every bound moves
                self._ds_stale.update(self._extra_by_slot)
            for slot in self._ds_stale:
                specs = list(self._extra_by_slot.get(slot, {}).values())
                if slot in self._slot_specs:
                    specs.append(self._slot_specs[slot])
                self._ds_slot[slot] = max((sp.host_ds_bound(interval) for sp in specs),
                                          default=0.0)
                self._ema_slot[slot] = max((sp.host_ema_bound(interval) for sp in specs),
                                           default=0.0)
            self._ds_stale = set()
            live = self.mask_host
            b = float(np.max(self._ds_slot[live], initial=0.0))
            be = float(np.max(self._ema_slot[live], initial=0.0))
            self._ds_small = bool(b <= stream_kernels.RESAMPLE_DSMAX)
            self._ema_fast = bool(max(agc.EMA_NMAX, n) * be <= agc.EMA_GATE)
            # window tier of the step bound; 1e-5 absorbs the one-ulp f32
            # wobble of rate-matched ratios
            self._ds_tier = 1 if b <= 1.0 + 1e-5 else 2 if b <= 2.0 else 4
            self._ds_dirty = False
            self._ds_interval = interval
            self._ds_n = n
        return self._ds_small

    def _ds_flag_sync(self, interval, n):
        """Resolve the pool's read-path flags for blocks of ``n`` frames
        and stamp them onto every node of the proto chain (part of the
        pool archetype)."""
        small = self._ds_bound_small(float(interval), n)
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
                stack.extend(_dr_children(node).values())

    def _ctrl_pending_any(self):
        return any(self.pending_ctrl.values()) or self._fade_pending_any()

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
        place (applied after plays, so a write lands on its voice); every
        lane on the device, padding lanes dropped (``scatter_drop_``)."""
        if "ctrl_idx0" not in params or not self.ctrl_keys:
            return inner_state
        from ..parallel.context import localize_index

        for j, (path, field) in enumerate(self.ctrl_keys):
            t = inner_state
            for k in path:
                t = t[k]
            leaf = t[field]
            V = leaf.shape[0]
            idx = device_param(localize_index(params[f"ctrl_idx{j}"], V), leaf.device)
            scatter_drop_(leaf, drop_lanes(idx, V),
                          device_param(params[f"ctrl_val{j}"], leaf.device, leaf.dtype))
        return inner_state
