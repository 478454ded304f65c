"""Carry device state between the JAX package and this one.

``state_from_numpy`` takes a JAX scene's ``device_collect()`` tree after
``jax.device_get`` (plain numpy arrays) and returns the same tree of
tensors on ``device``, same keys and dtypes; ``state_to_numpy`` goes the
other way.  ``carry_mixer`` carries a JAX ``Mixer``'s pools into a port
``Mixer`` built by the same control script, and ``carry_scene`` a JAX
``SpatialScene``'s into a port scene, and ``carry_pack`` every scene of a
JAX ``ScenePack`` into a port pack.  None of them imports JAX: JAX arrays
convert through ``numpy.asarray``.

The host buffered pool's ring is ``(V*L/128, 128)`` in the JAX package
and ``(V, L)`` here: the same bytes in the same order, carried by a
reshape.

Sampler voices (FramesSignal, Cycle) index a process-wide sample arena,
which the two packages fill in their own orders: their ``off``, ``goff``
and ``loff`` leaves are remapped by ``Frames``, through the voices both
control scripts played (the same slot, the same chain).  A port
FramesSignal also keeps the reference's f64 time cursor ``t``, which the
carry derives from the JAX package's (base, frac) cursor.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.drctrl import _dr_children

__all__ = ["state_from_numpy", "state_to_numpy", "carry_mixer", "carry_scene", "carry_pack"]


def state_from_numpy(tree, device="cpu"):
    """Numpy tree -> tensor tree on ``device`` (always a copy: the port
    updates some leaves in place)."""
    if isinstance(tree, dict):
        return {k: state_from_numpy(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def state_to_numpy(tree):
    """Tensor tree -> numpy tree (copies on the host)."""
    if isinstance(tree, dict):
        return {k: state_to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy().copy()


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _chain(sig):
    """Every node of a signal chain, parents first."""
    out = [sig]
    for c in sig.children().values():
        out.extend(_chain(c))
    return out


_SAMPLERS = ("FramesSignal", "Cycle")
_ARENA_FIELDS = ("off", "goff", "loff")


def _pair_offsets(pairs, a, b):
    """Record, for the sampler nodes of spec chains ``a`` (JAX) and ``b``
    (port) built alike, which port arena offset each JAX offset stands
    for, keyed by (channel count, field)."""
    for na, nb in zip(_chain(a), _chain(b)):
        if type(na).__name__ != type(nb).__name__:
            raise ValueError(f"chains differ: {type(na).__name__} vs {type(nb).__name__}")
        if type(na).__name__ in _SAMPLERS:
            for f in _ARENA_FIELDS:
                if f in na._host_fields:
                    table = pairs.setdefault((na.channels, f), {})
                    table[int(getattr(na, f))] = int(getattr(nb, f))


def _slot_pairs(a, b):
    """The offset pairs of the voices both pools played in the same slot."""
    pairs = {}
    for slot, spec in a._slot_specs.items():
        if slot in b._slot_specs:
            _pair_offsets(pairs, spec, b._slot_specs[slot])
    return pairs


def _remap(values, table, live, default, what):
    """A JAX (V,) offset column in port offsets; a live voice's offset must
    be known, a free slot's (or an unused fader bank's default) stays as
    it was."""
    out = np.array(values, copy=True)
    for i, v in enumerate(np.asarray(values).tolist()):
        if v in table:
            out[i] = table[v]
        elif live[i] and v != default:
            raise ValueError(f"{what}: arena offset {v} of a live voice belongs to a "
                             f"Frames the port's control script did not play")
    return out


def _remap_dr_samplers(state, proto, pairs, live, path=()):
    """Remap the sampler subtrees of a device-resident pool's inner state
    (numpy tree, in place) and give each port FramesSignal its time
    cursor ``t``."""
    name = type(proto).__name__
    if name in _SAMPLERS:
        defaults = proto.dr_state_init(1)
        for f in _ARENA_FIELDS:
            if f in state:
                state[f] = _remap(state[f], pairs.get((proto.channels, f), {}), live,
                                  int(defaults[f][0]), f"{'/'.join(path)}/{f}")
        if name == "FramesSignal":
            s = state["base"].astype(np.float64) + state["frac"].astype(np.float64)
            state["t"] = s / state["rate"].astype(np.float64)
    for k, c in _dr_children(proto).items():
        _remap_dr_samplers(state[k], c, pairs, live, path + (k,))


def _carry_host_fields(a, b):
    """Copy the host state of chain ``a`` (JAX) onto chain ``b`` (port):
    every node's host columns and a stream's producer queues (refilled in
    place, since its handles alias the lists) and dirty set.  A sampler's
    arena offsets stay the port's own (its slots were played alike)."""
    for na, nb in zip(_chain(a), _chain(b)):
        if type(na).__name__ != type(nb).__name__:
            raise ValueError(f"chains differ: {type(na).__name__} vs {type(nb).__name__}")
        for x in (na, nb):
            flush = getattr(x, "_flush_tick_debt", None)
            if flush is not None:
                flush()
        if getattr(na, "_pool_mode", False):
            _carry_queued_fades(na, nb)
        for f in na._host_fields:
            if type(na).__name__ in _SAMPLERS and f in _ARENA_FIELDS:
                continue
            setattr(nb, f, np.array(getattr(na, f), copy=True))
        if isinstance(getattr(na, "_pending", None), np.ndarray):  # a stream's queues
            for q_dst, q_src in zip(nb._pending.flat, na._pending.flat):
                q_dst[:] = [np.array(c, copy=True) for c in q_src]
            nb._dirty = set(na._dirty)


def _carry_queued_fades(a, b):
    """A host-pool Fader's waiting fades: ``b``'s script issued the same
    ``fade_to`` calls, so its queue holds a port target (last-wins per
    slot) for every slot ``a``'s holds; the slots ``a`` released since
    drop out (their fades live in the carried b bank and progress)."""
    qa, qb = a._pending_fades, b._pending_fades
    for slot, (_, dur) in qa.items():
        if slot not in qb or qb[slot][1] != dur:
            raise ValueError(f"slot {slot}: the port's script did not queue the fade "
                             f"the JAX fader holds")
    b._pending_fades = {slot: qb[slot] for slot in qa}
    b._pending_breset = set(a._pending_breset)


def _carry_batched(a, b):
    """A host pool's batched template: host columns, queues, device leaves."""
    _carry_host_fields(a, b)
    b.device_store(state_from_numpy(_numpy_tree(a.device_collect()), b.device))


def _carry_host_pool(a, b, columns):
    """Carry a JAX host pool ``a`` into the port's ``b`` (the same kind):
    the slot columns, the chain's host and device state, and a buffered
    pool's ring."""
    if type(a).__name__ != type(b).__name__:
        raise ValueError(f"pool {a.name}: {type(a).__name__} vs {type(b).__name__}")
    while b.capacity < a.capacity:
        b.grow()
    if b.capacity != a.capacity:
        raise ValueError(f"pool {a.name}: capacity {b.capacity} > {a.capacity}")
    for c in columns:
        setattr(b, c, np.array(getattr(a, c), copy=True))
    b._free = list(a._free)
    if getattr(a, "is_singleton", False):
        # the one voice is an engine: carry it whole
        carry = carry_scene if hasattr(a.sig, "_buffered_pools") else carry_mixer
        carry(a.sig, b.sig)
    else:
        _carry_batched(a.sig, b.sig)
    if hasattr(a, "ring_state"):
        ring = np.asarray(a.ring_state()).reshape(a.capacity, a.ring_len)
        b.ring = torch.from_numpy(ring.copy()).to(b.device)
        b._n_inner = a._n_inner
        b._use_strips = a._use_strips


def carry_mixer(src, dst):
    """Carry the pools of ``src`` (a JAX package ``Mixer``) into ``dst``
    (this package's ``Mixer``), which the same control script built: the
    same plays in the same order, so the pools line up by name.

    Carried per device-resident pool: the device state (mask, stopped,
    each voice's chain state: stream rings and cursors ``t``/``len``/
    ``start``/``closed``/``rate``, the Adapt columns and ``avg``, the Sine
    accumulators), the slot bookkeeping, queued stops and control writes,
    and, for stream pools, the host mirrors that must agree with the
    device: the batched proto's cursor mirrors, producer queues and dirty
    set.  Per host pool: the slot columns, the batched template's host
    columns, queues and device leaves (a submix is carried whole).  ``src``
    must have no plays pending (render it once after its last play); the
    plays ``dst`` queued while it was built are dropped, since the carried
    state holds them.  After the carry both mixers render the same
    blocks."""
    sp, dp = list(src._pools.values()), list(dst._pools.values())
    if [p.name for p in sp] != [p.name for p in dp]:
        raise ValueError("the two mixers hold different pools")
    for a, b in zip(sp, dp):
        if not a.is_dr:
            _carry_host_pool(a, b, ("mask", "stop", "slot_gen"))
            continue
        if a.pending_plays or any(a.pending_fades.values()):
            raise ValueError(f"pool {a.name} has plays or fades pending: render it once first")
        while b.capacity < a.capacity:
            b.grow()
        if b.capacity != a.capacity:
            raise ValueError(f"pool {a.name}: capacity {b.capacity} > {a.capacity}")
        pairs = _slot_pairs(a, b)
        _carry_fades(a, b, pairs)
        state = _numpy_tree(a.state)
        _remap_dr_samplers(state["inner"], b.proto, pairs, a.mask_host)
        b.state = state_from_numpy(state, b.device)
        b.slot_gen = a.slot_gen.copy()
        b._free = list(a._free)
        b.mask_host = a.mask_host.copy()
        b.stopped_host = a.stopped_host.copy()
        b.pending_plays = []
        b.pending_stops = set(a.pending_stops)
        b.pending_ctrl = {k: dict(v) for k, v in a.pending_ctrl.items()}
        b._interval = a._interval
        # the stream leaves of the batched protos (Adapt(Stream) -> Stream)
        for la, lb in zip(a._ingest_leaves, b._ingest_leaves):
            la._flush_tick_debt()
            lb._flush_tick_debt()
            for f in la._host_fields:
                setattr(lb, f, np.array(getattr(la, f), copy=True))
            # the port's stream handles alias these lists: refill in place
            for q_dst, q_src in zip(lb._pending, la._pending):
                q_dst[:] = [np.array(c, copy=True) for c in q_src]
            lb._dirty = set(la._dirty)


def _carry_fades(a, b, pairs):
    """A device-resident pool's fade mirrors, and its released fade
    targets: ``b``'s script issued the same ``fade_to`` calls, which wait
    in its queue; each moves into the bank ``a`` released it into (its
    handles rebound there) and pairs its sampler offsets."""
    for name in ("_fade_prog", "_fade_inc", "_fade_fading", "_fade_flip", "_fade_dur"):
        setattr(b, name, {p: v.copy() for p, v in getattr(a, name).items()})
    b._extra_specs, b._extra_by_slot = {}, {}
    for (slot, path, bank), spec_a in a._extra_specs.items():
        queued = b.pending_fades[path].pop(slot, None)
        if queued is None:
            raise ValueError(f"slot {slot}: the port's script did not issue the fade "
                             f"the JAX pool released")
        spec_b = queued[0]
        _pair_offsets(pairs, spec_a, spec_b)
        b._set_extra(slot, path, bank, spec_b)
        b._rebind_ctrl(spec_b, slot, int(a.slot_gen[slot]), path + (bank,))
    b.pending_fades = {p: {} for p in b.fade_paths}
    b._fade_quiet = a._fade_quiet
    b._ds_dirty = True


def carry_scene(src, dst):
    """Carry the pools of ``src`` (a JAX package ``SpatialScene``) into
    ``dst`` (this package's), built by the same control script.

    Host pools are carried whole: the ``_VoicePool`` columns (mask, stop
    and motion state, smoothing clock, lingering), a buffered pool's write
    cursors, ``max_delay`` and ring, and the batched template's host
    columns, producer queues and device leaves (a submix is carried
    whole).  Device-resident pools carry their device state; their host
    mirrors are the port's own, stepped through the same block
    preparations (``dst.host_prepare`` once per block ``src`` rendered).
    The listener rotation's device copy is carried too."""
    sp, dp = src._all_pools(), dst._all_pools()
    if [p.name for p in sp] != [p.name for p in dp]:
        raise ValueError("the two scenes hold different pools")
    tree = _numpy_tree(src.device_collect())
    dst._rot_dev = state_from_numpy(tree["_rot"], dst.device)
    for a, b in zip(sp, dp):
        if getattr(a, "is_dr", False):
            pairs = _slot_pairs(a, b)
            _carry_fades(a, b, pairs)
            state = tree[a.name]
            _remap_dr_samplers(state["inner"], b.proto, pairs, a.mask_host)
            b.state = state_from_numpy(state, b.device)
        else:
            _carry_host_pool(a, b, a._COL_NAMES)


def carry_pack(src, dst):
    """Carry a JAX package ``ScenePack`` ``src`` into this package's
    ``ScenePack`` ``dst``, whose scenes the same control scripts built:
    ``src.sync()`` writes its carried (S, ...) state back into its scenes,
    each scene carries across (``carry_scene`` or ``carry_mixer``: the
    device-resident pools with their fade mirrors and released fade
    targets, the host pools' columns, templates and rings, each submix
    whole), and ``dst`` drops any stack it held, so that its next block
    stacks the carried scenes.  The conditions of the per-scene carries
    hold (a spatial scene's host mirrors are ``dst``'s own, stepped
    through the same block preparations; ``dst``'s scripts issued the
    fades ``src`` released)."""
    if len(src.scenes) != len(dst.scenes):
        raise ValueError(f"{len(src.scenes)} scenes vs {len(dst.scenes)}")
    src.sync()
    dst.drop_stack()
    for a, b in zip(src.scenes, dst.scenes):
        (carry_scene if hasattr(a, "_buffered_pools") else carry_mixer)(a, b)
