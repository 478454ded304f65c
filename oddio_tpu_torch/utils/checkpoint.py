"""Engine checkpoint/resume (counterpart of oddio_tpu/utils/checkpoint.py).

The reference has no checkpointing (SURVEY.md §5); its closest analogue is
``Seek`` plus readable playback positions.  Every signal's state is
explicit — small host numpy arrays plus a device tree of tensors — so a
scene can be snapshotted and resumed exactly.  The snapshot captures state
only; the graph structure (what was played into which engine) must be
reconstructed by the caller before ``restore`` (same archetype).

A snapshot is ``{"host", "extra", "device"}``: the signal graph's host
fields and each node's ``host_aux_snapshot`` (an engine's is its
``host_snapshot``: its pools' bookkeeping, ``pool_state``), the
``host_snapshot`` of a signal without that hook, and the
``device_collect()`` tree as numpy.  Collecting it copies every leaf to
the host, which waits for the kernels that wrote them and for the pinned
uploads in flight.  ``restore`` uploads copies to the engine's own device,
so a snapshot taken on the card restores into a structurally identical
engine on the CPU and the reverse, and one snapshot restores any number
of times (the port updates some leaves in place).

Queued commands (a play or a fade that has not reached the device yet)
are part of the state and hold the signal they carry by reference; a
pickled snapshot (``save``) holds copies whose control handles are
detached (``ControlBlock.__getstate__``).
"""

from __future__ import annotations

import pickle
import uuid

import numpy as np
import torch

from .convert import state_from_numpy, state_to_numpy

__all__ = ["snapshot", "restore", "save", "load", "pools_snapshot", "pools_restore"]


def _host_state(sig):
    flush = getattr(sig, "_flush_tick_debt", None)
    if flush is not None:
        flush()  # deferred idle-tick mirror debt must land in the snapshot
    state = {f: np.copy(getattr(sig, f)) for f in sig._host_fields}
    aux = getattr(sig, "host_aux_snapshot", None)
    if aux is not None:
        state["__aux__"] = aux()
    kids = {k: _host_state(c) for k, c in sig.children().items()}
    if kids:
        state["__children__"] = kids
    return state


def _set_host_state(sig, state):
    if getattr(sig, "_tick_debt", None):
        sig._tick_debt = []  # restored mirrors are authoritative
    for f in sig._host_fields:
        setattr(sig, f, np.copy(state[f]))
    aux = getattr(sig, "host_aux_restore", None)
    if aux is not None and "__aux__" in state:
        aux(state["__aux__"])
    for k, c in sig.children().items():
        _set_host_state(c, state.get("__children__", {})[k])


def copy_host(x):
    """A copy of a host value: containers and arrays copied, scalars as
    they are, signals (a queued command's payload) by reference."""
    if isinstance(x, np.ndarray):
        return x.copy()
    if isinstance(x, dict):
        return {k: copy_host(v) for k, v in x.items()}
    if isinstance(x, list):
        return [copy_host(v) for v in x]
    if isinstance(x, tuple):
        return tuple(copy_host(v) for v in x)
    if isinstance(x, set):
        return set(x)
    if isinstance(x, torch.Tensor):
        raise TypeError("a tensor in a pool's host state: collect it with the device state")
    return x


#: pool attributes a snapshot leaves out: the pool's identity and
#: structure (its template's host state is walked apart, its device state
#: collected apart), per-block upload rings and device-side caches (rebuilt
#: on use), and the played specs its step bounds read (``_SPEC_MAPS``)
_POOL_SKIP = frozenset((
    "name", "device", "proto", "sig", "state", "ring", "_records",
    "_ingest_leaves", "_unpack_hook", "_count_t", "_counts_memo", "_sync_pack",
    "ctrl_keys", "fade_paths", "_ds_fields", "_ckpt_id", "_store_epoch",
    "_slot_specs", "_extra_specs", "_extra_by_slot",
))
#: a device-resident pool's played specs and released fade targets, whose
#: control mirrors its step and AGC bounds read
_SPEC_MAPS = ("_slot_specs", "_extra_specs", "_extra_by_slot")


def pool_state(pool):
    """A pool's host bookkeeping: every attribute but ``_POOL_SKIP``'s
    (slot columns, free list, queued plays, motion, stops, control writes
    and fades, fade and geometry mirrors, cursors, step bounds and read
    flags, walk-bound caches), copied."""
    st = {"attrs": {k: copy_host(v) for k, v in vars(pool).items() if k not in _POOL_SKIP}}
    if hasattr(pool, "_slot_specs"):
        if getattr(pool, "_ckpt_id", None) is None:
            pool._ckpt_id = uuid.uuid4().hex
        st["spec_owner"] = pool._ckpt_id
        st["specs"] = {k: copy_host(getattr(pool, k)) for k in _SPEC_MAPS}
    return st


def _merge_specs(own, saved, same):
    """The snapshot's keys; the snapshot's specs into the pool that took
    it, else the pool's own where it has the key (their handles write
    those mirrors)."""
    out = {}
    for k, v in saved.items():
        if isinstance(v, dict):
            out[k] = _merge_specs(own.get(k, {}), v, same)
        else:
            out[k] = v if same or k not in own else own[k]
    return out


def set_pool_state(pool, st):
    """Restore ``pool_state``: attributes the snapshot lacks (caches made
    after it) are dropped, so the pool recomputes them as it did; the
    handle-state readback in flight is dropped too."""
    attrs = st["attrs"]
    for k in list(vars(pool)):
        if k not in _POOL_SKIP and k not in attrs:
            delattr(pool, k)
    for k, v in attrs.items():
        setattr(pool, k, copy_host(v))
    if "specs" in st:
        same = st["spec_owner"] == getattr(pool, "_ckpt_id", None)
        for k in _SPEC_MAPS:
            setattr(pool, k, _merge_specs(getattr(pool, k), st["specs"][k], same))
    if hasattr(pool, "_sync_pack"):
        pool._sync_pack = None  # keyed on the replaced mask tensor


def pool_entry(snap, pool):
    """A pool's entry of an engine's host snapshot; the engine must hold
    the same pools at the same capacities as when it was taken."""
    st = snap.get(pool.name)
    if st is None:
        raise ValueError(f"pool {pool.name} was opened after the snapshot")
    cap = st["attrs"]["capacity"]
    if cap != pool.capacity:
        raise ValueError(f"pool {pool.name} holds {pool.capacity} slots, the snapshot {cap}")
    return st


def pools_snapshot(pools):
    """An engine's pools' host state: each pool's ``pool_state`` with its
    template's host state (a host pool's voice columns, a submix engine's
    own pools; a stream pool's cursor mirrors and producer queues)."""
    out = {}
    for p in pools:
        st = pool_state(p)
        if not p.is_dr:
            st["sig"] = _host_state(p.sig)
        elif p.proto.batch:
            st["proto"] = _host_state(p.proto)
        out[p.name] = st
    return out


def pools_restore(pools, snap):
    for p in pools:
        st = pool_entry(snap, p)
        set_pool_state(p, st)
        if "sig" in st:
            _set_host_state(p.sig, st["sig"])
        elif "proto" in st:
            _set_host_state(p.proto, st["proto"])


def _device_of(signal):
    dev = signal.device
    if dev is None:
        raise ValueError("the signal has no device yet: render it (or build its Renderer) first")
    return dev


def snapshot(signal):
    """Capture (host_state, engine extra, device_state) for a signal graph
    or engine."""
    host = _host_state(signal)
    extra = None
    snap_fn = getattr(signal, "host_snapshot", None)
    # an engine's aux hook (a submix's way in) has taken it already
    if snap_fn is not None and "__aux__" not in host:
        extra = snap_fn()
    device = state_to_numpy(signal.device_collect())
    return {"host": host, "extra": extra, "device": device}


def restore(signal, snap):
    """Restore a snapshot into a structurally identical signal graph, on
    that graph's own device."""
    _set_host_state(signal, snap["host"])
    if snap["extra"] is not None:
        signal.host_restore(snap["extra"])
    signal.device_store(state_from_numpy(snap["device"], _device_of(signal)))


def save(signal, path):
    with open(path, "wb") as f:
        pickle.dump(snapshot(signal), f)


def load(signal, path):
    with open(path, "rb") as f:
        restore(signal, pickle.load(f))
