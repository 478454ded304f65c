"""Carry device state between the JAX package and this one.

``state_from_numpy`` takes a JAX scene's ``device_collect()`` tree after
``jax.device_get`` (plain numpy arrays) and returns the same tree of
tensors on ``device``, same keys and dtypes; ``state_to_numpy`` goes the
other way.  ``carry_mixer`` carries a JAX ``Mixer``'s device-resident pools
into a port ``Mixer`` built by the same control script.  None of them
imports JAX: JAX arrays convert through ``numpy.asarray``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["state_from_numpy", "state_to_numpy", "carry_mixer"]


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
    return np.array(tree.detach().cpu(), copy=True)


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def carry_mixer(src, dst):
    """Carry the device-resident pools of ``src`` (a JAX package ``Mixer``)
    into ``dst`` (this package's ``Mixer``), which the same control script
    built: the same plays in the same order, so the pools line up by name.

    Carried per pool: the device state (mask, stopped, each voice's chain
    state: stream rings and cursors ``t``/``len``/``start``/``closed``/
    ``rate``, the Adapt columns and ``avg``, the Sine accumulators), the
    slot bookkeeping, queued stops and control writes, and, for stream
    pools, the host mirrors that must agree with the device: the batched
    proto's cursor mirrors, producer queues and dirty set.  ``src`` must
    have no plays pending (render it once after its last play); the plays
    ``dst`` queued while it was built are dropped, since the carried state
    holds them.  After the carry both mixers render the same blocks."""
    sp, dp = list(src._pools.values()), list(dst._pools.values())
    if [p.name for p in sp] != [p.name for p in dp]:
        raise ValueError("the two mixers hold different pools")
    for a, b in zip(sp, dp):
        if not a.is_dr:
            raise ValueError(f"pool {a.name} is a host pool, which is not ported")
        if a.pending_plays:
            raise ValueError(f"pool {a.name} has plays pending: render it once first")
        while b.capacity < a.capacity:
            b.grow()
        if b.capacity != a.capacity:
            raise ValueError(f"pool {a.name}: capacity {b.capacity} > {a.capacity}")
        b.state = state_from_numpy(_numpy_tree(a.state), b.device)
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
