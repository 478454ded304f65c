"""Dense masked mixer (counterpart of oddio_tpu/mixer.py).

Reference: oddio's src/mixer.rs — ``Mixer`` sums a dynamic set of
same-frame-type signals (mixer.rs:89-120): drain control messages, drop
stopped/finished voices (setting their stop flag so handles observe it,
mixer.rs:102-105), then sample each voice and accumulate.

Voices of equal archetype (graph structure) live in one pool, routed as
the JAX package routes them.  Device-resident capable chains play in a
``PoolDR``: mask, stop flags and the inner chains' whole state are tensors
on the mixer's device; the host ships sparse play, stop and control-field
deltas (padding lanes filtered on the host) and each stream's queued PCM,
and observes handle state at sync points with the reference's
one-scan-late reclamation (mixer.rs:129-147).  Other chains (a Speed over
a Stream, a user signal) play in a host ``Pool``: a batched template whose
host columns the host advances and whose device leaves the block renders
at once (``render_host``).  A non-batchable signal (a submix: an engine
played into the mixer) plays alone in a ``PoolSingleton``.  Capacity
doubles on demand (set.rs:57-63); bulk plays beyond ``k_play`` apply
eagerly.  The voice sum is a masked ``where`` + ``sum``, accumulated in
float64 so that it does not depend on the device's reduction order.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.drctrl import DRCtrlMixin, _upload, host_lanes, rows_scatter
from .core.hostmath import f32
from .core.signal import Engine, default_device
from .ops._dev import masked_voice_sum
from .parallel.context import current_scenes, localize_index
from .utils.tree import tree_map, tree_stack

__all__ = ["Mixer", "MixerControl", "Mixed", "Pool", "PoolSingleton", "PoolDR",
           "DEFAULT_CAPACITY", "render_submix"]

DEFAULT_CAPACITY = 16


def _ingest_leaves(node):
    """Leaf signals of the chain that own a host->device ingest channel
    (Streams): the idle path defers their cursor ticks directly."""
    kids = node.children()
    if not kids:
        return [node] if node.dr_needs_ingest() else []
    out = []
    for c in kids.values():
        out.extend(_ingest_leaves(c))
    return out


class Pool:
    """A host pool of voices sharing one archetype (the JAX package's
    ``Pool``): mask, stop flags and the chains' host state are numpy
    columns of one batched template, whose device leaves live on the
    mixer's device."""

    is_dr = False

    #: set by a ScenePack holding this pool's device state: called with
    #: ``drop`` True before growth (the pack's stack goes back into the
    #: scenes), False before a play's in-place slot reset (the scenes take
    #: views of the stack)
    _unpack_hook = None

    def __init__(self, name, spec, capacity, device):
        self.name = name
        self.proto = spec  # structure donor for clone/grow
        self.device = torch.device(device)
        self.sig = spec.clone_batched(capacity)
        self.sig._set_device(self.device)
        self.capacity = capacity
        self.mask = np.zeros(capacity, dtype=bool)
        self.stop = np.zeros(capacity, dtype=bool)
        self.slot_gen = np.zeros(capacity, dtype=np.int64)
        self._free = list(range(capacity - 1, -1, -1))

    def _pull_pack(self, drop=True):
        if self._unpack_hook is not None:
            self._unpack_hook(drop)

    def grow(self):
        self._pull_pack()
        old = self.capacity
        new = old * 2
        self.sig.grow_batched(new)
        self.mask = np.concatenate([self.mask, np.zeros(old, bool)])
        self.stop = np.concatenate([self.stop, np.zeros(old, bool)])
        self.slot_gen = np.concatenate([self.slot_gen, np.zeros(old, np.int64)])
        self._free = list(range(new - 1, old - 1, -1)) + self._free
        self.capacity = new

    def play(self, spec):
        if not self._free:
            self.grow()
        i = self._free.pop()
        gen = int(self.slot_gen[i])
        self.sig.write_slot(i, spec, self, gen)
        spec._moved = True
        self._pull_pack(drop=False)
        self.sig.device_reset_slot(i)
        self.mask[i] = True
        self.stop[i] = False
        return i, gen

    def reap(self):
        """Drop stopped/finished voices before rendering (mixer.rs:100-105)."""
        fin = self.sig.host_is_finished()
        drop = self.mask & (self.stop | fin)
        if drop.any():
            self.stop |= drop
            self.mask &= ~drop
            for i in np.nonzero(drop)[0]:
                self.slot_gen[i] += 1
                self._free.append(int(i))

    # handle interface shared with PoolDR
    def push_stop(self, slot, gen):
        if self.slot_gen[slot] == gen:
            self.stop[slot] = True

    def handle_stopped(self, slot, gen):
        if self.slot_gen[slot] != gen:
            return True
        return bool(self.stop[slot])


class PoolSingleton(Pool):
    """A one-voice pool for a non-batchable signal: a submix (an engine
    played into the mixer), which the reference boxes like any Signal
    (mixer.rs:18-26).  The voice renders unbatched, on its own device (the
    mixer's)."""

    is_singleton = True
    #: where a ScenePack finds the submix engine's params (None: its state
    #: is the whole subtree)
    INNER_PARAMS, INNER_STATE = "p", None

    def __init__(self, name, spec):
        self.name = name
        self.proto = spec
        self.sig = spec
        #: the archetype AS PLAYED: a fresh same-construction signal matches
        #: it, so a replay rebinds the freed pool (Mixer.play)
        self._arch0 = spec.archetype()
        self.capacity = 1
        self.mask = np.zeros(1, dtype=bool)
        self.stop = np.zeros(1, dtype=bool)
        self.slot_gen = np.zeros(1, dtype=np.int64)
        self._free = [0]

    def grow(self):
        raise RuntimeError("singleton pools hold exactly one voice")

    def play(self, spec):
        i = self._free.pop()
        gen = int(self.slot_gen[i])
        spec._moved = True
        self.mask[i] = True
        self.stop[i] = False
        return i, gen

    def rebind(self, spec):
        """Reuse this freed one-voice pool for a fresh same-archetype
        signal: the subtree swaps wholesale (fresh host and device state),
        the singleton's counterpart of a batched pool's slot reuse."""
        self._pull_pack()
        self.proto = self.sig = spec
        self._arch0 = spec.archetype()
        return self.play(spec)


def render_submix(sig, dstate, ddata, params, n):
    """A singleton pool's voice ``sig`` as rows: (1, C, n), or in a
    ScenePack its S scenes' (S, C, n), the engine's stacked render or a
    wrapper chain's batched one over S rows."""
    if current_scenes() is None:
        d2, block = sig.render(dstate, ddata, params, n)
        return d2, block[None]
    if isinstance(sig, Engine):
        return sig.render(dstate, ddata, params, n)
    return sig.render_host(dstate, ddata, params, n)


class PoolDR(DRCtrlMixin):
    """Device-resident voice pool of one archetype (mixer.rs:92-118)."""

    is_dr = True
    INDEX_PARAMS = ("play_idx", "stop_idx")

    def __init__(self, name, spec, capacity, k_play=8, k_stop=64, device="cpu"):
        self.name = name
        self.device = torch.device(device)
        # ingest-needing protos (Stream) keep BATCHED host mirror columns:
        # the pool's shadow of the device cursors plus the per-slot
        # producer queues (Stream.dr_bind_slot)
        self.proto = (
            spec.clone_batched(capacity) if spec.dr_needs_ingest() else spec
        )
        # the chain's read-only device data (sample arenas) on this device
        self.proto._set_device(self.device)
        self.capacity = capacity
        self.k_play = k_play
        self.k_stop = k_stop
        self.slot_gen = np.zeros(capacity, dtype=np.int64)
        self._free = list(range(capacity - 1, -1, -1))
        self.mask_host = np.zeros(capacity, dtype=bool)
        self.stopped_host = np.zeros(capacity, dtype=bool)
        self.pending_plays = []  # (slot, spec): rows materialize at prepare
        self.pending_stops = set()
        self.force_deltas = False
        self._interval = None
        self.state = None
        self._init_ctrl(spec)
        #: ingest leaves of the batched proto (identity survives growth)
        self._ingest_leaves = (
            _ingest_leaves(self.proto) if self.proto.batch else []
        )
        self._counts_memo = (None, None)  # (key, (V,) int32 numpy)
        self._count_t = (None, None)  # (key, (V,) int32 tensor)

    def _fresh_state(self, V):
        dev = self.device
        return {
            "mask": torch.zeros(V, dtype=torch.bool, device=dev),
            "stopped": torch.zeros(V, dtype=torch.bool, device=dev),
            "inner": tree_map(lambda x: _upload(x, dev), self.proto.dr_state_init(V)),
        }

    def dr_state(self):
        if self.state is None:
            self.state = self._fresh_state(self.capacity)
        return self.state

    def grow(self):
        """set-realloc analogue (set.rs:57-63): double capacity."""
        self._pull_pack()
        old = self.capacity
        new = old * 2
        self._ctrl_grow(old, new)
        self.dr_state()
        fresh = self._fresh_state(old)
        self.state = tree_map(lambda a, b: torch.cat([a, b]), self.state, fresh)
        self.slot_gen = np.concatenate([self.slot_gen, np.zeros(old, np.int64)])
        self.mask_host = np.concatenate([self.mask_host, np.zeros(old, bool)])
        self.stopped_host = np.concatenate([self.stopped_host, np.zeros(old, bool)])
        self._free = list(range(new - 1, old - 1, -1)) + self._free
        if self.proto.batch:
            self.proto.grow_batched(new)
        self.capacity = new

    def play(self, spec):
        if not self._free:
            self.grow()
        i = self._free.pop()
        gen = int(self.slot_gen[i])
        stack = [spec]
        while stack:  # Rust move semantics, recursively
            s = stack.pop()
            if s._moved:
                raise RuntimeError(
                    "signal was already played (moved); construct a new one"
                )
            s._moved = True
            stack.extend(s.children().values())
        self._rebind_ctrl(spec, i, gen)
        self._fade_claim_reset(i)
        self._fade_mirror_on_play(i, spec)
        self._track_spec(i, spec)
        if self.proto.batch:
            self.proto.dr_bind_slot(i, spec, self, gen)
        self.pending_plays.append((i, spec))
        self.mask_host[i] = True
        self.stopped_host[i] = False
        return i, gen

    def push_stop(self, slot, gen):
        if self.slot_gen[slot] == gen:
            self.pending_stops.add(int(slot))

    def handle_stopped(self, slot, gen):
        self._maybe_sync()
        if self.slot_gen[slot] != gen:
            return True
        return bool(self.stopped_host[slot])

    def _maybe_sync(self):
        """Refresh handle-visible state at most once per rendered block."""
        if getattr(self, "_sync_seen", -1) != getattr(self, "_prep_count", 0):
            self.sync()
            self._sync_seen = getattr(self, "_prep_count", 0)

    def _rows(self, plays, interval):
        return [
            {"mask": True, "stopped": False, "inner": s.dr_slot_row(interval)}
            for _, s in plays
        ]

    def _scatter_rows(self, S, idx, rows):
        """Write play rows (numpy, one per real lane) at slots ``idx``."""
        it = _upload(idx, self.device)
        for k in ("mask", "stopped"):
            S[k][it] = _upload(rows[k], self.device, torch.bool)
        S["inner"] = rows_scatter(S["inner"], rows["inner"], it)

    def _apply_plays_eager(self, interval):
        """Bulk plays: apply all pending plays directly to the device state,
        outside the per-block step."""
        self._pull_pack()
        self.dr_state()
        idx = np.array([i for i, _ in self.pending_plays], np.int64)
        rows = tree_stack(self._rows(self.pending_plays, interval))
        self.pending_plays = []
        S = dict(self.state)
        self._scatter_rows(S, idx, rows)
        self.state = S

    def sync_prefetch(self):
        self._sync_start()

    def _idle_gate(self, iv, n):
        """True when this block of ``n`` frames needs no params, cannot
        change the archetype, and every per-block side effect is deferrable
        (the flags were computed for this interval and block length)."""
        return (not self.force_deltas and not self.pending_plays
                and not self.pending_stops and self._fade_quiet
                and not self._ds_dirty
                and getattr(self, "_ds_interval", None) == iv
                and getattr(self, "_ds_n", None) == n
                and not self._ctrl_pending_any()
                and not any(l._dirty for l in self._ingest_leaves))

    def _idle_apply(self, times, count=None):
        """Side effects of ``times`` idle blocks, O(1): the stream-cursor
        ticks are deferred as leaf debt (replayed exactly on read)."""
        cnt = self._count if count is None else int(count)
        self._has_play = self._has_stop = False
        for leaf in self._ingest_leaves:
            if getattr(leaf, "_has_write", False):
                leaf._has_write = False
            leaf.tick_debt_add(self._interval, cnt, times)

    def _idle_bulk_apply(self, interval, n, times, count=None):
        """Advance ``times`` idle blocks at once (the caller checked
        ``_idle_gate``); equivalent to ``times`` idle host_prepare calls."""
        self._interval = float(np.float32(interval))
        self._count = int(n if count is None else count)
        self._prep_count = getattr(self, "_prep_count", 0) + times
        self._idle_apply(times)

    def host_prepare(self, interval, n, force=False, count=None):
        self._interval = float(np.float32(interval))
        #: frames each voice advances this block
        self._count = int(n if count is None else count)
        self._prep_count = getattr(self, "_prep_count", 0) + 1
        params = {}
        if not force and self._idle_gate(self._interval, n):
            # idle: no control traffic, clean flags, no queued stream
            # writes; params are {} and the stream-cursor mirror tick is
            # deferred by the leaves
            self._idle_apply(1)
            return params
        if len(self.pending_plays) > self.k_play:
            self._apply_plays_eager(self._interval)
        has = (
            bool(self.pending_plays) or bool(self.pending_stops)
            or self._ctrl_pending_any() or self.force_deltas or force
        )
        self._has_play = self._has_stop = has
        if has:
            self._ctrl_delta_params(params)
            Kp = self.k_play
            take = self.pending_plays[:Kp]
            self.pending_plays = self.pending_plays[Kp:]
            play_idx = np.full(Kp, self.capacity, np.int32)
            rows = self._rows(take, self._interval)
            if len(rows) < Kp:
                default = {
                    "mask": False,
                    "stopped": True,
                    "inner": self.proto.dr_default_row(self._interval),
                }
                rows = rows + [default] * (Kp - len(rows))
            for j, (i, _) in enumerate(take):
                play_idx[j] = i
            params["play_idx"] = play_idx
            params["play"] = tree_stack(rows)
            Ks = self.k_stop
            items = sorted(self.pending_stops)[:Ks]
            for s in items:
                self.pending_stops.discard(s)
            stop_idx = np.full(Ks, self.capacity, np.int32)
            stop_idx[: len(items)] = items
            params["stop_idx"] = stop_idx
        # fader bookkeeping: release waiting fades into lanes (on control-
        # event blocks) and advance the progress mirrors every block by the
        # frames the voices consume (count, as Fader.dr_render); before the
        # flag sync, since a released target renders this block
        self._fade_tick(params if has else None, self._interval, self._count)
        self._ds_small = self._ds_flag_sync(self._interval, n)
        # stream ingest and the cursor-mirror shadow (in render order:
        # ingest grows len, then the advance releases consumed samples)
        if self.proto.batch:
            ing = self.proto.dr_ingest_params()
            if ing is not None:
                params["ing"] = ing
            if self._counts_memo[0] != (self.capacity, self._count):
                self._counts_memo = (
                    (self.capacity, self._count),
                    np.full(self.capacity, self._count, np.int32),
                )
            self.proto.dr_host_tick(self._interval, self._counts_memo[1])
        return params

    #: set by a ScenePack whose scenes' pools advance different frame
    #: counts this block (submixes at their rings' write counts): one per
    #: scene, else None
    _pack_counts = None

    def _count_tensor(self, V):
        pc = self._pack_counts
        if pc is not None and current_scenes() == len(pc):
            counts = np.repeat(np.asarray(pc, np.int32), V // len(pc))
            return _upload(counts, self.device, torch.int32)
        key = (V, self._count, self.device)
        if self._count_t[0] != key:
            self._count_t = (
                key, torch.full((V,), self._count, dtype=torch.int32, device=self.device)
            )
        return self._count_t[1]

    def render(self, dstate, ddata, params, n):
        S = dict(dstate)
        V = S["mask"].shape[0]
        # 1. plays (set.rs insert semantics: applied before the walk)
        if "play_idx" in params:
            keep, idx = host_lanes(localize_index(params["play_idx"], V), V)
            if idx.size:
                rows = tree_map(lambda x: x[keep], params["play"])
                self._scatter_rows(S, idx, rows)
        # 1b. control-field deltas (set_gain, set_speed, stream close)
        S["inner"] = self._ctrl_apply(S["inner"], params)
        # 1c. fade starts (fader.rs:86-93 swap-channel delivery)
        S["inner"] = self._fade_apply(S["inner"], params)
        # 1d. stream PCM ingest at the device write cursors
        if "ing" in params:
            S["inner"] = self.proto.dr_ingest(S["inner"], params["ing"])
        # 2. stop deltas (Mixed::stop, mixer.rs:33-36)
        if "stop_idx" in params:
            keep, idx = host_lanes(localize_index(params["stop_idx"], V), V)
            if idx.size:
                S["stopped"][_upload(idx, self.device)] = True
        # 3. reap finished/stopped voices, setting the stop flag so handles
        # observe it (mixer.rs:102-105)
        fin = self.proto.dr_is_finished(S["inner"])
        S["stopped"] = S["stopped"] | (S["mask"] & fin)
        S["mask"] = S["mask"] & ~S["stopped"]
        # 4. render + masked sum (where, so garbage in free slots never
        # reaches the output); mono chains return (V, n), others (V, C, n)
        inner2, samples = self.proto.dr_render(
            S["inner"], ddata.get("inner", {}), self._interval, n,
            self._count_tensor(V),
        )
        S["inner"] = inner2
        if samples.dim() == 2:
            samples = samples[:, None, :]
        # a pack's rows are its scenes' pools end to end: mix each apart
        return S, masked_voice_sum(S["mask"], samples, current_scenes())


class Mixer(Engine):
    """A Signal that mixes a dynamic set of Signals (mixer.rs:60-120), on
    ``device``: the CUDA card unless the caller passes another; without a
    card and without ``device`` it raises."""

    def __init__(self, channels=1, initial_capacity=DEFAULT_CAPACITY, device=None):
        super().__init__()
        self.channels = channels
        self.initial_capacity = initial_capacity
        self.device = default_device(device)
        self._pools = {}  # archetype -> pool, insertion-ordered

    @classmethod
    def new(cls, channels=1, device=None):
        """mixer.rs:70-82: returns (MixerControl, Mixer)."""
        sig = cls(channels, device=device)
        return MixerControl(sig), sig

    # -- control side -------------------------------------------------------

    def play(self, spec):
        """Begin playing ``spec``; returns a Mixed handle (mixer.rs:18-26)."""
        if spec.channels != self.channels:
            raise ValueError(
                f"signal has {spec.channels} channels, mixer expects {self.channels}"
            )
        if not spec.host_batchable():
            spec._set_device(self.device)  # raises for an engine elsewhere
            # reuse a freed same-archetype singleton first: the replay
            # rebinds the subtree in place (no new pool)
            arch = spec.archetype()
            for pool in self._pools.values():
                if (
                    getattr(pool, "is_singleton", False)
                    and pool._free
                    and getattr(pool, "_arch0", None) == arch
                ):
                    slot, gen = pool.rebind(spec)
                    return Mixed(pool, slot, gen)
            name = f"p{len(self._pools)}"
            pool = PoolSingleton(name, spec)
            self._pools[("singleton", name)] = pool
            slot, gen = pool.play(spec)
            return Mixed(pool, slot, gen)
        # ingest-needing chains (streams) go device-resident when the route
        # to the stream leaf is clean (dr_ingest_ok); Speed/Fader-wrapped
        # streams keep the host pool
        dr = spec.dr_supported() and spec.dr_ingest_ok()
        arch = (spec.archetype(), dr)
        pool = self._pools.get(arch)
        if pool is None:
            cls = PoolDR if dr else Pool
            pool = cls(f"p{len(self._pools)}", spec, self.initial_capacity,
                       device=self.device)
            self._pools[arch] = pool
        slot, gen = pool.play(spec)
        return Mixed(pool, slot, gen)

    # -- Signal protocol ------------------------------------------------------

    def children(self):
        return {}

    def _arch_extra(self):
        return (self.initial_capacity,)

    def archetype(self):
        # host pools' batched templates carry per-block flags (a stream's
        # write-free variant) in their archetypes
        pools = tuple(
            (
                p.name,
                p.proto.archetype() if p.is_dr else p.sig.archetype(),
                getattr(p, "_interval", None),
                getattr(p, "_count", None),
                getattr(p, "_has_play", False),
                getattr(p, "_has_stop", False),
                getattr(p, "_ds_small", True),
                getattr(p, "_ds_tier", 4),
            )
            for p in self._all_pools()
        )
        return ("Mixer", self.channels, pools)

    def host_structure_event(self):
        for p in self._all_pools():
            if p.is_dr:
                # bulk plays apply eagerly outside the per-block step
                if len(p.pending_plays) > p.k_play:
                    return True
            elif p.sig.host_structure_event():
                return True
        return False

    def host_wants_deltas(self):
        """Whether any device-resident pool has control events queued for
        the next block (a ScenePack ORs it over its scenes, so that every
        scene ships deltas on the same blocks)."""
        return any(
            bool(p.pending_plays) or bool(p.pending_stops)
            or p._ctrl_pending_any() or p.force_deltas
            for p in self._all_pools()
            if p.is_dr
        )

    def host_idle_bulk_ok(self, interval, n):
        """True when ``host_prepare`` would take the idle path for every
        pool (host pools never do).  The host is single-threaded, so no
        control traffic arrives inside one render call: a True gate holds
        for the rest of it."""
        iv = float(np.float32(interval))
        return all(p.is_dr and p._idle_gate(iv, n) for p in self._all_pools())

    def host_idle_bulk(self, interval, n, times, count=None):
        """Advance ``times`` idle blocks at O(1) host cost; returns False
        (nothing touched) unless every pool passes the idle gate."""
        if not self.host_idle_bulk_ok(interval, n):
            return False
        for p in self._all_pools():
            p._idle_bulk_apply(interval, n, times, count)
        return True

    def host_prepare(self, interval, n, count=None, force=False):
        # scene-global control-event flag: every pool ships deltas together
        # (a pack forces a submix's engine through ``_pack_force``)
        force, self._pack_force = force or self._pack_force, False
        force = force or any(
            bool(p.pending_plays) or bool(p.pending_stops)
            or p._ctrl_pending_any()
            for p in self._all_pools()
            if p.is_dr
        )
        out = {}
        for pool in self._all_pools():
            if pool.is_dr:
                out[pool.name] = pool.host_prepare(interval, n, force, count=count)
                continue
            pool.reap()
            if getattr(pool, "is_singleton", False):
                out[pool.name] = {
                    "mask": pool.mask.copy(),
                    "p": pool.sig.host_prepare(
                        f32(interval), n, None if count is None else int(count),
                    ),
                }
                continue
            V = pool.capacity
            iv = np.broadcast_to(f32(interval), (V,)).astype(np.float32)
            cnt = None if count is None else np.broadcast_to(count, (V,))
            out[pool.name] = {
                "mask": pool.mask.copy(),
                "p": pool.sig.host_prepare(iv, n, cnt),
            }
        return out

    def device_collect(self):
        return {
            p.name: (p.dr_state() if p.is_dr else p.sig.device_collect())
            for p in self._all_pools()
        }

    def device_store(self, d):
        for p in self._all_pools():
            if p.name not in d:  # opened after ``d`` was collected
                continue
            if p.is_dr:
                p.state = d[p.name]
            else:
                p.sig.device_store(d[p.name])

    def device_reset_slot(self, i):
        """An engine plays only through a singleton pool, whose replay
        rebinds the whole subtree; a batched slot reset of a Mixer would
        be a bug."""
        raise RuntimeError(
            "engines render through singleton pools; batched slot reset "
            "is not applicable to a Mixer"
        )

    def device_data(self):
        return {
            p.name: (p.proto if p.is_dr else p.sig).device_data()
            for p in self._all_pools()
        }

    def sync(self):
        """Pull device-resident handle state back (is_stopped, reclamation);
        a submix syncs its own pools."""
        for p in self._all_pools():
            if p.is_dr:
                p.sync()
            elif isinstance(p.sig, Engine):
                p.sig.sync()

    def sync_prefetch(self):
        for p in self._all_pools():
            if p.is_dr:
                p.sync_prefetch()
            elif isinstance(p.sig, Engine):
                p.sig.sync_prefetch()

    def _all_pools(self):
        """The pools as a list: a play from the control thread may open a
        pool while the render thread walks them (``RealtimeDriver``)."""
        return list(self._pools.values())

    def render(self, dstate, ddata, params, n):
        # a ScenePack renders its scenes' pools stacked: (S, C, n)
        S = current_scenes()
        shape = (self.channels, n) if S is None else (S, self.channels, n)
        out = torch.zeros(shape, dtype=torch.float32, device=self.device)
        d2 = {}
        for pool in self._all_pools():
            if pool.name not in params:
                continue  # opened after this block's host_prepare: plays next block
            ps = params[pool.name]
            dd = ddata.get(pool.name, {})
            if pool.is_dr:
                dsub, block = pool.render(dstate[pool.name], {"inner": dd}, ps, n)
                d2[pool.name] = dsub
                out = out + block
                continue
            if getattr(pool, "is_singleton", False):
                dsub, blocks = render_submix(pool.sig, dstate[pool.name], dd, ps["p"], n)
            elif (rb := getattr(pool.sig, "render_batched", None)) is not None:
                # pool-level render of a bare Stream chain (K4/K6)
                dsub, blocks = rb(dstate[pool.name], dd, ps["p"], n)
            else:
                dsub, blocks = pool.sig.render_host(dstate[pool.name], dd, ps["p"], n)
            d2[pool.name] = dsub
            mask = _upload(ps["mask"], self.device)
            out = out + masked_voice_sum(mask, blocks, S)
        return d2, out

    # -- checkpoint/resume ----------------------------------------------------

    def host_snapshot(self):
        """Every pool's host bookkeeping (``utils.checkpoint.pool_state``:
        slot columns and free list, queued plays, stops, control writes and
        fades, the fade mirrors, the interval, the step bounds and read
        flags) and its template's host state."""
        from .utils.checkpoint import pools_snapshot

        return pools_snapshot(self._all_pools())

    def host_restore(self, snap):
        from .utils.checkpoint import pools_restore

        pools_restore(self._all_pools(), snap)

    # submixes (a Mixer played as a voice in another engine) checkpoint
    # through the generic host-state walk's aux hook
    # (utils/checkpoint._host_state)
    host_aux_snapshot = host_snapshot
    host_aux_restore = host_restore


class MixerControl:
    """Handle for controlling a Mixer from the game thread (mixer.rs:7-27)."""

    def __init__(self, mixer):
        self._mixer = mixer

    def play(self, spec):
        return self._mixer.play(spec)


class Mixed:
    """Handle to a signal playing in a Mixer (mixer.rs:30-44)."""

    def __init__(self, pool, slot, gen):
        self._pool = pool
        self._slot = slot
        self._gen = gen

    def _live(self):
        return self._pool.slot_gen[self._slot] == self._gen

    def stop(self):
        """Halt playback at the next block boundary (mixer.rs:33-36)."""
        self._pool.push_stop(self._slot, self._gen)

    def is_stopped(self):
        """Set by stop() and by signals naturally finishing (mixer.rs:38-44),
        as of the last sync."""
        return self._pool.handle_stopped(self._slot, self._gen)
