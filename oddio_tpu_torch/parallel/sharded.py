"""ScenePack: S scenes of one archetype rendered as one, over a (scene,
voice) mesh of devices (counterpart of oddio_tpu/parallel/sharded.py).

The JAX package ``vmap``s a scene's render over a leading scene axis and
runs it under ``shard_map`` on a (scene, voice) mesh.  Here there is no
``vmap`` over custom kernels: the pack stacks its scenes ALONG THE VOICE
AXIS.  Each pool of the archetype becomes one pool of S·V rows, scene s's
voices at rows ``s*V .. s*V + V - 1``, so every per-voice leaf of its
state is ``(S·V, ...)`` and the per-voice kernels (K4, K6, K7) take the
stacked rows as more rows.  Scene-level leaves are concatenated too: the
listener rotation ``_rot`` (4S,), a buffered pool's write cursor ``wcur``
(S,) and its fixed-size sub-pass list (S·SUBCAP).  The pools' renders mix
each scene apart into a leading scene axis (``parallel.context.
scene_stack``): the masked voice sums per scene, K1 writing each scene at
its own row pair, K2 and K5 summing each scene apart, all with one launch
per pool per block whatever S is.

On an a x b mesh the stack is split into cells.  The scene axis splits
the scenes into a groups of S/a; the voice axis splits each pool's slots
into b shards of V/b.  Cell (g, k) holds, on device ``mesh.devices[g][k]``,
the rows of slots ``k*V/b .. (k+1)*V/b - 1`` of group g's scenes, stacked
as above, and each scene-level leaf of those scenes whole (the pools
declare which leaves are per voice: ``params_voice_axes``,
``state_voice_axes``).  A submix (singleton) pool lives whole on voice
shard 0 of its group; the other shards neither hold nor render it, so it
counts once.  Per block the pack renders every cell in turn with scene
0's pools, under ``scene_stack(S/a)`` and ``mesh_cell`` (every pool's and
signal's ``device`` reads the cell's), and sums each group's shards'
(S/a, C, n) partial mixes on the group's first device in shard order: the
JAX package's voice-axis ``psum``, here plain torch.  A 1 x 1 mesh is one
cell holding the whole stack.  One process drives every device, as the
JAX package's one controller does.

Every pool kind packs.  Device-resident pools ship deltas whose slot
indices (plays, stops, controls, fade lanes) map to the cell's stacked
rows (``stack_index``; a lane whose slot another shard holds becomes
padding there).  Host pools (the buffered pool's K4/K5 pair, the seek
pool, the Mixer's host pool) ship per-voice params, sliced to the shard
and concatenated; a Stream's write chunk that some scenes lack ships as
zero rows.  A singleton (submix) pool is S/a rows, one voice per scene:
its engine's state is the inner engines' trees stacked as the scenes' are,
its params the inner engines' params merged by the same rules,
recursively, and the inner engine renders them under the same
``scene_stack`` to (S/a, C, n).

The host control plane stays per scene: each scene keeps its handles and
numpy state and prepares its own parameters; per block the pack merges
them per cell.  The scenes' Stream leaves of each pool form one tick
group (``ops/stream.TickGroup``): the idle ticks the pack's O(1) idle
runs defer on them replay in one stacked pass at the first mirror read
of any.  Where the scenes' per-block choices differ, the pack takes
one for the whole pack, so that every cell takes the route a 1 x 1 pack
takes: the widest read tier and step flags, and the host buffered pool's
exact elementwise read when any scene leaves its strip gate (stamped on
scene 0's pool before its archetype is read: the route is part of the
step's key).  The stacked
state is built once and carried; pool growth and eager plays pull it back
into the scenes first (the pools' ``_unpack_hook``) and the next block
restacks.  A host pool's play resets its slot in place: where every
scene's rows lie in one cell on the scenes' own device (a mesh of one
voice shard) it writes through views of the stack; on a voice-sharded
mesh, or one whose cells render elsewhere, the pack writes its state back,
drops it and restacks at the next block.

A submix under wrappers (an Adapt over a Mixer) stacks its wrappers'
one-voice state along a new scene axis: the wrappers render their S/a rows
batched, and the engine under them its scenes stacked.

On any mesh whose scenes all declare ``graph_capture`` (config-5
Mixers, samplers, main-path, seek-sampler and host-pool SpatialScenes,
Mixers of host pools and submixes) the pack takes block steps, as the
JAX pack compiles one ``shard_map``ped program whatever its mesh
(``oddio_tpu/parallel/sharded.py``): the Renderer's protocol
(``core/run.BlockSteps``) over each cell's carried stack, one lane per
cell (its own steps, staging buffers and, on a card, graphs, which share
the card's memory pool), a ``"single"`` key for ``render_block`` and
``"scan"`` keys of ``scan_unroll`` blocks a call for the runs of
``render_frames_device``, each block's merged params of the cell one
packed row, and on a card each cell's step one CUDA graph, replayed (a
cell on the CPU runs the same step uncaptured).  In a voice-sharded cell
the step also returns each pool's partial mix; after the replays of a
call the pack sums them as op by op (``_join``) over the call's (k, S/a,
C, n) outputs.  The runs are the JAX pack's: blocks of one archetype
(scene 0's, read after the pack-wide flags are stamped) are prepared
before any is rendered, a run is flushed before a scene's structure
event and on an archetype change, and an idle run's remaining blocks go
as replays of the idle key.  A run renders as of its own archetype
(``render_archetype``), inside ``scene_stack`` and ``mesh_cell``.  The
stacks' leaves stay put (rebuilt leaves are copied back, rings written
in place); a stack rebuilt by ``_ensure_state`` (growth, an unpack, a
restored state, a host pool's play on a voice-sharded mesh) makes the
steps capture again.  After a dispatch the scenes take views of the
stack where they can (``_views_ok``); elsewhere they get the gathered
state at ``sync()`` and before the stack drops.  Under ``eager()``, and
on every other pack, blocks render op by op.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.drctrl import read_handle_state
from ..core.run import BlockSteps, _pack_spec, eager_mode
from ..core.signal import Engine, same_device
from ..ops.geometry import HEAD_RADIUS, SPEED_OF_SOUND
from ..ops.stream import TickGroup
from ..utils.profiler import count, span
from ..utils.tree import tree_leaves, tree_map
from .context import mesh_cell, scene_stack, stack_index, voice_partials
from .mesh import SCENE_AXIS, VOICE_AXIS

__all__ = ["ScenePack"]


def _unstack(tree, S, axis=False):
    """A concatenated state tree as S per-scene trees of views (with
    ``axis``, a tree stacked along a new leading scene axis)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, S, axis) for k, v in tree.items()}
        return [{k: parts[k][s] for k in tree} for s in range(S)]
    return list(tree.unbind(0) if axis else tree.split(tree.shape[0] // S))


def _shard_rows(tree, axes, V, shard, shards):
    """Voice shard ``shard`` of ``shards`` of one scene's pool tree (numpy
    params or state tensors): the leaves ``axes`` marks per voice keep rows
    ``shard*V/shards ..`` of their ``V``, the others stay whole."""
    if shards == 1:
        return tree
    Vb = V // shards

    def take(x, per_voice):
        if not per_voice:
            return x
        if x.shape[0] != V:
            raise RuntimeError(f"a per-voice leaf of {x.shape[0]} rows in a pool of {V} slots")
        return x[shard * Vb:(shard + 1) * Vb]

    return tree_map(take, tree, axes)


def _is_submix(pool):
    """Whether ``pool`` is a singleton pool, whose one voice is a submix:
    an engine, or a chain of wrappers over one."""
    return getattr(pool, "is_singleton", False)


def _chain_engine(sig):
    """The engine at the bottom of a submix chain of one-child wrappers."""
    while not isinstance(sig, Engine):
        kids = list(sig.children().values())
        if len(kids) != 1:  # a Fader fading from one engine to another
            raise NotImplementedError(
                f"a pack stacks a submix under one-child wrappers; {type(sig).__name__} "
                f"holds {len(kids)} children")
        sig = kids[0]
    return sig


def _concat(vals):
    """Per-voice host params of the scenes end to end; a key some scenes
    lack (a Stream's write chunk, shipped only with queued PCM) ships as
    zero rows for them (a zero write count writes nothing)."""
    if isinstance(vals[0], dict):
        keys = []
        for v in vals:
            keys.extend(k for k in v if k not in keys)
        out = {}
        for k in keys:
            tmpl = next(v[k] for v in vals if k in v)
            out[k] = _concat([v[k] if k in v else tree_map(np.zeros_like, tmpl)
                              for v in vals])
        return out
    return np.concatenate(vals)


def _stream_leaf(pool):
    """The Stream leaf of a device-resident pool's batched template, whose
    drains ship the pool's ingest chunk, or None."""
    leaves = pool._ingest_leaves if pool.is_dr else ()
    return leaves[0] if leaves else None


class _IngestChunks:
    """A pack's merged ingest chunks where each cell holds every voice of
    its scenes (one voice shard): one persistent (S/a·V, C, mw+1) float32
    chunk per cell and device-resident stream pool, reused from block to
    block.  Before the prepares each dirty Stream leaf's drain is pointed
    at its scene's rows (``Stream._ing_out``), so the written spans land
    there once: no chunk per scene, no zero chunk for a silent scene, no
    concatenation.  Taking a chunk again zeroes the spans it carried, so
    it holds what the concatenated chunks would, zeros past each count
    included.  A chunk stays out of use from its block's prepare until
    that block's rows are packed (``release``): two ingest blocks in one
    run take two."""

    #: free chunks kept per cell and pool
    KEEP = 2

    def __init__(self):
        self.free = {}  # (scene group, pool) -> [[chunk, wcount], ...]
        self.open = {}  # id(chunk) -> [key, chunk, wcount] of the block in prepare
        self.held = []  # (block params, [entry, ...]): prepared, rows not packed

    def arm(self, pack):
        """Take this block's chunks and point the dirty stream leaves'
        drains at their rows; returns the leaves pointed, whose
        ``_ing_out`` the caller resets after the prepares.  A voice-sharded
        pack takes none: ``_shard_rows`` cuts each scene's chunk."""
        self.open = {}
        armed = []
        if pack.B > 1:
            return armed
        for g in range(pack.A):
            groups = [grp for _, gs in pack._engine_groups(pack._group(g)) for grp in gs]
            for i, group in enumerate(groups):
                if _stream_leaf(group[0]) is None:
                    continue
                leaves = [_stream_leaf(p) for p in group]
                dirty = [s for s, leaf in enumerate(leaves) if leaf._dirty]
                if not dirty:
                    continue
                V = group[0].capacity  # one across the pack (``_equalize``)
                entry = self._take((g, i), (len(group) * V, leaves[0].channels,
                                            leaves[0].max_write + 1))
                self.open[id(entry[1])] = entry
                for s in dirty:
                    leaves[s]._ing_out = entry[1][s * V:(s + 1) * V]
                    armed.append(leaves[s])
        return armed

    def _take(self, key, shape):
        """A free chunk of ``shape`` with the spans it carried zeroed (the
        cost of the written samples, not of the chunk), or a new one."""
        free = self.free.get(key, [])
        while free:
            chunk, wcount = free.pop()
            if chunk.shape == shape:
                rows = np.flatnonzero(wcount)
                if rows.size:
                    chunk[rows, :, :wcount[rows].max()] = 0
                return [key, chunk, None]
        return [key, np.zeros(shape, np.float32), None]

    def merge(self, vals):
        """One pool's ingest over a cell's scenes (``vals``, None for a
        scene that shipped none) as the chunk its drains wrote, or None
        where they wrote into chunks of their own."""
        tmpl = next(v for v in vals if v is not None)
        base = tmpl["chunk"].base
        entry = None if base is None else self.open.get(id(base))
        if entry is None:
            return None
        chunk = entry[1]
        V = tmpl["chunk"].shape[0]
        for s, v in enumerate(vals):
            if v is not None and v["chunk"].base is not chunk:
                # a stream first written (by a producer thread) after the arm
                chunk[s * V:(s + 1) * V] = v["chunk"]
        zero = np.zeros_like(tmpl["wcount"])
        entry[2] = np.concatenate([zero if v is None else v["wcount"] for v in vals])
        return {"chunk": chunk, "wcount": entry[2]}

    def close(self, params):
        """After a block's merges: the chunks they handed out stay out of
        use with the block's ``params`` until ``release``."""
        held = [e for e in self.open.values() if e[2] is not None]
        self.open = {}
        if held:
            self.held.append((params, held))

    def release(self, pend=None):
        """Return the chunks of the blocks ``pend`` (their params, whose
        rows are packed; every block's with None) to use."""
        keep = []
        for params, entries in self.held:
            if pend is not None and not any(params is p for p in pend):
                keep.append((params, entries))
                continue
            for key, chunk, wcount in entries:
                free = self.free.setdefault(key, [])
                if len(free) < self.KEEP:
                    free.append([chunk, wcount])
        self.held = keep


def _stamp_host_flags(sigs):
    """Scene 0's host template renders every scene's voices: give each of
    its nodes the pack-wide read flags a host prepare set per scene (a
    Stream's step tier and kernel gate: the widest tier, the gate only
    where every scene passes it)."""
    if "_ds_tier" in vars(sigs[0]):
        sigs[0]._ds_tier = max(s._ds_tier for s in sigs)
        sigs[0]._ds_small = all(s._ds_small for s in sigs)
    for kids in zip(*[s.children().values() for s in sigs]):
        _stamp_host_flags(list(kids))


class ScenePack(BlockSteps):
    """Renders S structurally identical scenes (Mixers, or SpatialScenes)
    as one stacked render over a (scene, voice) mesh.

    ``scenes``: engines of equal archetype, all built on one device, where
    their host mirrors and handle state live; ``mesh``: a
    ``make_mesh(a, b, devices)``, whose cells render (S must divide by a,
    every pool's capacity but a submix's by b, else ``ValueError``).
    ``scan_unroll``: blocks a block step renders per call (one graph
    replay) where the pack takes steps (``graph_capture``)."""

    def __init__(self, scenes, rate, mesh, scan_unroll=1):
        scenes = list(scenes)
        if not scenes:
            raise ValueError("a pack needs at least one scene")
        if len({s.archetype() for s in scenes}) != 1:
            raise ValueError("all scenes in a pack must share an archetype")
        self.device = scenes[0].device
        for s in scenes:
            if not same_device(s.device, self.device):
                raise ValueError(f"a pack's scenes live on one device: {s.device} vs {self.device}")
        self.A, self.B = mesh.shape[SCENE_AXIS], mesh.shape[VOICE_AXIS]
        if len(scenes) % self.A:
            raise ValueError(f"{len(scenes)} scenes do not split into {self.A} scene groups")
        self.scenes = scenes
        self._step_sig = scenes[0]  # its pools render the stack
        self.S = len(scenes)
        #: scenes per scene group
        self.Sa = self.S // self.A
        self.mesh = mesh
        #: (scene group, voice shard) -> the device its cell renders on
        self._cells = {(g, k): mesh.devices[g][k] for g in range(self.A) for k in range(self.B)}
        self._init_steps(scan_unroll)
        self.rate = int(rate)
        self.interval = np.float32(1.0) / np.float32(self.rate)
        self._dstate = None  # (group, shard) -> the cell's stacked state, scene 0's layout
        self._cell = None  # the cell whose block steps a dispatch runs
        self.step_partials = self.B > 1
        self._flush = None  # dispatches the run render_frames_device holds, if any
        #: the drains' persistent ingest chunks (where a cell holds whole scenes)
        self._ingest = _IngestChunks()
        self._names = None
        self._check_structure()
        self._check_split()

    # -- block steps --------------------------------------------------------------

    @property
    def graph_capture(self):
        """True where the scenes all declare ``graph_capture`` (config-5
        Mixers, samplers of Fader(Speed(FramesSignal)) voices, main-path,
        seek-sampler and host-pool SpatialScenes, Mixers of host pools and
        submixes), on any mesh: the pack then renders through block steps
        (CUDA graphs on a card, one per cell and key), its merged fade
        lanes, float64 cursors, host pools' per-voice params (K4/K5's
        records end to end, K5's scene form reading them), submixes'
        params and per-scene frame counts in each cell's packed row."""
        return all(getattr(s, "graph_capture", False) for s in self.scenes)

    def _stepped(self):
        return self.graph_capture and not eager_mode()

    # the block-step protocol's three things, for the cell in progress (a
    # lane of its own): its carried stack, scene 0's data on the cell's
    # device and scene 0's render (``_step_sig``)
    def _lane(self):
        return (self._cell,)

    def _step_get(self):
        return self._dstate[self._cell]

    def _step_set(self, d):
        """Keep the cell's stack after a dispatch (or as a step returned
        it, where its structure changed); ``_dispatch_steps`` stores the
        stacks in the scenes once every cell has run."""
        self._dstate[self._cell] = d

    def _step_data(self):
        return self.scenes[0].device_data()

    def _dispatch_steps(self, arch, kind, pend, n):
        """A run of merged params ``pend`` (each block's, by cell) through
        every cell's block steps of key ``(arch, kind)``, rendered as of
        ``arch`` by scene 0's pools over the cell's stack; then the
        voice shards' partial mixes summed (``_join``): (B, S, C, n).
        Where the scenes can hold views of the stacks (``_views_ok``) they
        take them, which bumps their store counts (the handle readback's
        key: a replay leaves the tensors' versions alone); elsewhere the
        gather waits for ``sync()``."""
        outs = {}
        with self.scenes[0].render_archetype(arch):
            for (g, k), dev in self._cells.items():
                self._cell = (g, k)
                with scene_stack(self.Sa, g * self.Sa), mesh_cell((g, k), dev):
                    outs[g, k] = self._run_key(arch, kind, [p[g, k] for p in pend], n)
            self._cell = None
        self._ingest.release(pend)  # their rows are packed
        if self._views_ok():
            self._store()
        return self._join(outs)

    # -- structure ---------------------------------------------------------------

    def _group(self, g):
        """The scenes of scene group ``g``."""
        return self.scenes[g * self.Sa:(g + 1) * self.Sa]

    def _check_split(self):
        """Every pool's capacity but a submix's must split over the voice
        shards."""
        for group in self._groups():
            for p in group:
                if not _is_submix(p) and p.capacity % self.B:
                    raise ValueError(f"pool {p.name}: capacity {p.capacity} does not split "
                                     f"into {self.B} voice shards")

    def _groups(self, engines=None):
        """Pool i of every engine (the scenes by default), for each pool
        index i."""
        return list(zip(*[e._all_pools() for e in (engines or self.scenes)]))

    def _engine_groups(self, engines=None):
        """The scenes, then each submix's engines across the scenes (one
        group per singleton pool, depth first): (engines, pool groups)."""
        engines = self.scenes if engines is None else engines
        groups = self._groups(engines)
        out = [(engines, groups)]
        for group in groups:
            if _is_submix(group[0]):
                out.extend(self._engine_groups([_chain_engine(p.sig) for p in group]))
        return out

    def _pool_groups(self):
        return [g for _, groups in self._engine_groups() for g in groups]

    @staticmethod
    def _layout(engine):
        """An engine's pools by name, each submix's own layout nested."""
        return tuple(
            (p.name, None if not _is_submix(p) else ScenePack._layout(_chain_engine(p.sig)))
            for p in engine._all_pools()
        )

    def _check_structure(self):
        """Adopt the scenes' pools again when a play opened a new one (its
        state joins the stack at the next restack), and hook every pool,
        the submixes' included."""
        names = tuple(self._layout(s) for s in self.scenes)
        if names == self._names:
            return
        if len(set(names)) != 1:
            raise ValueError(f"the pack's scenes hold different pools: {sorted(set(names))}")
        self._unpack()
        for group in self._pool_groups():
            for p in group:
                p._unpack_hook = self._unpack
            # the scenes' stream leaves of the pool replay the idle ticks
            # the pack's O(1) idle runs leave them in one pass
            for leaves in zip(*[getattr(p, "_ingest_leaves", ()) for p in group]):
                TickGroup(leaves)
        self._names = names

    def _equalize(self):
        """One capacity per pool across the pack: the stacked rows of scene
        s start at s*V.  Grows the smaller pools (which pulls any carried
        state back first); a singleton holds one voice and never grows."""
        for group in self._pool_groups():
            if _is_submix(group[0]):
                continue
            cap = max(p.capacity for p in group)
            for p in group:
                while p.capacity < cap:
                    p.grow()

    def _ensure_state(self):
        """Stack the scenes' device state cell by cell, unless the carried
        stack is current (it is dropped by growth and eager plays)."""
        if self._dstate is not None:
            return
        self._check_split()
        trees = [s.device_collect() for s in self.scenes]
        self._dstate = {}
        for (g, k), dev in self._cells.items():
            eng = self._group(g)
            parts = [self._shard(e, t, k) for e, t in zip(eng, trees[g * self.Sa:])]
            st = self._stack(eng, parts)
            if not same_device(dev, self.device):
                st = tree_map(lambda x, dev=dev: x.to(dev), st)
            self._dstate[g, k] = st

    def _shard(self, engine, tree, k):
        """Voice shard ``k`` of one scene's device tree: each pool's
        per-voice leaves cut to the shard's slots, scene-level leaves
        whole, a submix's subtree on shard 0 only."""
        if self.B == 1:
            return tree
        axes = engine.device_state_voice_axes(tree)
        pools = {p.name: p for p in engine._all_pools()}
        out = {}
        for key, sub in tree.items():
            pool = pools.get(key)
            if pool is None:
                out[key] = sub
            elif not _is_submix(pool):
                out[key] = _shard_rows(sub, axes[key], pool.capacity, k, self.B)
            elif k == 0:
                out[key] = sub
        return out

    def _stack(self, engines, trees):
        """The engines' device trees as one: pool rows end to end (a
        scene-level leaf, the listener rotation, end to end too), each
        submix's state stacked by its chain (``_stack_chain``)."""
        subs = {g[0].name: g for g in self._groups(engines) if _is_submix(g[0])}
        out = {}
        for k in trees[0]:
            group = subs.get(k)
            if group is None:
                out[k] = tree_map(lambda *xs: torch.cat(xs), *[t[k] for t in trees])
                continue
            key = group[0].INNER_STATE
            inner = [t[k] if key is None else t[k][key] for t in trees]
            st = self._stack_chain([p.sig for p in group], inner)
            if key is not None:  # the singleton's own rows (a ring) beside it
                st = {**tree_map(lambda *xs: torch.cat(xs),
                                 *[{j: v for j, v in t[k].items() if j != key} for t in trees]),
                      key: st}
            out[k] = st
        return out

    def _stack_chain(self, sigs, trees):
        """A submix chain's state over the scenes: its engine's as a
        scene's, each wrapper's own leaves (one voice each) stacked along a
        new scene axis, S rows for the wrapper's batched render."""
        if isinstance(sigs[0], Engine):
            return self._stack(sigs, trees)
        kids = [s.children() for s in sigs]
        return {k: self._stack_chain([c[k] for c in kids], [t[k] for t in trees])
                if k in kids[0] else tree_map(lambda *xs: torch.stack(xs), *[t[k] for t in trees])
                for k in trees[0]}

    # -- per block ---------------------------------------------------------------

    def _tier_floors(self, n):
        """One render draws every scene's buffered pool, so the pools of a
        group must agree on the motion-adaptive read tier: give each the
        max PRE-drain walk bound over the pack (each pool's post-drain bound
        is <= its tier_bound, so every scene resolves the same tier)."""
        for engines, groups in self._engine_groups():
            rot_any = any(getattr(e, "_rot_pending", None) is not None for e in engines)
            for grp in groups:
                if not hasattr(grp[0], "tier_bound"):
                    continue
                floor = max(p.tier_bound(self.interval, n) for p in grp)
                if rot_any and n > 0:
                    elapsed = float(np.float32(self.interval) * np.float32(n))
                    floor += 2.0 * float(HEAD_RADIUS) / (float(SPEED_OF_SOUND) * elapsed)
                for p in grp:
                    p._dmax_floor = floor

    def _pack_force(self):
        """Any scene with queued control events forces EVERY scene onto the
        delta path this block, so the merged delta lanes line up; all-idle
        pack blocks ship no delta arrays.  The submixes' engines are forced
        the same way, group by group (their singleton prepares them).
        Stream ingest stays per scene (a scene without queued PCM ships
        zero rows).  Returns the scenes' own force."""
        groups = self._engine_groups()
        for engines, _ in groups[1:]:
            want = any(e.host_wants_deltas() for e in engines)
            for e in engines:
                e._pack_force = want
        return any(s.host_wants_deltas() for s in self.scenes)

    def _pack_flags(self):
        """Scene 0's pools render the pack, so their read-path flags must
        hold for every scene: where the scenes differ, stamp the pack-wide
        ones (every step fits the stream kernel, the widest step tier,
        every tau fits the closed-form AGC) onto scene 0's pool, and on a
        host pool's template; a host buffered pool takes the exact route in
        every scene where any scene's block left the strip gate (each
        scene group's cells merge their scenes' params by it); a
        device-resident Mixer pool whose scenes advance different frame
        counts (a submix's, at its ring's write count) takes them per
        scene."""
        for group in self._pool_groups():
            if group[0].is_dr:
                flags = {(p._ds_small, p._ds_tier, p._ema_fast) for p in group}
                if len(flags) > 1:
                    group[0]._stamp_flags(
                        all(f[0] for f in flags), max(f[1] for f in flags),
                        all(f[2] for f in flags),
                    )
                if hasattr(group[0], "_count"):
                    counts = tuple(p._count for p in group)
                    for p in group:
                        p._pack_counts = counts if len(set(counts)) > 1 else None
            else:
                if not _is_submix(group[0]):
                    _stamp_host_flags([p.sig for p in group])
                if len({getattr(p, "_use_strips", True) for p in group}) > 1:
                    # one read for the stack, whichever scene group a cell
                    # holds: the exact route, if any scene's block left the
                    # strip gate
                    for p in group:
                        p._use_strips = False

    def _merge_ingest(self, vals):
        """Per-voice ingest chunks end to end; a scene with no queued PCM
        this block ships zero rows (its zero-termination lands past its
        buffered data, where no read looks).  Where the drains wrote into
        the cell's persistent chunk (``_IngestChunks``) it is the merged
        chunk; elsewhere (voice shards) the chunks are concatenated."""
        with span("pack.merge_ingest"):
            tmpl = next(v for v in vals if v is not None)
            # the zero rows ship too: slots of the chunk that carry nothing
            count("ingest.slots", tmpl["chunk"].size * sum(v is None for v in vals))
            out = self._ingest.merge(vals)
            if out is not None:
                count("ingest.merged_inplace")
                return out
            count("ingest.merged_concat")
            zero = tree_map(np.zeros_like, tmpl)
            return tree_map(lambda *xs: np.concatenate(xs),
                            *[zero if v is None else v for v in vals])

    def _merge_pool(self, group, ps, shard):
        """One pool's params over a cell's scenes, by the layout the pool
        declares: scene-level params stacked, slot indices mapped to the
        cell's stacked rows, per-voice params cut to the cell's voice shard
        ``shard`` = (k, b) and concatenated, per-lane params concatenated,
        a submix's engine params merged as a scene's."""
        pool = group[0]
        V, (k, b) = pool.capacity, shard
        if not pool.is_dr:
            if not getattr(pool, "_use_strips", True):
                # the pack reads on the exact route (``_pack_flags``)
                ps = [p.exact_params(q) for p, q in zip(group, ps)]
            if not _is_submix(pool):
                if b > 1:
                    ps = [_shard_rows(q, pool.params_voice_axes(q), V, k, b) for q in ps]
                return _concat(ps)
            key = pool.INNER_PARAMS
            out = _concat([{j: v for j, v in q.items() if j != key} for q in ps])
            out[key] = self._merge_chain([p.sig for p in group], [q[key] for q in ps])
            return out
        S = len(group)
        if b > 1:
            ps = [_shard_rows(q, pool.params_voice_axes(q), V, k, b) for q in ps]
        index_keys = pool.params_index_keys()
        # a scene on the param-free cursor path did not ship its own
        cursors = [p.cursor_params() for p in group]
        keys = []
        for p in ps:
            keys.extend(j for j in p if j not in keys)
        out = {}
        for key in keys:
            vals = [p.get(key) for p in ps]
            if key in cursors[0]:
                out[key] = np.stack([c[key] for c in cursors])
            elif key == "ing":
                out[key] = self._merge_ingest(vals)
            elif any(v is None for v in vals):
                raise RuntimeError(
                    f"pool {pool.name}: {key!r} shipped by some scenes of the pack only")
            elif key in pool.SCENE_PARAMS:
                out[key] = np.stack(vals)
            elif key in index_keys:
                out[key] = np.concatenate(
                    [stack_index(v, s, V, S, k, b) for s, v in enumerate(vals)])
            else:
                out[key] = tree_map(lambda *xs: np.concatenate(xs), *vals)
        if getattr(pool, "_pack_counts", None) is not None:
            # the scenes advance different frame counts: each scene's ships
            out["pack_counts"] = np.asarray([p._count for p in group], np.int32)
        return out

    def _merge_chain(self, sigs, ps):
        """A submix chain's params over the scenes: its engine's merged as a
        scene's, each wrapper's own (one voice each) stacked."""
        if isinstance(sigs[0], Engine):
            return self._merge(sigs, ps)
        kids = [s.children() for s in sigs]
        return {k: self._merge_chain([c[k] for c in kids], [p[k] for p in ps])
                if k in kids[0] else tree_map(lambda *xs: np.stack(xs), *[p[k] for p in ps])
                for k in ps[0]}

    def _merge(self, engines, per_scene, shard=(0, 1)):
        """The engines' per-block params as one tree for a stacked render:
        of voice shard ``shard`` = (k, b) (a submix's engines are never
        split), whose cell holds a submix only where k is 0."""
        out = {}
        rots = [p.get("_rot_new") for p in per_scene]
        if any(r is not None for r in rots):
            if any(r is None for r in rots):
                raise RuntimeError("a listener rotation shipped by some scenes of the pack only")
            out["_rot_new"] = np.stack(rots)
        for group in self._groups(engines):
            if shard[0] and _is_submix(group[0]):
                continue
            name = group[0].name
            out[name] = self._merge_pool(group, [p[name] for p in per_scene], shard)
        return out

    def _block_params(self, n):
        """Prepare every scene for one block; returns the merged params of
        each cell, keyed (scene group, voice shard)."""
        with span("pack.coordinate"):
            self._check_structure()
            self._tier_floors(n)
            self._equalize()
            force = self._pack_force()
        with span("pack.prepare"):
            armed = self._ingest.arm(self)
            try:
                per_scene = [s.host_prepare(self.interval, n, force=force) for s in self.scenes]
            finally:
                for leaf in armed:
                    leaf._ing_out = None
        with span("pack.coordinate"):
            self._pack_flags()
            self._ensure_state()
        out = {}
        for g, k in self._cells:
            with span("pack.merge"):
                out[g, k] = self._merge(self._group(g), per_scene[g * self.Sa:(g + 1) * self.Sa],
                                        (k, self.B))
        self._ingest.close(out)
        return out

    def _render(self, params, n):
        """One block of every cell op by op; returns (S, C, n) on the
        mesh's first device.  Where a scene group has several voice
        shards, each cell keeps its pools' partial mixes apart
        (``voice_partials``; float64 where the pool sums in float64) for
        ``_join``."""
        scene0 = self.scenes[0]
        self.graph_counts["eager"] += 1
        outs = {}
        for (g, k), dev in self._cells.items():
            part = {} if self.B > 1 else None
            with scene_stack(self.Sa, g * self.Sa), mesh_cell((g, k), dev), \
                    voice_partials(part):
                self._dstate[g, k], block = scene0.render(
                    self._dstate[g, k], scene0.device_data(), params[g, k], n)
            outs[g, k] = block if part is None else {"mix": block, "parts": part}
        self._ingest.release([params])
        return self._join(outs)

    def _join(self, outs):
        """The cells' outputs, ``outs[g, k]`` (a cell's (..., S/a, C, n)
        mix, or in a voice-sharded cell ``{"mix", "parts"}`` with each
        pool's partial mix in render order), as the pack's (..., S, C, n)
        on the mesh's first device: each group's pools' shards summed on
        the group's first device in shard order (the JAX package's
        voice-axis ``psum``), rounded and added to shard 0's mix in render
        order, as one cell holding all the rows would.  The adds are
        elementwise, so a block and a run's (k, ...) outputs sum alike."""
        with span("pack.join"):
            blocks = []
            for g in range(self.A):
                if self.B == 1:
                    blocks.append(outs[g, 0])
                    continue
                parts = [outs[g, k]["parts"] for k in range(self.B)]
                out = outs[g, 0]["mix"]
                for name, x in parts[0].items():  # shard 0 holds every pool
                    for part in parts[1:]:
                        if name in part:
                            x = x + part[name].to(x.device)
                    out = out + x.to(torch.float32)
                blocks.append(out)
            if len(blocks) == 1:
                return blocks[0]
            return torch.cat([b.to(self.mesh.first) for b in blocks], dim=-3)

    def render_block(self, n):
        """Render one block for every scene; returns float32 numpy (S, n, C)."""
        with span("pack.call"):
            self._ingest.release()  # no block of an earlier call is pending
            params = self._block_params(n)
            if self._stepped():
                block = self._dispatch_steps(self.scenes[0].archetype(), "single",
                                             [params], n)[0]
            else:
                block = self._render(params, n)
            return np.moveaxis(block.cpu().numpy(), 1, 2)

    def _idle_bulk(self, n, remaining):
        """Advance every scene ``remaining`` idle blocks in O(1) where all
        pass the idle gate (device-resident pools only); returns whether
        they did."""
        if not all(getattr(s, "host_idle_bulk_ok", lambda iv, n: False)(self.interval, n)
                   for s in self.scenes):
            return False
        for s in self.scenes:
            s.host_idle_bulk(self.interval, n, remaining)
        return True

    def render_frames_device(self, total, block_size=512):
        """Offline pack render that keeps the audio on the device: returns a
        list of (B, S, C, n) tensors on the mesh's first device, without
        any host transfer or wait: one per run where the pack takes block
        steps (the JAX pack's runs), else one.  The run-length idle path
        of ``Renderer``: a block whose merged params are empty, on scenes
        whose pools all pass the idle gate (device-resident pools only),
        proves the remaining blocks the same, so the scenes advance them
        in O(1) (``host_idle_bulk``) and they render without preparing."""
        nblocks, rem = divmod(total, block_size)
        if rem:
            raise ValueError("total must be a multiple of block_size")
        with span("pack.call"):
            self._ingest.release()  # no block of an earlier call is pending
            if self._stepped():
                return self._run_frames(nblocks, block_size)
            return self._eager_frames(nblocks, block_size)

    def _eager_frames(self, nblocks, block_size):
        """``render_frames_device`` op by op."""
        blocks = []
        for bi in range(nblocks):
            params = self._block_params(block_size)
            blocks.append(self._render(params, block_size))
            remaining = nblocks - bi - 1
            if remaining and not tree_leaves(params) and self._idle_bulk(block_size, remaining):
                for _ in range(remaining):
                    blocks.append(self._render(params, block_size))
                break
        return [torch.stack(blocks)] if blocks else []

    def _run_frames(self, nblocks, n):
        """``render_frames_device`` through block steps: blocks of one
        archetype are prepared while it holds, and each run goes through
        the ``"scan"`` steps, flushed before any scene's structure event
        (its prepare applies state eagerly) and on an archetype change
        (after the next block's prepare: the run renders as of its own
        archetype) or a change of the merged params' layout (a stream
        write in a scene but scene 0, whose archetype does not show it:
        a run's rows share one layout)."""
        out, pend, pend_arch, pend_spec = [], [], None, None

        def flush():
            nonlocal pend, pend_arch
            run, arch = pend, pend_arch
            pend, pend_arch = [], None
            if run:
                out.append(self._dispatch_steps(arch, "scan", run, n))

        # a pool that grows (or plays eagerly) between two blocks of the
        # call pulls the stack back (``_unpack``): the run prepared so far
        # renders first, on the state it was prepared against
        self._flush = flush
        try:
            for bi in range(nblocks):
                if pend and any(s.host_structure_event() for s in self.scenes):
                    flush()
                params = self._block_params(n)  # every cell's
                arch = self.scenes[0].archetype()
                spec = [_pack_spec(p) for p in params.values()]
                if pend and (arch != pend_arch or spec != pend_spec):
                    flush()
                pend.append(params)
                pend_arch, pend_spec = arch, spec
                remaining = nblocks - bi - 1
                if remaining and not tree_leaves(params) and self._idle_bulk(n, remaining):
                    pend.extend([params] * remaining)
                    break
            flush()
        finally:
            self._flush = None
        return out

    # -- handle state ------------------------------------------------------------

    def _dr_states(self, engines, dstate):
        """(pool group, stacked state) of every device-resident pool in the
        stack, the submixes' included (a pool opened since the stack was
        built has none yet)."""
        for group in self._groups(engines):
            st = dstate.get(group[0].name)
            if st is None:
                continue
            if group[0].is_dr:
                yield group, st
            elif _is_submix(group[0]):
                key = group[0].INNER_STATE
                st = st if key is None else st[key]
                sig = group[0].sig
                while not isinstance(sig, Engine):  # the wrappers' subtrees
                    (k, sig), = sig.children().items()
                    st = st[k]
                yield from self._dr_states([_chain_engine(p.sig) for p in group], st)

    def _unstack_engines(self, engines, tree):
        """A stacked engine tree (``_stack``'s) as one tree of views per
        engine."""
        S = len(engines)
        subs = {g[0].name: g for g in self._groups(engines) if _is_submix(g[0])}
        parts = {}
        for k, v in tree.items():
            group = subs.get(k)
            if group is None:
                parts[k] = _unstack(v, S)
                continue
            key = group[0].INNER_STATE
            chain = self._unstack_chain([p.sig for p in group], v if key is None else v[key])
            if key is None:
                parts[k] = chain
            else:
                own = _unstack({j: x for j, x in v.items() if j != key}, S)
                parts[k] = [{**o, key: c} for o, c in zip(own, chain)]
        return [{k: parts[k][s] for k in tree} for s in range(S)]

    def _unstack_chain(self, sigs, tree):
        """A submix chain's stacked state as one tree per scene: its
        wrappers' own leaves along their scene axis, its engine's rows
        apart."""
        if isinstance(sigs[0], Engine):
            return self._unstack_engines(sigs, tree)
        kids = [s.children() for s in sigs]
        parts = {k: self._unstack_chain([c[k] for c in kids], v) if k in kids[0]
                 else _unstack(v, len(sigs), axis=True) for k, v in tree.items()}
        return [{k: parts[k][s] for k in tree} for s in range(len(sigs))]

    def _views_ok(self):
        """Whether each scene's rows lie in one cell on the scenes' own
        device, so that the scenes can hold views of the stack."""
        return self.B == 1 and all(same_device(d, self.device) for d in self._cells.values())

    def _store(self):
        """Point each scene's device state (its submixes' included) at its
        rows of the carried stack, so that writes in place land there;
        where a scene's rows lie in several cells or on another device,
        store a gathered copy instead (``_gather``)."""
        views = self._views_ok()
        with span("pack.join"):
            for g in range(self.A):
                eng = self._group(g)
                parts = [self._unstack_engines(eng, self._dstate[g, k]) for k in range(self.B)]
                for s, scene in enumerate(eng):
                    scene.device_store(parts[0][s] if views
                                       else self._gather(scene, [p[s] for p in parts]))

    def _gather(self, scene, parts):
        """One scene's device tree from its voice shards' trees, on the
        scenes' device: per-voice leaves end to end in shard order,
        scene-level leaves and a submix's subtree from shard 0."""
        home = self.device
        axes = scene.device_state_voice_axes(parts[0])

        def join(per_voice, *xs):
            xs = [x.to(home) for x in xs]
            return torch.cat(xs) if per_voice else xs[0]

        return {key: tree_map(join, axes[key], *[p[key] for p in parts if key in p])
                for key in parts[0]}

    def sync(self):
        """Push the carried state back into each scene (``_store``) and
        pull handle-visible state to the host: one readback per
        device-resident pool group per cell, each scene's columns
        reassembled from its shards, then each scene's slot reclamation."""
        if self._dstate is None:
            return
        self._store()
        cols = {}
        for (g, k), st in self._dstate.items():
            for group, pst in self._dr_states(self._group(g), st):
                mask, stopped = read_handle_state(pst["mask"], pst["stopped"])
                R = mask.shape[0] // len(group)  # the shard's rows of each scene
                for s, p in enumerate(group):
                    c = cols.setdefault(id(p), (p, np.zeros(p.capacity, bool),
                                                np.zeros(p.capacity, bool)))
                    c[1][k * R:(k + 1) * R] = mask[s * R:(s + 1) * R]
                    c[2][k * R:(k + 1) * R] = stopped[s * R:(s + 1) * R]
        for p, mask, stopped in cols.values():
            p._sync_apply(mask, stopped)

    def drop_stack(self):
        """Forget the carried stack WITHOUT writing it back (the scenes'
        own state was replaced, e.g. carried in from the JAX package or
        restored from a checkpoint); the next block stacks the scenes
        anew."""
        self._dstate = None
        for group in self._pool_groups():
            for p in group:
                if hasattr(p, "_dmax_floor"):
                    p._dmax_floor = 0.0

    def _unpack(self, drop=True):
        """Push the authoritative carried state back into the scenes and
        drop the stack; the next block restacks from the (now current)
        per-scene pools.  Fired by pool growth and eager plays, so that
        out-of-render changes never act on stale state.  With ``drop``
        False (a host pool's play, which resets its slot in place) the
        scenes only take views of the stack, which stays, where views can
        hold their rows (``_views_ok``); elsewhere the stack drops."""
        if self._dstate is None:
            return
        if self._flush is not None:
            self._flush()
        if not drop and self._views_ok():
            self._store()
            return
        self.sync()
        self.drop_stack()
