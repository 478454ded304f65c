"""ScenePack: S scenes of one archetype rendered as one, on one card
(counterpart of oddio_tpu/parallel/sharded.py).

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

Every pool kind packs.  Device-resident pools ship deltas whose slot
indices (plays, stops, controls, fade lanes) map to stacked rows.  Host
pools (the buffered pool's K4/K5 pair, the seek pool, the Mixer's host
pool) ship per-voice params, concatenated; a Stream's write chunk that
some scenes lack ships as zero rows.  A singleton (submix) pool is S rows,
one voice per scene: its engine's state is the S inner engines' trees
stacked as the scenes' are, its params the inner engines' params merged
by the same rules, recursively, and the inner engine renders them under
the same ``scene_stack(S)`` to (S, C, n).

The host control plane stays per scene: each scene keeps its handles and
numpy state and prepares its own parameters; per block the pack merges
them and renders the stack once, with scene 0's pools and archetype.
Where the scenes' per-block choices differ, the pack takes one for the
whole stack: the widest read tier and step flags, and the host buffered
pool's exact elementwise read when any scene leaves its strip gate.  The
stacked state is built once and carried; pool growth and eager plays pull
it back into the scenes first (the pools' ``_unpack_hook``) and the next
block restacks; a host pool's play writes its slot through views of the
stack.

A submix under wrappers (an Adapt over a Mixer) stacks its wrappers'
one-voice state along a new scene axis: the wrappers render their S rows
batched, and the engine under them its scenes stacked.  A pack renders
on one card (``make_mesh(1, 1)``); larger meshes are the multi-card form
(ROADMAP PK2).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.drctrl import read_handle_state
from ..core.signal import Engine, same_device
from ..ops.geometry import HEAD_RADIUS, SPEED_OF_SOUND
from ..utils.tree import tree_leaves, tree_map
from .context import scene_stack, stack_index
from .mesh import SCENE_AXIS, VOICE_AXIS

__all__ = ["ScenePack"]


def _unstack(tree, S, axis=False):
    """A concatenated state tree as S per-scene trees of views (with
    ``axis``, a tree stacked along a new leading scene axis)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, S, axis) for k, v in tree.items()}
        return [{k: parts[k][s] for k in tree} for s in range(S)]
    return list(tree.unbind(0) if axis else tree.split(tree.shape[0] // S))


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


class ScenePack:
    """Renders S structurally identical scenes (Mixers, or SpatialScenes)
    as one stacked render on one card.

    ``scenes``: engines of equal archetype, built on one device (each
    engine's own; the CUDA card unless built with ``device=``); ``mesh``:
    ``make_mesh(1, 1)``.  ``scan_unroll`` is accepted and ignored, as
    ``Renderer`` ignores it (it shapes the JAX package's compiled scan)."""

    def __init__(self, scenes, rate, mesh, scan_unroll=1):
        scenes = list(scenes)
        if not scenes:
            raise ValueError("a pack needs at least one scene")
        if len({s.archetype() for s in scenes}) != 1:
            raise ValueError("all scenes in a pack must share an archetype")
        if (mesh.shape[SCENE_AXIS], mesh.shape[VOICE_AXIS]) != (1, 1):
            raise ValueError(f"{mesh}: packs render on one card (make_mesh(1, 1)); ROADMAP PK2")
        self.device = scenes[0].device
        for s in scenes:
            if not same_device(s.device, self.device):
                raise ValueError(f"a pack's scenes render on one device: {s.device} vs {self.device}")
        if mesh.devices is not None and not same_device(mesh.devices[0], self.device):
            raise ValueError(f"the scenes render on {self.device}, the mesh is {mesh.devices[0]}")
        self.scenes = scenes
        self.S = len(scenes)
        self.mesh = mesh
        self.scan_unroll = int(scan_unroll)
        self.rate = int(rate)
        self.interval = np.float32(1.0) / np.float32(self.rate)
        self._dstate = None  # the stacked state, scene 0's tree layout
        self._names = None
        self._check_structure()

    # -- structure ---------------------------------------------------------------

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
        """Stack the scenes' device state, unless the carried stack is
        current (it is dropped by growth and eager plays)."""
        if self._dstate is not None:
            return
        self._dstate = self._stack(self.scenes, [s.device_collect() for s in self.scenes])

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
        host pool's template; a device-resident Mixer pool whose scenes
        advance different frame counts (a submix's, at its ring's write
        count) takes them per scene."""
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
                    group[0]._pack_counts = counts if len(set(counts)) > 1 else None
            elif not _is_submix(group[0]):
                _stamp_host_flags([p.sig for p in group])

    def _merge_ingest(self, vals):
        """Per-voice ingest chunks end to end; a scene with no queued PCM
        this block ships zero rows (its zero-termination lands past its
        buffered data, where no read looks)."""
        tmpl = next(v for v in vals if v is not None)
        zero = tree_map(np.zeros_like, tmpl)
        return tree_map(lambda *xs: np.concatenate(xs),
                        *[zero if v is None else v for v in vals])

    def _merge_pool(self, group, ps):
        """One pool's params over the pack, by the layout the pool declares:
        scene-level params stacked, slot indices mapped to stacked rows,
        per-lane and per-voice params concatenated, a submix's engine
        params merged as a scene's."""
        pool = group[0]
        if not pool.is_dr:
            if len({getattr(p, "_use_strips", True) for p in group}) > 1:
                # one read for the stack: the exact route, if any scene's
                # block left the strip gate
                ps = [p.exact_params(q) for p, q in zip(group, ps)]
                pool._use_strips = False
            if not _is_submix(pool):
                return _concat(ps)
            key = pool.INNER_PARAMS
            out = _concat([{k: v for k, v in q.items() if k != key} for q in ps])
            out[key] = self._merge_chain([p.sig for p in group], [q[key] for q in ps])
            return out
        V, S = pool.capacity, self.S
        index_keys = pool.params_index_keys()
        # a scene on the param-free cursor path did not ship its own
        cursors = [p.cursor_params() for p in group]
        keys = []
        for p in ps:
            keys.extend(k for k in p if k not in keys)
        out = {}
        for k in keys:
            vals = [p.get(k) for p in ps]
            if k in cursors[0]:
                out[k] = np.stack([c[k] for c in cursors])
            elif k == "ing":
                out[k] = self._merge_ingest(vals)
            elif any(v is None for v in vals):
                raise RuntimeError(
                    f"pool {pool.name}: {k!r} shipped by some scenes of the pack only")
            elif k in pool.SCENE_PARAMS:
                out[k] = np.stack(vals)
            elif k in index_keys:
                out[k] = np.concatenate(
                    [stack_index(v, s, V, S) for s, v in enumerate(vals)])
            else:
                out[k] = tree_map(lambda *xs: np.concatenate(xs), *vals)
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

    def _merge(self, engines, per_scene):
        """The engines' per-block params as one tree for the stacked
        render."""
        out = {}
        rots = [p.get("_rot_new") for p in per_scene]
        if any(r is not None for r in rots):
            if any(r is None for r in rots):
                raise RuntimeError("a listener rotation shipped by some scenes of the pack only")
            out["_rot_new"] = np.stack(rots)
        for group in self._groups(engines):
            name = group[0].name
            out[name] = self._merge_pool(group, [p[name] for p in per_scene])
        return out

    def _block_params(self, n):
        """Prepare every scene for one block; returns the merged params."""
        self._check_structure()
        self._tier_floors(n)
        self._equalize()
        force = self._pack_force()
        per_scene = [s.host_prepare(self.interval, n, force=force) for s in self.scenes]
        self._pack_flags()
        self._ensure_state()
        return self._merge(self.scenes, per_scene)

    def _render(self, params, n):
        """One stacked block: (S, C, n) on the device."""
        with scene_stack(self.S):
            self._dstate, block = self.scenes[0].render(
                self._dstate, self.scenes[0].device_data(), params, n)
        return block

    def render_block(self, n):
        """Render one block for every scene; returns float32 numpy (S, n, C)."""
        block = self._render(self._block_params(n), n)
        return np.moveaxis(block.cpu().numpy(), 1, 2)

    def render_frames_device(self, total, block_size=512):
        """Offline pack render that keeps the audio on the device: returns a
        list of (B, S, C, n) tensors (here one), without any host transfer
        or wait.  The run-length idle path of ``Renderer``: a block whose
        merged params are empty, on scenes whose pools all pass the idle
        gate (device-resident pools only), proves the remaining blocks the
        same, so the scenes advance them in O(1) (``host_idle_bulk``) and
        they render without preparing."""
        nblocks, rem = divmod(total, block_size)
        if rem:
            raise ValueError("total must be a multiple of block_size")
        blocks = []
        for bi in range(nblocks):
            params = self._block_params(block_size)
            blocks.append(self._render(params, block_size))
            remaining = nblocks - bi - 1
            if remaining and not tree_leaves(params) and all(
                getattr(s, "host_idle_bulk_ok", lambda iv, n: False)(self.interval, block_size)
                for s in self.scenes
            ):
                for s in self.scenes:
                    s.host_idle_bulk(self.interval, block_size, remaining)
                for _ in range(remaining):
                    blocks.append(self._render(params, block_size))
                break
        return [torch.stack(blocks)] if blocks else []

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

    def _store_views(self):
        """Point each scene's device state (its submixes' included) at its
        rows of the carried stack, so that writes in place land there."""
        for scene, tree in zip(self.scenes, self._unstack_engines(self.scenes, self._dstate)):
            scene.device_store(tree)

    def sync(self):
        """Push the carried state back into each scene (views of the stack)
        and pull handle-visible state to the host: one readback per
        device-resident pool group, then each scene's slot reclamation."""
        if self._dstate is None:
            return
        self._store_views()
        for group, st in self._dr_states(self.scenes, self._dstate):
            mask, stopped = read_handle_state(st["mask"], st["stopped"])
            V = group[0].capacity
            for s, p in enumerate(group):
                p._sync_apply(mask[s * V:(s + 1) * V], stopped[s * V:(s + 1) * V])

    def drop_stack(self):
        """Forget the carried stack WITHOUT writing it back (the scenes'
        own state was replaced, e.g. carried in from the JAX package); the
        next block stacks the scenes anew."""
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
        scenes only take views of the stack, which stays."""
        if self._dstate is None:
            return
        if not drop:
            self._store_views()
            return
        self.sync()
        self.drop_stack()
