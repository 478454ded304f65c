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
its own row pair, K2 summing each scene apart, all with one launch per
pool per block whatever S is.

The host control plane stays per scene: each scene keeps its handles and
numpy state and prepares its own parameters; per block the pack merges
them (per-voice arrays and delta lanes end to end, slot indices mapped to
stacked rows, scene-level scalars stacked) and renders the stack once,
with scene 0's pools and archetype.  The stacked state is built once and
carried; pool growth and eager plays pull it back into the scenes first
(the pools' ``_unpack_hook``), and the next block restacks.

Only device-resident pools pack on one card (``make_mesh(1, 1)``).  Host
and singleton (submix) pools raise ``NotImplementedError`` (ROADMAP PK1);
larger meshes are the multi-card form (PK2); Gain, Fader and Frames
voices have no module in this package yet (PK3).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.drctrl import read_handle_state
from ..core.signal import same_device
from ..ops.geometry import HEAD_RADIUS, SPEED_OF_SOUND
from ..utils.tree import tree_leaves, tree_map
from .context import scene_stack, stack_index
from .mesh import SCENE_AXIS, VOICE_AXIS

__all__ = ["ScenePack"]


def _unstack(tree, S):
    """A concatenated state tree as S per-scene trees of views."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, S) for k, v in tree.items()}
        return [{k: parts[k][s] for k in tree} for s in range(S)]
    return list(tree.split(tree.shape[0] // S))


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
        self._ddata = None
        self._names = None
        self._check_structure()

    # -- structure ---------------------------------------------------------------

    def _groups(self):
        """Pool i of every scene, for each pool index i."""
        return list(zip(*[s._all_pools() for s in self.scenes]))

    def _check_structure(self):
        """Adopt the scenes' pools again when a play opened a new one (its
        state joins the stack at the next restack): refuse what a one-card
        pack leaves out, and hook every pool."""
        names = tuple(tuple(p.name for p in s._all_pools()) for s in self.scenes)
        if names == self._names:
            return
        if len(set(names)) != 1:
            raise ValueError(f"the pack's scenes hold different pools: {sorted(set(names))}")
        for s in self.scenes:
            for p in s._all_pools():
                if not p.is_dr:
                    kind = "singleton (submix)" if getattr(p, "is_singleton", False) else "host"
                    raise NotImplementedError(
                        f"{type(p).__name__} {p.name} is a {kind} pool: a ScenePack packs "
                        "device-resident pools only (host and singleton pools in packs: "
                        "ROADMAP PK1)"
                    )
                if p.fade_paths:
                    # a pack maps the slot lanes of plays, stops and controls
                    # onto its stacked rows, not yet those of fades
                    raise NotImplementedError(
                        f"{type(p).__name__} {p.name} holds Fader voices: fades in packs "
                        "are ROADMAP PK3"
                    )
        self._unpack()
        for s in self.scenes:
            for p in s._all_pools():
                p._unpack_hook = self._unpack
        self._names = names

    def _equalize(self):
        """One capacity per pool across the pack: the stacked rows of scene
        s start at s*V.  Grows the smaller pools (which pulls any carried
        state back first)."""
        for group in self._groups():
            cap = max(p.capacity for p in group)
            for p in group:
                while p.capacity < cap:
                    p.grow()

    def _ensure_state(self):
        """Stack the scenes' device state, unless the carried stack is
        current (it is dropped by growth and eager plays)."""
        if self._dstate is not None:
            return
        trees = [s.device_collect() for s in self.scenes]
        self._dstate = tree_map(lambda *xs: torch.cat(xs), *trees)
        self._ddata = self.scenes[0].device_data()

    # -- per block ---------------------------------------------------------------

    def _tier_floors(self, n):
        """One render draws every scene's buffered pool, so the pools of a
        group must agree on the motion-adaptive read tier: give each the
        max PRE-drain walk bound over the pack (each pool's post-drain bound
        is <= its tier_bound, so every scene resolves the same tier)."""
        rot_any = any(getattr(s, "_rot_pending", None) is not None for s in self.scenes)
        for grp in self._groups():
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
        pack blocks ship no delta arrays.  Stream ingest stays per scene
        (a scene without queued PCM ships zero rows)."""
        return any(s.host_wants_deltas() for s in self.scenes)

    def _pack_flags(self):
        """Scene 0's pools render the pack, so their read-path flags must
        hold for every scene: where the scenes differ, stamp the pack-wide
        ones (every step fits the stream kernel, the widest step tier,
        every tau fits the closed-form AGC) onto scene 0's pool."""
        for group in self._groups():
            flags = {(p._ds_small, p._ds_tier, p._ema_fast) for p in group}
            if len(flags) > 1:
                group[0]._stamp_flags(
                    all(f[0] for f in flags), max(f[1] for f in flags),
                    all(f[2] for f in flags),
                )

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
        per-lane params concatenated."""
        pool = group[0]
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

    def _merge(self, per_scene):
        """The scenes' per-block params as one tree for the stacked render."""
        out = {}
        rots = [p.get("_rot_new") for p in per_scene]
        if any(r is not None for r in rots):
            if any(r is None for r in rots):
                raise RuntimeError("a listener rotation shipped by some scenes of the pack only")
            out["_rot_new"] = np.stack(rots)
        for group in self._groups():
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
        return self._merge(per_scene)

    def _render(self, params, n):
        """One stacked block: (S, C, n) on the device."""
        with scene_stack(self.S):
            self._dstate, block = self.scenes[0].render(self._dstate, self._ddata, params, n)
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
        gate, proves the remaining blocks the same, so the scenes advance
        them in O(1) (``host_idle_bulk``) and they render without
        preparing."""
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

    def sync(self):
        """Push the carried state back into each scene (views of the stack)
        and pull handle-visible state to the host: one readback per pool
        group, then each scene's slot reclamation."""
        if self._dstate is None:
            return
        for scene, tree in zip(self.scenes, _unstack(self._dstate, self.S)):
            scene.device_store(tree)
        for group in self._groups():
            st = self._dstate.get(group[0].name)
            if st is None:  # a pool opened since the stack was built
                continue
            mask, stopped = read_handle_state(st["mask"], st["stopped"])
            V = group[0].capacity
            for s, p in enumerate(group):
                p._sync_apply(mask[s * V:(s + 1) * V], stopped[s * V:(s + 1) * V])

    def drop_stack(self):
        """Forget the carried stack WITHOUT writing it back (the scenes'
        own state was replaced, e.g. carried in from the JAX package); the
        next block stacks the scenes anew."""
        self._dstate = None
        for s in self.scenes:
            for p in s._all_pools():
                if hasattr(p, "_dmax_floor"):
                    p._dmax_floor = 0.0

    def _unpack(self):
        """Push the authoritative carried state back into the scenes and
        drop the stack; the next block restacks from the (now current)
        per-scene pools.  Fired by pool growth and eager plays, so that
        out-of-render changes never act on stale state."""
        if self._dstate is None:
            return
        self.sync()
        self.drop_stack()
