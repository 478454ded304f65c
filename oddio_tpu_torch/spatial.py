"""3D spatial audio scene (counterpart of oddio_tpu/spatial.py).

Reference: oddio's src/spatial.rs — ``SpatialScene`` spatializes
mono signals into stereo with panning, distance attenuation, doppler and
propagation delay.  Two voice families, each in a device-resident pool:

* ``play`` (spatial.rs:289-302): seekable sources re-sampled per ear at
  time-shifted, rate-warped positions (doppler by time warp) — the seek
  pool, pure elementwise tensor math.
* ``play_buffered`` (spatial.rs:314-340): sources pre-rendered into a
  per-voice delay ring and read back at fractional, time-varying offsets —
  the buffered pool, on the ring kernels of ``ops/ring_kernels.py``.

The host keeps the JAX package's exact bookkeeping (shared ring cursor,
walk-bound mirrors, read-tier ladder, family sub-pass plan) in numpy; the
device state is a dict of tensors under the JAX package's keys, on the
scene's ``device``.  Per-block parameters stay numpy on the host and are
uploaded where a render uses them; padding lanes of the delta arrays are
filtered on the host.  The ring is updated in place.

Host pools (``_VoicePool``, ``_BufferedPool``, ``_BufferedPoolSingleton``,
``_SeekPool``) are ROADMAP P2.4: a spec that would need one raises
``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.drctrl import DRCtrlMixin, _upload, host_lanes, rows_scatter
from .core.hostmath import f32, quat_invert, v3_norm
from .core.signal import Signal
from .ops._dev import device_advance, device_split_ds, exact_positions
from .ops.geometry import (  # noqa: F401  (re-exported API surface)
    EAR_DIR,
    EAR_POS,
    HEAD_RADIUS,
    POSITION_SMOOTHING_PERIOD,
    SPEED_OF_SOUND,
    ear_states_c,
    quat_rotate_c,
    smoothed_position,
    smoothed_position_c,
    unstack3,
    v3_norm_c,
)
from .ops.ring_kernels import (
    PAGE,
    rows_append,
    select_window,
    window_select_ears,
    window_select_multi,
)
from .parallel.context import localize_index
from .utils.tree import tree_map, tree_stack

__all__ = [
    "SpatialScene",
    "SpatialSceneControl",
    "Spatial",
    "SpatialOptions",
    "SPEED_OF_SOUND",
    "HEAD_RADIUS",
]

DEFAULT_CAPACITY = 16

#: bounds the per-block doppler walk handled by the select kernel
K_DOPPLER = 64

_F32 = torch.float32
_I32 = torch.int32


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _smooth_host(prev, smdt, dt_extra, mpos, mvel):
    """Host twin of ops.geometry.smoothed_position (spatial.rs:501-511):
    same f32 term order, batched (V, 3) numpy.  Drives the per-block read
    walk bound without any device sync."""
    dt = (smdt + np.float32(dt_extra)).astype(np.float32)
    change = (mvel * dt[:, None]).astype(np.float32)
    naive = (prev + change).astype(np.float32)
    intended = (mpos + change).astype(np.float32)
    r = np.minimum(dt / POSITION_SMOOTHING_PERIOD, np.float32(1.0))[:, None]
    return ((np.float32(1.0) - r) * naive + r * intended).astype(np.float32)


class SpatialOptions:
    """Passed to play/play_buffered (spatial.rs:352-371)."""

    def __init__(self, position=(0.0, 0.0, 0.0), velocity=(0.0, 0.0, 0.0), radius=0.1):
        self.position = f32(position)
        self.velocity = f32(velocity)
        self.radius = np.float32(radius)


class _DRPoolBase(DRCtrlMixin):
    """Shared device-resident control plane for spatial voice pools.

    All per-voice control state — motion, smoothing, lingering, masks and
    the inner sources' playback state — lives on the device; every block
    the geometry (spatial.rs:204-261, 530-550) runs there.  The host ships
    only sparse control deltas (plays, set_motion) with bounded-capacity
    backpressure (overflow carries to the next block).  Handle state
    (is_finished) is observed at sync points.
    """

    is_dr = True

    #: per-voice geometry/lifecycle columns common to every DR pool kind
    GEOM_KEYS = (
        "mask", "stopped", "finished_for", "radius", "motion_pos",
        "motion_vel", "prev_position", "smdt",
    )
    #: state keys carried in play rows (subclasses extend)
    ROW_KEYS = GEOM_KEYS

    def _init_base(self, name, spec, capacity, k_motion, k_play, device):
        self.name = name
        self.proto = spec
        self.device = torch.device(device)
        self.capacity = capacity
        self.k_motion = k_motion
        self.k_play = k_play
        self._elapsed = 0.0
        self.slot_gen = np.zeros(capacity, dtype=np.int64)
        self._free = list(range(capacity - 1, -1, -1))
        self.mask_host = np.zeros(capacity, dtype=bool)
        self.stopped_host = np.zeros(capacity, dtype=bool)
        self.pending_plays = []  # (slot, row tree)
        self.pending_motion = {}  # slot -> (pos, vel, disc); last-wins
        self.state = None
        # exact host mirrors of the device walk's geometry inputs (same f32
        # math, updated at play and at motion-delta ship time): the
        # per-block read-walk bound derives from these, without device sync
        self._g_prev = np.zeros((capacity, 3), np.float32)
        self._g_mpos = np.zeros((capacity, 3), np.float32)
        self._g_mvel = np.zeros((capacity, 3), np.float32)
        self._g_smdt = np.zeros(capacity, np.float32)
        #: cached walk-bound verdict + validity horizons (see _block_b)
        self._b_cache = None
        self._t_scene = 0.0
        self._init_ctrl(spec)

    # -- state ---------------------------------------------------------------

    def _geom_zero(self, V):
        dev = self.device
        return {
            "mask": torch.zeros(V, dtype=torch.bool, device=dev),
            "stopped": torch.zeros(V, dtype=torch.bool, device=dev),
            "finished_for": torch.full((V,), float("nan"), dtype=_F32, device=dev),
            "radius": torch.full((V,), 0.1, dtype=_F32, device=dev),
            "motion_pos": torch.zeros((V, 3), dtype=_F32, device=dev),
            "motion_vel": torch.zeros((V, 3), dtype=_F32, device=dev),
            "prev_position": torch.zeros((V, 3), dtype=_F32, device=dev),
            "smdt": torch.zeros(V, dtype=_F32, device=dev),
        }

    def _extra_zero(self, V):
        """Subclass state leaves beyond geometry + inner."""
        return {}

    def _fresh_state(self, V):
        st = self._geom_zero(V)
        st.update(self._extra_zero(V))
        st["inner"] = tree_map(
            lambda x: _upload(x, self.device), self.proto.dr_state_init(V)
        )
        return st

    def dr_state(self):
        if self.state is None:
            self.state = self._fresh_state(self.capacity)
        return self.state

    def _concat_state(self, st, fresh):
        return tree_map(lambda a, b: torch.cat([a, b]), st, fresh)

    def grow(self):
        """set-realloc analogue (set.rs:57-63): double capacity."""
        old = self.capacity
        new = old * 2
        self.dr_state()
        fresh = self._fresh_state(old)
        self.state = self._concat_state(self.state, fresh)
        self.slot_gen = np.concatenate([self.slot_gen, np.zeros(old, np.int64)])
        self.mask_host = np.concatenate([self.mask_host, np.zeros(old, bool)])
        self.stopped_host = np.concatenate([self.stopped_host, np.zeros(old, bool)])
        self._free = list(range(new - 1, old - 1, -1)) + self._free
        self._g_prev = np.concatenate([self._g_prev, np.zeros((old, 3), np.float32)])
        self._g_mpos = np.concatenate([self._g_mpos, np.zeros((old, 3), np.float32)])
        self._g_mvel = np.concatenate([self._g_mvel, np.zeros((old, 3), np.float32)])
        self._g_smdt = np.concatenate([self._g_smdt, np.zeros(old, np.float32)])
        self._b_cache = None
        self.capacity = new

    # -- control side ----------------------------------------------------------

    def _claim_slot(self, spec):
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
        return i, gen

    def _geom_row(self, options):
        return {
            "mask": True,
            "stopped": False,
            "finished_for": np.float32(np.nan),
            "radius": np.float32(options.radius),
            "motion_pos": f32(options.position),
            "motion_vel": f32(options.velocity),
            "prev_position": f32(options.position),
            "smdt": np.float32(0.0),
        }

    def _default_row(self):
        """Benign padding row for unfilled play-delta lanes."""
        return {
            "mask": False,
            "stopped": True,
            "finished_for": np.float32(np.nan),
            "radius": np.float32(0.1),
            "motion_pos": np.zeros(3, np.float32),
            "motion_vel": np.zeros(3, np.float32),
            "prev_position": np.zeros(3, np.float32),
            "smdt": np.float32(0),
            "inner": self.proto.dr_default_row(
                getattr(self, "interval_inner", 0.0)
            ),
        }

    def _queue_play(self, i, row):
        self.pending_plays.append((i, row))
        self.mask_host[i] = True
        self.stopped_host[i] = False
        self._g_prev[i] = row["prev_position"]
        self._g_mpos[i] = row["motion_pos"]
        self._g_mvel[i] = row["motion_vel"]
        self._g_smdt[i] = row["smdt"]
        self._b_cache = None

    def push_motion(self, slot, gen, pos, vel, disc):
        if self.slot_gen[slot] == gen:
            self.pending_motion[slot] = (f32(pos), f32(vel), bool(disc))

    def handle_finished(self, slot, gen):
        self._maybe_sync()
        if self.slot_gen[slot] != gen:
            return True
        return bool(self.stopped_host[slot])

    def _maybe_sync(self):
        """Refresh handle-visible state at most once per rendered block."""
        if getattr(self, "_sync_seen", -1) != getattr(self, "_prep_count", 0):
            self.sync()
            self._sync_seen = getattr(self, "_prep_count", 0)

    def _clear_rows(self, S, idx):
        """Reset layout-sensitive per-slot state (delay rings) for the
        slots in the filtered index tensor ``idx``."""

    def _scatter_rows(self, S, idx, rows):
        """Write play rows (numpy, one per real lane) at slots ``idx``."""
        it = _upload(idx, self.device)
        for k in self.ROW_KEYS:
            S[k][it] = _upload(rows[k], self.device, S[k].dtype)
        S["inner"] = rows_scatter(S["inner"], rows["inner"], it)
        self._clear_rows(S, it)

    def _apply_plays_eager(self):
        """Apply all pending plays directly to device state (the bulk-setup
        path, outside the per-block step)."""
        self.dr_state()
        idx = np.array([i for i, _ in self.pending_plays], np.int64)
        rows = tree_stack([r for _, r in self.pending_plays])
        self.pending_plays = []
        S = dict(self.state)
        self._scatter_rows(S, idx, rows)
        self.state = S

    def sync_prefetch(self):
        """Start the (asynchronous on CUDA) device->host copy of the packed
        handle-visible state so a following sync() need not stall."""
        self._sync_start()

    def sync(self):
        """Pull mask/stopped back from the device; reclaim freed slots."""
        if self.state is None:
            return
        mask, stopped = self._sync_read()
        pending = {i for i, _ in self.pending_plays}
        for i in range(self.capacity):
            if i in pending:
                continue
            if self.mask_host[i] and stopped[i] and not mask[i]:
                self.mask_host[i] = False
                self.stopped_host[i] = True
                self.slot_gen[i] += 1
                self._free.append(i)
                self._b_cache = None  # the live set shrank; re-bound

    # -- per block ---------------------------------------------------------------

    def _delta_params(self, params, force=False):
        """Pack queued control events into bounded per-block delta arrays.
        Bulk plays (beyond k_play) apply eagerly; blocks without control
        events ship no delta arrays at all unless forced."""
        self._prep_count = getattr(self, "_prep_count", 0) + 1
        if len(self.pending_plays) > self.k_play:
            self._apply_plays_eager()
        has = (
            bool(self.pending_plays) or bool(self.pending_motion)
            or self._ctrl_pending_any() or force
        )
        self._has_play = self._has_mot = has
        if has:
            self._ctrl_delta_params(params)
        if self._has_play:
            Kp = self.k_play
            take = self.pending_plays[:Kp]
            self.pending_plays = self.pending_plays[Kp:]
            play_idx = np.full(Kp, self.capacity, np.int32)
            rows = [r for _, r in take]
            if len(rows) < Kp:
                rows = rows + [self._default_row()] * (Kp - len(rows))
            for j, (i, _) in enumerate(take):
                play_idx[j] = i
            params["play_idx"] = play_idx
            params["play"] = tree_stack(rows)

        # motion deltas (last-wins per slot; overflow carries to the next
        # block — bounded-channel semantics like a full swap/spsc pair)
        if self._has_mot:
            Km = self.k_motion
            items = list(self.pending_motion.items())[:Km]
            for k, _ in items:
                del self.pending_motion[k]
            mot_idx = np.full(Km, self.capacity, np.int32)
            mot_pos = np.zeros((Km, 3), np.float32)
            mot_vel = np.zeros((Km, 3), np.float32)
            mot_disc = np.zeros(Km, bool)
            for j, (slot, (p, v, d)) in enumerate(items):
                mot_idx[j] = slot
                mot_pos[j] = p
                mot_vel[j] = v
                mot_disc[j] = d
                # mirror the device's motion-refresh math (walk step 2)
                sm = _smooth_host(
                    self._g_prev[slot : slot + 1],
                    self._g_smdt[slot : slot + 1],
                    0.0,
                    self._g_mpos[slot : slot + 1],
                    self._g_mvel[slot : slot + 1],
                )[0]
                self._g_prev[slot] = p if d else sm
                self._g_smdt[slot] = 0.0
                self._g_mpos[slot] = p
                self._g_mvel[slot] = v
                self._b_cache = None
            params["mot_idx"] = mot_idx
            params["mot_pos"] = mot_pos
            params["mot_vel"] = mot_vel
            params["mot_disc"] = mot_disc
        return params

    def _walk_device(self, S, params, elapsed):
        """Device control walk: apply play/motion deltas, smooth + rotate
        positions, lingering reclamation (spatial.rs:204-261).  Returns
        (S, mask, prev_pos, next_pos), positions as (V,) component tuples."""
        V = S["mask"].shape[0]
        dev = self.device

        # 1. plays (set.rs insert semantics: applied before the walk)
        if "play_idx" in params:
            keep, idx = host_lanes(localize_index(params["play_idx"], V), V)
            if idx.size:
                rows = tree_map(lambda x: x[keep], params["play"])
                self._scatter_rows(S, idx, rows)

        # 1b. control-field deltas (set_gain/set_speed/..., gain.rs:103-108)
        S["inner"] = self._ctrl_apply(S["inner"], params)

        # 2. motion refresh (swap-channel drain + smoothing, spatial.rs:216-227);
        # a block whose lanes are all padding leaves every column as it was
        if "mot_idx" in params:
            keep, idx = host_lanes(localize_index(params["mot_idx"], V), V)
            if idx.size:
                it = _upload(idx, dev)
                upd = torch.zeros(V, dtype=torch.bool, device=dev)
                upd[it] = True
                pend_pos = S["motion_pos"].clone()
                pend_pos[it] = _upload(params["mot_pos"][keep], dev)
                pend_vel = S["motion_vel"].clone()
                pend_vel[it] = _upload(params["mot_vel"][keep], dev)
                pend_disc = torch.zeros(V, dtype=torch.bool, device=dev)
                pend_disc[it] = _upload(params["mot_disc"][keep], dev)
                sm_orig = smoothed_position(
                    S["prev_position"], S["smdt"], 0.0, S["motion_pos"],
                    S["motion_vel"],
                )
                new_prev = torch.where(pend_disc[:, None], pend_pos, sm_orig)
                S["prev_position"] = torch.where(
                    upd[:, None], new_prev, S["prev_position"]
                )
                S["smdt"] = torch.where(upd, 0.0, S["smdt"])
                S["motion_pos"] = torch.where(upd[:, None], pend_pos, S["motion_pos"])
                S["motion_vel"] = torch.where(upd[:, None], pend_vel, S["motion_vel"])

        # 3. geometry (spatial.rs:228-238), component-split
        prev3 = unstack3(S["prev_position"])
        mp3 = unstack3(S["motion_pos"])
        mv3 = unstack3(S["motion_vel"])
        sm0 = smoothed_position_c(prev3, S["smdt"], 0.0, mp3, mv3)
        sm1 = smoothed_position_c(prev3, S["smdt"], elapsed, mp3, mv3)
        prev_pos = quat_rotate_c(params["rot_prev"], sm0)
        next_pos = quat_rotate_c(params["rot"], sm1)
        ef = float(np.float32(elapsed))
        S["smdt"] = S["smdt"] + ef

        # 4. lingering reclamation (spatial.rs:241-261)
        dist = v3_norm_c(prev_pos)
        inner_fin = self.proto.dr_is_finished(S["inner"])
        ff = S["finished_for"]
        lingering = ~torch.isnan(ff)
        expire = lingering & (ff > dist / float(SPEED_OF_SOUND))
        S["stopped"] = S["stopped"] | (expire & S["mask"])
        ff = torch.where(lingering & ~expire, ff + ef, ff)
        newly = S["mask"] & ~lingering & inner_fin
        S["finished_for"] = torch.where(newly, ef, ff)
        S["mask"] = S["mask"] & ~S["stopped"]
        return S, S["mask"], prev_pos, next_pos

    def render_multi(self, dstate, ddata, params, n, nb):
        """Default fused idle group: loop the per-block render.  Returns
        ``(S, (C, nb*n))``."""
        S = dstate
        outs = []
        for _ in range(nb):
            S, block = self.render(S, ddata, params, n)
            outs.append(block)
        return S, torch.cat(outs, dim=-1)


class _SeekPoolDR(_DRPoolBase):
    """Device-resident seek-path pool: doppler by time warp
    (spatial.rs:438-470).  With a positionally-evaluable source chain
    (``dr_warp_render``) a whole block is elementwise math over (voice,
    ear, frame): geometry, two warped source evaluations, gain ramps and
    one masked voice sum — no delay ring and no hand kernel."""

    ROW_KEYS = _DRPoolBase.GEOM_KEYS

    def __init__(self, name, spec, capacity, k_motion=64, k_play=8, device="cpu"):
        self._init_base(name, spec, capacity, k_motion, k_play, device)

    def play(self, spec, options):
        i, gen = self._claim_slot(spec)
        row = self._geom_row(options)
        # seek-path sources are sampled at per-block warped intervals; the
        # slot row encodes only position state (interval-free)
        row["inner"] = spec.dr_slot_row(0.0)
        self._queue_play(i, row)
        return i, gen

    def host_prepare(self, prev_rot, rot, interval, n, force=False):
        self._elapsed = float(np.float32(f32(interval) * np.float32(n)))
        params = self._delta_params({}, force)
        self._g_smdt = (self._g_smdt + np.float32(self._elapsed)).astype(np.float32)
        return params

    def render(self, dstate, ddata, params, n):
        S = dict(dstate)
        elapsed = np.float32(self._elapsed)
        S, mask, prev_pos, next_pos = self._walk_device(S, params, elapsed)

        # per-ear offsets/gains and warp rates (spatial.rs:445-453)
        p_off_c, p_gain_c = ear_states_c(prev_pos, S["radius"])
        n_off_c, n_gain_c = ear_states_c(next_pos, S["radius"])
        nf = float(np.float32(n)) if n > 0 else 1.0
        ef = float(elapsed)
        p_off = torch.stack(p_off_c, dim=-1)
        p_gain = torch.stack(p_gain_c, dim=-1)
        dt_e = torch.stack(
            [((ef + n_off_c[e]) - p_off_c[e]) / nf for e in range(2)], dim=-1
        )
        d_gain = torch.stack(
            [(n_gain_c[e] - p_gain_c[e]) / nf for e in range(2)], dim=-1
        )

        # sample both ears at cursor + p_off + j*dt (spatial.rs:455-463),
        # then advance the real cursor by the block (spatial.rs:465-468)
        samples = self.proto.dr_warp_render(
            S["inner"], ddata.get("inner", {}), p_off, dt_e, n
        )
        S["inner"] = self.proto.dr_advance(S["inner"], self._elapsed)

        jn = torch.arange(n, dtype=_F32, device=self.device)
        gains = p_gain[:, :, None] + jn * d_gain[:, :, None]
        contrib = torch.where(mask[:, None, None], samples * gains, 0.0)
        return S, contrib.sum(dim=0)


class _BufferedPoolDR(_DRPoolBase):
    """Device-resident buffered pool: delay rings on the device.

    Ring storage is rows-native per voice, ``(V, RPV, 128)``, covering the
    flat per-voice span ``F + L + M + SLACK`` (front pad, ring, mirror —
    cols ``[F+L, F+L+M)`` replicate ``[F, F+M)`` — and dump slack), the
    JAX package's layout, so state carries across leaf by leaf.  The pool
    shares one write cursor, so the per-block append is one slab write
    (``rows_append``, K1) into every voice, primary and mirror legs, in
    place.  Reads gather tile-granule windows and run the per-ear select
    kernel (``window_select_ears``, K2; ``window_select_multi``, K3, for
    fused idle groups).
    """

    ROW_KEYS = _DRPoolBase.GEOM_KEYS + ("max_delay", "phase", "tight")

    #: ratio-1 flagship read tier's walk bound (see the JAX package)
    K_DOPPLER = 64
    #: frames per read chunk at ratio 1
    R_CHUNK = 512
    #: columns per general-path write chunk (and the front-pad width)
    W_CHUNK = 1024
    #: mirror width: covers the widest read window
    M_PAD = 1024
    #: family sub-pass slot count (wide-walk voices rendered by a small
    #: wide-tier pass while the main pool keeps its tight tier)
    SUBCAP = 256
    #: read-tier ladder for the sub-pass
    SUB_TIERS = ((256, 256), (128, 192))
    #: blocks fused per multi-block dispatch group (superwindow reads);
    #: < 2 disables
    MULTI_NB = 4

    def __init__(self, name, spec, capacity, rate, cap_pool, k_motion=64,
                 k_play=8, device="cpu"):
        self._init_base(name, spec, capacity, k_motion, k_play, device)
        self.rate = int(rate)
        #: the pool's shared write cursor (f32, host-authoritative)
        self._w_host = np.float32(0.0)
        #: uniform ring modulus for the pool (>= every voice's capacity)
        self.cap_pool = int(cap_pool)
        if self.cap_pool % PAGE or self.cap_pool < 2 * PAGE:
            raise ValueError(f"ring modulus {cap_pool} must be a multiple of {PAGE} >= {2 * PAGE}")
        self.ring_len = self.cap_pool
        self.interval_inner = float(np.float32(1.0) / np.float32(rate))
        #: inter-ear read stagger bound in samples (|d_L - d_R| <= 0.215 m)
        self.emax2 = int(np.ceil(0.215 / float(SPEED_OF_SOUND) * rate)) + 2
        self._n_inner = 1
        self._read_cfg = None  # set per block by host_prepare
        #: per-voice max_delay host column (offset-clamp checks)
        self._md_host = np.zeros(capacity, np.float32)
        #: family sub-pass: the shipped wide-voice list, its tier for this
        #: block, and the ship-pending flag
        self._sub_list = np.zeros(0, np.int64)
        self._sub_cfg = None
        self._sub_dirty = False
        #: tier-transition log (SpatialSceneControl.tier_events)
        self._tier_log = []
        self._tier_last = None

    # -- state ---------------------------------------------------------------

    @property
    def rowlen(self):
        return self.W_CHUNK + self.ring_len + self.M_PAD + self.W_CHUNK

    def _ring_shape(self, V):
        return (V, self.rowlen // 128, 128)

    def _extra_zero(self, V):
        dev = self.device
        return {
            "ring": torch.zeros(self._ring_shape(V), dtype=_F32, device=dev),
            "max_delay": torch.zeros(V, dtype=_F32, device=dev),
            "phase": torch.zeros(V, dtype=_F32, device=dev),
            # device twin of the pool write cursor: idle blocks derive the
            # ring cursor on the device and ship no params at all
            "wcur": torch.zeros(1, dtype=_F32, device=dev),
            # family sub-pass state (fixed SUBCAP shape regardless of V)
            "tight": torch.ones(V, dtype=_F32, device=dev),
            "sub_idx": torch.zeros(self.SUBCAP, dtype=_I32, device=dev),
            "sub_on": torch.zeros(self.SUBCAP, dtype=_F32, device=dev),
        }

    def _concat_state(self, st, fresh):
        """Per-voice leaves concatenate; the fixed-shape sub-pass leaves and
        the pool cursor carry over unchanged."""
        st = dict(st)
        fresh = dict(fresh)
        keep = {k: st.pop(k) for k in ("sub_idx", "sub_on", "wcur")}
        for k in keep:
            fresh.pop(k)
        out = tree_map(lambda a, b: torch.cat([a, b]), st, fresh)
        out.update(keep)
        return out

    # -- control side ----------------------------------------------------------

    def grow(self):
        old = self.capacity
        super().grow()
        self._md_host = np.concatenate([self._md_host, np.zeros(old, np.float32)])

    def play(self, spec, options, max_delay):
        i, gen = self._claim_slot(spec)
        cap = int(np.ceil(np.float32(max_delay) * np.float32(self.rate))) + 1
        if cap > self.cap_pool:
            raise ValueError("max_delay exceeds the pool's ring modulus")
        # The voice starts at the pool's shared write cursor: its freshly
        # zeroed band plays the role of the reference's pre-delay zeros
        # (spatial.rs:39-43); the pre-delay's fractional sample phase (and
        # the pool cursor's phase at play) become a per-voice read offset.
        d = np.minimum(
            v3_norm(f32(options.position)[None, :])[0] / SPEED_OF_SOUND,
            np.float32(max_delay),
        )
        w0 = np.float32(np.float32(self.rate) * np.float32(d))
        W = np.float32(self._w_host)
        row = self._geom_row(options)
        row["phase"] = np.float32((w0 - np.ceil(w0)) - (W - np.ceil(W)))
        row["max_delay"] = np.float32(max_delay)
        row["tight"] = np.float32(1.0)  # reused slots rejoin the main pass
        row["inner"] = spec.dr_slot_row(self.interval_inner)
        self._md_host[i] = np.float32(max_delay)
        self._queue_play(i, row)
        return i, gen

    def _default_row(self):
        row = super()._default_row()
        row["max_delay"] = np.float32(0)
        row["phase"] = np.float32(0)
        row["tight"] = np.float32(1.0)
        return row

    def _clear_rows(self, S, idx):
        """Zero the delay rings of newly played slots, in place."""
        S["ring"][idx] = 0.0

    # -- per block: host plan ------------------------------------------------------

    def _walk_bound(self, elapsed, rot_sin_half):
        """Conservative bounds on this block's |apparent radial velocity|/c
        over audible voices, from the exact host geometry mirrors — no
        device sync.  Returns (steady, full); see the JAX package."""
        C = np.float32(SPEED_OF_SOUND)
        T = np.float32(POSITION_SMOOTHING_PERIOD)
        live = self.mask_host
        if not live.any():
            self._b_cache = {
                "elapsed": elapsed, "steady": 0.0, "full": 0.0,
                "clamp": False, "valid_until": np.inf, "trans_until": 0.0,
                "d_hi_max": 0.0, "spd_max": 0.0, "t": self._t_scene,
            }
            return 0.0, 0.0
        livef = live.astype(np.float32)
        mvel = self._g_mvel
        prev = self._g_prev
        mpos = self._g_mpos
        smdt = self._g_smdt
        vn = np.sqrt(np.einsum("ij,ij->i", mvel, mvel))
        # while smoothing (smdt < T) the apparent velocity carries the
        # pos-refresh transition term, constant until smdt crosses T
        d = mpos - prev
        tn = np.sqrt(np.einsum("ij,ij->i", d, d))
        smoothing = smdt < T
        trans = np.where(smoothing & live, tn / T, np.float32(0.0))
        vn = vn * livef
        spd = vn + trans
        e32 = np.float32(elapsed)
        margin = np.float32(2.0 / self.rate + 1e-4)
        d_hi = np.float32(0.0)
        d_lo = np.float32(np.inf)
        for dt_extra in (np.float32(0.0), e32):
            dt = smdt + dt_extra
            r = np.minimum(dt / T, np.float32(1.0))
            p = prev + mvel * dt[:, None] + r[:, None] * d
            nn = np.sqrt(np.einsum("ij,ij->i", p, p))
            d_hi = np.maximum(d_hi, nn)
            d_lo = np.minimum(d_lo, nn)
        d_hi = d_hi + np.float32(HEAD_RADIUS)
        d_lo = np.maximum(d_lo - np.float32(HEAD_RADIUS), np.float32(0.0))
        # inside / certainly frozen / the band between (spatial.rs:414-416)
        bnd = (self._md_host - e32 - margin) * C
        bnd_hi = (self._md_host + margin) * C
        frozen = (d_lo >= bnd_hi) & live
        band = (d_hi >= bnd) & live & ~frozen
        clamp = bool(band.any())
        gap = np.where(
            live,
            np.minimum(np.abs(d_hi - bnd), np.abs(d_lo - bnd_hi)),
            np.float32(np.inf),
        )
        if self._sub_list.size:
            gap[self._sub_list] = np.float32(np.inf)
        vn_t = np.where(frozen, np.float32(0.0), vn)
        spd_t = np.where(frozen, np.float32(0.0), spd)
        steady = (float(vn_t.max()) * 1.05 + 0.5) / float(C)
        full = (float(spd_t.max()) * 1.05 + 0.5) / float(C)
        with np.errstate(divide="ignore", invalid="ignore"):
            horizon = float(np.where(spd > 0, gap / np.maximum(spd, 1e-9),
                                     np.float32(np.inf)).min())
        rem = np.where(smoothing & live, T - smdt, np.float32(0.0))
        self._b_cache = {
            "elapsed": elapsed,
            "steady": steady,
            "full": full,
            "clamp": clamp,
            "valid_until": self._t_scene + horizon,
            "trans_until": self._t_scene + float(rem.max()),
            "d_hi_max": float(np.where(frozen, np.float32(0.0), d_hi).max()),
            "spd_max": float(spd.max()),
            "t": self._t_scene,
            "pv": {
                "live": live.copy(),
                "vn": vn,
                "trans": trans,
                "clamp": band,
                "frozen": frozen,
                "d_hi": d_hi,
                "d_lo": d_lo,
                "spd": spd,
            },
        }
        if clamp:
            steady = max(steady, 1.0)
            full = max(full, 1.0)
        if rot_sin_half > 0.0 and elapsed > 0:
            swing = 2.0 * min(
                float(HEAD_RADIUS),
                self._b_cache["d_hi_max"] * float(rot_sin_half),
            )
            full += 1.05 * swing / (float(C) * elapsed)
        return steady, full

    def _block_b(self, elapsed, n, ratio, rot_sin_half):
        """Final walk-bound fraction for this block (the O(V) sweep runs only
        when the cached verdict can have changed)."""
        c = self._b_cache
        if (
            c is None
            or c["elapsed"] != elapsed
            or self._t_scene >= c["valid_until"]
        ):
            steady, full = self._walk_bound(elapsed, rot_sin_half)
        else:
            steady, full = c["steady"], c["full"]
            if self._t_scene >= c["trans_until"]:
                full = steady  # every smoothing transition has decayed
            if c["clamp"]:
                steady = max(steady, 1.0)
                full = max(full, 1.0)
            if rot_sin_half > 0.0 and elapsed > 0:
                d_hi = c["d_hi_max"] + c["spd_max"] * max(
                    0.0, self._t_scene + elapsed - c["t"]
                )
                swing = 2.0 * min(
                    float(HEAD_RADIUS), d_hi * float(rot_sin_half)
                )
                full += 1.05 * swing / (float(SPEED_OF_SOUND) * elapsed)
        b_cap = max(
            0.0, (64.0 / min(512, max(n, 1)) - abs(ratio - 1.0)) / max(ratio, 1e-9)
        )
        return max(steady, min(full, max(b_cap, steady)))

    def force_needed(self):
        """Whether this pool wants the delta step even without queued
        events (a decaying smoothing transition, or a pending sub-pass
        membership change)."""
        if getattr(self, "_sub_dirty", False):
            return True
        c = self._b_cache
        if c is None:
            return True
        return (
            self._t_scene < c["trans_until"]
            and c["full"] > c["steady"] + 1e-6
        )

    def _per_voice_bounds(self, elapsed, n, ratio, rot_sin_half):
        """Per-voice analogue of ``_block_b``: ``(b_v, dmax_v, live)``, or
        None when no voices are live."""
        c = self._b_cache
        if (
            c is None
            or c["elapsed"] != elapsed
            or self._t_scene >= c["valid_until"]
        ):
            self._walk_bound(elapsed, rot_sin_half)
            c = self._b_cache
        pv = c.get("pv")
        if pv is None:
            return None
        memo_key = None
        if rot_sin_half == 0.0:
            memo_key = (
                c["t"], elapsed, n, ratio,
                self._t_scene < c["trans_until"],
            )
            hit = getattr(self, "_pvb_memo", None)
            if hit is not None and hit[0] == memo_key:
                return hit[1]
        C = float(SPEED_OF_SOUND)
        live = pv["live"]
        vn = pv["vn"]
        trans = (
            pv["trans"]
            if self._t_scene < c["trans_until"]
            else np.zeros_like(pv["trans"])
        )
        steady = (vn * np.float32(1.05) + np.float32(0.5)) / C
        full = ((vn + trans) * np.float32(1.05) + np.float32(0.5)) / C
        clamp_v = pv["clamp"]
        steady = np.where(clamp_v, np.maximum(steady, 1.0), steady)
        full = np.where(clamp_v, np.maximum(full, 1.0), full)
        if rot_sin_half > 0.0 and elapsed > 0:
            age = np.float32(max(0.0, self._t_scene + elapsed - c["t"]))
            d_hi = pv["d_hi"] + (vn + pv["trans"]) * age
            swing = 2.0 * np.minimum(
                float(HEAD_RADIUS), d_hi * np.float32(rot_sin_half)
            )
            full = full + np.float32(1.05) * swing / (C * elapsed)
        b_cap = max(
            0.0, (64.0 / min(512, max(n, 1)) - abs(ratio - 1.0)) / max(ratio, 1e-9)
        )
        b_v = np.maximum(steady, np.minimum(full, np.maximum(b_cap, steady)))
        active = live & ~pv["frozen"]
        b_v = np.where(active, b_v, 0.0)
        dmax_v = np.where(active, abs(ratio - 1.0) + b_v * ratio, 0.0)
        out = (b_v, dmax_v, live)
        if memo_key is not None:
            self._pvb_memo = (memo_key, out)
        return out

    def host_prepare(self, prev_rot, rot, interval, n, force=False):
        # per-(interval, n) invariants: elapsed, inner frame count, cursor
        # advance, rate ratio
        key = (float(interval), n)
        if getattr(self, "_prep_key", None) == key:
            elapsed, n_inner, advf, ratio = self._prep_inv
        else:
            elapsed = float(np.float32(f32(interval) * np.float32(n)))
            n_inner = (
                int(np.ceil(np.float64(elapsed) * self.rate)) + 1 if n > 0 else 1
            )
            advf = float(np.float32(np.float32(elapsed) * np.float32(self.rate)))
            ratio = float(np.float32(self.rate) * f32(interval))
            self._prep_key = key
            self._prep_inv = (elapsed, n_inner, advf, ratio)
        self._elapsed = elapsed
        self._n_inner = n_inner
        # shared ring cursor bookkeeping (ring.rs:18-41), host-authoritative
        cap = self.cap_pool
        w0f = float(self._w_host)
        int_path = advf.is_integer() and w0f.is_integer()
        if int_path:
            # integer fast path: every f32 op below is exact on integers
            # < 2^24, so plain int arithmetic reproduces it bit for bit
            w_uni = int(w0f) + int(advf)
            endi = w_uni % cap
            start_i = int(w0f)
            n_write = int(advf)
            end = np.float32(endi)
            self._w_host = end
        else:
            end, start_i, n_write = self._prepare_cursor_f32(advf)
        # aligned fast path: the cursor advances by whole 128-lane rows and
        # the slab fits both the primary and the mirror/dump leg
        mirror_fits = (
            start_i + n_write <= self.M_PAD + self.W_CHUNK
            if start_i < self.M_PAD
            else n_write <= self.W_CHUNK
        )
        self._w_aligned = (
            n_write
            if (
                0 < n_write <= self._n_inner
                and n_write % 128 == 0
                and start_i % 128 == 0
                and start_i + n_write <= cap
                and mirror_fits
            )
            else 0
        )
        params = {
            "w": end,
            "nw": np.int32(n_write),
            "wstart": np.int32(start_i),
        }
        # deltas ship (and mirror-update) BEFORE the tier choice: shipped
        # motion applies on this block
        params = self._delta_params(params, force)
        # read-path tier from the rate ratio and the scene's actual motion
        if prev_rot is rot:
            rot_sin_half = 0.0
        else:
            pr = np.asarray(prev_rot, np.float64)
            rr = np.asarray(rot, np.float64)
            rot_sin_half = (
                0.0
                if np.array_equal(pr, rr)
                else float(np.sqrt(max(0.0, 1.0 - min(1.0, np.dot(pr, rr) ** 2))))
            )
        tiers = ((512, 32), (512, 64), (512, 128), (256, 256), (128, 192))
        if self._has_play:
            # delta blocks skip the tight tier (pinned at the K=64 class)
            tiers = tiers[1:]
        self._sub_plan(n, ratio, elapsed, rot_sin_half, params, tiers)
        # mirror the walk's smoothing-clock advance (step 3)
        self._g_smdt = self._g_smdt + np.float32(elapsed)
        self._t_scene += elapsed
        # param-free idle blocks: on the integer fast path with an aligned
        # append whose advance divides the modulus, the device derives
        # (w, nw, wstart) from its cursor and the block ships nothing
        self._w_free = (
            int_path
            and n_write > 0
            and self._w_aligned == n_write
            and cap % n_write == 0
            and n_write <= self.W_CHUNK
            and len(params) == 3
        )
        if self._w_free:
            return {}
        return params

    def _prepare_cursor_f32(self, advf):
        """General (fractional-cursor) f32 cursor advance."""
        capf = np.float32(self.cap_pool)
        adv = np.float32(advf)
        w0 = np.float32(self._w_host)
        # UNWRAPPED advance (blocks may exceed the ring modulus)
        w_un = np.float32(w0 + adv)
        end = np.float32(np.mod(w_un, capf))
        start_i = int(np.ceil(w0))
        n_write = int(np.ceil(w_un)) - start_i
        self._w_host = end
        return end, start_i, n_write

    def _pick_tier(self, d, n, ladder):
        memo = getattr(self, "_tier_memo", None)
        if memo is None:
            memo = self._tier_memo = {}
        key = (d, n, ladder)
        hit = memo.get(key, False)
        if hit is not False:
            return hit
        out = None
        for n_c, k in ladder:
            if (
                d * min(n_c, max(n, 1)) <= k
                and select_window(n_c, 127 + self.emax2, k) <= self.M_PAD
            ):
                out = (n_c, k)
                break
        if len(memo) > 256:
            memo.clear()
        memo[key] = out
        return out

    _EMPTY_SUB = np.zeros(0, np.int64)

    def _sub_plan(self, n, ratio, elapsed, rot_sin_half, params, tiers):
        """Pick the read tier(s) for this block, splitting wide-walk voices
        into the family sub-pass when that keeps the main pool on a
        512-frame tier (see the JAX package for the full rationale)."""
        desired = None  # None = keep the shipped list as-is
        pvb = None
        if n > 0:
            b_all = self._block_b(elapsed, n, ratio, rot_sin_half)
            cfg_all = self._pick_tier(abs(ratio - 1.0) + b_all * ratio, n, tiers)
            if cfg_all is None or cfg_all[0] < 512 or self._sub_list.size:
                pvb = self._per_voice_bounds(elapsed, n, ratio, rot_sin_half)
        if pvb is not None:
            b_v, dmax_v, live = pvb
            wide_v = live & (dmax_v * min(512, max(n, 1)) > 128.0)
            in_ship = np.zeros(self.capacity, bool)
            in_ship[self._sub_list] = True
            covered = not bool((wide_v & ~in_ship).any())
            c = self._b_cache
            fresh = c is not None and c.get("t") == self._t_scene
            if (not covered or fresh) and (
                wide_v.any() or self._sub_list.size
            ):
                # pre-list horizon: also list voices that can reach the
                # clamp transition band within H seconds
                pv = c["pv"]
                age = np.float32(max(0.0, self._t_scene - c["t"]))
                C = np.float32(SPEED_OF_SOUND)
                e32 = np.float32(elapsed)
                margin = np.float32(2.0 / self.rate + 1e-4)
                bnd = (self._md_host - e32 - margin) * C
                bnd_hi = (self._md_host + margin) * C
                spd = pv["spd"]
                d_hi = pv["d_hi"] + spd * age
                d_lo = np.maximum(pv["d_lo"] - spd * age, np.float32(0.0))
                frozen = pv["frozen"]
                cand = None
                for H in (8.0, 4.0, 2.0, 1.0, 0.5, 0.25, 0.1, 0.0):
                    r = spd * np.float32(H)
                    near = live & (
                        wide_v
                        | (~frozen & (d_hi + r >= bnd))
                        | (frozen & (d_lo - r <= bnd_hi))
                    )
                    idx = np.nonzero(near)[0]
                    if idx.size <= self.SUBCAP:
                        cand = idx
                        break
                desired = self._EMPTY_SUB
                if cand is not None and cand.size:
                    sd = dmax_v[cand]
                    sub_ok = self._pick_tier(float(sd.max()), n, self.SUB_TIERS)
                    mask_c = np.zeros(self.capacity, bool)
                    mask_c[cand] = True
                    tb = float(np.where(mask_c, 0.0, b_v).max())
                    main = self._pick_tier(abs(ratio - 1.0) + tb * ratio, n, tiers)
                    # splitting pays only when it rescues a 512 tier
                    if (sub_ok is not None and main is not None
                            and main[0] == 512):
                        desired = cand
        # membership updates ride delta blocks; an idle-block change leaves
        # the shipped list authoritative and the main tier demoted once
        if desired is not None and not np.array_equal(desired, self._sub_list):
            if self._has_play:
                self._sub_list = desired
                self._sub_dirty = False
            else:
                self._sub_dirty = True
        else:
            self._sub_dirty = False
        shipped = self._sub_list
        if shipped.size:
            if self._has_play:
                idx = np.zeros(self.SUBCAP, np.int32)
                on = np.zeros(self.SUBCAP, np.float32)
                idx[: shipped.size] = shipped
                on[: shipped.size] = 1.0
                params["sub_idx"] = idx
                params["sub_on"] = on
            in_sub = np.zeros(self.capacity, bool)
            in_sub[shipped] = True
            if pvb is not None:
                b_v, dmax_v, live = pvb
                mb = float(np.where(in_sub, 0.0, b_v).max())
                sd_live = dmax_v[shipped][live[shipped]]
                sd = float(sd_live.max()) if sd_live.size else 0.0
            else:
                mb, sd = 0.0, 0.0
            self._read_cfg = self._pick_tier(
                abs(ratio - 1.0) + mb * ratio,
                n, tiers,
            )
            self._sub_cfg = self._pick_tier(sd, n, self.SUB_TIERS)
            if self._read_cfg is None or self._sub_cfg is None:
                # beyond every kernel tier: whole-pool exact read
                self._read_cfg = None
                self._sub_cfg = None
        else:
            b = self._block_b(elapsed, n, ratio, rot_sin_half)
            self._read_cfg = self._pick_tier(abs(ratio - 1.0) + b * ratio, n, tiers)
            self._sub_cfg = None
        cur = (self._read_cfg, self._sub_cfg, int(self._sub_list.size))
        if cur != self._tier_last:
            self._tier_last = cur
            if len(self._tier_log) < 4096:
                self._tier_log.append((float(self._t_scene),) + cur)

    # -- per block: device side ------------------------------------------------

    def _advance_block(self, dstate, ddata, params, n):
        """One block's control walk, ring append and read-prep geometry,
        shared by ``render`` and ``render_multi``.  Returns ``(S, ro)`` with
        ``ro`` holding the per-ear read operands."""
        S = dict(dstate)
        dev = self.device
        elapsed = np.float32(self._elapsed)
        ef = float(elapsed)
        ratef = float(np.float32(self.rate))
        n_inner = self._n_inner

        # 1-4. control walk (plays, motion, geometry, lingering)
        S, mask, prev_pos, next_pos = self._walk_device(S, params, elapsed)

        # 5. shared ring cursor: host scalars on delta blocks (resyncing the
        # device cursor), derived on the device from "wcur" on param-free
        # idle blocks (exact on the integer fast path)
        cap = self.cap_pool
        capf = float(cap)
        if "w" in params:
            w_end = _upload(params["w"], dev, _F32)
            nw_s = _upload(params["nw"], dev, _I32)
            start_i = _upload(params["wstart"], dev, _I32)
        else:
            adv = float(np.float32(self._prep_inv[2]))
            w0 = S["wcur"][0]
            w_un = w0 + adv
            w_end = torch.remainder(w_un, capf)
            start_i = torch.ceil(w0).to(_I32)
            nw_s = torch.ceil(w_un).to(_I32) - start_i
        S["wcur"] = w_end.reshape(1)
        # dead/unplayed slots do not advance their inner cursors
        n_write = torch.where(mask, nw_s, 0)

        # 6. inner source render; slab append (ring.rs:18-41).  All n_inner
        # frames are written every block; the <=1-frame overlap past
        # n_write is recomputed identically next block.
        inner2, samples = self.proto.dr_render(
            S["inner"], ddata.get("inner", {}), self.interval_inner, n_inner,
            n_write,
        )
        S["inner"] = inner2
        FP = self.W_CHUNK  # front pad (absorbs wrapped mirror writes)
        M = self.M_PAD
        ring = S["ring"]  # (V, RPV, 128)
        if self._w_aligned:
            # row-aligned slab: primary + mirror-maintenance legs, in place
            nw = self._w_aligned
            r0 = _fdiv(FP + start_i, 128)
            rm = _fdiv(FP + torch.where(start_i < M, start_i + cap, cap + M), 128)
            ring = rows_append(ring, samples[:, :nw], r0, rm)
        else:
            # general (unaligned/wrapping) path, exotic block configs only:
            # each <=W_CHUNK-wide sub-slab lands twice on the flat view —
            # into the mirror when it touches [0, M), onto the canonical
            # home when it wrapped past L, or into the dump slack otherwise
            flat = ring.view(ring.shape[0], self.rowlen)
            for k in range(0, n_inner, self.W_CHUNK):
                chunk = samples[:, k : k + self.W_CHUNK]
                width = chunk.shape[1]
                lanes = torch.arange(width, dtype=torch.int64, device=dev)
                ck = torch.remainder(start_i + k, cap)
                flat.index_copy_(1, (FP + ck).to(torch.int64) + lanes, chunk)
                c2 = FP + torch.where(
                    ck + width > cap, ck - cap,
                    torch.where(ck < M, ck + cap, cap + M),
                )
                flat.index_copy_(1, c2.to(torch.int64) + lanes, chunk)
        S["ring"] = ring

        # 7. per-ear read operands (spatial.rs:409-431), component-split
        p_off_c, p_gain_c = ear_states_c(prev_pos, S["radius"])
        n_off_c, n_gain_c = ear_states_c(next_pos, S["radius"])
        nmd = -S["max_delay"]
        p_off_c = [torch.maximum(po - ef, nmd) for po in p_off_c]
        n_off_c = [torch.maximum(no, nmd) for no in n_off_c]
        nf = float(np.float32(n)) if n > 0 else 1.0
        d_gain_c = [(n_gain_c[e] - p_gain_c[e]) / nf for e in range(2)]
        wp = w_end + S["phase"]
        offset0_c = [
            torch.remainder(wp + p_off_c[e] * ratef, capf) for e in range(2)
        ]
        obase_c = [torch.floor(o) for o in offset0_c]
        split_c = [
            device_split_ds(((n_off_c[e] - p_off_c[e]) / nf) * ratef)
            for e in range(2)
        ]
        maskf = mask.to(_F32)
        # per-ear FROZEN flags: a fully offset-clamped voice (spatial.rs:
        # 414-416) has n_off == p_off exactly, so its read step is exactly
        # zero and the select kernel repeats its j = 0 sample
        frz_c = [(n_off_c[e] == p_off_c[e]).to(_F32) for e in range(2)]
        return S, {
            "mask": mask,
            "maskf": maskf,
            "p_gain_c": p_gain_c,
            "d_gain_c": d_gain_c,
            "offset0_c": offset0_c,
            "obase_c": obase_c,
            "split_c": split_c,
            "frz_c": frz_c,
        }

    def render(self, dstate, ddata, params, n):
        S, ro = self._advance_block(dstate, ddata, params, n)
        V = S["mask"].shape[0]
        dev = self.device
        cap = self.cap_pool
        maskf = ro["maskf"]
        p_gain_c = ro["p_gain_c"]
        d_gain_c = ro["d_gain_c"]
        offset0_c = ro["offset0_c"]
        obase_c = ro["obase_c"]
        split_c = ro["split_c"]
        ring = S["ring"]
        FP = self.W_CHUNK
        if self._read_cfg is None:
            # exotic rate ratio: exact elementwise read of the flat ring
            # (any-ratio correct, frames.rs-style lerp)
            p_gain = torch.stack(p_gain_c, dim=-1)
            d_gain = torch.stack(d_gain_c, dim=-1)
            offset0 = torch.stack(offset0_c, dim=-1)
            obase = torch.stack(obase_c, dim=-1)
            ds_int = torch.stack([s[0] for s in split_c], dim=-1)
            f_hi = torch.stack([s[1] for s in split_c], dim=-1)
            f_lo = torch.stack([s[2] for s in split_c], dim=-1)
            jn = torch.arange(n, dtype=_F32, device=dev)
            gains = p_gain[:, :, None] + jn * d_gain[:, :, None]
            flat = ring.view(V, self.rowlen)[:, FP:]
            whole, fr = exact_positions(offset0 - obase, ds_int, f_hi, f_lo, n)
            x = torch.remainder(obase.to(_I32)[:, :, None] + whole, cap)

            def look(ix):
                return torch.gather(
                    flat, 1, ix.reshape(V, 2 * n).to(torch.int64)
                ).reshape(V, 2, n)

            a = look(x)
            b = look(torch.remainder(x + 1, cap))
            s = a + fr * (b - a)
            contrib = torch.where(ro["mask"][:, None, None], s * gains, 0.0)
            return S, contrib.sum(dim=0)
        base_c = [o.to(_I32) for o in obase_c]
        frac_c = [offset0_c[e] - obase_c[e] for e in range(2)]
        RPV = self.rowlen // 128
        rows8 = ring.view(V * (RPV // 8), 8, 128)
        vb8 = torch.arange(V, dtype=_I32, device=dev) * (RPV // 8)
        sub_cfg = self._sub_cfg
        if "sub_idx" in params:
            # membership refresh (delta blocks): carry the list and the
            # derived per-voice tight flags in state
            S["sub_idx"] = _upload(params["sub_idx"], dev, _I32)
            S["sub_on"] = _upload(params["sub_on"], dev, _F32)
            hit = (
                S["sub_idx"][:, None]
                == torch.arange(V, dtype=_I32, device=dev)[None, :]
            ) & (S["sub_on"][:, None] > 0.0)
            S["tight"] = 1.0 - hit.any(dim=0).to(_F32)
        maskf_main = maskf * S["tight"] if sub_cfg is not None else maskf
        out = self._windows_read(
            rows8, vb8, base_c, frac_c, split_c, p_gain_c, d_gain_c,
            maskf_main, self._read_cfg, n, cap, FP,
            frz_c=[f[:, None] for f in ro["frz_c"]],
        )
        if sub_cfg is not None:
            # family sub-pass: the host-listed wide-walk voices render at a
            # wide tier over their gathered rows, while the pool above kept
            # its tight tier
            si = S["sub_idx"].to(torch.int64)
            out = out + self._windows_read(
                rows8,
                S["sub_idx"] * (RPV // 8),
                [b[si] for b in base_c],
                [f[si] for f in frac_c],
                [tuple(x[si] for x in s) for s in split_c],
                [g[si] for g in p_gain_c],
                [g[si] for g in d_gain_c],
                maskf[si] * S["sub_on"],
                sub_cfg, n, cap, FP,
            )
        return S, out

    def host_multiblock(self, interval, n):
        """Whether (and how wide) the NEXT idle blocks may dispatch as fused
        multi-block groups: the param-free aligned cursor path, a
        single-chunk 512-class tier with no sub-pass, and enough ring slack
        that group-batched appends cannot overwrite samples an earlier
        block of the group still reads.  Returns nb >= 2 or 0."""
        nb = self.MULTI_NB
        if nb < 2 or not getattr(self, "_w_free", False):
            return 0
        cfg = self._read_cfg
        if cfg is None or self._sub_cfg is not None or cfg[0] < n:
            return 0
        advf = self._prep_inv[2]
        live = self.mask_host
        md = float(self._md_host[live].max()) if live.any() else 0.0
        if md * self.rate + (nb - 1) * advf + cfg[1] + 1152 > self.cap_pool:
            return 0
        return nb

    @staticmethod
    def _ear_starts(base_c, cap, DMAX, K, FP):
        """Shared-ear window start and per-ear staggers (the two ears'
        starts differ by at most the inter-ear distance)."""
        ob0 = torch.remainder(base_c[0], cap)
        ob1 = torch.remainder(base_c[1], cap)
        dlr = torch.remainder(ob0 - ob1, cap)
        l_ahead = dlr <= DMAX
        cm = torch.where(l_ahead, ob1, ob0)
        dstart = [
            torch.where(l_ahead, dlr, 0).clamp(0, DMAX),
            torch.where(l_ahead, 0, cap - dlr).clamp(0, DMAX),
        ]
        rstart = torch.remainder(cm - K, cap) + FP
        return rstart, dstart

    def render_multi(self, dstate, ddata, params, n, nb):
        """``nb`` idle blocks in one group: per-block control walk, append
        and cursor math identical to ``render``, but all reads share ONE
        superwindow gather and ONE select kernel call (K3).  Appends all
        land before the gather; host_multiblock's slack gate keeps later
        appends from overwriting samples earlier blocks still read.
        Returns (S, (2, nb*n))."""
        S = dstate
        ros = []
        for _ in range(nb):
            S, ro = self._advance_block(S, ddata, params, n)
            ros.append(ro)
        V = S["mask"].shape[0]
        dev = self.device
        cap = self.cap_pool
        PW, GW = 128, 1024
        FP = self.W_CHUNK
        FPG = FP // GW
        capg = cap // GW
        RPV = self.rowlen // PW
        rows8 = S["ring"].view(V * (RPV // 8), 8, PW)
        vb8 = torch.arange(V, dtype=_I32, device=dev) * (RPV // 8)
        _, K = self._read_cfg
        DMAX = self.emax2
        emax2r = PW - 1 + self.emax2
        WIN = select_window(n, emax2r, K)
        advf = self._prep_inv[2]
        # static per-block slice bases / realign ranges
        row0s = [max(0, int(np.floor(b * (advf - K) / PW))) for b in range(nb)]
        hs = [
            int(GW - 1 + b * (advf + K)) // PW - row0s[b] + 1
            for b in range(nb)
        ]
        rsh, scal01, g01, e01, f01 = [], ([], []), ([], []), ([], []), ([], [])
        for b, ro in enumerate(ros):
            base_c = [o.to(_I32) for o in ro["obase_c"]]
            frac_c = [ro["offset0_c"][e] - ro["obase_c"][e] for e in range(2)]
            rstart, dstart = self._ear_starts(base_c, cap, DMAX, K, FP)
            if b == 0:
                rstart0 = rstart
                r0g = _fdiv(rstart0, GW)
                base_col = r0g * GW
            rel = torch.remainder(rstart - rstart0, cap)
            rsh.append(_fdiv(rstart0 - base_col + rel, PW) - row0s[b])
            exr = torch.remainder(rstart, PW)
            for e in range(2):
                ds_e, fh_e, fl_e = ro["split_c"][e]
                scal01[e].append(torch.stack(
                    [frac_c[e], fh_e, fl_e, ds_e.to(_F32)], dim=-1
                ))
                g01[e].append(torch.stack(
                    [ro["p_gain_c"][e] * ro["maskf"],
                     ro["d_gain_c"][e] * ro["maskf"]],
                    dim=-1,
                ))
                e01[e].append((exr + dstart[e]).to(_I32))
                f01[e].append(ro["frz_c"][e])
        # ONE superwindow per voice: whole 1024-column granules, wrapped
        # granule-wise (mod capg) so the span may exceed the mirror width
        ngr_s = -(-int(GW - 1 + (nb - 1) * (advf + K) + WIN) // GW)
        kg = FPG + torch.remainder(
            r0g[:, None] - FPG
            + torch.arange(ngr_s, dtype=_I32, device=dev)[None, :],
            capg,
        )
        ridx = (vb8[:, None] + kg).reshape(-1).to(torch.int64)
        wide = rows8.index_select(0, ridx).reshape(V, ngr_s * GW)
        out = window_select_multi(
            wide,
            torch.stack(rsh, dim=-1),
            tuple(torch.cat(scal01[e], dim=-1) for e in range(2)),
            tuple(torch.cat(g01[e], dim=-1) for e in range(2)),
            tuple(torch.stack(e01[e], dim=-1) for e in range(2)),
            tuple(torch.stack(f01[e], dim=-1) for e in range(2)),
            n=n, K=K, emax2=emax2r, nb=nb, row0s=row0s, hs=hs,
        )
        return S, out

    def _windows_read(self, rows8, vbase, base_c, frac_c, split_c,
                      p_gain_c, d_gain_c, maskf, cfg, n, cap, FP,
                      frz_c=None):
        """Tile-granule window gather + per-ear select (K2) over one voice
        set (the main pool or the family sub-pass list), mixed to (2, n).
        ``rows8`` is the (8, 128)-tile view of the ring; ``vbase`` maps each
        rendered row to its voice's first granule.  Windows come off whole
        1024-column granules; the granule remainder becomes the kernel's
        coarse shift (``rowshift``, multiples of 128) plus the per-ear
        stagger."""
        R_CHUNK, K = cfg
        DMAX = self.emax2
        PW = 128
        GW = 8 * PW
        emax2r = PW - 1 + self.emax2
        base_c, frac_c = list(base_c), list(frac_c)
        Vr = base_c[0].shape[0]
        parts = []
        for j0 in range(0, n, R_CHUNK):
            n_c = min(R_CHUNK, n - j0)
            rstart, dstart = self._ear_starts(base_c, cap, DMAX, K, FP)
            SREAD = select_window(n_c, emax2r, K)
            ngr = -(-(GW - 1 + SREAD) // GW)
            r0 = _fdiv(rstart, GW)
            ridx = (
                vbase[:, None] + r0[:, None]
                + torch.arange(ngr, dtype=_I32, device=rows8.device)[None, :]
            ).reshape(-1).to(torch.int64)
            wide = rows8.index_select(0, ridx).reshape(Vr, ngr * GW)
            rowshift = _fdiv(rstart - r0 * GW, PW)
            exr = torch.remainder(rstart, PW)
            # gains ship with the voice mask folded in (exact for 0/1 masks)
            scal01, g01, e01 = [], [], []
            for e in range(2):
                ds_e, fh_e, fl_e = split_c[e]
                scal01.append(torch.stack(
                    [frac_c[e], fh_e, fl_e, ds_e.to(_F32)], dim=-1
                ))
                g0_e = (p_gain_c[e] + float(j0) * d_gain_c[e]) * maskf
                g01.append(torch.stack([g0_e, d_gain_c[e] * maskf], dim=-1))
                e01.append((exr + dstart[e]).to(_I32)[:, None])
            parts.append(window_select_ears(
                wide, rowshift, scal01, g01, e01, n=n_c, K=K, emax2=emax2r,
                hmax=GW // PW, frz01=frz_c,
            ))
            if j0 + n_c < n:
                for e in range(2):
                    ds_e, fh_e, fl_e = split_c[e]
                    base_c[e], frac_c[e] = device_advance(
                        base_c[e], frac_c[e], n_c, ds_e, fh_e, fl_e
                    )
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def _next_pow2(x):
    p = 1
    while p < x:
        p *= 2
    return p


class SpatialScene(Signal):
    """Signal for stereo output from a spatial scene (spatial.rs:159-188).

    ``device`` places the scene's device state (default: the CPU, like
    torch's own factories); the ring kernels run on CUDA devices and their
    plain versions on the CPU."""

    channels = 2

    def __init__(self, initial_capacity=DEFAULT_CAPACITY, device=None):
        super().__init__()
        self.initial_capacity = initial_capacity
        self.device = torch.device("cpu" if device is None else device)
        self._rot = np.array([1.0, 0.0, 0.0, 0.0], dtype=np.float32)
        self._rot_pending = None
        self._rot_dev = None  # device copy ("_rot" state leaf)
        self._has_rot = False
        self._seek_pools = {}
        self._buffered_pools = {}

    @classmethod
    def new(cls, initial_capacity=DEFAULT_CAPACITY, device=None):
        """spatial.rs:170-188 — returns (SpatialSceneControl, SpatialScene)."""
        sig = cls(initial_capacity, device)
        return SpatialSceneControl(sig), sig

    def host_batchable(self):
        return False

    # -- control side ---------------------------------------------------------

    def _play(self, spec, options):
        if spec.channels != 1:
            raise ValueError("spatial signals must be mono (spatial.rs:276-279)")
        if not spec.seekable:
            raise TypeError(
                "play() requires a seekable (deterministic) signal; "
                "use play_buffered() for arbitrary signals"
            )
        if not spec.dr_seek_supported():
            raise NotImplementedError(
                "this source needs the host seek pool (_SeekPool), which "
                "is not ported yet (ROADMAP P2.4)"
            )
        key = (spec.archetype(), True)
        pool = self._seek_pools.get(key)
        if pool is None:
            pool = _SeekPoolDR(
                f"s{len(self._seek_pools)}", spec, self.initial_capacity,
                device=self.device,
            )
            self._seek_pools[key] = pool
        i, gen = pool.play(spec, options)
        return Spatial(pool, i, gen)

    def _play_buffered(self, spec, options, max_distance, rate, buffer_duration):
        if spec.channels != 1:
            raise ValueError("spatial signals must be mono (spatial.rs:276-279)")
        # spatial.rs:330: max_delay = max_distance / c + buffer_duration
        max_delay = np.float32(max_distance) / SPEED_OF_SOUND + np.float32(
            buffer_duration
        )
        cap = int(np.ceil(np.float32(max_delay) * np.float32(rate))) + 1
        bucket = max(2048, _next_pow2(cap))  # pool modulus / storage bucket
        if not (spec.host_batchable() and spec.dr_supported()):
            raise NotImplementedError(
                "this source needs a host buffered pool (_BufferedPool or "
                "_BufferedPoolSingleton), which is not ported yet (ROADMAP P2.4)"
            )
        key = (spec.archetype(), int(rate), bucket, True)
        pool = self._buffered_pools.get(key)
        if pool is None:
            pool = _BufferedPoolDR(
                f"b{len(self._buffered_pools)}", spec, self.initial_capacity,
                rate, bucket, device=self.device,
            )
            self._buffered_pools[key] = pool
        i, gen = pool.play(spec, options, max_delay)
        return Spatial(pool, i, gen)

    def sync(self):
        """Pull device-resident voice state back to the host so handles
        observe finishes and freed slots become reusable."""
        for p in self._all_pools():
            p.sync()

    def sync_prefetch(self):
        for p in self._all_pools():
            p.sync_prefetch()

    def _set_listener_rotation(self, rotation):
        """spatial.rs:345-349 — stores the inverse quaternion."""
        self._rot_pending = quat_invert(f32(rotation))

    # -- Signal protocol ---------------------------------------------------------

    def _all_pools(self):
        return list(self._buffered_pools.values()) + list(self._seek_pools.values())

    def archetype(self):
        """Structural key: equal keys on consecutive blocks let the Renderer
        group them (and fuse idle runs into multi-block dispatches)."""
        pools = tuple(
            (
                p.name,
                p.proto.archetype(),
                getattr(p, "ring_len", 0),
                getattr(p, "_n_inner", 0),
                p._elapsed,
                getattr(p, "_has_play", False),
                getattr(p, "_has_mot", False),
                getattr(p, "_w_aligned", 0),
                getattr(p, "_w_free", False),
                getattr(p, "_read_cfg", None),
                getattr(p, "_sub_cfg", None),
            )
            for p in self._all_pools()
        )
        return ("SpatialScene", self._has_rot, pools)

    def host_structure_event(self):
        # bulk plays apply eagerly outside the per-block step
        return any(len(p.pending_plays) > p.k_play for p in self._all_pools())

    def host_prepare(self, interval, n, count=None):
        # listener rotation swap refresh (spatial.rs:382-386): the host keeps
        # the authoritative mirror; the pools read the device copy ("_rot")
        prev_rot = self._rot
        rot_event = self._rot_pending is not None
        if rot_event:
            if self._rot_dev is None:
                self._rot_dev = _upload(self._rot, self.device)
            self._rot = self._rot_pending
            self._rot_pending = None
        rot = self._rot
        # scene-global control-event flag: when ANY pool has queued events,
        # every pool ships its (padded) delta arrays
        force = rot_event or any(
            bool(p.pending_plays) or bool(p.pending_motion)
            or p._ctrl_pending_any()
            or getattr(p, "force_needed", lambda: False)()
            for p in self._all_pools()
        )
        self._has_rot = force
        out = {}
        if force:
            out["_rot_new"] = rot.copy()
        for p in self._all_pools():
            out[p.name] = p.host_prepare(prev_rot, rot, f32(interval), n, force)
        return out

    def device_collect(self):
        if self._rot_dev is None:
            self._rot_dev = _upload(self._rot, self.device)
        out = {"_rot": self._rot_dev}
        for p in self._all_pools():
            out[p.name] = p.dr_state()
        return out

    def device_store(self, d):
        self._rot_dev = d["_rot"]
        for p in self._all_pools():
            p.state = d[p.name]

    def device_data(self):
        return {p.name: {"inner": p.proto.device_data()} for p in self._all_pools()}

    def host_multiblock(self, interval, n):
        """Fused idle-group width the Renderer may dispatch (0 = off): at
        least one buffered pool must profit, and each buffered pool must
        pass its superwindow gate (_BufferedPoolDR.host_multiblock)."""
        nb = 0
        for p in self._all_pools():
            m = getattr(p, "host_multiblock", None)
            if m is None:
                continue
            k = m(interval, n)
            if k < 2:
                return 0
            nb = k if nb == 0 else min(nb, k)
        return nb

    def render_multi(self, dstate, ddata, n, nb):
        """``nb`` consecutive param-free blocks as one group (dispatched
        only for idle runs that passed host_multiblock).  Returns
        (d2, (2, nb*n))."""
        rot_prev = dstate["_rot"]
        out = torch.zeros((2, nb * n), dtype=_F32, device=self.device)
        d2 = {"_rot": rot_prev}
        for p in self._all_pools():
            pp = {"rot_prev": rot_prev, "rot": rot_prev}
            dsub, block = p.render_multi(dstate[p.name], ddata[p.name], pp, n, nb)
            d2[p.name] = dsub
            out = out + block
        return d2, out

    def render(self, dstate, ddata, params, n):
        # rotation refresh: prev = state, cur = delta (if any)
        rot_prev = dstate["_rot"]
        rot_cur = (
            _upload(params["_rot_new"], self.device)
            if "_rot_new" in params else rot_prev
        )
        out = torch.zeros((2, n), dtype=_F32, device=self.device)
        d2 = {"_rot": rot_cur}
        for p in self._all_pools():
            pp = dict(params[p.name])
            pp["rot_prev"] = rot_prev
            pp["rot"] = rot_cur
            dsub, block = p.render(dstate[p.name], ddata[p.name], pp, n)
            d2[p.name] = dsub
            out = out + block
        return d2, out


class SpatialSceneControl:
    """Control for modifying a SpatialScene (spatial.rs:267-350)."""

    def __init__(self, scene):
        self._scene = scene

    def play(self, signal, options=None):
        return self._scene._play(signal, options or SpatialOptions())

    def play_buffered(self, signal, options=None, max_distance=100.0, rate=48000,
                      buffer_duration=0.1):
        return self._scene._play_buffered(
            signal, options or SpatialOptions(), max_distance, rate, buffer_duration
        )

    def set_listener_rotation(self, rotation):
        """Listener rotation as quaternion (s, x, y, z); an unrotated listener
        faces -Z with +X right and +Y up (spatial.rs:342-349)."""
        self._scene._set_listener_rotation(rotation)

    def read_tiers(self):
        """Per-pool snapshot of the active buffered read plan: main-pass
        ``(chunk, K)`` tier, sub-pass tier and occupancy, frozen/band voice
        counts from the last host sweep, and whether the pool is demoted
        off the tight 512-frame tier."""
        out = {}
        for p in self._scene._buffered_pools.values():
            cfg = p._read_cfg
            pv = (p._b_cache or {}).get("pv") or {}
            frozen = pv.get("frozen")
            band = pv.get("clamp")
            out[p.name] = {
                "kind": "dr",
                "read_cfg": cfg,
                "sub_cfg": p._sub_cfg,
                "listed": int(p._sub_list.size),
                "frozen": int(frozen.sum()) if frozen is not None else None,
                "band": int(band.sum()) if band is not None else None,
                "demoted": cfg is None or cfg[0] < 512,
            }
        return out

    def tier_events(self, drain=True):
        """Tier-transition log: ``{pool: [(t_scene, read_cfg, sub_cfg,
        listed), ...]}``; ``drain=True`` clears it."""
        out = {}
        for p in self._scene._buffered_pools.values():
            log = p._tier_log
            if log:
                out[p.name] = list(log)
                if drain:
                    log.clear()
        return out


class Spatial:
    """Control for updating the motion of a spatial signal (spatial.rs:119-157)."""

    def __init__(self, pool, slot, gen):
        self._pool = pool
        self._slot = slot
        self._gen = gen

    def _live(self):
        return self._pool.slot_gen[self._slot] == self._gen

    def set_motion(self, position, velocity, discontinuity=False):
        """spatial.rs:137-149 — last-value-wins, applied at the next block."""
        self._pool.push_motion(self._slot, self._gen, position, velocity, discontinuity)

    def is_finished(self):
        """Whether the signal has completed and can no longer be heard,
        accounting for propagation delay (spatial.rs:151-157), as of the
        last state sync."""
        return self._pool.handle_finished(self._slot, self._gen)
