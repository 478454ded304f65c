"""3D spatial audio scene (counterpart of oddio_tpu/spatial.py).

Reference: oddio's src/spatial.rs — ``SpatialScene`` spatializes
mono signals into stereo with panning, distance attenuation, doppler and
propagation delay.  Two voice families:

* ``play`` (spatial.rs:289-302): seekable sources re-sampled per ear at
  time-shifted, rate-warped positions (doppler by time warp) — the seek
  pools, elementwise tensor math.
* ``play_buffered`` (spatial.rs:314-340): sources pre-rendered into a
  per-voice delay ring and read back at fractional, time-varying offsets —
  the buffered pools, on the ring kernels of ``ops/ring_kernels.py``.

Chains that are device-resident capable play in device-resident pools
(``_SeekPoolDR``, ``_BufferedPoolDR``, streams included): their control
state lives on the device and the host keeps the JAX package's exact
bookkeeping (shared ring cursor, walk-bound mirrors, read-tier ladder,
family sub-pass plan, stream cursor mirrors) in numpy.  The rest play in
host pools, routed as the JAX package routes them: ``_SeekPool`` (seekable
chains with their own finish rule), ``_BufferedPool`` (Speed- or
Fader-wrapped streams, user signals; per-voice write cursors on the host,
K4 write and K5 read) and ``_BufferedPoolSingleton`` (a whole engine, such
as a Mixer, as one voice).  Device state is a dict of tensors under the JAX
package's keys, on the scene's ``device`` (the CUDA card unless the caller
passes another).  Per-block parameters stay numpy on the host and are
uploaded where a render uses them (a Renderer's block step hands them over
as tensors unpacked from one row on the device, ``core/drctrl.
device_param``); every lane of the delta arrays is applied on the device,
padding lanes dropped (``core/drctrl.scatter_drop_``).  Rings are updated
in place.  A scene whose every pool reads its per-block values from the
params, the state or its archetype entry (device-resident seek and
buffered pools of ``mixer._GRAPH_NODES`` chains: Sine, stream and sampler
voices, Cycle, Constant, FixedGain, Speed, Fader and the limiters, the
arena steps inside; host buffered pools of such chains with K4/K5's
operand record in the packed row; submixes whose engine captures)
declares ``graph_capture``: its Renderer then replays each block (or
idle group) as one CUDA graph.  Every render, stepped or op by op, reads
the host values of its run's own archetype (``render_archetype``).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .core.drctrl import (DRCtrlMixin, PinnedUpload, _upload, device_param, drop_lanes,
                          scatter_drop_, scatter_rows_drop_)
from .core.hostmath import (
    f32,
    full,
    quat_invert,
    quat_rotate,
    rem_euclid,
    rust_rem,
    v3_dot,
    v3_norm,
)
from .core.frames import FramesSignal
from .core.signal import Engine, default_device, render_as
from .mixer import _graph_chain, _ingest_leaves, render_submix
from .ops._dev import (
    exact_positions,
    masked_voice_sum,
    per_voice,
    scene_sum,
    split_ds,
)
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
    multi_rows,
    ring_select_ears,
    ring_select_multi,
    rows_append_cursor,
    select_window,
    strip_select_record,
    voice_record,
)
from .ops.stream_kernels import ring_place_plain, ring_place_record
from .ops.walk import WALK_KEYS, voice_walk, walk_geometry
from .parallel.context import (RenderDevice, add_block, current_scenes, in_block_step,
                               localize_index)
from .utils.profiler import count, span
from .utils.tree import tree_fill, tree_map, tree_stack

__all__ = [
    "SpatialScene",
    "SpatialSceneControl",
    "Spatial",
    "SpatialOptions",
    "SPEED_OF_SOUND",
    "HEAD_RADIUS",
]

DEFAULT_CAPACITY = 16

#: bounds the per-block doppler walk handled by the select kernels
K_DOPPLER = 64

#: row granularity of the host buffered pool's read-window cursors
RING_ROW = 128

_F32 = torch.float32
_I32 = torch.int32


def _emax(rate):
    """Per-ear start offsets within a shared read window sit in [0, emax):
    row granularity + the inter-ear distance in samples (|d_L - d_R| <=
    0.215 m, spatial.rs:571-598) + slack."""
    return RING_ROW + int(np.ceil(0.215 / float(SPEED_OF_SOUND) * rate)) + 2


def _host_write_counts(vcur, max_delay, adv, rate):
    """``voice_write_count`` on the host, in the same float32 operations:
    (count int32, the advanced cursors)."""
    c = (np.ceil((max_delay * np.float32(rate)).astype(np.float32)) + np.float32(1.0))
    un = (vcur + np.float32(adv)).astype(np.float32)
    end = np.fmod(un, c.astype(np.float32)).astype(np.float32)
    return (np.ceil(end) - np.ceil(vcur) + (un - end)).astype(np.int32), end


def _blockwise(node):
    """Whether what a chain renders can depend on where its blocks start:
    True unless every node is seekable (a pure function of time) and none
    can finish (a FramesSignal reads its end block by block)."""
    if not node.seekable or isinstance(node, FramesSignal):
        return True
    return any(_blockwise(c) for c in node.children().values())


_BEFORE_LEGS = {}


def _before_legs(FP, cap, M, device):
    """(cap, 2) int64: for a write cursor ``s``, the flat ring columns of
    pool index ``s - 1`` (wrapping), primary and mirror (the dump slack
    past the mirror where the index lies outside it).  A constant of the
    layout, made once a device, outside any graph capture (the pool's
    first state makes it)."""
    key = (FP, cap, M, str(device))
    legs = _BEFORE_LEGS.get(key)
    if legs is None:
        p = (np.arange(cap, dtype=np.int64) - 1) % cap
        legs = np.stack([FP + p, FP + cap + np.minimum(p, M)], axis=1)
        legs = _BEFORE_LEGS[key] = torch.as_tensor(legs, device=device)
    return legs


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


def _ear_states(position, radius):
    """EarState::new for both ears (spatial.rs:530-550), numpy: offsets
    (V, 2) seconds (negative) and gains (V, 2)."""
    rel = position[:, None, :] - EAR_POS[None, :, :]  # (V, 2, 3)
    distance = v3_norm(rel)  # (V, 2)
    offset = distance * (np.float32(-1.0) / SPEED_OF_SOUND)
    distance_gain = radius[:, None] / np.maximum(distance, radius[:, None])
    inv = (np.float32(0.5) / distance).astype(np.float32)
    scaled = position[:, None, :] * inv[:, :, None]
    d = v3_dot(EAR_DIR[None, :, :], scaled)
    stereo_gain = np.float32(0.5) + np.where(
        distance < np.float32(1e-3), np.float32(0.5), d
    )
    return offset.astype(np.float32), (stereo_gain * distance_gain).astype(np.float32)


class _VoicePool:
    """Host pools' shared voice bookkeeping (the JAX package's
    ``_VoicePool``): the motion swap channels, smoothing state, lingering
    reclamation and slot lifecycle, all numpy columns on the host.  The
    voices' chain is one batched template (``sig``) whose device leaves
    live on the pool's device."""

    is_dr = False
    #: the pool's device; inside a pack's mesh cell, the cell's
    device = RenderDevice()

    #: set by a ScenePack holding this pool's device state: called with
    #: ``drop`` True before growth (the pack's stack goes back into the
    #: scenes), False before a play's in-place slot reset (the scenes take
    #: views of the stack)
    _unpack_hook = None

    def __init__(self, name, spec, capacity, device):
        self.name = name
        self.proto = spec
        self.device = torch.device(device)
        self.sig = spec.clone_batched(capacity)
        self.sig._set_device(self.device)
        self.capacity = capacity
        self._alloc_cols(capacity)
        self._free = list(range(capacity - 1, -1, -1))

    def _alloc_cols(self, V):
        self.mask = np.zeros(V, dtype=bool)
        self.stopped = np.zeros(V, dtype=bool)
        self.slot_gen = np.zeros(V, dtype=np.int64)
        self.radius = full((V,), 0.1)
        self.motion_pos = full((V,), 0.0, extra=(3,))
        self.motion_vel = full((V,), 0.0, extra=(3,))
        self.pend_flag = np.zeros(V, dtype=bool)
        self.pend_pos = full((V,), 0.0, extra=(3,))
        self.pend_vel = full((V,), 0.0, extra=(3,))
        self.pend_disc = np.zeros(V, dtype=bool)
        self.prev_position = full((V,), 0.0, extra=(3,))
        self.dt = full((V,), 0.0)
        self.finished_for = full((V,), np.nan)

    _COL_NAMES = (
        "mask stopped slot_gen radius motion_pos motion_vel pend_flag pend_pos "
        "pend_vel pend_disc prev_position dt finished_for"
    ).split()

    def _pull_pack(self, drop=True):
        if self._unpack_hook is not None:
            self._unpack_hook(drop)

    def grow(self):
        self._pull_pack()
        old = self.capacity
        new = old * 2
        self.sig.grow_batched(new)
        saved = {c: getattr(self, c) for c in self._COL_NAMES}
        self._alloc_cols(new)
        for c, v in saved.items():
            getattr(self, c)[:old] = v
        self._free = list(range(new - 1, old - 1, -1)) + self._free
        self.capacity = new

    def claim(self, spec, options):
        if not self._free:
            self.grow()
        i = self._free.pop()
        gen = int(self.slot_gen[i])
        self.sig.write_slot(i, spec, self, gen)
        spec._moved = True
        self._pull_pack(drop=False)
        self.sig.device_reset_slot(i)
        self.mask[i] = True
        self.stopped[i] = False
        self.radius[i] = options.radius
        self.motion_pos[i] = options.position
        self.motion_vel[i] = options.velocity
        self.pend_flag[i] = False
        self.prev_position[i] = options.position  # State::new (spatial.rs:494-499)
        self.dt[i] = 0.0
        self.finished_for[i] = np.nan
        return i, gen

    def common_walk(self, prev_rot, rot, elapsed):
        """walk_set's per-voice prologue (spatial.rs:204-261), vectorized:
        motion refresh + smoothing, rotation into listener space, lingering
        reclamation.  Returns (prev_position, next_position) in listener
        space, both (V, 3)."""
        inner_finished = self.sig.host_is_finished()
        upd = self.pend_flag.copy()
        # spatial.rs:216-227: on refresh, prev_position snaps to the
        # discontinuity target or to the smoothed estimate under the OLD motion
        sm_orig = _smooth_host(
            self.prev_position, self.dt, 0.0, self.motion_pos, self.motion_vel
        )
        new_prev = np.where(self.pend_disc[:, None], self.pend_pos, sm_orig)
        self.prev_position = np.where(upd[:, None], new_prev, self.prev_position).astype(
            np.float32
        )
        self.dt = np.where(upd, np.float32(0.0), self.dt).astype(np.float32)
        self.motion_pos = np.where(upd[:, None], self.pend_pos, self.motion_pos).astype(
            np.float32
        )
        self.motion_vel = np.where(upd[:, None], self.pend_vel, self.motion_vel).astype(
            np.float32
        )
        self.pend_flag[:] = False

        # spatial.rs:228-235: rotate smoothed start/end positions
        sm0 = _smooth_host(
            self.prev_position, self.dt, 0.0, self.motion_pos, self.motion_vel
        )
        sm1 = _smooth_host(
            self.prev_position, self.dt, elapsed, self.motion_pos, self.motion_vel
        )
        prev_position = quat_rotate(prev_rot[None, :], sm0)
        next_position = quat_rotate(rot[None, :], sm1)
        self.dt = (self.dt + np.float32(elapsed)).astype(np.float32)

        # spatial.rs:241-261: lingering reclamation with propagation delay
        distance = v3_norm(prev_position)
        lingering = ~np.isnan(self.finished_for)
        expire = lingering & (self.finished_for > distance / SPEED_OF_SOUND)
        self.stopped |= expire & self.mask
        self.finished_for = np.where(
            lingering & ~expire,
            (self.finished_for + np.float32(elapsed)).astype(np.float32),
            self.finished_for,
        )
        newly = self.mask & ~lingering & inner_finished
        self.finished_for = np.where(newly, np.float32(elapsed), self.finished_for)

        drop = self.mask & self.stopped
        if drop.any():
            self.mask &= ~drop
            for i in np.nonzero(drop)[0]:
                self.slot_gen[i] += 1
                self._free.append(int(i))
        return prev_position, next_position

    # handle interface shared with the DR pools
    def push_motion(self, slot, gen, pos, vel, disc):
        if self.slot_gen[slot] == gen:
            self.pend_pos[slot] = f32(pos)
            self.pend_vel[slot] = f32(vel)
            self.pend_disc[slot] = bool(disc)
            self.pend_flag[slot] = True

    def handle_finished(self, slot, gen):
        if self.slot_gen[slot] != gen:
            return True
        return bool(self.stopped[slot])

    def sync(self):
        """Host pools keep their handle state on the host."""

    def sync_prefetch(self):
        """Nothing to prefetch (see ``sync``)."""

    def _upload(self, x, dtype=None):
        return _upload(x, self.device, dtype)

    def params_voice_axes(self, params):
        """Which param leaves carry a leading voice axis: every one of a
        host pool (per-voice columns), none of a singleton's (its one
        voice is a whole submix, which a ScenePack keeps on one voice
        shard)."""
        return tree_fill(params, not getattr(self, "is_singleton", False))

    state_voice_axes = params_voice_axes


class _BufferedPool(_VoicePool):
    """``play_buffered`` voices whose chains are not device-resident
    capable (Speed- or Fader-wrapped streams, user signals): per-voice
    delay rings on the device, per-voice write cursors and the geometry on
    the host (the JAX package's ``_BufferedPool``, cursor math term for
    term).

    The ring is ``(V, L)``: both kernels address each voice's ring
    directly, K4 (``ring_place``) writing ``n_write`` samples at
    ``start mod L`` and K5 (``strip_select``) reading both ears from
    ``128*rrow + extra_e`` onward, so the TPU's row strips (gathered,
    placed, scattered back) have no counterpart.  Its bytes are the JAX
    package's ``(V*L/128, 128)`` ring in the same order, so state carries
    across by a reshape.  Blocks outside the strip gate (fast movers, odd
    block sizes) take the exact elementwise read, plain torch as it is
    plain XLA in the JAX package."""

    def __init__(self, name, spec, capacity, rate, ring_len, device):
        self.rate = int(rate)
        self.ring_len = int(ring_len)
        if self.ring_len % RING_ROW:
            raise ValueError(f"ring length {ring_len} must be a multiple of {RING_ROW}")
        self._n_inner = 1
        self._use_strips = True
        super().__init__(name, spec, capacity, device)
        self.ring = None  # (V, ring_len) on the device, created lazily
        self._records = PinnedUpload(self.device)  # K4/K5's operand records

    def _alloc_cols(self, V):
        super()._alloc_cols(V)
        self.write = full((V,), 0.0)
        self.max_delay = full((V,), 0.0)

    _COL_NAMES = _VoicePool._COL_NAMES + ["write", "max_delay"]

    def grow(self):
        old = self.capacity
        super().grow()
        if self.ring is not None:
            add = torch.zeros((self.capacity - old, self.ring_len), dtype=_F32,
                              device=self.device)
            self.ring = torch.cat([self.ring, add])

    def ring_state(self):
        if self.ring is None:
            self.ring = torch.zeros((self.capacity, self.ring_len), dtype=_F32,
                                    device=self.device)
        return self.ring

    def play(self, spec, options, max_delay):
        i, gen = self.claim(spec, options)
        cap = int(np.ceil(np.float32(max_delay) * np.float32(self.rate))) + 1
        if cap > self.ring_len:
            raise ValueError("max_delay exceeds the pool's ring length")
        self.max_delay[i] = np.float32(max_delay)
        # SpatialSignalBuffered::new (spatial.rs:39-43): pre-delay the ring by
        # min(|position|/c, max_delay), with the pool's uniform modulus
        d = np.minimum(
            v3_norm(f32(options.position)[None, :])[0] / SPEED_OF_SOUND,
            np.float32(max_delay),
        )
        self.write[i] = rust_rem(
            np.float32(self.rate) * np.float32(d), np.float32(self.ring_len)
        )
        self.ring_state()[i] = 0.0
        return i, gen

    def host_prepare(self, prev_rot, rot, interval, n):
        elapsed = (f32(interval) * np.float32(n)).astype(np.float32)
        prev_position, next_position = self.common_walk(prev_rot, rot, elapsed)
        V = self.capacity
        ratef = np.float32(self.rate)
        L = self.ring_len
        capf = np.float32(L)

        # Ring::write bookkeeping (ring.rs:18-41), uniform modulus; the
        # UNWRAPPED end keeps n_write right when a block advances by >= L
        w = self.write
        w_un = (w + elapsed * ratef).astype(np.float32)
        end = rust_rem(w_un, capf)
        start_idx = np.ceil(w).astype(np.int64)
        n_write = (np.ceil(w_un).astype(np.int64) - start_idx).astype(np.int32)
        self.write = end.astype(np.float32)
        # static per (block size, interval): upper bound on any voice's write
        self._n_inner = int(np.ceil(np.float64(elapsed) * self.rate)) + 1 if n > 0 else 1
        inner_interval = np.full(V, np.float32(1.0) / ratef, np.float32)
        inner_params = self._inner_prepare(inner_interval, self._n_inner, n_write)

        # per-ear offsets/gains (spatial.rs:409-431)
        prev_off, prev_gain = _ear_states(prev_position, self.radius)
        next_off, next_gain = _ear_states(next_position, self.radius)
        prev_off = np.maximum((prev_off - elapsed).astype(np.float32), -self.max_delay[:, None])
        next_off = np.maximum(next_off, -self.max_delay[:, None])
        nf = np.float32(n) if n > 0 else np.float32(1.0)
        dt_e = ((next_off - prev_off) / nf).astype(np.float32)
        d_gain = ((next_gain - prev_gain) / nf).astype(np.float32)
        # Ring::sample base offset (ring.rs:57): (write' + t*rate) rem_euclid cap
        offset0 = rem_euclid(
            (self.write[:, None] + prev_off * ratef).astype(np.float32), capf
        )
        # an exact integer base and a fractional start (ops/_dev.py)
        obase = np.floor(offset0)
        ds = (dt_e * ratef).astype(np.float32)
        ds_int, f_hi, f_lo = split_ds(ds)
        params = {"inner": inner_params}
        # the strip read needs the walk bound: positions step at ds =
        # (ring rate / scene rate) x doppler, so |ds - 1| * n must stay
        # under K; supersonic motion or a frozen -max_delay clamp (ds = 0,
        # spatial.rs:414-415) takes the exact elementwise read
        live = self.mask
        walk = (
            float(np.abs(ds[live] - np.float32(1.0)).max()) * n
            if live.any()
            else 0.0
        )
        self._use_strips = bool(
            self._n_inner <= PAGE + 1
            and 0 < n <= 640
            and walk <= K_DOPPLER
        )
        start_i = start_idx.astype(np.int32)
        ob = obase.astype(np.int32)
        # the exact route's operands; a ScenePack whose other scenes leave
        # the strip gate this block ships them instead (``exact_params``)
        self._exact = {
            "mask": self.mask.copy(), "n_write": n_write, "gain0": prev_gain,
            "d_gain": d_gain, "start": start_i, "obase": ob,
            "ofrac": (offset0 - obase).astype(np.float32), "ds_int": ds_int,
            "f_hi": f_hi, "f_lo": f_lo,
        }
        if self._use_strips:
            # one write cursor per voice, ONE shared read window for both
            # ears; every operand of K4 and K5 in one record per voice
            K = K_DOPPLER
            wrow = start_i // RING_ROW
            dlr = np.mod(ob[:, 0] - ob[:, 1], L)
            DMAX = _emax(self.rate) - RING_ROW
            l_ahead = dlr <= DMAX
            cm = np.where(l_ahead, ob[:, 1], ob[:, 0])
            dstart = np.stack(
                [np.where(l_ahead, dlr, 0), np.where(l_ahead, 0, L - dlr)],
                axis=-1,
            )
            dstart = np.clip(dstart, 0, DMAX)
            rstart = np.mod(cm - K, L)
            rrow = (rstart // RING_ROW).astype(np.int32)
            scal = np.stack(
                [
                    (offset0 - obase).astype(np.float32),
                    f_hi, f_lo, ds_int.astype(np.float32),
                ],
                axis=-1,
            )
            params["rec"] = voice_record(
                rrow, (rstart - rrow * RING_ROW)[:, None] + dstart, scal, prev_gain,
                d_gain, self.mask, wrow, start_i - wrow * RING_ROW, n_write,
            )
        else:
            params.update(self._exact)
        return params

    def exact_params(self, params):
        """This block's params (as ``host_prepare`` returned them) on the
        exact elementwise route."""
        out = {k: v for k, v in params.items() if k != "rec"}
        out.update(self._exact)
        return out

    def _inner_prepare(self, inner_interval, n_inner, n_write):
        return self.sig.host_prepare(inner_interval, n_inner, count=n_write)

    def _inner_render(self, dstate, ddata, params, n_inner):
        dd = ddata.get("inner", {})
        rb = getattr(self.sig, "render_batched", None)
        if rb is not None:
            # pool-level read of a bare Stream chain (K6 where it fits)
            return rb(dstate["inner"], dd, params["inner"], n_inner)
        return self.sig.render_host(dstate["inner"], dd, params["inner"], n_inner)

    def render(self, dstate, ddata, params, n):
        n_inner = self._n_inner
        dev = self.device

        def up(x, dtype=None):
            # a block step's views of its row, or numpy uploaded (eager)
            return device_param(x, dev, dtype)

        dsub, blocks = self._inner_render(dstate, ddata, params, n_inner)
        samples = blocks[:, 0, :].contiguous()  # (V, n_inner) mono
        ring = dstate["ring"]  # (V, L), updated in place
        V, L = ring.shape
        S = current_scenes()  # a pack's rows: S scenes, mixed apart

        if not self._use_strips:
            # exact elementwise write and read (any ratio, any walk): the
            # write a masked scatter at start mod L, as K4's plain version
            ring_place_plain(ring, samples, up(params["start"], _I32),
                             up(params["n_write"], _I32))
            whole, fr = exact_positions(
                up(params["ofrac"]), up(params["ds_int"]), up(params["f_hi"]),
                up(params["f_lo"]), n,
            )
            x = torch.remainder(up(params["obase"])[:, :, None] + whole, L).to(torch.int64)

            def look(ix):
                return torch.gather(ring, 1, ix.reshape(V, 2 * n)).reshape(V, 2, n)

            a = look(x)
            b = look(torch.remainder(x + 1, L))
            s = a + fr * (b - a)
            jn = torch.arange(n, dtype=_F32, device=dev)
            gains = up(params["gain0"])[:, :, None] + jn * up(params["d_gain"])[:, :, None]
            out = masked_voice_sum(up(params["mask"]), s * gains, S)
            return {"ring": ring, "inner": dsub}, out

        # ring write (ring.rs:18-41) through K4 at start mod L, then the
        # two-ear read through K5 (ring.rs:51-79, spatial.rs:409-431), both
        # on the block's operand record: in a block step a view of its row
        # (no cast: its int32 fields are float32 bit patterns), op by op
        # shipped with one copy
        rec = device_param(params["rec"], dev, upload=self._records)
        ring_place_record(ring, samples, rec)
        out = strip_select_record(ring, rec, n=n, K=K_DOPPLER, scenes=S)
        return {"ring": ring, "inner": dsub}, out


class _BufferedPoolSingleton(_BufferedPool):
    """A one-voice buffered pool for a non-batchable signal: a whole engine
    (a ``Mixer`` submix, a nested scene) played into the scene, which the
    reference allows for any Signal (spatial.rs:314-340).  The voice's
    signal renders unbatched on its own device (the scene's); the geometry
    walk, ring cursors and the K4/K5 pair at V = 1 are the host buffered
    pool's."""

    is_singleton = True
    #: where a ScenePack finds the submix engine's params and state
    INNER_PARAMS = INNER_STATE = "inner"

    def __init__(self, name, spec, rate, ring_len, device):
        self.name = name
        self.proto = spec
        self.sig = spec
        self.device = torch.device(device)
        self.capacity = 1
        self._alloc_cols(1)
        self._free = [0]
        self.rate = int(rate)
        self.ring_len = int(ring_len)
        if self.ring_len % RING_ROW:
            raise ValueError(f"ring length {ring_len} must be a multiple of {RING_ROW}")
        self._n_inner = 1
        self._use_strips = True
        self.ring = None
        self._records = PinnedUpload(self.device)

    def grow(self):
        raise RuntimeError("singleton pools hold exactly one voice")

    def claim(self, spec, options):
        i = 0
        gen = int(self.slot_gen[i])
        spec._moved = True
        self._pull_pack(drop=False)  # the ring's row resets in place
        self.mask[i] = True
        self.stopped[i] = False
        self.radius[i] = options.radius
        self.motion_pos[i] = options.position
        self.motion_vel[i] = options.velocity
        self.pend_flag[i] = False
        self.prev_position[i] = options.position
        self.dt[i] = 0.0
        self.finished_for[i] = np.nan
        return i, gen

    def _inner_prepare(self, inner_interval, n_inner, n_write):
        # an engine takes a scalar interval and count
        return self.sig.host_prepare(
            np.float32(inner_interval[0]), n_inner, count=int(n_write[0])
        )

    def _inner_render(self, dstate, ddata, params, n_inner):
        # (1, C, n_inner); in a pack the submix renders its S scenes, S rows
        return render_submix(self.sig, dstate["inner"], ddata.get("inner", {}),
                             params["inner"], n_inner)

    def sync(self):
        """A submix engine's own handle state (its device-resident pools)."""
        if isinstance(self.sig, Engine):
            self.sig.sync()

    def sync_prefetch(self):
        if isinstance(self.sig, Engine):
            self.sig.sync_prefetch()


class _SeekPool(_VoicePool):
    """``play()`` voices whose chains are not device-resident capable (a
    seekable signal with its own finish rule): deterministic sources
    re-sampled per ear with warped time (doppler by time warp,
    spatial.rs:438-470), as two batched renders per block; no kernel."""

    def host_prepare(self, prev_rot, rot, interval, n):
        elapsed = (f32(interval) * np.float32(n)).astype(np.float32)
        prev_position, next_position = self.common_walk(prev_rot, rot, elapsed)
        prev_off, prev_gain = _ear_states(prev_position, self.radius)
        next_off, next_gain = _ear_states(next_position, self.radius)
        nf = np.float32(n) if n > 0 else np.float32(1.0)
        # spatial.rs:449-453
        effective = ((np.float32(elapsed) + next_off) - prev_off).astype(np.float32)
        dt_e = (effective / nf).astype(np.float32)
        d_gain = ((next_gain - prev_gain) / nf).astype(np.float32)
        ear_params = []
        for e in (0, 1):
            self.sig.host_seek(prev_off[:, e])  # initial real time -> delayed
            ear_params.append(self.sig.host_prepare(dt_e[:, e], n))
            # final delayed -> initial real time (spatial.rs:465)
            self.sig.host_seek((-effective[:, e] - prev_off[:, e]).astype(np.float32))
        self.sig.host_seek(np.full(self.capacity, elapsed, np.float32))
        return {
            "mask": self.mask.copy(),
            "earL": ear_params[0],
            "earR": ear_params[1],
            "gain0": prev_gain,
            "d_gain": d_gain,
        }

    def render(self, dstate, ddata, params, n):
        dd = ddata.get("inner", {})
        up = self._upload
        d2, bL = self.sig.render_host(dstate["inner"], dd, params["earL"], n)
        d3, bR = self.sig.render_host(d2, dd, params["earR"], n)
        s = torch.stack([bL[:, 0, :], bR[:, 0, :]], dim=1)  # (V, 2, n)
        jn = torch.arange(n, dtype=_F32, device=self.device)
        gains = up(params["gain0"])[:, :, None] + jn * up(params["d_gain"])[:, :, None]
        return {"inner": d3}, masked_voice_sum(up(params["mask"]), s * gains,
                                               current_scenes())


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
    INDEX_PARAMS = ("play_idx", "mot_idx")

    #: per-voice geometry/lifecycle columns common to every DR pool kind
    GEOM_KEYS = (
        "mask", "stopped", "finished_for", "radius", "motion_pos",
        "motion_vel", "prev_position", "smdt",
    )
    #: state keys carried in play rows (subclasses extend)
    ROW_KEYS = GEOM_KEYS

    def _init_base(self, name, spec, capacity, k_motion, k_play, device):
        self.name = name
        # ingest-needing chains (streams) keep BATCHED host mirror columns:
        # the pool's shadow of the device cursors plus the per-slot
        # producer queues (Stream.dr_bind_slot)
        self.proto = (
            spec.clone_batched(capacity) if spec.dr_needs_ingest() else spec
        )
        self.device = torch.device(device)
        # the chain's read-only device data (sample arenas) on this device
        self.proto._set_device(self.device)
        #: ingest leaves of the batched proto (identity survives growth)
        self._ingest_leaves = _ingest_leaves(self.proto) if self.proto.batch else []
        self.capacity = capacity
        self.k_motion = k_motion
        self.k_play = k_play
        self._elapsed = 0.0
        self.slot_gen = np.zeros(capacity, dtype=np.int64)
        self._free = list(range(capacity - 1, -1, -1))
        self.mask_host = np.zeros(capacity, dtype=bool)
        self.stopped_host = np.zeros(capacity, dtype=bool)
        self.pending_plays = []  # (slot, row tree)
        #: plays queued into each slot so far: a digest keeps a copy, so a
        #: sync from it never frees a slot played after it was taken
        self._played = np.zeros(capacity, dtype=np.int64)
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
        self._pull_pack()
        old = self.capacity
        new = old * 2
        self._ctrl_grow(old, new)
        self.dr_state()
        fresh = self._fresh_state(old)
        self.state = self._concat_state(self.state, fresh)
        self.slot_gen = np.concatenate([self.slot_gen, np.zeros(old, np.int64)])
        self.mask_host = np.concatenate([self.mask_host, np.zeros(old, bool)])
        self.stopped_host = np.concatenate([self.stopped_host, np.zeros(old, bool)])
        self._played = np.concatenate([self._played, np.zeros(old, np.int64)])
        self._free = list(range(new - 1, old - 1, -1)) + self._free
        self._g_prev = np.concatenate([self._g_prev, np.zeros((old, 3), np.float32)])
        self._g_mpos = np.concatenate([self._g_mpos, np.zeros((old, 3), np.float32)])
        self._g_mvel = np.concatenate([self._g_mvel, np.zeros((old, 3), np.float32)])
        self._g_smdt = np.concatenate([self._g_smdt, np.zeros(old, np.float32)])
        self._b_cache = None
        if self.proto.batch:
            self.proto.grow_batched(new)
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
        self._fade_claim_reset(i)
        self._fade_mirror_on_play(i, spec)
        self._track_spec(i, spec)
        if self.proto.batch:
            self.proto.dr_bind_slot(i, spec, self, gen)
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
        self._played[i] += 1
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

    def sync(self):
        super().sync()
        # handle queries until the next block read what this sync applied
        self._sync_seen = getattr(self, "_prep_count", 0)

    def _clear_rows(self, S, lanes):
        """Reset layout-sensitive per-slot state (delay rings) for the
        slots of the ``drop_lanes`` plan ``lanes``."""

    def _scatter_rows(self, S, idx, rows):
        """Write play rows (one per lane, numpy or tensors) at slots
        ``idx``, padding lanes dropped, every leaf in place."""
        lanes = drop_lanes(device_param(idx, self.device), S["mask"].shape[0])
        for k in self.ROW_KEYS + ("inner",):
            scatter_rows_drop_(S[k], rows[k], lanes)
        self._clear_rows(S, lanes)

    def _apply_plays_eager(self):
        """Apply all pending plays directly to device state (the bulk-setup
        path, outside the per-block step)."""
        self._pull_pack()
        self.dr_state()
        idx = np.array([i for i, _ in self.pending_plays], np.int64)
        rows = tree_stack([r for _, r in self.pending_plays])
        self.pending_plays = []
        count("plays.eager", len(idx))
        S = dict(self.state)
        self._scatter_rows(S, idx, rows)
        self.state = S

    def sync_prefetch(self):
        """Start the (asynchronous on CUDA) device->host copy of the packed
        handle-visible state so a following sync() need not stall, nor
        wait for what is queued after it."""
        self._sync_start()

    def _on_freed(self):
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
        # reports the channel could not take this block (``k_motion``)
        count("motion.deferred", len(self.pending_motion))
        return params

    def _walk_controls(self, S, params):
        """The walk's first step on the device, in place in the dict ``S``:
        plays, control-field deltas and fade starts."""
        # 1. plays (set.rs insert semantics: applied before the walk)
        if "play_idx" in params:
            self._scatter_rows(S, localize_index(params["play_idx"], S["mask"].shape[0]),
                               params["play"])
        # 1b. control-field deltas (set_gain/set_speed/..., gain.rs:103-108)
        S["inner"] = self._ctrl_apply(S["inner"], params)
        # 1c. fade starts (fader.rs:86-93 swap-channel delivery)
        S["inner"] = self._fade_apply(S["inner"], params)

    def _motion_lanes(self, params, V):
        """The block's motion lanes as ``ops.walk`` takes them (slots, their
        positions, velocities and discontinuity flags, on the device), or
        None on a block that ships none."""
        if "mot_idx" not in params:
            return None
        dev = self.device
        return (device_param(localize_index(params["mot_idx"], V), dev, _I32),
                device_param(params["mot_pos"], dev, _F32),
                device_param(params["mot_vel"], dev, _F32),
                device_param(params["mot_disc"], dev, torch.bool))

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
        # warp steps are the scene interval times the doppler factor; 1.25
        # covers the clamped |v|/c range (K_DOPPLER) with margin
        self._ds_small = self._ds_flag_sync(float(f32(interval)) * 1.25, n)
        params = self._delta_params({}, force)
        self._g_smdt = (self._g_smdt + np.float32(self._elapsed)).astype(np.float32)
        return params

    def render(self, dstate, ddata, params, n):
        S = dict(dstate)
        elapsed = np.float32(self._elapsed)
        # the walk (spatial.rs:204-261) op by op: plays, control and fade
        # lanes, motion, smoothed and rotated positions, lingering
        self._walk_controls(S, params)
        mask, prev_pos, next_pos = walk_geometry(
            S, self._motion_lanes(params, S["mask"].shape[0]), params["rot_prev"],
            params["rot"], elapsed, self.proto.dr_is_finished(S["inner"]))

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
        return S, scene_sum(contrib, current_scenes())


class _BufferedPoolDR(_DRPoolBase):
    """Device-resident buffered pool: delay rings on the device.

    Ring storage is rows-native per voice, ``(V, RPV, 128)``, covering the
    flat per-voice span ``F + L + M + SLACK`` (front pad, ring, mirror —
    cols ``[F+L, F+L+M)`` replicate ``[F, F+M)`` — and dump slack), the
    JAX package's layout, so state carries across leaf by leaf.  The pool
    shares one write cursor, so the per-block append is one slab write
    (``rows_append_cursor``, K1) into every voice, primary and mirror
    legs, in place.  Each read is one kernel launch straight from the ring
    (``ring_select_ears``, K2; ``ring_select_multi``, K3, for fused idle
    groups), on the operands ``_advance_block`` leaves on the device: the
    walk, the voices' own cursors and the read preparation are one launch
    too (``ops.walk.voice_walk``), after the plays and control lanes.
    """

    ROW_KEYS = _DRPoolBase.GEOM_KEYS + ("max_delay", "phase", "tight", "vcur", "vbase")
    #: the family sub-pass list (slot numbers of the scene's own pool)
    SCENE_PARAMS = ("sub_idx", "sub_on")
    #: the pool write cursor and the fixed-size sub-pass list
    SCENE_STATE = ("wcur", "sub_idx", "sub_on")

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
        #: host twin of the voices' own ring cursors ("vcur"), for the
        #: mirrors that advance by each voice's write count (fade progress,
        #: stream cursors); None in a pool that keeps neither
        self._vc_host = (np.zeros(capacity, np.float32)
                         if self.fade_paths or self.proto.batch else None)
        #: whether each source advances by its own ring cursor's count (a
        #: chain whose samples do not depend on where blocks start keeps
        #: the pool's count, and the work that takes)
        self._own_counts = _blockwise(self.proto)
        #: family sub-pass: the shipped wide-voice list, its tier for this
        #: block, and the ship-pending flag
        self._sub_list = np.zeros(0, np.int64)
        self._sub_cfg = None
        self._sub_dirty = False
        #: tier-transition log (SpatialSceneControl.tier_events)
        self._tier_log = []
        self._tier_last = None
        #: pack-wide walk-bound floor (a ScenePack renders its scenes'
        #: pools as one, so they must agree on the read tier)
        self._dmax_floor = 0.0

    # -- state ---------------------------------------------------------------

    @property
    def rowlen(self):
        return self.W_CHUNK + self.ring_len + self.M_PAD + self.W_CHUNK

    def _ring_shape(self, V):
        return (V, self.rowlen // 128, 128)

    def _extra_zero(self, V):
        dev = self.device
        _before_legs(self.W_CHUNK, self.cap_pool, self.M_PAD, torch.empty(0, device=dev).device)
        return {
            "ring": torch.zeros(self._ring_shape(V), dtype=_F32, device=dev),
            "max_delay": torch.zeros(V, dtype=_F32, device=dev),
            "phase": torch.zeros(V, dtype=_F32, device=dev),
            # each voice's own ring cursor, as the reference keeps it
            # (ring.rs:18-41: f32, modulo the voice's capacity), and the
            # pool ring index of the voice ring's index 0 in its current lap
            "vcur": torch.zeros(V, dtype=_F32, device=dev),
            "vbase": torch.zeros(V, dtype=_I32, device=dev),
            # samples the voice's source runs ahead of the pool's cursor:
            # 1 from the block after its cursor wrote one short, else 0
            "lag": torch.zeros(V, dtype=_I32, device=dev),
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
        keep = {k: st.pop(k) for k in self.SCENE_STATE}
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
        if self._vc_host is not None:
            self._vc_host = np.concatenate([self._vc_host, np.zeros(old, np.float32)])

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
        # the reference's own cursor: sample s lands at voice ring index
        # ceil(w0) + s and at pool index ceil(W) + s
        row["vcur"] = w0
        row["vbase"] = np.int32((int(np.ceil(W)) - int(np.ceil(w0))) % self.cap_pool)
        row["max_delay"] = np.float32(max_delay)
        row["tight"] = np.float32(1.0)  # reused slots rejoin the main pass
        row["inner"] = spec.dr_slot_row(self.interval_inner)
        self._md_host[i] = np.float32(max_delay)
        if self._vc_host is not None:
            self._vc_host[i] = w0
        self._queue_play(i, row)
        return i, gen

    def _default_row(self):
        row = super()._default_row()
        row["max_delay"] = np.float32(0)
        row["phase"] = np.float32(0)
        row["vcur"] = np.float32(0)
        row["vbase"] = np.int32(0)
        row["tight"] = np.float32(1.0)
        return row

    def _clear_rows(self, S, lanes):
        """Zero the delay rings and lags of newly played slots, in place."""
        scatter_drop_(S["ring"], lanes, S["ring"].new_zeros(()))
        if "lag" in S:
            scatter_drop_(S["lag"], lanes, S["lag"].new_zeros(()))

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
        events (a decaying smoothing transition, a pending sub-pass
        membership change, or a sub-pass list a pack-wide floor clears)."""
        if getattr(self, "_sub_dirty", False):
            return True
        if self._dmax_floor > 0.0 and self._sub_list.size:
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

    def cursor_params(self):
        """The write cursor's per-block scalars ``w``, ``nw``, ``wstart``
        of the last ``host_prepare``, shipped or not."""
        return dict(self._w_last)

    def tier_bound(self, interval, n):
        """PRE-drain conservative walk bound for pack-wide tier agreement
        (a ScenePack renders every scene's pool as one): the post-drain
        bound any aligned pool can compute this block is <= this value, so
        max-over-pack of tier_bound is a sound shared floor.  Transient
        terms are capped exactly like ``_block_b``."""
        elapsed = float(np.float32(f32(interval) * np.float32(n)))
        ratio = float(np.float32(self.rate) * f32(interval))
        C = float(SPEED_OF_SOUND)
        T = float(POSITION_SMOOTHING_PERIOD)
        b_cap = max(
            0.0, (64.0 / min(512, max(n, 1)) - abs(ratio - 1.0)) / max(ratio, 1e-9)
        )
        b = self._block_b(elapsed, n, ratio, 0.0)
        margin = 2.0 / self.rate + 1e-4
        for slot, (p, v, d) in self.pending_motion.items():
            sm = _smooth_host(
                self._g_prev[slot : slot + 1],
                self._g_smdt[slot : slot + 1],
                0.0,
                self._g_mpos[slot : slot + 1],
                self._g_mvel[slot : slot + 1],
            )[0]
            vn = float(np.linalg.norm(np.asarray(v, np.float64)))
            trans = (
                0.0 if d else float(np.linalg.norm(np.asarray(p, np.float64) - sm)) / T
            )
            steady_p = (1.05 * vn + 0.5) / C
            full_p = (1.05 * (vn + trans) + 0.5) / C
            np_ = float(np.linalg.norm(np.asarray(p, np.float64)))
            ns_ = float(np.linalg.norm(sm.astype(np.float64)))
            d_hi = max(np_, ns_) + float(HEAD_RADIUS) + (vn + trans) * elapsed
            d_lo = min(np_, ns_) - float(HEAD_RADIUS) - (vn + trans) * elapsed
            if d_lo / C >= float(self._md_host[slot]) + margin:
                # certainly frozen for this block: rides the select
                # kernel's frozen branch, exempt from the walk bound
                steady_p = full_p = 0.0
            elif d_hi / C >= float(self._md_host[slot]) - elapsed - margin:
                steady_p = max(steady_p, 1.0)
                full_p = max(full_p, 1.0)
            b = max(b, max(steady_p, min(full_p, max(b_cap, steady_p))))
        return b

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
        # the render's walk route: the hand kernel on a card, the torch
        # chain (its plain version) elsewhere
        count("walk.fused" if self.device.type == "cuda" else "walk.chain")
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
        self._w_last = dict(params)
        # deltas ship (and mirror-update) BEFORE the tier choice: shipped
        # motion applies on this block
        with span("pool.deltas", pool=self.name):
            params = self._delta_params(params, force)
        # fader bookkeeping rides the inner timebase (faders advance by the
        # ring-write frame count, like every inner node), before the flag
        # sync: a released fade's target renders this block
        counts = n_write
        if self._vc_host is not None:
            # the device's per-voice write counts (voice_write_count)
            vc, self._vc_host = _host_write_counts(self._vc_host, self._md_host, advf, self.rate)
            if self._w_aligned:
                counts = vc
        self._fade_tick(params if self._has_play else None, self.interval_inner, counts)
        # the chain's read-path flags (stream step bound, AGC gate) at the
        # inner timebase, after this block's plays and control writes
        self._ds_small = self._ds_flag_sync(self.interval_inner, self._n_inner)
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
        with span("pool.plan", pool=self.name):
            self._sub_plan(n, ratio, elapsed, rot_sin_half, params, tiers)
        # mirror the walk's smoothing-clock advance (step 3)
        self._g_smdt = self._g_smdt + np.float32(elapsed)
        self._t_scene += elapsed
        # stream ingest and the cursor-mirror shadow, in the render's order
        # (ingest grows len, then the advance releases); counts mirror the
        # device's mask gate (idle slots hold their cursors).  A block with
        # queued PCM ships it, so it is never param-free or fused below.
        if self.proto.batch:
            ing = self.proto.dr_ingest_params()
            if ing is not None:
                params["ing"] = ing
            live = np.where(self.mask_host, counts, np.int32(0)).astype(np.int32)
            if self.mask_host.all() and (live == n_write).all():
                # uniform tick: deferred as O(1) debt, replayed exactly at
                # the first mirror read
                self.proto.dr_host_tick(self.interval_inner, int(n_write))
            else:
                self.proto.dr_host_tick(self.interval_inner, live)
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
        if self._dmax_floor > 0.0 and self._sub_list.size:
            desired = self._EMPTY_SUB  # packs demote; no sub-pass under floors
        if self._dmax_floor == 0.0 and n > 0:
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
                abs(ratio - 1.0) + max(mb, float(self._dmax_floor)) * ratio,
                n, tiers,
            )
            self._sub_cfg = self._pick_tier(sd, n, self.SUB_TIERS)
            if self._read_cfg is None or self._sub_cfg is None:
                # beyond every kernel tier: whole-pool exact read
                self._read_cfg = None
                self._sub_cfg = None
        else:
            b = max(
                self._block_b(elapsed, n, ratio, rot_sin_half),
                float(self._dmax_floor),
            )
            self._read_cfg = self._pick_tier(abs(ratio - 1.0) + b * ratio, n, tiers)
            self._sub_cfg = None
        cur = (self._read_cfg, self._sub_cfg, int(self._sub_list.size))
        if cur != self._tier_last:
            self._tier_last = cur
            if len(self._tier_log) < 4096:
                self._tier_log.append((float(self._t_scene),) + cur)

    # -- per block: device side ------------------------------------------------

    def _adv(self):
        """The write cursor's advance a block, ``elapsed*rate`` in f32, from
        the render's ``_elapsed`` (``host_prepare``'s ``advf``)."""
        return float(np.float32(np.float32(self._elapsed) * np.float32(self.rate)))

    def _advance_block(self, dstate, ddata, params, n):
        """One block's control walk, ring append and read-prep geometry,
        shared by ``render`` and ``render_multi``.  Returns ``(S, ro)`` with
        ``ro`` holding the per-ear read operands."""
        S = dict(dstate)
        dev = self.device
        elapsed = np.float32(self._elapsed)
        n_inner = self._n_inner
        if "vcur" not in S:
            # a state carried from the JAX package: the voice cursors from
            # the pool cursor and the phases, before this block's plays
            # write their own
            S.update(self._voice_cursors_from_phase(S, S["wcur"]))

        # 1. plays, control and fade lanes
        self._walk_controls(S, params)
        V = S["mask"].shape[0]

        # 5. shared ring cursor: host scalars on delta blocks (resyncing the
        # device cursor), derived on the device from "wcur" on param-free
        # idle blocks (exact on the integer fast path).  One cursor per
        # scene: (1,), or a ScenePack's (S,)
        cap = self.cap_pool
        capf = float(cap)
        if "w" in params:
            w_end = device_param(params["w"], dev, _F32).reshape(-1)
            nw_s = device_param(params["nw"], dev, _I32).reshape(-1)
            start_i = device_param(params["wstart"], dev, _I32).reshape(-1)
        else:
            adv = self._adv()
            w0 = S["wcur"]
            w_un = w0 + adv
            w_end = torch.remainder(w_un, capf)
            start_i = torch.ceil(w0).to(_I32)
            nw_s = torch.ceil(w_un).to(_I32) - start_i
        S["wcur"] = w_end

        # 2-4, the voices' own ring cursors of 5, and 7: the walk (motion,
        # geometry, lingering), each voice's cursor advance (ring.rs:18-41;
        # on the aligned path its source advances by what that cursor
        # writes, and a voice whose cursor wrote one short runs a sample
        # ahead of the pool's cursor from then on: ``late``) and the
        # per-ear read operands (spatial.rs:409-431), one kernel on a card
        own = bool(self._w_aligned and self._own_counts)
        if own and "lag" not in S:  # a state carried from the JAX package
            S["lag"] = torch.zeros_like(S["vbase"])
        cols, ro, n_write, late = voice_walk(
            {k: S[k] for k in WALK_KEYS if k in S}, self._motion_lanes(params, V),
            params["rot_prev"], params["rot"], self.proto.dr_is_finished(S["inner"]), nw_s,
            elapsed=elapsed, adv=self._adv(), rate=self.rate, cap=cap, n=n, late=own)
        S.update(cols)

        # 6. inner source render; slab append (ring.rs:18-41).  All n_inner
        # frames are written every block; the <=1-frame overlap past
        # n_write is recomputed identically next block.  Stream PCM is
        # placed at the device write cursors first (K4), as the host pools
        # write before they read.
        if "ing" in params:
            S["inner"] = self.proto.dr_ingest(S["inner"], params["ing"])
        inner2, samples = self.proto.dr_render(
            S["inner"], ddata.get("inner", {}), self.interval_inner, n_inner,
            n_write,
        )
        S["inner"] = inner2
        FP = self.W_CHUNK  # front pad (absorbs wrapped mirror writes)
        M = self.M_PAD
        ring = S["ring"]  # (V, RPV, 128)
        if self._w_aligned:
            # row-aligned slab: primary + mirror-maintenance legs, in place,
            # at rows K1 derives from the write cursor itself
            nw = self._w_aligned
            slab = samples[:, :nw]
            if late is not None:
                # a late voice's block starts one sample before the pool's
                # cursor: its first sample lands there, the rest one on
                slab = torch.where(late[:, None], samples[:, 1 : nw + 1], slab)
            ring = rows_append_cursor(ring, slab, start_i, FP, cap, M)
            if late is not None:
                self._write_before(ring, samples[:, :1], late, start_i, FP, cap, M)
        else:
            # general (unaligned/wrapping) path, exotic block configs only:
            # each <=W_CHUNK-wide sub-slab lands twice on the flat view —
            # into the mirror when it touches [0, M), onto the canonical
            # home when it wrapped past L, or into the dump slack otherwise
            flat = ring.view(ring.shape[0], self.rowlen)
            start_v = per_voice(start_i, V).expand(V).to(torch.int64)
            for k in range(0, n_inner, self.W_CHUNK):
                chunk = samples[:, k : k + self.W_CHUNK]
                width = chunk.shape[1]
                lanes = torch.arange(width, dtype=torch.int64, device=dev)
                ck = torch.remainder(start_v + k, cap)
                flat.scatter_(1, (FP + ck)[:, None] + lanes, chunk)
                c2 = FP + torch.where(
                    ck + width > cap, ck - cap,
                    torch.where(ck < M, ck + cap, cap + M),
                )
                flat.scatter_(1, c2[:, None] + lanes, chunk)
        S["ring"] = ring
        return S, ro

    def render(self, dstate, ddata, params, n):
        S, ro = self._advance_block(dstate, ddata, params, n)
        V = S["mask"].shape[0]
        dev = self.device
        ring = S["ring"]
        if self._read_cfg is None:
            # exotic rate ratio: exact elementwise read of the flat ring
            # (any-ratio correct, frames.rs-style lerp)
            cap = self.cap_pool
            split_c = ro["split_c"]
            p_gain = torch.stack(ro["p_gain_c"], dim=-1)
            d_gain = torch.stack(ro["d_gain_c"], dim=-1)
            frac = torch.stack(ro["frac_c"], dim=-1)
            base = torch.stack(ro["base_c"], dim=-1)
            ds_int = torch.stack([s[0] for s in split_c], dim=-1)
            f_hi = torch.stack([s[1] for s in split_c], dim=-1)
            f_lo = torch.stack([s[2] for s in split_c], dim=-1)
            jn = torch.arange(n, dtype=_F32, device=dev)
            gains = p_gain[:, :, None] + jn * d_gain[:, :, None]
            flat = ring.view(V, self.rowlen)[:, self.W_CHUNK:]
            whole, fr = exact_positions(frac, ds_int, f_hi, f_lo, n)
            x = torch.remainder(base[:, :, None] + whole, cap)

            def look(ix):
                return torch.gather(
                    flat, 1, ix.reshape(V, 2 * n).to(torch.int64)
                ).reshape(V, 2, n)

            a = look(x)
            b = look(torch.remainder(x + 1, cap))
            s = a + fr * (b - a)
            contrib = torch.where(ro["mask"][:, None, None], s * gains, 0.0)
            return S, scene_sum(contrib, current_scenes())
        sub_cfg = self._sub_cfg
        if sub_cfg is not None and current_scenes() is not None:
            # a pack-wide floor clears every list on a delta block first
            # (force_needed)
            raise RuntimeError("a packed buffered pool rendered with a family sub-pass")
        if "sub_idx" in params:
            # membership refresh (delta blocks): carry the list and the
            # derived per-voice tight flags in state
            S["sub_idx"] = device_param(params["sub_idx"], dev, _I32)
            S["sub_on"] = device_param(params["sub_on"], dev, _F32)
            hit = (
                S["sub_idx"][:, None]
                == torch.arange(V, dtype=_I32, device=dev)[None, :]
            ) & (S["sub_on"][:, None] > 0.0)
            S["tight"] = 1.0 - hit.any(dim=0).to(_F32)
        out = self._ring_read(
            ring, ro, self._read_cfg, n,
            tight=S["tight"] if sub_cfg is not None else None, scenes=current_scenes(),
        )
        if sub_cfg is not None:
            # family sub-pass: the host-listed wide-walk voices render at a
            # wide tier, while the pool above kept its tight tier
            out = out + self._ring_read(ring, ro, sub_cfg, n, sub_idx=S["sub_idx"],
                                        sub_on=S["sub_on"])
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

    def _write_before(self, ring, col, late, start_i, FP, cap, M):
        """Write ``col`` (V, 1) at the pool ring index just before the write
        cursor ``start_i``, primary and mirror, for the ``late`` voices;
        the others' land in the dump slack past the mirror.  The two flat
        columns of each cursor come from a table, one lookup a block."""
        V = col.shape[0]
        dump = FP + cap + M
        at = _before_legs(FP, cap, M, ring.device)[start_i.to(torch.int64)]
        if at.shape[0] > 1:
            at = at.repeat_interleave(V // at.shape[0], dim=0)
        at = torch.where(late[:, None], at, dump)
        ring.view(V, self.rowlen).scatter_(1, at, col.expand(V, 2))

    def _voice_cursors_from_phase(self, S, wcur):
        """``vcur``/``vbase`` of a state carried from the JAX package
        (``utils.convert``), which keeps the pool cursor and a per-voice
        phase: the voice cursor at pool index ``wcur + phase``."""
        p = torch.remainder(per_voice(wcur, S["phase"].shape[0]) + S["phase"],
                            float(self.cap_pool))
        c = torch.ceil(S["max_delay"] * float(np.float32(self.rate))) + 1.0
        fl = torch.floor(p)
        lap0 = fl - torch.remainder(fl, c)
        return {"vcur": p - lap0,
                "vbase": torch.remainder(lap0.to(_I32), self.cap_pool)}

    def render_multi(self, dstate, ddata, params, n, nb):
        """``nb`` idle blocks in one group: per-block control walk, append
        and cursor math identical to ``render``, but all reads are ONE
        kernel launch (K3), each block's read wrapped modulo the ring as the
        JAX package's superwindow gather wraps it.  Appends all land before
        the read; host_multiblock's slack gate keeps later appends from
        overwriting samples earlier blocks still read.  Returns (S, (2,
        nb*n))."""
        S = dstate
        ros = []
        for _ in range(nb):
            S, ro = self._advance_block(S, ddata, params, n)
            ros.append(ro)
        _, K = self._read_cfg
        # static per-block coarse rows and shift ranges (the tier contract
        # |ds-1|*n <= K per block bounds each block's walk)
        row0s, hs = multi_rows(self._adv(), K, nb)
        out = ring_select_multi(
            S["ring"], ros, n=n, K=K, DMAX=self.emax2, FP=self.W_CHUNK, cap=self.cap_pool,
            row0s=row0s, hs=hs,
        )
        return S, out

    def _ring_read(self, ring, ro, cfg, n, **kw):
        """One read (K2) of block operands ``ro`` at read tier ``cfg`` =
        (R_CHUNK, K): the main pool (``tight``, ``scenes``) or the family
        sub-pass list (``sub_idx``, ``sub_on``), mixed to (2, n), or in a
        ScenePack to (S, 2, n), each scene's voices apart."""
        R_CHUNK, K = cfg
        return ring_select_ears(ring, ro, n=n, K=K, R=R_CHUNK, DMAX=self.emax2,
                                FP=self.W_CHUNK, cap=self.cap_pool, **kw)


def _pool_captures(p):
    """Whether a scene's pool reads every per-block value from the params,
    the state or its archetype entry (``SpatialScene.graph_capture``)."""
    if isinstance(p, (_SeekPoolDR, _BufferedPoolDR)):
        return _graph_chain(p.proto)
    if isinstance(p, _BufferedPoolSingleton):
        return bool(getattr(p.sig, "graph_capture", False))
    return isinstance(p, _BufferedPool) and _graph_chain(p.sig)


def _next_pow2(x):
    p = 1
    while p < x:
        p *= 2
    return p


class SpatialScene(Engine):
    """Signal for stereo output from a spatial scene (spatial.rs:159-188).

    ``device`` places the scene's device state: the CUDA card unless the
    caller passes another (``device="cpu"`` runs every kernel's plain
    version); without a card and without ``device`` it raises."""

    channels = 2
    #: state leaves a block step writes in place (``core/run.py``: a
    #: captured step must leave them where they are; never copied back)
    GRAPH_INPLACE = ("ring",)

    def __init__(self, initial_capacity=DEFAULT_CAPACITY, device=None):
        super().__init__()
        self.initial_capacity = initial_capacity
        self.device = default_device(device)
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

    # -- control side ---------------------------------------------------------

    def _play(self, spec, options):
        if spec.channels != 1:
            raise ValueError("spatial signals must be mono (spatial.rs:276-279)")
        if not spec.seekable:
            raise TypeError(
                "play() requires a seekable (deterministic) signal; "
                "use play_buffered() for arbitrary signals"
            )
        dr = spec.dr_seek_supported()
        key = (spec.archetype(), dr)
        pool = self._seek_pools.get(key)
        if pool is None:
            cls = _SeekPoolDR if dr else _SeekPool
            pool = cls(f"s{len(self._seek_pools)}", spec, self.initial_capacity,
                       device=self.device)
            self._seek_pools[key] = pool
        if dr:
            i, gen = pool.play(spec, options)
        else:
            i, gen = pool.claim(spec, options)
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
        if not spec.host_batchable():
            # a submix (Mixer, or a chain holding an engine): a one-voice
            # pool, rendered unbatched (spatial.rs:314-340 takes any Signal)
            spec._set_device(self.device)  # raises for an engine elsewhere
            name = f"b{len(self._buffered_pools)}"
            pool = _BufferedPoolSingleton(name, spec, rate, bucket, self.device)
            self._buffered_pools[("singleton", name)] = pool
            i, gen = pool.play(spec, options, max_delay)
            return Spatial(pool, i, gen)
        # ingest-needing chains (streams) go device-resident when the route
        # to the stream leaf is clean (dr_ingest_ok); Speed/Fader-wrapped
        # streams keep the host pool
        dr = spec.dr_supported() and spec.dr_ingest_ok()
        key = (spec.archetype(), int(rate), bucket, dr)
        pool = self._buffered_pools.get(key)
        if pool is None:
            cls = _BufferedPoolDR if dr else _BufferedPool
            pool = cls(
                f"b{len(self._buffered_pools)}", spec, self.initial_capacity,
                rate, bucket, device=self.device,
            )
            self._buffered_pools[key] = pool
        i, gen = pool.play(spec, options, max_delay)
        return Spatial(pool, i, gen)

    def sync(self):
        """Pull device-resident voice state back to the host so handles
        observe finishes and freed slots become reusable.  Each pool
        reclaims from its newest prefetched digest (``sync_prefetch``)
        where there is one, without waiting for the calls queued after it:
        a game that prefetches at each call's control sees a finish at most
        one call late, and never waits for the call in flight."""
        with span("scene.sync"):
            for p in self._all_pools():
                p.sync()

    def sync_prefetch(self):
        for p in self._all_pools():
            p.sync_prefetch()

    # -- checkpoint/resume -----------------------------------------------------

    def host_snapshot(self):
        """The listener rotation and every pool's host bookkeeping
        (``utils.checkpoint.pool_state``: slot columns, queued plays,
        motion, control writes and fades, the fade and geometry mirrors,
        the write cursor and its last scalars, the walk-bound cache and
        scene clock, the read tiers and sub-pass list, a host pool's
        voice columns, write cursors and exact-route operands) and its
        template's host state."""
        from .utils.checkpoint import pools_snapshot

        return {"rot": self._rot.copy(), "rot_pending": self._rot_pending,
                "has_rot": self._has_rot, "pools": pools_snapshot(self._all_pools())}

    def host_restore(self, snap):
        from .utils.checkpoint import pools_restore

        self._rot = snap["rot"].copy()
        self._rot_pending = snap["rot_pending"]
        self._has_rot = snap["has_rot"]
        self._rot_dev = None  # the device copy comes with the device state
        pools_restore(self._all_pools(), snap["pools"])

    # scene-in-scene submixes checkpoint through the aux hook like mixers
    host_aux_snapshot = host_snapshot
    host_aux_restore = host_restore

    def _set_listener_rotation(self, rotation):
        """spatial.rs:345-349 — stores the inverse quaternion."""
        self._rot_pending = quat_invert(f32(rotation))

    # -- Signal protocol ---------------------------------------------------------

    def _all_pools(self):
        return list(self._buffered_pools.values()) + list(self._seek_pools.values())

    #: a pool's entry of ``archetype()`` after its name and its template's
    #: archetype: these attributes, each with its default.  ``_ema_fast``
    #: (an Adapt's K7-or-scan route) is in Adapt's ``_arch_extra`` too; it
    #: stands here as well so that ``render_archetype`` reads it from the
    #: entry, and adds no key
    POOL_ARCH = (("ring_len", 0), ("_n_inner", 0), ("is_dr", False), ("_elapsed", 0.0),
                 ("_has_play", False), ("_has_mot", False), ("_w_aligned", 0),
                 ("_w_free", False), ("_ds_small", True), ("_ds_tier", 4),
                 ("_read_cfg", None), ("_sub_cfg", None), ("_use_strips", True),
                 ("_ema_fast", False))
    #: those of them a block's render reads
    RENDER_ATTRS = ("_n_inner", "_elapsed", "_w_aligned", "_read_cfg", "_sub_cfg",
                    "_use_strips")

    @contextlib.contextmanager
    def render_archetype(self, arch):
        """Render as of the blocks that prepared ``arch``: a Renderer
        dispatches a run only after preparing the next block, whose plan
        (its read tier, a host pool's strip gate, say) the pools now hold,
        so every attribute a render reads is set from the run's own
        archetype for the dispatch and put back after: a device-resident
        pool's route flags (a FramesSignal's arena step or gather, K7 or
        the scan) are stamped on its proto chain from the entry, a host
        pool's template takes its nodes' flags (a Stream's read flags)
        from its own archetype in the entry, and a submix renders as of
        its engine's (``core.signal.render_as``).  A block, stepped or op
        by op, so depends on its key alone."""
        field = {a: 2 + i for i, (a, _) in enumerate(self.POOL_ARCH)}
        saved = []
        with contextlib.ExitStack() as stack:
            for p, entry in zip(self._all_pools(), arch[2]):
                if entry[0] != p.name:
                    raise ValueError(f"archetype entry {entry[0]} for pool {p.name}")
                own = vars(p)
                # a pool's tier is set at its first prepare
                flags = ((p._ds_small, getattr(p, "_ds_tier", 4), p._ema_fast) if p.is_dr
                         else None)
                saved.append((p, {a: own[a] for a in self.RENDER_ATTRS if a in own}, flags))
                for a in self.RENDER_ATTRS:
                    if a in own:
                        setattr(p, a, entry[field[a]])
                if p.is_dr:
                    p._stamp_flags(*(entry[field[a]] for a in ("_ds_small", "_ds_tier",
                                                               "_ema_fast")))
                else:
                    stack.enter_context(render_as(p.sig, entry[1]))
            try:
                yield
            finally:
                for p, attrs, flags in saved:
                    for a, v in attrs.items():
                        setattr(p, a, v)
                    if flags is not None:
                        p._stamp_flags(*flags)

    @property
    def graph_capture(self):
        """True while every pool renders from the params, the state or the
        key alone (``_pool_captures``): device-resident seek and buffered
        pools of ``mixer._GRAPH_NODES`` chains (the main path's Sine
        voices; buffered FramesSignal, Speed(FramesSignal),
        Fader(Speed(FramesSignal)) and Cycle voices, ``arena_step`` and
        ``fader_step`` writing their rings; seek Cycle, Constant, FixedGain,
        Reinhard and Tanh chains, ``arena_warp`` reading a Cycle or
        FramesSignal leaf under them; stream chains with their ingest chunk
        in the row), host buffered pools of such chains (Speed(Stream):
        K4/K5's operand record in the row) and submixes whose engine
        captures.  A Renderer then captures the block step as a CUDA
        graph.  Host seek pools (user signals with a finish rule of their
        own) and pools of any chain holding a user signal keep op-by-op
        dispatch."""
        return all(_pool_captures(p) for p in self._all_pools())

    def archetype(self):
        """Structural key: equal keys on consecutive blocks let the Renderer
        group them (and fuse idle runs into multi-block dispatches)."""
        pools = tuple(
            (p.name, (p.proto if p.is_dr else p.sig).archetype())
            + tuple(getattr(p, a, d) for a, d in self.POOL_ARCH)
            for p in self._all_pools()
        )
        return ("SpatialScene", self._has_rot, pools)

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
        """True when the NEXT block would ship control-delta arrays: the
        pack-coordination predicate (a ScenePack ORs it over its scenes
        and passes it as ``force``, so every scene ships deltas on the
        same blocks, while all-idle pack blocks ship nothing)."""
        return self._rot_pending is not None or any(
            bool(p.pending_plays) or bool(p.pending_motion)
            or p._ctrl_pending_any() or getattr(p, "force_deltas", False)
            or getattr(p, "force_needed", lambda: False)()
            for p in self._all_pools()
            if p.is_dr
        )

    def host_prepare(self, interval, n, count=None, force=False):
        # listener rotation swap refresh (spatial.rs:382-386): the host keeps
        # the authoritative mirror; the pools read the device copy ("_rot")
        prev_rot = self._rot
        rot_event = self._rot_pending is not None
        # a pack forces a submix's engine through ``_pack_force``
        force, self._pack_force = force or self._pack_force, False
        if rot_event:
            if self._rot_dev is None:
                self._rot_dev = _upload(self._rot, self.device)
            self._rot = self._rot_pending
            self._rot_pending = None
        rot = self._rot
        # scene-global control-event flag: when ANY pool has queued events,
        # every pool ships its (padded) delta arrays; ``force`` adds a
        # pack's (an event in a sibling scene)
        force = force or rot_event or any(
            bool(p.pending_plays) or bool(p.pending_motion)
            or p._ctrl_pending_any()
            or getattr(p, "force_needed", lambda: False)()
            for p in self._all_pools()
            if p.is_dr
        )
        self._has_rot = force
        out = {}
        if force:
            out["_rot_new"] = rot.copy()
        for p in self._all_pools():
            if p.is_dr:
                out[p.name] = p.host_prepare(prev_rot, rot, f32(interval), n, force)
            else:
                out[p.name] = p.host_prepare(prev_rot, rot, f32(interval), n)
        return out

    def device_collect(self):
        if self._rot_dev is None:
            if in_block_step():
                raise RuntimeError("a block step uploaded the listener rotation")
            self._rot_dev = _upload(self._rot, self.device)
        out = {"_rot": self._rot_dev}
        for p in self._all_pools():
            if p.is_dr:
                out[p.name] = p.dr_state()
            else:
                d = {"inner": p.sig.device_collect()}
                if isinstance(p, _BufferedPool):
                    d["ring"] = p.ring_state()
                out[p.name] = d
        return out

    def device_store(self, d):
        self._rot_dev = d["_rot"]
        for p in self._all_pools():
            if p.name not in d:  # opened after ``d`` was collected
                continue
            if p.is_dr:
                p.state = d[p.name]
                p._store_epoch += 1
            else:
                p.sig.device_store(d[p.name]["inner"])
                if isinstance(p, _BufferedPool):
                    p.ring = d[p.name]["ring"]

    def device_data(self):
        return {
            p.name: {"inner": (p.proto if p.is_dr else p.sig).device_data()}
            for p in self._all_pools()
        }

    def host_multiblock(self, interval, n):
        """Fused idle-group width the Renderer may dispatch (0 = off):
        every pool must be device-resident (host pools ship per-voice
        params every block), at least one buffered pool must profit, and
        each buffered pool must pass its superwindow gate
        (_BufferedPoolDR.host_multiblock)."""
        nb = 0
        for p in self._all_pools():
            if not p.is_dr:
                return 0
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
        # rotation refresh: prev = state, cur = delta (if any).  A ScenePack
        # stacks its scenes' pools: its "_rot" holds S rotations end to
        # end, and the block is (S, 2, n)
        S = current_scenes()
        rot_prev = dstate["_rot"]
        rot_cur = (
            device_param(params["_rot_new"], self.device, _F32)
            if "_rot_new" in params else rot_prev
        )
        shape = (2, n)
        if S is not None:
            rot_prev, rot_cur = rot_prev.reshape(S, 4), rot_cur.reshape(S, 4)
            shape = (S, 2, n)
        out = torch.zeros(shape, dtype=_F32, device=self.device)
        d2 = {"_rot": rot_cur.reshape(dstate["_rot"].shape)}
        for p in self._all_pools():
            if p.name not in params:
                continue  # opened after this block's host_prepare: plays next block
            pp = params[p.name]
            if p.is_dr:
                pp = dict(pp)
                pp["rot_prev"] = rot_prev
                pp["rot"] = rot_cur
            dsub, block = p.render(dstate[p.name], ddata[p.name], pp, n)
            d2[p.name] = dsub
            out = add_block(out, block, p.name)
        return d2, out


def _played(sp, handle):
    """Tag the ``scene.play`` span ``sp`` with the pool the voice went to
    and count it (``voices.played``)."""
    if sp is not None:
        sp.attrs["pool"] = handle._pool.name
    count("voices.played")
    return handle


class SpatialSceneControl:
    """Control for modifying a SpatialScene (spatial.rs:267-350)."""

    def __init__(self, scene):
        self._scene = scene

    def play(self, signal, options=None):
        with span("scene.play") as sp:
            return _played(sp, self._scene._play(signal, options or SpatialOptions()))

    def play_buffered(self, signal, options=None, max_distance=100.0, rate=48000,
                      buffer_duration=0.1):
        with span("scene.play") as sp:
            return _played(sp, self._scene._play_buffered(
                signal, options or SpatialOptions(), max_distance, rate, buffer_duration))

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
            if not p.is_dr:
                out[p.name] = {"kind": "host"}
                continue
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
            log = getattr(p, "_tier_log", None)
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
