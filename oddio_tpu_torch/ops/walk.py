"""The device-resident buffered pool's walk and read preparation (the
counterpart of XLA's fusion of oddio_tpu/spatial.py ``_walk_device`` and the
read preparation after it).

``voice_walk`` takes one block of ``_BufferedPoolDR._advance_block`` from
the motion refresh through the read operands, per voice:

* the walk (spatial.rs:204-261): the motion lanes (last-wins per slot),
  both smoothed positions rotated by the listener's previous and current
  rotation, the smoothing clock, lingering reclamation, the stop flags and
  the mask;
* each voice's own ring cursor (ring.rs:18-41): its advance, what it
  writes, its lag behind the pool's cursor (``late``) and the frames its
  source renders this block;
* both ears' read operands (spatial.rs:409-431) as ``ring_select_ears``
  (K2) and ``ring_select_multi`` (K3) take them: the offset clamps, the
  gain ramps, the read cursor's pool index and fraction, the split read
  step, the frozen flags and the 0/1 mask.

Its plain version, ``voice_walk_plain``, is the torch chain the pool ran
op by op: ``walk_geometry`` (shared with the seek pool), the cursor
helpers and ``read_operands``.  The wrapper runs the plain version for
tensors on the CPU and launches ``csrc/walk_kernel.cu`` (one thread per
voice) for tensors on a CUDA device, where it writes the state columns in
place and is bit-equal to the plain version run there; it never falls
back from one to the other.  Each launch adds one to
``LAUNCHES["voice_walk"]``.

What stays outside: the plays, control and fade lanes (generic over the
inner signal's tree), the inner source's finish flags (passed in as a bool
column), the shared pool write cursor and the inner render.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.drctrl import drop_lanes, scatter_drop_
from ._build import lib
from ._dev import device_split_ds, per_voice
from .geometry import (
    EAR_DIR,
    EAR_POS,
    POSITION_SMOOTHING_PERIOD,
    SPEED_OF_SOUND,
    ear_states_c,
    quat_rotate_c,
    smoothed_position,
    smoothed_position_c,
    unstack3,
    v3_norm_c,
)
from .ring_kernels import _check, _check_contig, _cuda_device, _raise_rc, _stream_ptr

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "WALK_KEYS",
    "voice_cursor_advance",
    "voice_write_count",
    "voice_reads",
    "walk_geometry",
    "read_operands",
    "voice_walk",
    "voice_walk_plain",
]

_F32, _I32, _BOOL = torch.float32, torch.int32, torch.bool

#: launches since the last reset (CUDA launches only)
LAUNCHES = {"voice_walk": 0}

#: the pool state columns ``voice_walk`` reads (``lag`` on the late path)
WALK_KEYS = ("mask", "stopped", "finished_for", "smdt", "prev_position", "motion_pos",
             "motion_vel", "vcur", "vbase", "lag", "radius", "max_delay")

#: each column's dtype and trailing shape
_COLUMNS = {"mask": (_BOOL, ()), "stopped": (_BOOL, ()), "finished_for": (_F32, ()),
            "smdt": (_F32, ()), "prev_position": (_F32, (3,)), "motion_pos": (_F32, (3,)),
            "motion_vel": (_F32, (3,)), "vcur": (_F32, ()), "vbase": (_I32, ()),
            "lag": (_I32, ()), "radius": (_F32, ()), "max_delay": (_F32, ())}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --- the plain version: the pool's torch chain ---------------------------------------


def voice_cursor_advance(vcur, vbase, max_delay, adv, rate, cap):
    """The reference's delay-ring write cursor (ring.rs:18-41) for each
    voice of a buffered pool whose rings share one modulus ``cap``,
    advanced one block in float32 as the reference rounds it.

    A voice's own ring holds ``c = ceil(max_delay*rate) + 1`` samples and
    its write cursor ``vcur`` in [0, c) advances by ``adv`` (the block's
    f32 ``elapsed*rate``) modulo c; ``vbase`` is the pool ring index of the
    voice ring's index 0 in the current lap.  Returns (vcur', vbase', c,
    the unwrapped sum ``vcur + adv``)."""
    c = torch.ceil(max_delay * float(np.float32(rate))) + 1.0
    un = vcur + float(np.float32(adv))
    nxt = torch.fmod(un, c)
    return nxt, torch.remainder(vbase + (un - nxt).to(_I32), cap), c, un


def voice_write_count(vcur, nxt, un):
    """What a block writes by a voice's own cursor, from ``vcur`` to
    ``nxt`` (``voice_cursor_advance``'s, with its unwrapped sum ``un``):
    ``ceil(end) - ceil(start)`` samples (ring.rs:18-41), int32.  That is
    the pool's count but in the one block where a first-lap cursor's
    fraction rounds away as it grows past a power of two: 511 of 512 at
    48 kHz, in ~0.1% of voices."""
    return (torch.ceil(nxt) - torch.ceil(vcur) + (un - nxt)).to(_I32)


def voice_reads(vcur, vbase, c, offsets, rate, cap):
    """The reads of each voice's advanced cursor (ring.rs:51-79): an ear at
    offset ``t`` seconds reads from ``(vcur + t*rate) rem_euclid c``, one
    (base int32 pool index, frac in [0, 1)) per offset.  The pool's shared
    cursor rounds the same sums at another magnitude, which moved the
    reads by up to ~1e-3 samples from the reference's (ROADMAP Q3.1)."""
    ratef = float(np.float32(rate))
    ci = c.to(_I32)
    out = []
    for t in offsets:
        x = vcur + t * ratef
        lap = x < 0.0  # the read lies in the previous lap
        off = torch.where(lap, x + c, x)
        fl = torch.floor(off)
        out.append((torch.remainder(vbase - torch.where(lap, ci, 0) + fl.to(_I32), cap),
                    off - fl))
    return out


def _rot_rows(rot, V):
    """The listener rotation a walk applies: one shared (4,) quaternion, or
    a ScenePack's (S, 4), one per scene, repeated for its V/S voice rows."""
    return rot if rot.dim() == 1 else rot.repeat_interleave(V // rot.shape[0], dim=0)


def walk_geometry(st, motion, rot_prev, rot, elapsed, inner_fin):
    """The walk after the plays (spatial.rs:216-261), op by op: the motion
    lanes ``motion`` = (slots (K,) int32, positions (K, 3), velocities
    (K, 3), discontinuity flags (K,) bool) or None, the smoothed and
    rotated positions, the smoothing clock, lingering reclamation.  Writes
    the new columns into the dict ``st``; returns (mask, prev_pos,
    next_pos), positions as (V,) component tuples."""
    V = st["mask"].shape[0]
    dev = st["mask"].device
    # 2. motion refresh (swap-channel drain + smoothing, spatial.rs:216-227);
    # a block whose lanes are all padding leaves every column as it was
    if motion is not None:
        idx, pos, vel, disc = motion
        lanes = drop_lanes(idx, V)
        upd = scatter_drop_(torch.zeros(V, dtype=_BOOL, device=dev), lanes,
                            torch.ones((), dtype=_BOOL, device=dev))
        pend_pos = scatter_drop_(st["motion_pos"].clone(), lanes, pos)
        pend_vel = scatter_drop_(st["motion_vel"].clone(), lanes, vel)
        pend_disc = scatter_drop_(torch.zeros(V, dtype=_BOOL, device=dev), lanes, disc)
        sm_orig = smoothed_position(
            st["prev_position"], st["smdt"], 0.0, st["motion_pos"], st["motion_vel"],
        )
        new_prev = torch.where(pend_disc[:, None], pend_pos, sm_orig)
        st["prev_position"] = torch.where(upd[:, None], new_prev, st["prev_position"])
        st["smdt"] = torch.where(upd, 0.0, st["smdt"])
        st["motion_pos"] = torch.where(upd[:, None], pend_pos, st["motion_pos"])
        st["motion_vel"] = torch.where(upd[:, None], pend_vel, st["motion_vel"])

    # 3. geometry (spatial.rs:228-238), component-split
    prev3 = unstack3(st["prev_position"])
    mp3 = unstack3(st["motion_pos"])
    mv3 = unstack3(st["motion_vel"])
    sm0 = smoothed_position_c(prev3, st["smdt"], 0.0, mp3, mv3)
    sm1 = smoothed_position_c(prev3, st["smdt"], elapsed, mp3, mv3)
    # a pack's rotations are per scene, (S, 4): one per voice row
    prev_pos = quat_rotate_c(_rot_rows(rot_prev, V), sm0)
    next_pos = quat_rotate_c(_rot_rows(rot, V), sm1)
    ef = float(np.float32(elapsed))
    st["smdt"] = st["smdt"] + ef

    # 4. lingering reclamation (spatial.rs:241-261)
    dist = v3_norm_c(prev_pos)
    ff = st["finished_for"]
    lingering = ~torch.isnan(ff)
    expire = lingering & (ff > dist / float(SPEED_OF_SOUND))
    st["stopped"] = st["stopped"] | (expire & st["mask"])
    ff = torch.where(lingering & ~expire, ff + ef, ff)
    newly = st["mask"] & ~lingering & inner_fin
    st["finished_for"] = torch.where(newly, ef, ff)
    st["mask"] = st["mask"] & ~st["stopped"]
    return st["mask"], prev_pos, next_pos


def read_operands(st, mask, prev_pos, next_pos, c_v, elapsed, n, rate, cap):
    """Both ears' read operands (spatial.rs:409-431), component-split, from
    the walk's positions and the advanced voice cursors of ``st`` (their
    ring sizes ``c_v``): the dict ``ring_select_ears`` takes."""
    ef = float(np.float32(elapsed))
    ratef = float(np.float32(rate))
    p_off_c, p_gain_c = ear_states_c(prev_pos, st["radius"])
    n_off_c, n_gain_c = ear_states_c(next_pos, st["radius"])
    nmd = -st["max_delay"]
    p_off_c = [torch.maximum(po - ef, nmd) for po in p_off_c]
    n_off_c = [torch.maximum(no, nmd) for no in n_off_c]
    nf = float(np.float32(n)) if n > 0 else 1.0
    d_gain_c = [(n_gain_c[e] - p_gain_c[e]) / nf for e in range(2)]
    # the read cursor as the reference rounds it: each voice's own ring
    # cursor, not the pool's shared one (ROADMAP Q3.1)
    cursors = voice_reads(st["vcur"], st["vbase"], c_v, p_off_c, rate, cap)
    split_c = [
        device_split_ds(((n_off_c[e] - p_off_c[e]) / nf) * ratef)
        for e in range(2)
    ]
    # per-ear FROZEN flags: a fully offset-clamped voice (spatial.rs:
    # 414-416) has n_off == p_off exactly, so its read step is exactly
    # zero and the select kernel repeats its j = 0 sample
    return {
        "mask": mask,
        "maskf": mask.to(_F32),
        "p_gain_c": p_gain_c,
        "d_gain_c": d_gain_c,
        "base_c": [c[0] for c in cursors],
        "frac_c": [c[1] for c in cursors],
        "split_c": split_c,
        "frz_c": [(n_off_c[e] == p_off_c[e]).to(_F32) for e in range(2)],
    }


def voice_walk_plain(st, motion, rot_prev, rot, inner_fin, nw, *, elapsed, adv, rate, cap,
                     n, late):
    """Plain version of ``voice_walk``: the torch chain, each column
    rebuilt.  Returns (the walked columns of ``st``, the read operands,
    the frames each source renders (V,) int32, the late flags (V,) bool or
    None)."""
    st = dict(st)
    V = st["mask"].shape[0]
    mask, prev_pos, next_pos = walk_geometry(st, motion, rot_prev, rot, elapsed, inner_fin)
    # each voice's own ring cursor (ring.rs:18-41), advanced; on the late
    # path its source advances by what that cursor writes, and a voice
    # whose cursor wrote one short runs a sample ahead of the pool's
    # cursor from then on
    vc0 = st["vcur"]
    st["vcur"], st["vbase"], c_v, un = voice_cursor_advance(
        vc0, st["vbase"], st["max_delay"], adv, rate, cap)
    late_v = None
    if late:
        nw_v = voice_write_count(vc0, st["vcur"], un)
        lag = st["lag"]
        late_v = lag > 0
        st["lag"] = lag + per_voice(nw, V) - nw_v
    else:
        nw_v = per_voice(nw, V)
    # dead/unplayed slots do not advance their inner cursors
    n_write = torch.where(mask, nw_v, 0)
    ro = read_operands(st, mask, prev_pos, next_pos, c_v, elapsed, n, rate, cap)
    return {k: st[k] for k in WALK_KEYS if k in st}, ro, n_write, late_v


# --- the kernel ----------------------------------------------------------------------

#: signatures the wrapper has validated: a call with one of them skips the
#: column-by-column checks, any other is checked in full
_VALIDATED = set()


def _f32(x):
    return float(np.float32(x))


#: the kernel's constants: ATen's float32 reciprocals of the chain's
#: divisions by Python floats (the speed of sound, the smoothing period),
#: the ear offset's factor, the ears' x and directions, 1/4096
_CONSTS = np.array(
    [_f32(np.float32(1.0) / SPEED_OF_SOUND), _f32(np.float32(1.0) / POSITION_SMOOTHING_PERIOD),
     _f32(np.float32(-1.0) / SPEED_OF_SOUND), float(EAR_POS[0, 0]), float(EAR_POS[1, 0]),
     *(float(c) for c in EAR_DIR.reshape(-1)), _f32(1.0 / 4096.0)],
    dtype=np.float32)


def _vps(R, V, name):
    """The voices each of a per-scene operand's R rows covers."""
    if R < 1 or V % R:
        raise ValueError(f"{name} has {R} rows, which do not split {V} voices")
    return V // R


def _rot_vps(rot, V, name):
    """The voices each row of a rotation covers: (4,) one shared, (S, 4)
    one a scene."""
    return _vps(1 if rot.dim() == 1 else rot.shape[0], V, name)


def _check_walk(st, motion, rot_prev, rot, inner_fin, nw, late, V, dev):
    for k, (dt, tail) in _COLUMNS.items():
        if k == "lag" and not late:
            continue
        if k not in st:
            raise KeyError(f"voice_walk needs the state column {k}")
        _check(st[k], k, dt, (V,) + tail, dev)
        _check_contig(st[k], k)
    _check(inner_fin, "inner_fin", _BOOL, (V,), dev)
    _check_contig(inner_fin, "inner_fin")
    for name, r in (("rot_prev", rot_prev), ("rot", rot)):
        shape = (4,) if r.dim() == 1 else (r.shape[0], 4)
        _check(r, name, _F32, shape, dev)
        _check_contig(r, name)
        _rot_vps(r, V, name)
    if nw.dim() != 1:
        raise ValueError(f"nw must be (S,), got {tuple(nw.shape)}")
    _check(nw, "nw", _I32, tuple(nw.shape), dev)
    _check_contig(nw, "nw")
    _vps(nw.shape[0], V, "nw")
    if motion is not None:
        if motion[0].dim() != 1:
            raise ValueError(f"mot_idx must be (K,), got {tuple(motion[0].shape)}")
        K = motion[0].shape[0]
        for name, x, dt, shape in zip(("mot_idx", "mot_pos", "mot_vel", "mot_disc"), motion,
                                      (_I32, _F32, _F32, _BOOL), ((K,), (K, 3), (K, 3), (K,))):
            _check(x, name, dt, shape, dev)
            _check_contig(x, name)
    if dev.type != "cpu":
        _cuda_device(st["mask"])


def voice_walk(st, motion, rot_prev, rot, inner_fin, nw, *, elapsed, adv, rate, cap, n,
               late):
    """One block's walk, voice cursors and read operands of a
    device-resident buffered pool (the module docstring has the steps).

    ``st``: the pool's state columns (``WALK_KEYS``; ``lag`` where
    ``late``), (V,) or (V, 3); ``motion``: the block's motion lanes
    (slots (K,) int32, positions and velocities (K, 3) float32,
    discontinuity flags (K,) bool; a slot outside [0, V) pads) or None;
    ``rot_prev``, ``rot``: the listener's rotations, (4,) or a ScenePack's
    (S, 4); ``inner_fin``: the inner sources' finish flags (V,) bool;
    ``nw``: the pool cursor's write count (1,) or (S,) int32; ``elapsed``
    the block's float32 seconds, ``adv`` the cursor's advance, ``rate``
    and ``cap`` the ring's rate and modulus, ``n`` the block's frames;
    ``late``: whether each source advances by its own cursor's count (the
    aligned write path of a chain that can tell where a block starts).
    Returns (the walked columns, the read operands as ``ring_select_ears``
    takes them, the frames each source renders (V,) int32, the late flags
    (V,) bool or None).  On a CUDA device the columns are ``st``'s own,
    written in place, and the operands are rows of one (17, V) tensor; one
    launch."""
    V = st["mask"].shape[0]
    dev = st["mask"].device
    key = (tuple((k, x.shape, x.stride(), x.dtype, x.device) for k, x in st.items()
                 if k in _COLUMNS),
           None if motion is None else tuple((x.shape, x.stride(), x.dtype, x.device)
                                             for x in motion),
           tuple((x.shape, x.stride(), x.dtype, x.device) for x in (rot_prev, rot, inner_fin,
                                                                    nw)),
           bool(late))
    if key not in _VALIDATED:
        _check_walk(st, motion, rot_prev, rot, inner_fin, nw, late, V, dev)
        _VALIDATED.add(key)
    if dev.type == "cpu":
        return voice_walk_plain(st, motion, rot_prev, rot, inner_fin, nw, elapsed=elapsed,
                                adv=adv, rate=rate, cap=cap, n=n, late=late)
    ops = torch.empty((17, V), dtype=_F32, device=dev)
    opi = ops.view(_I32)
    n_write = torch.empty(V, dtype=_I32, device=dev)
    late_v = torch.empty(V, dtype=_BOOL, device=dev) if late else None
    cols = [st[k] for k in ("mask", "stopped", "finished_for", "smdt", "prev_position",
                            "motion_pos", "motion_vel", "vcur", "vbase")]
    lanes = (None,) * 4 if motion is None else motion
    ptrs = np.array([x.data_ptr() for x in cols]
                    + [st["lag"].data_ptr() if late else 0]
                    + [x.data_ptr() for x in (st["radius"], st["max_delay"], inner_fin,
                                              rot_prev, rot, nw)]
                    + [0 if x is None else x.data_ptr() for x in lanes]
                    + [ops.data_ptr(), n_write.data_ptr(),
                       0 if late_v is None else late_v.data_ptr()], dtype=np.uint64)
    nf = float(np.float32(n)) if n > 0 else 1.0
    scal = np.concatenate([np.array([_f32(elapsed), _f32(adv), _f32(rate),
                                     _f32(np.float32(1.0) / np.float32(nf))], np.float32),
                           _CONSTS])
    rc = lib("walk_kernel").voice_walk(
        ptrs.ctypes.data, scal.ctypes.data, V, _rot_vps(rot_prev, V, "rot_prev"),
        _rot_vps(rot, V, "rot"), _vps(nw.shape[0], V, "nw"),
        0 if motion is None else motion[0].shape[0], cap, _stream_ptr(dev))
    LAUNCHES["voice_walk"] += 1
    _raise_rc(rc, "voice_walk")
    ro = {
        "mask": st["mask"],
        "maskf": ops[16],
        "p_gain_c": [ops[5], ops[13]],
        "d_gain_c": [ops[6], ops[14]],
        "base_c": [opi[0], opi[8]],
        "frac_c": [ops[1], ops[9]],
        "split_c": [(opi[2], ops[3], ops[4]), (opi[10], ops[11], ops[12])],
        "frz_c": [ops[7], ops[15]],
    }
    return {k: st[k] for k in WALK_KEYS if k in st}, ro, n_write, late_v
