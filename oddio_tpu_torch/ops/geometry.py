"""Device-side spatial geometry (counterpart of oddio_tpu/ops/geometry.py).

The same f32 formulas as the reference (spatial.rs:501-511 smoothing,
math/mod.rs:62-94 quaternions, spatial.rs:530-550 ear states), term for
term, on torch tensors.  Vectors travel as tuples of (V,) components, as in
the JAX package's component-split twins, so the expression trees (and so the
rounding) are identical to it.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "smoothed_position",
    "smoothed_position_c",
    "quat_rotate_c",
    "ear_states_c",
    "unstack3",
    "v3_norm_c",
    "SPEED_OF_SOUND",
    "HEAD_RADIUS",
    "POSITION_SMOOTHING_PERIOD",
    "EAR_POS",
    "EAR_DIR",
]

#: spatial.rs:602 — rate sound travels from signals to listeners (m/s)
SPEED_OF_SOUND = np.float32(343.0)
#: spatial.rs:605 — distance from center of head to an ear (m)
HEAD_RADIUS = np.float32(0.1075)
#: spatial.rs:520 — seconds over which to smooth position discontinuities
POSITION_SMOOTHING_PERIOD = np.float32(0.5)

# Ear geometry (spatial.rs:571-598): positions of ears wrt a head facing -Z,
# and the unit direction of least attenuation ([+-4, 0, -1] normalized).
_SQRT17 = np.sqrt(np.float32(17.0), dtype=np.float32)
EAR_POS = np.array(
    [[-HEAD_RADIUS, 0.0, 0.0], [HEAD_RADIUS, 0.0, 0.0]], dtype=np.float32
)
EAR_DIR = np.array(
    [
        [np.float32(-4.0) / _SQRT17, 0.0, np.float32(-1.0) / _SQRT17],
        [np.float32(4.0) / _SQRT17, 0.0, np.float32(-1.0) / _SQRT17],
    ],
    dtype=np.float32,
)

_NEG_INV_C = float(np.float32(-1.0) / SPEED_OF_SOUND)
_T = float(POSITION_SMOOTHING_PERIOD)


def smoothed_position(prev_position, state_dt, dt_extra, motion_pos, motion_vel):
    """State::smoothed_position (spatial.rs:501-511), batched (V, 3)."""
    dt = state_dt + float(np.float32(dt_extra))
    change = motion_vel * dt[:, None]
    naive = prev_position + change
    intended = motion_pos + change
    r = torch.clamp(dt / _T, max=1.0)[:, None]
    return (1.0 - r) * naive + r * intended


def unstack3(p):
    """(V, 3) -> ((V,), (V,), (V,)) component views."""
    return p[:, 0], p[:, 1], p[:, 2]


def v3_norm_c(p3):
    x, y, z = p3
    return torch.sqrt(x * x + (y * y + z * z))


def smoothed_position_c(prev3, state_dt, dt_extra, mp3, mv3):
    """smoothed_position on component tuples; bit-identical."""
    dt = state_dt + float(np.float32(dt_extra))
    r = torch.clamp(dt / _T, max=1.0)
    one_r = 1.0 - r
    out = []
    for pv, mp, mv in zip(prev3, mp3, mv3):
        change = mv * dt
        out.append(one_r * (pv + change) + r * (mp + change))
    return tuple(out)


def quat_rotate_c(rot, p3):
    """Rotate component-tuple points by a SHARED quaternion ``rot`` (4,),
    mirroring quat_mul(rot, quat_mul(pq, quat_invert(rot)))[1:] term for
    term (including the literal zero products of pq's scalar part)."""
    rs, rx, ry, rz = rot[0], rot[1], rot[2], rot[3]
    nrx, nry, nrz = rx * -1.0, ry * -1.0, rz * -1.0
    x, y, z = p3
    z0 = torch.zeros_like(x)
    # A = quat_mul(pq, quat_invert(rot)), pq = (0, x, y, z)
    As = z0 * rs - x * nrx - y * nry - z * nrz
    Ax = z0 * nrx + x * rs + y * nrz - z * nry
    Ay = z0 * nry - x * nrz + y * rs + z * nrx
    Az = z0 * nrz + x * nry - y * nrx + z * rs
    # out = quat_mul(rot, A)[1:]
    Ox = rs * Ax + rx * As + ry * Az - rz * Ay
    Oy = rs * Ay - rx * Az + ry * As + rz * Ax
    Oz = rs * Az + rx * Ay - ry * Ax + rz * As
    return Ox, Oy, Oz


def ear_states_c(p3, radius):
    """EarState::new for both ears (spatial.rs:530-550) on a component
    tuple; returns per-ear lists ([off_L, off_R], [gain_L, gain_R]) of (V,)
    tensors (the literal ear-constant zero terms are kept)."""
    x, y, z = p3
    offs, gains = [], []
    for e in range(2):
        ex, ey, ez = (float(c) for c in EAR_POS[e])
        relx, rely, relz = x - ex, y - ey, z - ez
        distance = torch.sqrt(relx * relx + (rely * rely + relz * relz))
        offset = distance * _NEG_INV_C
        distance_gain = radius / torch.maximum(distance, radius)
        inv = 0.5 / distance
        sx, sy, sz = x * inv, y * inv, z * inv
        edx, edy, edz = (float(c) for c in EAR_DIR[e])
        d = edx * sx + (edy * sy + edz * sz)
        stereo_gain = 0.5 + torch.where(distance < 1e-3, 0.5, d)
        offs.append(offset)
        gains.append(stereo_gain * distance_gain)
    return offs, gains
