"""Host-side float helpers.

The reference (oddio) advances all sequential signal state (cursors, ramps,
geometry) in scalar f32/f64 on the audio thread.  In this TPU rebuild, that
state lives on the *host* in small numpy arrays (one lane per voice), advanced
once per block with the exact same IEEE arithmetic, while the device renders
each block as a pure function of the resulting per-block parameters.

Reference math shim: oddio's src/math/mod.rs (Float trait, vec3 and
quaternion helpers).  numpy elementwise f32 ops are bit-identical to Rust's
scalar f32 ops for the same operation order, which is what makes golden-value
parity possible.
"""

from __future__ import annotations

import numpy as np

F32 = np.float32
F64 = np.float64
I32 = np.int32
I64 = np.int64

#: f32 machine epsilon; equals Rust's ``f32::EPSILON`` (1.1920929e-07).
EPS32 = np.float32(np.finfo(np.float32).eps)

#: f32 rounding of 2*pi; equals Rust's ``core::f32::consts::TAU``.
TAU32 = np.float32(6.283185307179586)


def f32(x):
    """Cast to a float32 numpy array (0-d for scalars)."""
    return np.asarray(x, dtype=np.float32)


def f64(x):
    """Cast to a float64 numpy array (0-d for scalars)."""
    return np.asarray(x, dtype=np.float64)


def i32(x):
    return np.asarray(x, dtype=np.int32)


def full(batch, value, dtype=np.float32, extra=()):
    """Batch-shaped host-state array filled with ``value``."""
    return np.full(tuple(batch) + tuple(extra), value, dtype=dtype)


def rem_euclid(a, b):
    """Rust ``rem_euclid``: remainder with the sign of the divisor.

    numpy's ``mod`` already has divisor-sign semantics, matching
    ``f32::rem_euclid`` for positive divisors (the only use in the reference).
    """
    return np.mod(a, b)


def rust_rem(a, b):
    """Rust ``%`` on floats: fmod semantics (sign of the dividend)."""
    return np.fmod(a, b)


# --- vec3 / quaternion helpers (reference: math/mod.rs:33-94) -------------
# Vectors are numpy arrays with a trailing axis of size 3, batched in front.
# All in f32, matching the reference's op order exactly.


def v3_norm(v):
    """math/mod.rs:33-35 — sqrt(sum(x^2)); powi(2) is an exact multiply."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return np.sqrt(x * x + (y * y + z * z)).astype(np.float32, copy=False)


def v3_dot(a, b):
    """math/mod.rs:37-43."""
    return (
        a[..., 0] * b[..., 0] + (a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2])
    ).astype(np.float32, copy=False)


def v3_scale(v, s):
    return (v * np.asarray(s)[..., None]).astype(np.float32, copy=False)


def v3_mix(a, b, r):
    """math/mod.rs:56-59 — (1-r)*a + r*b, componentwise."""
    r = np.asarray(r, dtype=np.float32)[..., None]
    ir = np.float32(1.0) - r
    return (ir * a + r * b).astype(np.float32, copy=False)


def quat_invert(q):
    """math/mod.rs:62-67 — conjugate.  Layout: (s, x, y, z) trailing axis 4."""
    out = q.copy()
    out[..., 1:] = -out[..., 1:]
    return out


def quat_mul(q, r):
    """math/mod.rs:69-81."""
    qs, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rs, rx, ry, rz = r[..., 0], r[..., 1], r[..., 2], r[..., 3]
    return np.stack(
        [
            qs * rs - qx * rx - qy * ry - qz * rz,
            qs * rx + qx * rs + qy * rz - qz * ry,
            qs * ry - qx * rz + qy * rs + qz * rx,
            qs * rz + qx * ry - qy * rx + qz * rs,
        ],
        axis=-1,
    ).astype(np.float32, copy=False)


def quat_rotate(rot, p):
    """math/mod.rs:83-94 — rotate point p (.., 3) by quaternion rot (.., 4)."""
    pq = np.concatenate([np.zeros_like(p[..., :1]), p], axis=-1)
    out = quat_mul(rot, quat_mul(pq, quat_invert(rot)))
    return out[..., 1:]
