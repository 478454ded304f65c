"""K6's arena form (``stream_kernels.arena_resample``, the sampler reads of
FramesSignal, Cycle and the seek pool) against the JAX package's
``_dr_resample`` (oddio_tpu/core/frames.py: row-window gather, then the
interpreted ``strip_resample``) on the same operands and the same guarded
and looped arena.

Both evaluate the same f32 position math op for op, so they read the same
arena samples at the same fractions: the JAX output equals, bit for bit,
the port's reads and fractions put through a fused lerp.  The interpreted
kernel's XLA:CPU program contracts ``a + fr*(b - a)`` into a fused
multiply-add (ROADMAP R7), which the port's torch and its CUDA kernel
(``--fmad=false``) round in two steps; that is the whole difference: at
most half an ulp of the product ``fr*(b - a)`` (its own rounding) plus an
ulp of the result (the sum rounded from two nearby values).  Cases: ds
tiers 1, 2 and 4, n = 512, 128, 100 and 1, negative ``o0``, cursors before and past a region (its guard
zeros, and the clamp), a two-channel sound's regions at
``goff + c*guard_stride(len)``, and looped regions.  The CUDA kernel is
held to the plain version in test_torch_cuda.py.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from oddio_tpu.core import frames as JF  # noqa: E402
from oddio_tpu_torch.core import frames as PF  # noqa: E402
from oddio_tpu_torch.ops import stream_kernels as SK  # noqa: E402
from oddio_tpu_torch.ops._dev import split_ds  # noqa: E402

torch.set_num_threads(1)

V = 48
L1, LS, LT = 5000, 3300, 700  # mono sound, stereo sound, looped table


def _arena(rng):
    """A guarded arena laid out as core/frames.py lays it: a mono sound, a
    two-channel sound (one guarded region per channel), a looped table."""
    A = PF._Arena(1)
    g1 = A.add_guarded(rng.standard_normal(L1).astype(np.float32))
    st = rng.standard_normal((LS, 2)).astype(np.float32)
    g2 = [A.add_guarded(np.ascontiguousarray(st[:, c])) for c in range(2)]
    assert g2[1] == g2[0] + PF.guard_stride(LS)
    loff, _ = A.add_looped(rng.standard_normal(LT).astype(np.float32))
    return np.concatenate(A._gchunks).reshape(-1, PF.ARENA_ROW), g1, g2[0], loff


def _operands(rng, g1, g2, loff, ds_range, neg):
    """Per-row cursors: a third on the mono region (some far before or past
    it, so the clamp binds), a third on the stereo regions (channel rows
    interleaved as the pool stacks them), a third on the looped region."""
    ds = rng.uniform(*ds_range, V).astype(np.float32)
    if ds_range[0] <= 1.1025 <= ds_range[1]:  # 44.1 kHz at 48 kHz under speed 1.2
        ds[0] = np.float32(44100.0) / np.float32(48000.0) * np.float32(1.2)
    o0 = rng.uniform(-0.99 if neg else 0.0, 0.999, V).astype(np.float32)
    k = V // 3
    xg = np.empty(V, np.int32)
    lo = np.empty(V, np.int32)
    hi = np.empty(V, np.int32)
    base = rng.integers(-3000, L1 + 400, k)
    base[:3] = (-9000, L1 + 5000, -1)
    xg[:k], lo[:k], hi[:k] = g1 + base, g1 - PF.ARENA_GUARD, g1 + L1
    sb = np.repeat(rng.integers(-200, LS + 200, k // 2), 2)
    goff = g2 + np.tile([0, PF.guard_stride(LS)], k // 2)
    xg[k:2 * k], lo[k:2 * k], hi[k:2 * k] = goff + sb, goff - PF.ARENA_GUARD, goff + LS
    lb = rng.integers(0, LT, V - 2 * k)
    xg[2 * k:], lo[2 * k:], hi[2 * k:] = loff + lb, loff - 1, loff + LT - 1
    return (xg, lo, hi, o0) + tuple(split_ds(ds))


@pytest.mark.parametrize("tier,ds_range", [(1, (0.2, 1.0)), (2, (1.0, 2.0)), (4, (2.0, 4.0))])
@pytest.mark.parametrize("n", [512, 128, 100, 1])
@pytest.mark.parametrize("neg", [False, True])
def test_arena_resample_plain_reads_what_dr_resample_reads(tier, ds_range, n, neg):
    rng = np.random.default_rng(100 * tier + n + int(neg))
    garena, g1, g2, loff = _arena(rng)
    ops = _operands(rng, g1, g2, loff, ds_range, neg)
    xg, lo, hi, o0, di, fh, fl = ops
    ref = np.asarray(JF._dr_resample(
        jnp.asarray(garena), *(jnp.asarray(x) for x in (xg, lo, hi, o0, di, fh, fl)), n,
        DS=tier,
    ))
    T = torch.tensor
    got = SK.arena_resample(T(garena), *(T(x) for x in (xg, lo, hi, o0, di, fh, fl)), n)
    assert SK.LAUNCHES["arena_resample"] == 0  # the plain version launches nothing
    got = got.numpy()
    # the port's reads and fractions, through a fused lerp
    _, p, fr = SK._positions(T(o0), T(di), T(fh), T(fl), n)
    xc = np.clip(xg - 1, lo, hi).astype(np.int64)
    idx = xc[:, None] + 1 + p.numpy()
    flat = garena.reshape(-1)
    a = flat[idx].astype(np.float64)
    b = flat[idx + 1].astype(np.float64)
    d = (b - a).astype(np.float32).astype(np.float64)
    fused = (a + fr.numpy().astype(np.float64) * d).astype(np.float32)
    np.testing.assert_array_equal(ref, fused)
    assert np.abs(ref).max() > 0.5
    prod = np.abs(fr.numpy().astype(np.float64) * d).astype(np.float32)
    assert (np.abs(got - ref) <= 0.5 * np.spacing(prod) + np.spacing(np.abs(ref))).all()
    # the clamped cursors read guard zeros: far before and far past the sound
    np.testing.assert_array_equal(got[:2], 0.0)


def test_arena_resample_reads_the_guards_at_the_region_edges():
    """A cursor just before a sound reads its leading zeros and then the
    sound's first samples; one at its end reads the trailing zeros
    (frames.rs:105-123), on the plain version."""
    rng = np.random.default_rng(2)
    garena, g1, _, _ = _arena(rng)
    flat = garena.reshape(-1)
    T = torch.tensor
    i32 = np.int32
    xg = np.array([g1 - 4, g1 + L1 - 2], i32)
    ops = (xg, xg * 0 + i32(g1 - PF.ARENA_GUARD), xg * 0 + i32(g1 + L1),
           np.zeros(2, np.float32), np.ones(2, i32), np.zeros(2, np.float32),
           np.zeros(2, np.float32))
    got = SK.arena_resample(T(garena), *(T(x) for x in ops), 8).numpy()
    np.testing.assert_array_equal(got[0], np.r_[np.zeros(4), flat[g1:g1 + 4]])
    np.testing.assert_array_equal(got[1], np.r_[flat[g1 + L1 - 2:g1 + L1], np.zeros(6)])


def test_arena_resample_rejects_bad_operands():
    g = torch.zeros((4, 256))
    i4 = torch.zeros(4, dtype=torch.int32)
    f4 = torch.zeros(4)
    with pytest.raises(TypeError):
        SK.arena_resample(g, i4.long(), i4, i4, f4, i4, f4, f4, 8)
    with pytest.raises(ValueError):
        SK.arena_resample(g, i4, i4, i4, torch.zeros(3), i4, f4, f4, 8)
    with pytest.raises(ValueError):
        SK.arena_resample(g, i4, i4, i4, f4, i4, f4, f4, 5000)
    with pytest.raises(TypeError):
        SK.arena_resample(g.double(), i4, i4, i4, f4, i4, f4, f4, 8)


def test_arena_resample_rejects_n_past_its_guards():
    """The regions' guards and loop copies cover RESAMPLE_NMAX frames at
    ds <= 4: a longer n is refused, on the CPU as on the card."""
    g = torch.zeros((4 * PF.ARENA_GUARD // PF.ARENA_ROW, PF.ARENA_ROW))
    i4 = torch.full((4,), PF.ARENA_GUARD, dtype=torch.int32)
    f4 = torch.zeros(4)
    ops = (i4, i4 * 0, i4 * 2, f4, i4 * 0 + 4, f4, f4)
    assert SK.arena_resample(g, *ops, SK.RESAMPLE_NMAX).shape == (4, SK.RESAMPLE_NMAX)
    with pytest.raises(ValueError):
        SK.arena_resample(g, *ops, SK.RESAMPLE_NMAX + 1)


def test_arena_resample_keeps_reads_inside_the_arena():
    """A step past RESAMPLE_DSMAX on the arena's last region, or a clamp
    bound before its start, would read past the arena's ends: each such
    read takes the nearest end (the kernel does the same), and the reads
    inside the arena are unchanged."""
    rng = np.random.default_rng(3)
    garena, g1, _, loff = _arena(rng)
    flat = garena.reshape(-1)
    i32 = np.int32
    xg = np.array([loff + LT - 2, -40], i32)
    ops = (xg, np.array([loff - 1, -50], i32), np.array([loff + LT - 1, 10], i32),
           np.zeros(2, np.float32)) + tuple(split_ds(np.array([64.0, 1.0], np.float32)))
    got = SK.arena_resample(torch.tensor(garena), *(torch.tensor(x) for x in ops), 512).numpy()
    p = np.minimum(loff + LT - 2 + 64 * np.arange(512), flat.size - 2)
    np.testing.assert_array_equal(got[0], flat[p])
    np.testing.assert_array_equal(got[1], flat[np.maximum(np.arange(512) - 40, 0)])
