"""The port's split-cursor twins (oddio_tpu_torch/ops/_dev.py) against the
JAX package's originals (oddio_tpu/ops/_dev.py) on the same seeded inputs.

Against eager jnp (one XLA op per call, nothing fused) every output is held
bit for bit, integers and floats alike.  Under ``jax.jit``, XLA:CPU contracts
``a*b + c`` into one fused multiply-add (a single rounding), which eager
torch never does; jitted float outputs are then held to <= 1 ulp, and
integer outputs stay bit-exact.  The JAX scene renders through jitted
programs, which is where the scene-level tests' 1e-5 bound comes from.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from oddio_tpu.ops import _dev as J  # noqa: E402
from oddio_tpu_torch.ops import _dev as P  # noqa: E402

torch.set_num_threads(1)


def _split_inputs(rng, V, lo, hi):
    ds = rng.uniform(lo, hi, V)
    return J.split_ds(ds)


@pytest.mark.parametrize("jit", [False, True])
def test_exact_positions(jit):
    rng = np.random.default_rng(0)
    V, n = 64, 513
    di, fh, fl = _split_inputs(rng, V, -0.5, 2.5)
    o0 = rng.uniform(-0.999, 0.999, V).astype(np.float32)
    for signed in (False, True):
        f = (
            jax.jit(J.exact_positions, static_argnums=(4, 5)) if jit
            else J.exact_positions
        )
        w, r = f(jnp.asarray(o0), jnp.asarray(di), jnp.asarray(fh),
                 jnp.asarray(fl), n, signed)
        w2, r2 = P.exact_positions(torch.tensor(o0), torch.tensor(di),
                                   torch.tensor(fh), torch.tensor(fl), n, signed)
        assert w2.dtype == torch.int32 and r2.dtype == torch.float32
        if not jit:
            np.testing.assert_array_equal(np.asarray(w), w2.numpy())
            np.testing.assert_array_equal(np.asarray(r), r2.numpy())
        else:
            # an FMA'd fraction moves a floor boundary at most to its twin:
            # whole + fract agrees to an ulp of the position
            pos = np.asarray(w, np.float64) + np.asarray(r, np.float64)
            pos2 = w2.numpy().astype(np.float64) + r2.numpy()
            assert np.abs(pos - pos2).max() <= 2.0**-23 * max(1.0, np.abs(pos).max())


def test_split_ds_and_device_split_ds():
    rng = np.random.default_rng(1)
    ds = rng.uniform(-3.0, 5.0, 4096).astype(np.float32)
    for a, b in zip(J.split_ds(ds), P.split_ds(ds)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(J.device_split_ds(jnp.asarray(ds)),
                    P.device_split_ds(torch.tensor(ds))):
        assert str(np.asarray(a).dtype) == str(b.numpy().dtype)
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("count", [1, 128, 511, 4095])
def test_device_advance_negative_and_wrapping(count):
    rng = np.random.default_rng(2)
    V = 256
    base = rng.integers(-(2**20), 2**20, V).astype(np.int32)
    frac = rng.uniform(0, 1, V).astype(np.float32)
    di, fh, fl = _split_inputs(rng, V, -1.5, 3.0)
    a = J.device_advance(jnp.asarray(base), jnp.asarray(frac), jnp.int32(count),
                         jnp.asarray(di), jnp.asarray(fh), jnp.asarray(fl))
    b = P.device_advance(torch.tensor(base), torch.tensor(frac), count,
                         torch.tensor(di), torch.tensor(fh), torch.tensor(fl))
    b_t = P.device_advance(torch.tensor(base), torch.tensor(frac),
                           torch.full((V,), count, dtype=torch.int32),
                           torch.tensor(di), torch.tensor(fh), torch.tensor(fl))
    for x, y, z in zip(a, b, b_t):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
        np.testing.assert_array_equal(y.numpy(), z.numpy())


@pytest.mark.parametrize("jit", [False, True])
def test_sin_turns(jit):
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, 100_000).astype(np.float32)
    x[:4] = [0.0, 0.25, 0.5, np.float32(1.0) - np.float32(2**-24)]
    f = jax.jit(J.sin_turns) if jit else J.sin_turns
    a = np.asarray(f(jnp.asarray(x)))
    b = P.sin_turns(torch.tensor(x)).numpy()
    if jit:
        assert np.abs(a - b).max() <= 2.0**-23  # one ulp of values near 1
    else:
        np.testing.assert_array_equal(a, b)


def test_top12_and_warp_shift():
    rng = np.random.default_rng(4)
    x = rng.standard_normal(4096).astype(np.float32) * 100
    np.testing.assert_array_equal(J.top12(x), P.top12(x))
    np.testing.assert_array_equal(
        np.asarray(J.device_top12(jnp.asarray(x))),
        P.device_top12(torch.tensor(x)).numpy(),
    )
    V = 128
    rate = rng.uniform(8000, 96000, V).astype(np.float32)
    r_hi = J.top12(rate)
    t = rng.uniform(-2.0, 10.0, (V, 2)).astype(np.float32)
    a = J.warp_shift(jnp.asarray(rate), jnp.asarray(r_hi), jnp.asarray(t))
    b = P.warp_shift(torch.tensor(rate), torch.tensor(r_hi), torch.tensor(t))
    for x1, y1 in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x1), y1.numpy())


def test_to_trunc_form_and_chunked_frames():
    rng = np.random.default_rng(5)
    base = rng.integers(-50, 50, 512).astype(np.int32)
    frac = rng.uniform(0, 1, 512).astype(np.float32)
    frac[:8] = 0.0
    for x, y in zip(J.to_trunc_form(jnp.asarray(base), jnp.asarray(frac)),
                    P.to_trunc_form(torch.tensor(base), torch.tensor(frac))):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())

    # a 1300-frame walk in 512-frame chunks, cursors re-based between
    # chunks with device_advance — both packages, same pieces
    V, n = 32, 1300
    di, fh, fl = _split_inputs(rng, V, 0.5, 1.5)
    c0 = rng.uniform(0, 1, V).astype(np.float32)

    def run(mod, xp, arrs):
        o0, d, h, l_ = arrs

        def ev(c, n_c):
            return mod.exact_positions(c, d, h, l_, n_c)[1]

        def adv(c, n_c):
            cnt = jnp.int32(n_c) if xp is jnp else n_c
            return mod.device_advance(xp.zeros_like(d), c, cnt, d, h, l_)[1]

        return mod.chunked_frames(ev, adv, o0, n)

    a = run(J, jnp, [jnp.asarray(v) for v in (c0, di, fh, fl)])
    b = run(P, torch, [torch.tensor(v) for v in (c0, di, fh, fl)])
    assert b.shape == (V, n)
    np.testing.assert_array_equal(np.asarray(a), b.numpy())
