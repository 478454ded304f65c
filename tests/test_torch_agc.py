"""The port's AGC (oddio_tpu_torch/ops/agc.py K7 ``agc_step`` and the Adapt
scan ``_ema_gain``) against the JAX package and a float64 sequential
oracle.

* ``agc_step`` plain vs JAX ``ema_gain_closed`` and ``agc_gains`` (Pallas,
  interpret mode), fed the same alpha, with rows whose ``count`` < n:
  output samples and carries within ``agc.agc_tolerance`` elementwise
  (the bound the CUDA kernel is held to on the card), gains within 5e-7.
* ``_ema_gain`` (Hillis-Steele scan) vs JAX's ``associative_scan``: the
  same maps composed in another order; gains within 5e-7, carries within
  1e-6 relative (measured 1.8e-7 and 1.1e-7).
* Near the closed form's gate (n * interval/tau close to EMA_GATE,
  tau = 0.334 ms at 48 kHz), judged against the float64 sequential
  recurrence of adapt.rs:69-88, not against the JAX package (ROADMAP R2):
  gains within 2e-6, output samples within the 1e-5 contract (measured
  6e-7 and 2.7e-7).
* The tolerance fails planted faults, in a float32 emulation of the CUDA
  kernel's arithmetic order (lane-serial sums over F frames, a shuffle
  scan of the lane totals): an inclusive prefix where the exclusive one
  belongs, a dropped ``count`` freeze, channel 1 left out of the level,
  and the tail frame of n = 513 left out of the frame mask.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from oddio_tpu.ops.adapt import _ema_gain as jax_ema_gain  # noqa: E402
from oddio_tpu.ops.pallas_agc import agc_gains as jax_agc_gains  # noqa: E402
from oddio_tpu.ops.pallas_agc import ema_gain_closed as jax_closed  # noqa: E402
from oddio_tpu.ops.pallas_agc import pack_agc_scalars as jax_pack  # noqa: E402
from oddio_tpu_torch.ops import agc as A  # noqa: E402
from oddio_tpu_torch.ops.adapt import _ema_gain  # noqa: E402

torch.set_num_threads(1)


IV = np.float32(1.0 / 48000.0)


def _inputs(V, n, seed, alpha=None):
    rng = np.random.default_rng(seed)
    s = (rng.standard_normal((V, n)) * 0.4).astype(np.float32)
    if alpha is None:
        alpha = rng.uniform(1e-5, 0.06, V)
    alpha = np.broadcast_to(np.asarray(alpha, np.float32), (V,)).copy()
    count = rng.integers(0, n + 1, V).astype(np.int32)
    count[: V // 2] = n
    low = np.full(V, np.float32(0.1 / np.sqrt(2)), np.float32)
    high = np.full(V, np.float32(0.5 / np.sqrt(2)), np.float32)
    mg = rng.uniform(1, 8, V).astype(np.float32)
    avg0 = rng.uniform(1e-4, 1.0, V).astype(np.float32)
    return avg0, s, alpha, count, low, high, mg


def _step_args(args):
    """``_inputs`` as ``agc_step``'s operands at a 48 kHz interval: the tau
    of each alpha, and the alpha the step derives from it (which the JAX
    functions are fed)."""
    avg0, s, alpha, count, low, high, mg = args
    tau = (-np.float64(IV) / np.log1p(-alpha.astype(np.float64))).astype(np.float32)
    T = [torch.tensor(x) for x in (s, avg0, tau)]
    step = (T[0], T[1], T[2], float(IV), torch.tensor(count), torch.tensor(low),
            torch.tensor(high), torch.tensor(mg))
    a = A._alpha(float(IV), T[2]).numpy()
    return step, (avg0, s, a, count, low, high, mg)


def _within(got, ref, tol):
    return bool((np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
                 <= tol.numpy()).all())


@pytest.mark.parametrize("V,n", [(8, 128), (20, 512)])
def test_agc_plain_matches_jax_closed_form_and_kernel(V, n):
    step, args = _step_args(_inputs(V, n, V * 1000 + n))
    J = [jnp.asarray(x) for x in args]
    gj, cj = jax_closed(*J, n)
    gk, ck = jax_agc_gains(J[1], jax_pack(J[0], J[2], J[3], J[4], J[5], J[6]),
                           n=n, interpret=True)
    before = A.LAUNCHES["agc_gains"]
    out, c = A.agc_step(*step, n)
    assert A.LAUNCHES["agc_gains"] == before  # the plain version launches nothing
    tol_x, tol_c = A.agc_tolerance(*step, n)
    s = args[1]
    for gr, cr in ((gj, cj), (gk, ck)):
        assert _within(out, s * np.asarray(gr), tol_x)
        assert _within(c, cr, tol_c)
        g = out.numpy() / np.where(s == 0, 1, s)
        assert np.abs(np.where(s == 0, 0, g - np.asarray(gr))).max() <= 5e-7


@pytest.mark.parametrize("V,n", [(8, 128), (20, 512), (5, 384)])
def test_ema_gain_scan_matches_jax(V, n):
    args = _inputs(V, n, 7 + V + n)
    gj, cj = jax.jit(jax_ema_gain, static_argnums=7)(
        *[jnp.asarray(x) for x in args], n
    )
    g, c = _ema_gain(*[torch.tensor(x) for x in args], n)
    assert np.abs(g.numpy() - np.asarray(gj)).max() <= 5e-7
    cj = np.asarray(cj)
    assert (np.abs(c.numpy() - cj) <= 1e-6 * np.abs(cj)).all()


def _sequential_f64(avg0, s, alpha, count, low, high, mg):
    """adapt.rs:69-88 frame by frame in float64 (the carry frozen past
    ``count``, the output still one EMA step from it)."""
    V, n = s.shape
    g = np.zeros((V, n))
    carry = np.zeros(V)
    for v in range(V):
        a = np.float64(alpha[v])
        avg = np.float64(avg0[v])
        for i in range(n):
            x = np.float64(s[v, i])
            a2 = x * x * a + avg * (1.0 - a)
            if i < count[v]:
                avg = a2
            pk = np.sqrt(a2) * np.sqrt(2.0)
            if pk < low[v]:
                g[v, i] = min(low[v] / pk, mg[v])
            elif pk > high[v]:
                g[v, i] = high[v] / pk
            else:
                g[v, i] = 1.0
        carry[v] = avg
    return g, carry


def test_closed_form_near_gate_matches_sequential_oracle():
    n = A.EMA_NMAX
    tau = np.float32(3.34e-4)
    assert 31.0 < n * float(IV) / float(tau) <= A.EMA_GATE
    alpha = np.float32(1.0) - np.exp(-IV / tau, dtype=np.float32)
    step, args = _step_args(_inputs(16, n, 5, alpha=alpha))
    out, c = A.agc_step(*step, n)
    go, co = _sequential_f64(*args)
    s = args[1]
    g = out.numpy() / np.where(s == 0, 1, s)
    assert np.abs(np.where(s == 0, 0, g - go)).max() <= 2e-6
    assert np.abs(out.numpy() - go * s).max() <= 1e-5
    assert (np.abs(c.numpy() - co) <= 2e-6 * co).all()


# --- planted faults ------------------------------------------------------------


def _kernel_order(x, cols, n, fault=None):
    """float32 emulation of csrc/agc_kernel.cu on a (V, C, n) block: the
    same ops, the channel sum in order, and the prefix sum in its order
    (each lane's F frames summed serially, a 5-step shuffle scan of the
    lane totals, the lane's exclusive offset carried serially through its
    frames).  ``fault``: "inclusive" uses the inclusive prefix where the
    exclusive one belongs; "count" drops the count freeze; "channel"
    leaves channel 1 out of the level; "tail" leaves the frames past the
    last multiple of 32 out of the frame mask (they keep the input, the
    carry is never written).  Returns (output (V, C, n), carry)."""
    V = x.shape[0]
    F = next(f for f in (1, 3, 5, 9, 17) if 32 * f >= n)
    avg0, a, lg, lim, low, high, mg = cols
    if fault == "count":
        lim = torch.full_like(lim, float(n))
    s = x[:, 0] if fault == "channel" else x.sum(dim=1)
    i_f = torch.arange(n, dtype=torch.float32)
    s2 = s * s
    M = torch.exp(torch.minimum(i_f + 1.0, lim) * lg)
    term = torch.where(i_f < lim, (a * s2) / M, 0.0)
    tp = torch.zeros((V, 32 * F))
    tp[:, :n] = term
    tp = tp.view(V, 32, F)
    run = torch.zeros((V, 32))
    for k in range(F):
        run = run + tp[..., k]
    incl = run
    for d in (1, 2, 4, 8, 16):
        incl = torch.cat([incl[:, :d], incl[:, d:] + incl[:, :-d]], dim=1)
    cur = torch.cat([torch.zeros((V, 1)), incl[:, :-1]], dim=1)
    excl = torch.zeros((V, 32, F))
    for k in range(F):
        excl[..., k] = cur
        cur = cur + tp[..., k]
    excl = excl.reshape(V, 32 * F)[:, :n]
    if fault == "inclusive":
        excl = excl + term
    prev = torch.exp(torch.minimum(i_f, lim) * lg) * (avg0 + excl)
    avg2 = s2 * a + prev * (1.0 - a)
    gain = A._gain(avg2, low, high, mg)
    carry = M[:, -1] * (avg0[:, 0] + (excl[:, -1] + term[:, -1]))
    if fault == "tail":
        gain[:, n & ~31:] = 1.0
        carry = torch.zeros_like(carry)
    return x * gain[:, None, :], carry


def _worst(got, ref, tol):
    d = (got.double() - ref.double()).abs()
    return float((d / tol.clamp_min(1e-300)).max())


@pytest.mark.parametrize("n,C", [(512, 1), (513, 2)])
def test_agc_tolerance_fails_planted_faults(n, C):
    """The kernel's own summation order sits inside the tolerance; each
    planted fault lands far outside it (at the card tests' tau = 0.1 s)."""
    V = 256
    alpha = np.float32(1.0) - np.exp(-IV / np.float32(0.1), dtype=np.float32)
    step, args = _step_args(_inputs(V, n, 11, alpha=alpha))
    rng = np.random.default_rng(12)
    x = torch.tensor((rng.standard_normal((V, C, n)) * 0.4).astype(np.float32))
    step = (x if C > 1 else x[:, 0],) + step[1:]
    out, c = A.agc_step_plain(*step, n)
    tol_x, tol_c = A.agc_tolerance(*step, n)
    if C == 1:
        out, tol_x = out[:, None], tol_x[:, None]
    cols = A._columns(*step[1:8])
    ge, ce = _kernel_order(x, cols, n)
    assert _worst(ge, out, tol_x) <= 1.0 and _worst(ce, c, tol_c) <= 1.0
    faults = ["inclusive", "count"] + (["channel", "tail"] if C > 1 else [])
    for fault in faults:
        gf, cf = _kernel_order(x, cols, n, fault=fault)
        assert max(_worst(gf, out, tol_x), _worst(cf, c, tol_c)) > 10.0, fault
