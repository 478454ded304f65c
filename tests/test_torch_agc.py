"""The port's AGC gains (oddio_tpu_torch/ops/agc.py K7 and the Adapt scan
``_ema_gain``) against the JAX package and a float64 sequential oracle.

* ``agc_gains`` plain vs JAX ``ema_gain_closed`` and ``agc_gains`` (Pallas,
  interpret mode), with rows whose ``count`` < n: within
  ``agc.agc_tolerance`` elementwise (the bound the CUDA kernel is held to
  on the card; the measured gap is about a quarter of it, <= 1.8e-7 on
  gains of 0.1 to 8).
* ``_ema_gain`` (Hillis-Steele scan) vs JAX's ``associative_scan``: the
  same maps composed in another order; gains within 5e-7, carries within
  1e-6 relative (measured 1.8e-7 and 1.1e-7).
* Near the closed form's gate (EMA_NMAX * interval/tau close to EMA_GATE,
  tau = 0.334 ms at 48 kHz), judged against the float64 sequential
  recurrence of adapt.rs:69-88, not against the JAX package (ROADMAP R2):
  gains within 2e-6, output samples within the 1e-5 contract (measured
  6e-7 and 2.7e-7).
* The tolerance fails planted faults, in a float32 emulation of the CUDA
  kernel's arithmetic order: an inclusive prefix where the exclusive one
  belongs, and a dropped ``count`` freeze.
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


def _within(got, ref, tol):
    return bool((np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
                 <= tol.numpy()).all())


@pytest.mark.parametrize("V,n", [(8, 128), (20, 512)])
def test_agc_plain_matches_jax_closed_form_and_kernel(V, n):
    args = _inputs(V, n, V * 1000 + n)
    J = [jnp.asarray(x) for x in args]
    T = [torch.tensor(x) for x in args]
    gj, cj = jax_closed(*J, n)
    gk, ck = jax_agc_gains(J[1], jax_pack(J[0], J[2], J[3], J[4], J[5], J[6]),
                           n=n, interpret=True)
    scal = A.pack_agc_scalars(T[0], T[2], T[3], T[4], T[5], T[6])
    before = A.LAUNCHES["agc_gains"]
    g, c = A.agc_gains(T[1], scal, n)
    assert A.LAUNCHES["agc_gains"] == before  # the plain version launches nothing
    tol_g, tol_c = A.agc_tolerance(T[1], scal, n)
    for gr, cr in ((gj, cj), (gk, ck)):
        assert _within(g, gr, tol_g)
        assert _within(c, cr, tol_c)
        assert np.abs(g.numpy() - np.asarray(gr)).max() <= 5e-7


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
    iv = np.float32(1.0 / 48000.0)
    tau = np.float32(3.34e-4)
    assert 31.0 < n * float(iv) / float(tau) <= A.EMA_GATE
    alpha = np.float32(1.0) - np.exp(-iv / tau, dtype=np.float32)
    args = _inputs(16, n, 5, alpha=alpha)
    T = [torch.tensor(x) for x in args]
    scal = A.pack_agc_scalars(T[0], T[2], T[3], T[4], T[5], T[6])
    g, c = A.agc_gains(T[1], scal, n)
    go, co = _sequential_f64(*args)
    assert np.abs(g.numpy() - go).max() <= 2e-6
    assert np.abs((g.numpy() - go) * args[1]).max() <= 1e-5
    assert (np.abs(c.numpy() - co) <= 2e-6 * co).all()


# --- planted faults ------------------------------------------------------------


def _kernel_order(s, scal, n, fault=None):
    """float32 emulation of csrc/agc_kernel.cu: the same ops, and the
    prefix sum in its order (5-step warp shuffle scan, then the scanned
    warp totals added back).  ``fault``: "inclusive" uses csum where the
    exclusive prefix belongs; "count" drops the count freeze."""
    V = s.shape[0]
    avg0, a, lg, lim, low, high, mg = (scal[:, k : k + 1] for k in range(7))
    if fault == "count":
        lim = torch.full_like(lim, float(n))
    i_f = torch.arange(n, dtype=torch.float32)
    s2 = s * s
    M = torch.exp(torch.minimum(i_f + 1.0, lim) * lg)
    term = torch.where(i_f < lim, (a * s2) / M, 0.0)

    def warp_scan(x):
        for d in (1, 2, 4, 8, 16):
            x = torch.cat([x[..., :d], x[..., d:] + x[..., :-d]], dim=-1)
        return x

    x = warp_scan(term.view(V, n // 32, 32))
    tot = torch.zeros((V, 32))
    tot[:, : n // 32] = x[..., 31]
    w = warp_scan(tot)[:, : n // 32]
    csum = x.clone()
    csum[:, 1:] = x[:, 1:] + w[:, :-1, None]
    csum = csum.reshape(V, n)
    excl = csum if fault == "inclusive" else csum - term
    prev = torch.exp(torch.minimum(i_f, lim) * lg) * (avg0 + excl)
    avg2 = s2 * a + prev * (1.0 - a)
    gain = A._gain(avg2, low, high, mg)
    carry = torch.exp(torch.minimum(torch.tensor(float(n)), lim) * lg)[:, 0] * (
        avg0[:, 0] + csum[:, -1]
    )
    return gain, carry


def _worst(got, ref, tol):
    d = (got.double() - ref.double()).abs()
    return float((d / tol.clamp_min(1e-300)).max())


def test_agc_tolerance_fails_planted_faults():
    """The kernel's own summation order sits inside the tolerance; each
    planted fault lands far outside it (at the smoke's tau = 0.1 s)."""
    V, n = 256, 512
    iv = np.float32(1.0 / 48000.0)
    alpha = np.float32(1.0) - np.exp(-iv / np.float32(0.1), dtype=np.float32)
    args = _inputs(V, n, 11, alpha=alpha)
    T = [torch.tensor(x) for x in args]
    scal = A.pack_agc_scalars(T[0], T[2], T[3], T[4], T[5], T[6])
    g, c = A.agc_gains_plain(T[1], scal, n)
    tol_g, tol_c = A.agc_tolerance(T[1], scal, n)
    ge, ce = _kernel_order(T[1], scal, n)
    assert _worst(ge, g, tol_g) <= 1.0 and _worst(ce, c, tol_c) <= 1.0
    gi, _ = _kernel_order(T[1], scal, n, fault="inclusive")
    assert _worst(gi, g, tol_g) > 10.0
    gc, cc = _kernel_order(T[1], scal, n, fault="count")
    assert max(_worst(gc, g, tol_g), _worst(cc, c, tol_c)) > 10.0
