"""The port's ring kernels (oddio_tpu_torch/ops/ring_kernels.py) against the
JAX package's Pallas kernels, run in interpret mode as its own tests run
them.

* K1 ``rows_append`` vs ``rows_append_dma``: exact (a copy).
* K2 ``window_select_ears`` vs ``window_select_tiles_ears``, with and
  without frozen flags, with ``hmax``: <= 1e-6 abs.  The plain version mixes
  voices in the reference's matvec form; the remaining gap is the order of
  that voice sum (XLA's dot vs torch's) and XLA:CPU's fused multiply-adds in
  the interpreted position math.
* K3 ``window_select_multi``: equal to four K2 calls on the same blocks
  (bit for bit, same arithmetic), and <= 1e-6 abs of the Pallas kernel.

The CUDA kernels are held to these plain versions in test_torch_cuda.py.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from oddio_tpu.ops import pallas_ring as PR  # noqa: E402
from oddio_tpu.ops._dev import device_split_ds  # noqa: E402
from oddio_tpu_torch.ops import ring_kernels as RK  # noqa: E402

torch.set_num_threads(1)

EMAX2 = 127 + 33  # 48 kHz ear stagger + the 128-lane granule remainder
GW = 1024


def _select_inputs(rng, V, n, K, S2, nb=1, hcap=8):
    """Seeded per-ear operands in the layout the spatial pool builds."""
    ds = rng.uniform(1 - K / n, 1 + K / n, (V, 2 * nb)).astype(np.float32)
    di, fh, fl = (np.asarray(x) for x in device_split_ds(jnp.asarray(ds)))
    ofrac = rng.uniform(0, 1, (V, 2 * nb)).astype(np.float32)
    scal = np.stack([ofrac, fh, fl, di.astype(np.float32)], -1)  # (V, 2nb, 4)
    scal01 = [scal[:, e::2].reshape(V, 4 * nb).copy() for e in range(2)]
    gain = rng.uniform(0, 1, (V, 2 * nb, 2)).astype(np.float32)
    gain[..., 1] = rng.uniform(-1e-3, 1e-3, (V, 2 * nb))
    maskf = rng.integers(0, 2, (V, 1, 1)).astype(np.float32)
    gain = gain * maskf
    g01 = [gain[:, e::2].reshape(V, 2 * nb).copy() for e in range(2)]
    e01 = [rng.integers(0, EMAX2, (V, nb)).astype(np.int32) for _ in range(2)]
    frz01 = [(rng.uniform(0, 1, (V, nb)) > 0.7).astype(np.float32) for _ in range(2)]
    wide = rng.standard_normal((V, S2)).astype(np.float32)
    rowshift = rng.integers(0, hcap, (V, nb)).astype(np.int32)
    return wide, rowshift, scal01, g01, e01, frz01


def _t(xs, device="cpu"):
    if isinstance(xs, (list, tuple)):
        return [torch.tensor(x, device=device) for x in xs]
    return torch.tensor(xs, device=device)


def _ears_span(n, K):
    WIN = RK.select_window(n, EMAX2, K)
    return -(-(GW - 1 + WIN) // GW) * GW


def test_rows_append_matches_pallas():
    rng = np.random.default_rng(0)
    V, RPV = 16, 40
    ring = rng.standard_normal((V, RPV, 128)).astype(np.float32)
    samples = rng.standard_normal((V, 513)).astype(np.float32)
    ref = np.asarray(PR.rows_append_dma(
        jnp.asarray(ring), jnp.asarray(samples[:, :512]), 12, 30, interpret=True
    ))
    before = RK.LAUNCHES["append"]
    got = RK.rows_append(torch.tensor(ring), torch.tensor(samples)[:, :512],
                         torch.tensor(12, dtype=torch.int32), 30)
    np.testing.assert_array_equal(ref, got.numpy())
    assert RK.LAUNCHES["append"] == before  # the plain version launches nothing


@pytest.mark.parametrize("K", [32, 64])
@pytest.mark.parametrize("n", [128, 512])
@pytest.mark.parametrize("V", [1, 3, 16])
def test_window_select_ears_matches_pallas(V, n, K):
    rng = np.random.default_rng(V * 1000 + n + K)
    S2 = _ears_span(n, K)
    wide, rowshift, scal01, g01, e01, frz01 = _select_inputs(rng, V, n, K, S2)
    for frz in (None, frz01):
        ref = np.asarray(PR.window_select_tiles_ears(
            jnp.asarray(wide), jnp.asarray(rowshift[:, 0]),
            [jnp.asarray(s) for s in scal01], [jnp.asarray(g) for g in g01],
            [jnp.asarray(e) for e in e01], n=n, K=K, emax2=EMAX2,
            interpret=True, hmax=8,
            frz01=None if frz is None else [jnp.asarray(f) for f in frz],
        ))
        got = RK.window_select_ears(
            _t(wide), _t(rowshift[:, 0]), _t(scal01), _t(g01), _t(e01),
            n=n, K=K, emax2=EMAX2, hmax=8,
            frz01=None if frz is None else _t(frz),
        ).numpy()
        assert got.shape == (2, n)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def _multi_geometry(n, K, nb):
    adv = n  # ratio 1: the window advances one block per block
    row0s = [max(0, int(np.floor(b * (adv - K) / 128))) for b in range(nb)]
    hs = [int(GW - 1 + b * (adv + K)) // 128 - row0s[b] + 1 for b in range(nb)]
    WIN = RK.select_window(n, EMAX2, K)
    S2 = -(-int(GW - 1 + (nb - 1) * (adv + K) + WIN) // GW) * GW
    return row0s, hs, S2


@pytest.mark.parametrize("K", [32, 64])
def test_window_select_multi_matches_blocks_and_pallas(K):
    rng = np.random.default_rng(7 + K)
    V, n, nb = 16, 512, 4
    row0s, hs, S2 = _multi_geometry(n, K, nb)
    wide, rowshift, scal01, g01, e01, frz01 = _select_inputs(
        rng, V, n, K, S2, nb=nb, hcap=min(hs)
    )
    kw = dict(n=n, K=K, emax2=EMAX2, nb=nb, row0s=row0s, hs=hs)
    got = RK.window_select_multi(
        _t(wide), _t(rowshift), _t(scal01), _t(g01), _t(e01), _t(frz01), **kw
    ).numpy()
    assert got.shape == (2, nb * n)
    # four K2 calls on each block's slice of the superwindow
    for b in range(nb):
        blk = RK.window_select_ears(
            _t(wide[:, 128 * row0s[b]:].copy()), _t(rowshift[:, b].copy()),
            [_t(s[:, 4 * b : 4 * b + 4].copy()) for s in scal01],
            [_t(g[:, 2 * b : 2 * b + 2].copy()) for g in g01],
            [_t(e[:, b : b + 1].copy()) for e in e01],
            n=n, K=K, emax2=EMAX2, hmax=hs[b],
            frz01=[_t(f[:, b : b + 1].copy()) for f in frz01],
        ).numpy()
        np.testing.assert_array_equal(got[:, b * n : (b + 1) * n], blk)
    ref = np.asarray(PR.window_select_tiles_multi(
        jnp.asarray(wide), jnp.asarray(rowshift),
        [jnp.asarray(s) for s in scal01], [jnp.asarray(g) for g in g01],
        [jnp.asarray(e) for e in e01], [jnp.asarray(f) for f in frz01],
        interpret=True, **kw,
    ))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def _chunk_order_mix(samps, gs, n, drop=None, partial_dtype=torch.float32):
    """The CUDA select kernel's voice sum, in torch: float32 products added
    voice by voice within 16-voice chunks, each chunk's partial sum stored
    as ``partial_dtype``, the chunks added in order.  ``drop`` zeroes one
    voice, as a kernel that skips it would."""
    jn = torch.arange(n, dtype=torch.float32)
    rows = []
    for samp, g in zip(samps, gs):
        m = []
        for col in range(2):
            x = g[:, col : col + 1] * samp
            if drop is not None:
                x[drop] = 0.0
            xc = x.reshape(-1, RK.VOICE_CHUNK, n)
            part = torch.zeros_like(xc[:, 0])
            for i in range(RK.VOICE_CHUNK):
                part = part + xc[:, i]
            part = part.to(partial_dtype).to(torch.float32)
            acc = torch.zeros(n)
            for c in range(part.shape[0]):
                acc = acc + part[c]
            m.append(acc)
        rows.append(m[0] + jn * m[1])
    return torch.stack(rows)


@pytest.mark.parametrize("fault", [None, "drop_voice", "bf16_partials"])
def test_mix_tolerance_fails_planted_faults(fault):
    """At the main path's width (4096 voices, gains to 0.05) the kernel's
    voice-sum order stays within ``mix_tolerance`` of the plain version,
    while a kernel that drops one voice or keeps bf16 partial sums does
    not."""
    rng = np.random.default_rng(40)
    V, n = 4096, 512
    samps = [_t(rng.standard_normal((V, n)).astype(np.float32)) for _ in range(2)]
    gs = []
    for _ in range(2):
        g = np.stack([rng.uniform(0, 0.05, V), rng.uniform(-1e-4, 1e-4, V)], -1)
        gs.append(_t(g.astype(np.float32)))
    plain = RK._mix_rows(samps, gs, n)
    got = _chunk_order_mix(
        samps, gs, n, drop=1000 if fault == "drop_voice" else None,
        partial_dtype=torch.bfloat16 if fault == "bf16_partials" else torch.float32,
    )
    within = bool(((got - plain).abs().double() <= RK.mix_tolerance(samps, gs, n)).all())
    assert within == (fault is None)


def test_wrappers_reject_bad_operands():
    x = torch.zeros((4, 8, 128))
    with pytest.raises(ValueError):
        RK.rows_append(x, torch.zeros((4, 100)), 0, 1)  # W % 128 != 0
    with pytest.raises(TypeError):
        RK.rows_append(x.double(), torch.zeros((4, 128), dtype=torch.float64), 0, 1)
    with pytest.raises(ValueError):
        RK.window_select_ears(
            torch.zeros((2, 64)), torch.zeros(2, dtype=torch.int32),
            [torch.zeros((2, 4))] * 2, [torch.zeros((2, 2))] * 2,
            [torch.zeros((2, 1), dtype=torch.int32)] * 2, n=128, K=32,
            emax2=EMAX2,
        )  # span narrower than the select window
