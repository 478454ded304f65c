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
* K5 ``strip_select`` (reading the ring directly) vs ``strip_select`` on
  the row strips gathered from the same ring at the same ``rrow``: <= 1e-6
  abs (the voice-sum order and XLA's fused multiply-adds), including
  near the strip gate, where the TPU kernel's ``SELECT_R - 1`` walk clamp
  binds and both depart from the unclamped read alike (ROADMAP R10).

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


# --- K5: strip select ---------------------------------------------------------------

EMAX = 128 + 33  # spatial._emax(48000)


def _strip_inputs(rng, V, n, L, dsm1_lo, dsm1_hi):
    """Seeded K5 operands in the host buffered pool's layout: per-ear
    steps with |ds - 1| in [dsm1_lo, dsm1_hi] (either sign), read windows
    anywhere in the ring (wrapping), gains of spatial size."""
    mag = rng.uniform(dsm1_lo, dsm1_hi, (V, 2))
    ds = (1.0 + mag * rng.choice([-1.0, 1.0], (V, 2))).astype(np.float32)
    di, fh, fl = (np.asarray(x) for x in device_split_ds(jnp.asarray(ds)))
    ofrac = rng.uniform(0, 1, (V, 2)).astype(np.float32)
    scal = np.stack([ofrac, fh, fl, di.astype(np.float32)], -1)  # (V, 2, 4)
    gain0 = rng.uniform(0, 0.1, (V, 2)).astype(np.float32)
    d_gain = rng.uniform(-1e-4, 1e-4, (V, 2)).astype(np.float32)
    maskf = (rng.uniform(0, 1, V) > 0.2).astype(np.float32)
    rrow = rng.integers(0, L // 128, V).astype(np.int32)
    extra = rng.integers(0, EMAX, (V, 2)).astype(np.int32)
    ring = rng.standard_normal((V, L)).astype(np.float32)
    return ring, rrow, extra, scal, gain0, d_gain, maskf


def _pallas_strip_select(ring, rrow, extra, scal, gain0, d_gain, maskf, n, K):
    """The JAX package's K5 as ``_BufferedPool.render`` calls it: row strips
    gathered from the ring at ``rrow`` (spatial.py:532-546), interpreted."""
    V, L = ring.shape
    rpv = L // 128
    H7 = (EMAX - 1 + 2 * K) // 128 + 1
    need = (-(-n // 128) - 1) * 128 + 128 * (H7 - 1) + 384
    rows = (rrow[:, None] + np.arange(-(-need // 128))) % rpv
    strips = np.stack([ring[v].reshape(rpv, 128)[rows[v]].reshape(-1) for v in range(V)])
    return np.asarray(PR.strip_select(
        jnp.asarray(strips), jnp.asarray(scal), jnp.asarray(gain0),
        jnp.asarray(d_gain), jnp.asarray(maskf), jnp.asarray(extra),
        n=n, K=K, emax=EMAX, interpret=True,
    ))


def _clamp_binds(scal, n, K):
    """Frames whose walk within their sub-block passes SELECT_R - 1."""
    V = scal.shape[0]
    nsb = -(-n // 128)
    hits = 0
    for e in range(2):
        kk, _ = RK._positions(_t(scal[:, e]), nsb * 128, K)
        kk = kk.view(V, nsb, 128)
        r = kk - kk.min(dim=2, keepdim=True).values
        hits += int((r.reshape(V, -1)[:, :n] > RK.SELECT_R - 1).sum())
    return hits


STRIP_CASES = {
    "main": (16, 512, 16384, 0.0, 0.09),
    "singleton": (1, 512, 2048, 0.0, 0.09),
    "partial_subblock": (24, 200, 4096, 0.0, 0.09),
    "near_gate": (32, 512, 16384, 0.119, 0.125),
}


@pytest.mark.parametrize("case", sorted(STRIP_CASES))
def test_strip_select_matches_pallas(case):
    V, n, L, lo, hi = STRIP_CASES[case]
    K = 64
    rng = np.random.default_rng(V + n)
    ops = _strip_inputs(rng, V, n, L, lo, hi)
    ref = _pallas_strip_select(*ops, n, K)
    before = RK.LAUNCHES["strip_select"]
    got = RK.strip_select(*_t(list(ops)), n=n, K=K).numpy()
    assert RK.LAUNCHES["strip_select"] == before  # the plain version launches nothing
    assert got.shape == (2, n) and np.abs(ref).max() > 0.1
    assert (_clamp_binds(ops[3], n, K) > 0) == (case == "near_gate")
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_strip_select_clamp_departs_from_the_exact_read_like_pallas():
    """Near the gate (|ds - 1| up to 0.125, about 43 m/s radially at equal
    rates) the TPU kernel reads at most SELECT_R - 1 past the sub-block's
    smallest walk offset, so frames whose walk reaches 16 read one sample
    early.  Against the exact read (the oracle: whole positions in
    float64, no clamp) the port's plain version departs exactly where and
    as much as the JAX kernel does: a reference-side effect (ROADMAP R10)."""
    V, n, L, lo, hi = STRIP_CASES["near_gate"]
    K = 64
    ring, rrow, extra, scal, gain0, d_gain, maskf = _strip_inputs(
        np.random.default_rng(V + n), V, n, L, lo, hi
    )
    ref = _pallas_strip_select(ring, rrow, extra, scal, gain0, d_gain, maskf, n, K)
    got = RK.strip_select(*_t([ring, rrow, extra, scal, gain0, d_gain, maskf]),
                          n=n, K=K).numpy()
    # the exact read: position o0 + j*ds in float64, lerp, ramp, mask, sum
    j = np.arange(n)
    exact = np.zeros((2, n))
    for e in range(2):
        ds = scal[:, e, 3].astype(np.float64) + scal[:, e, 1] + scal[:, e, 2]
        pos = scal[:, e, 0][:, None].astype(np.float64) + j * ds[:, None]
        whole = np.floor(pos).astype(np.int64)
        fr = pos - whole
        idx = (128 * rrow[:, None].astype(np.int64) + extra[:, e:e + 1]
               + whole - j + K + j) % L
        a = np.take_along_axis(ring, idx, 1).astype(np.float64)
        b = np.take_along_axis(ring, (idx + 1) % L, 1).astype(np.float64)
        g = gain0[:, e:e + 1] + j * d_gain[:, e:e + 1].astype(np.float64)
        exact[e] = ((a + fr * (b - a)) * g * maskf[:, None]).sum(0)
    dev_port, dev_jax = np.abs(got - exact), np.abs(ref - exact)
    assert dev_port.max() > 1e-3  # the clamp binds, by whole samples
    np.testing.assert_allclose(dev_port, dev_jax, rtol=0, atol=2e-6)


def _chunk_order_sum(x, drop=None):
    """The CUDA K5's voice sum in torch: float32 summands added voice by
    voice within 16-voice chunks, then the chunks in order; ``drop``
    zeroes one voice, as a kernel that skips it would."""
    x = x.clone()
    if drop is not None:
        x[drop] = 0.0
    V = x.shape[0]
    pad = (-V) % RK.VOICE_CHUNK
    xc = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])]).reshape(
        -1, RK.VOICE_CHUNK, *x.shape[1:])
    part = torch.zeros_like(xc[:, 0])
    for i in range(RK.VOICE_CHUNK):
        part = part + xc[:, i]
    acc = torch.zeros_like(part[0])
    for c in range(part.shape[0]):
        acc = acc + part[c]
    return acc


@pytest.mark.parametrize("fault", [None, "drop_voice", "no_clamp"])
def test_strip_tolerance_fails_planted_faults(fault):
    """At the main path's width (4096 voices, spatial gains) and near the
    gate, the kernel's voice-sum order stays within ``strip_tolerance`` of
    the plain version, while a kernel that drops a voice or reads without
    the SELECT_R clamp does not."""
    V, n, L, K = 4096, 512, 2048, 64
    ops = _t(list(_strip_inputs(np.random.default_rng(41), V, n, L, 0.1, 0.125)))
    plain = RK.strip_select_plain(*ops, n=n, K=K)
    tol = RK.strip_tolerance(*ops, n=n, K=K)
    R = RK.SELECT_R
    if fault == "no_clamp":
        RK.SELECT_R = 10**6
    try:
        x = RK._strip_products(*ops, n, K)
    finally:
        RK.SELECT_R = R
    loudest = int(torch.argmax(ops[4][:, 0] * ops[6]))
    got = _chunk_order_sum(x, drop=loudest if fault == "drop_voice" else None)
    within = bool(((got - plain).abs().double() <= tol).all())
    assert within == (fault is None)


# --- K8-K10: the flat-window and flat-ring kernels ----------------------------------

from oddio_tpu_torch.ops import flat_kernels as FK  # noqa: E402


def _flat_select_operands(rng, V, emax2, ds_lo, ds_hi):
    """K8/K10 per-ear operands, as pallas_ring's wrappers take them."""
    ds = rng.uniform(ds_lo, ds_hi, (V, 2)).astype(np.float32)
    di, fh, fl = (np.asarray(x) for x in device_split_ds(jnp.asarray(ds)))
    ofrac = rng.uniform(0, 1, (V, 2)).astype(np.float32)
    scal = np.stack([ofrac, fh, fl, di.astype(np.float32)], -1)  # (V, 2, 4)
    extra = rng.integers(0, emax2, (V, 2)).astype(np.int32)
    gain0 = rng.uniform(0, 1, (V, 2)).astype(np.float32)
    d_gain = rng.uniform(-1e-3, 1e-3, (V, 2)).astype(np.float32)
    maskf = (rng.uniform(0, 1, V) > 0.3).astype(np.float32)
    return scal, gain0, d_gain, maskf, extra


@pytest.mark.parametrize("emax2", [36, 163])
def test_window_select_matches_pallas(emax2):
    """K8 against the interpreted ``window_select``, at both table widths
    ``tests/test_ops.py:400`` holds it at; the launch counter does not move
    on the CPU."""
    rng = np.random.default_rng(emax2)
    V, n, K = 8, 256, 64
    win = rng.standard_normal((V, PR.select_window(n, emax2, K))).astype(np.float32)
    scal, gain0, d_gain, maskf, extra = _flat_select_operands(rng, V, emax2, 0.99, 1.01)
    ref = np.asarray(PR.window_select(
        *(jnp.asarray(x) for x in (win, scal, gain0, d_gain, maskf, extra)),
        n=n, K=K, emax2=emax2, interpret=True,
    ))
    before = dict(FK.LAUNCHES)
    got = FK.window_select(*_t([win, scal, gain0, d_gain, maskf, extra]), n=n, K=K,
                           emax2=emax2).numpy()
    assert FK.LAUNCHES == before
    assert got.shape == (2, n) and np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_flat_append_aligned_matches_pallas():
    """K9 against the interpreted ``flat_append_aligned``: exact, both
    legs; a page past the row raises."""
    rng = np.random.default_rng(9)
    V, rowlen = 8, 4096
    ring = rng.standard_normal((V, rowlen)).astype(np.float32)
    samples = rng.standard_normal((V, 1024)).astype(np.float32)
    ref = np.asarray(PR.flat_append_aligned(jnp.asarray(ring), jnp.asarray(samples), 2, 6,
                                            interpret=True))
    got = FK.flat_append_aligned(torch.tensor(ring), torch.tensor(samples),
                                 torch.tensor(2, dtype=torch.int32), 6).numpy()
    np.testing.assert_array_equal(got, ref)
    with pytest.raises(IndexError):
        FK.flat_append_aligned(torch.tensor(ring), torch.tensor(samples), 2, 7)
    with pytest.raises(ValueError):
        FK.flat_append_aligned(torch.tensor(ring), torch.tensor(samples[:, :1000]), 2, 6)


@pytest.mark.parametrize("form", ["ints", "scalars", "pair"])
def test_flat_append_aligned_page_forms(form):
    """K9's pages as host ints, int32 scalar tensors, or one (2,) int32
    pair with ``pmir`` omitted write the same ring; a pair of another
    shape is refused."""
    rng = np.random.default_rng(19)
    V, rowlen = 4, 4096
    ring = rng.standard_normal((V, rowlen)).astype(np.float32)
    samples = rng.standard_normal((V, 512)).astype(np.float32)
    want = ring.copy()
    want[:, 1024:1536] = samples
    want[:, 3072:3584] = samples
    pages = {"ints": (2, 6),
             "scalars": (torch.tensor(2, dtype=torch.int32), torch.tensor(6, dtype=torch.int32)),
             "pair": (torch.tensor([2, 6], dtype=torch.int32),)}[form]
    got = FK.flat_append_aligned(torch.tensor(ring), torch.tensor(samples), *pages)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        FK.flat_append_aligned(torch.tensor(ring), torch.tensor(samples),
                               torch.tensor([2, 6, 1], dtype=torch.int32))


def _dma_operands(rng, V, rowlen, emax2):
    ring = rng.standard_normal((V, rowlen)).astype(np.float32)
    rstart = rng.integers(0, rowlen - 2048, V).astype(np.int32)
    ops = _flat_select_operands(rng, V, emax2, 0.95, 1.05)
    return (ring, rstart) + ops


def _pallas_dma(ops, n, K, emax2):
    return np.asarray(PR.dma_window_select(
        *(jnp.asarray(x) for x in ops), n=n, K=K, emax2=emax2, interpret=True))


@pytest.mark.parametrize("row_end", [False, True])
def test_dma_window_select_matches_pallas(row_end):
    """K10 against the interpreted ``dma_window_select`` (<= 1e-6); with
    ``row_end`` one voice's window runs past its row end, where the TPU's
    fetch from the flat ring reads the next voice's row, and so does the
    port."""
    rng = np.random.default_rng(10 + row_end)
    V, rowlen, n, K, emax2 = 8, 4096, 512, 64, 36
    ops = _dma_operands(rng, V, rowlen, emax2)
    if row_end:
        ops[1][3] = rowlen - 300  # voice 3 reads ~340 samples of row 4
    ref = _pallas_dma(ops, n, K, emax2)
    got = FK.dma_window_select(*_t(list(ops)), n=n, K=K, emax2=emax2).numpy()
    assert got.shape == (2, n) and np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    if row_end:
        # the same reads from the rows laid end to end, voice 3 alone
        flat = ops[0].reshape(-1)
        kk, fr = RK._positions(torch.tensor(ops[2][3:4, 0]), n, K)
        idx = 3 * rowlen + ops[1][3] + ops[6][3, 0] + np.arange(n) + kk.numpy()[0].astype(int)
        assert idx.max() > 4 * rowlen  # into row 4


def test_dma_window_select_fetch_past_the_ring_raises():
    """The last voice's fetch past the tensor (and a negative start) fail,
    as the TPU's out-of-range DMA would; the kernel trips a device-side
    assert there."""
    rng = np.random.default_rng(12)
    V, rowlen, n, K, emax2 = 4, 4096, 512, 64, 36
    ops = list(_dma_operands(rng, V, rowlen, emax2))
    ops[1][V - 1] = rowlen - 1000
    with pytest.raises(IndexError, match="voice 3"):
        FK.dma_window_select(*_t(ops), n=n, K=K, emax2=emax2)
    ops[1][V - 1] = 0
    ops[1][0] = -5
    with pytest.raises(IndexError, match="voice 0"):
        FK.dma_window_select(*_t(ops), n=n, K=K, emax2=emax2)
    with pytest.raises(ValueError, match="too wide"):
        FK.dma_window_select(*_t(ops), n=n, K=K, emax2=500)


@pytest.mark.parametrize("fault", [None, "drop_voice"])
def test_dma_tolerance_fails_a_dropped_voice(fault):
    """At 4096 voices the kernel's chunked voice-sum order stays within
    ``dma_tolerance`` of the plain version; a kernel that drops the loudest
    voice does not."""
    rng = np.random.default_rng(13)
    V, rowlen, n, K, emax2 = 4096, 2048, 512, 64, 36
    ops = _t(list(_dma_operands(rng, V, rowlen + 2048, emax2)))
    ops[3] = ops[3] * 0.05
    plain = FK.dma_window_select_plain(*ops, n=n, K=K, emax2=emax2)
    tol = FK.dma_tolerance(*ops, n=n, K=K)
    x = FK._dma_products(*ops, n, K)
    loudest = int(torch.argmax(ops[3][:, 0] * ops[5]))
    got = _chunk_order_sum(x, drop=loudest if fault else None)
    within = bool(((got - plain).abs().double() <= tol).all())
    assert within == (fault is None)


# --- the scene axis of K1/K2 (ScenePack) ---------------------------------------------


def test_rows_append_scene_axis_equals_single_scene_calls():
    """K1 with one (r0, rmir0) pair per scene equals S single-scene calls on
    each scene's rows."""
    rng = np.random.default_rng(14)
    S, V, RPV = 4, 6, 40
    ring = torch.tensor(rng.standard_normal((S * V, RPV, 128)).astype(np.float32))
    slab = torch.tensor(rng.standard_normal((S * V, 512)).astype(np.float32))
    r0 = torch.tensor([8, 12, 16, 20], dtype=torch.int32)
    rm = torch.tensor([30, 34, 30, 8], dtype=torch.int32)
    got = RK.rows_append(ring.clone(), slab, r0, rm)
    want = ring.clone()
    for s in range(S):
        rows = slice(s * V, (s + 1) * V)
        want[rows] = RK.rows_append(want[rows].clone(), slab[rows], int(r0[s]), rm[s])
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        five = torch.arange(5, dtype=torch.int32)
        RK.rows_append(ring.clone(), slab, five, five)  # 24 rows, 5 scenes


@pytest.mark.parametrize("frz", [False, True])
def test_window_select_ears_scene_axis_equals_single_scene_calls(frz):
    """K2 with ``scenes`` mixes each scene's rows apart, (S, 2, n), equal to
    S single-scene calls bit for bit; its tolerance is per scene too."""
    rng = np.random.default_rng(15)
    S, V, n, K = 4, 20, 512, 32
    args = _select_inputs(rng, S * V, n, K, _ears_span(n, K))
    wide, rowshift, scal01, g01, e01, frz01 = (_t(x) if not isinstance(x, list) else _t(x)
                                                for x in args)
    kw = dict(n=n, K=K, emax2=EMAX2, hmax=8, frz01=frz01 if frz else None)
    got = RK.window_select_ears(wide, rowshift[:, 0], scal01, g01, e01, scenes=S, **kw)
    assert got.shape == (S, 2, n)
    for s in range(S):
        r = slice(s * V, (s + 1) * V)
        one = RK.window_select_ears(
            wide[r], rowshift[r, 0], [x[r] for x in scal01], [x[r] for x in g01],
            [x[r] for x in e01], n=n, K=K, emax2=EMAX2, hmax=8,
            frz01=[x[r] for x in frz01] if frz else None,
        )
        assert torch.equal(got[s], one)
    samps = [RK.ear_samples(wide, 0, rowshift[:, 0], 8, scal01[e], e01[e],
                            frz01[e] if frz else None, n, K) for e in range(2)]
    tol = RK.mix_tolerance(samps, g01, n, scenes=S)
    assert tol.shape == (S, 2, n)
    for s in range(S):
        r = slice(s * V, (s + 1) * V)
        assert torch.equal(tol[s], RK.mix_tolerance([x[r] for x in samps],
                                                    [g[r] for g in g01], n))
