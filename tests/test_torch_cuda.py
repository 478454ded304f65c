"""The port's CUDA kernels on a card, against their plain PyTorch versions
(which the CPU tests hold against the JAX package).  Needs no JAX, so it
runs on a machine with the card:

    python -m pytest tests/test_torch_cuda.py -q

Every test skips without a CUDA card.  Bounds: K1 exact (a copy); K2/K3
within ``ring_kernels.mix_tolerance`` elementwise (the kernel sums the same
products in another, fixed order; the tolerance follows how float32
rounding errors of such a sum grow, and fails a dropped voice or bf16
partial sums); the scene within the PARITY.md 1e-5.
"""

import numpy as np
import pytest
import torch

import oddio_tpu_torch as pt
from oddio_tpu_torch.ops import ring_kernels as RK
from oddio_tpu_torch.ops._dev import device_split_ds

torch.set_num_threads(1)

EMAX2 = 127 + 33  # 48 kHz ear stagger + the 128-lane granule remainder
GW = 1024


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: runs the CUDA kernels")
    return torch.device("cuda")


def _select_inputs(rng, dev, V, n, K, S2, nb=1, hcap=8):
    def t(x):
        return torch.tensor(x, device=dev)

    ds = t(rng.uniform(1 - K / n, 1 + K / n, (V, 2 * nb)).astype(np.float32))
    di, fh, fl = device_split_ds(ds)
    ofrac = t(rng.uniform(0, 1, (V, 2 * nb)).astype(np.float32))
    scal = RK.pack_select_scalars(ofrac, di, fh, fl)  # (V, 2nb, 4)
    scal01 = [scal[:, e::2].reshape(V, 4 * nb).contiguous() for e in range(2)]
    gain = rng.uniform(0, 1, (V, 2 * nb, 2)).astype(np.float32)
    gain[..., 1] = rng.uniform(-1e-3, 1e-3, (V, 2 * nb))
    gain = t(gain * rng.integers(0, 2, (V, 1, 1)).astype(np.float32))
    g01 = [gain[:, e::2].reshape(V, 2 * nb).contiguous() for e in range(2)]
    e01 = [t(rng.integers(0, EMAX2, (V, nb)).astype(np.int32)) for _ in range(2)]
    frz01 = [t((rng.uniform(0, 1, (V, nb)) > 0.7).astype(np.float32)) for _ in range(2)]
    wide = t(rng.standard_normal((V, S2)).astype(np.float32))
    rowshift = t(rng.integers(0, hcap, (V, nb)).astype(np.int32))
    return wide, rowshift, scal01, g01, e01, frz01


def _tolerance(wide, col0, rowshift, H, scal01, g01, e01, frz01, n, K):
    samps = [
        RK.ear_samples(wide, col0, rowshift, H, scal01[e], e01[e],
                       None if frz01 is None else frz01[e], n, K)
        for e in range(2)
    ]
    return RK.mix_tolerance(samps, g01, n)


def test_rows_append_exact(cuda):
    rng = np.random.default_rng(10)
    V, RPV = 64, 160
    ring = torch.tensor(rng.standard_normal((V, RPV, 128)).astype(np.float32), device=cuda)
    samples = torch.tensor(rng.standard_normal((V, 513)).astype(np.float32), device=cuda)
    rows = torch.tensor([8, 136], dtype=torch.int32, device=cuda)
    plain = RK.rows_append_plain(ring.clone(), samples[:, :512], rows[0], rows[1])
    before = RK.LAUNCHES["append"]
    got = RK.rows_append(ring.clone(), samples[:, :512], rows[0], rows[1])
    torch.cuda.synchronize()
    assert RK.LAUNCHES["append"] == before + 1
    assert torch.equal(got, plain)
    # host-int rows and a contiguous (16-byte aligned) slab take the
    # vector-load path
    got2 = RK.rows_append(ring.clone(), samples[:, :512].contiguous(), 8, 136)
    assert torch.equal(got2, plain)


@pytest.mark.parametrize("V", [1, 3, 16, 1000])
@pytest.mark.parametrize("frz", [False, True])
@pytest.mark.parametrize("n,K", [(128, 32), (512, 64)])
def test_window_select_ears(cuda, V, frz, n, K):
    rng = np.random.default_rng(20 + V + n)
    WIN = RK.select_window(n, EMAX2, K)
    S2 = -(-(GW - 1 + WIN) // GW) * GW
    wide, rowshift, scal01, g01, e01, frz01 = _select_inputs(rng, cuda, V, n, K, S2)
    rs = rowshift[:, 0].contiguous()
    f = frz01 if frz else None
    kw = dict(n=n, K=K, emax2=EMAX2, hmax=8, frz01=f)
    plain = RK.window_select_ears_plain(wide, rs, scal01, g01, e01, **kw)
    before = RK.LAUNCHES["select_ears"]
    got = RK.window_select_ears(wide, rs, scal01, g01, e01, **kw)
    torch.cuda.synchronize()
    assert RK.LAUNCHES["select_ears"] == before + 1
    tol = _tolerance(wide, 0, rs, 8, scal01, g01, e01, f, n, K)
    assert bool(((got - plain).abs().double() <= tol).all())


def test_window_select_multi(cuda):
    rng = np.random.default_rng(30)
    V, n, nb, K = 1000, 512, 4, 32
    row0s = [max(0, int(np.floor(b * (n - K) / 128))) for b in range(nb)]
    hs = [int(GW - 1 + b * (n + K)) // 128 - row0s[b] + 1 for b in range(nb)]
    WIN = RK.select_window(n, EMAX2, K)
    S2 = -(-int(GW - 1 + (nb - 1) * (n + K) + WIN) // GW) * GW
    args = _select_inputs(rng, cuda, V, n, K, S2, nb=nb, hcap=min(hs))
    kw = dict(n=n, K=K, emax2=EMAX2, nb=nb, row0s=row0s, hs=hs)
    plain = RK.window_select_multi_plain(*args, **kw)
    got = RK.window_select_multi(*args, **kw)
    torch.cuda.synchronize()
    wide, rowshift, scal01, g01, e01, frz01 = args
    for b in range(nb):
        tol = _tolerance(
            wide, 128 * row0s[b], rowshift[:, b], hs[b],
            [s[:, 4 * b : 4 * b + 4] for s in scal01],
            [g[:, 2 * b : 2 * b + 2] for g in g01],
            [e[:, b : b + 1] for e in e01],
            [x[:, b : b + 1] for x in frz01], n, K,
        )
        d = (got - plain)[:, b * n : (b + 1) * n].abs().double()
        assert bool((d <= tol).all())


def _entry_scene(device, n_buffered=64, n_seek=32):
    rng = np.random.default_rng(0)
    control, scene = pt.SpatialScene.new(device=device)
    for _ in range(n_buffered):
        control.play_buffered(
            pt.Sine(rng.uniform(0, 6), rng.uniform(100, 2000)),
            pt.SpatialOptions(position=rng.uniform(-30, 30, 3),
                              velocity=rng.uniform(-10, 10, 3)),
            max_distance=50.0, rate=48000, buffer_duration=0.1,
        )
    for _ in range(n_seek):
        control.play(
            pt.Sine(rng.uniform(0, 6), rng.uniform(100, 2000)),
            pt.SpatialOptions(position=rng.uniform(-30, 30, 3)),
        )
    return scene


def test_entry_scene_on_card_matches_cpu(cuda):
    """The entry() scene on the card (CUDA kernels) against the same scene
    on the CPU (plain versions): every kernel launches, and the renders
    agree within the contract."""
    a = pt.Renderer(_entry_scene("cpu"), 48000).render_frames(512 * 20)
    RK.reset_launches()
    b = pt.Renderer(_entry_scene(cuda), 48000).render_frames(512 * 20)
    assert all(RK.LAUNCHES[k] > 0 for k in RK.LAUNCHES), RK.LAUNCHES
    assert np.abs(a - b).max() <= 1e-5


@pytest.mark.parametrize("scene_rate,ring_rate", [(48000, 44100), (16000, 48000)])
def test_torch_only_paths_on_card_match_cpu(cuda, scene_rate, ring_rate):
    """The general ring write (slice writes) and the exact elementwise read
    run as plain torch on the card too; they agree with the CPU render."""
    outs = []
    for device in ("cpu", cuda):
        rng = np.random.default_rng(5)
        control, scene = pt.SpatialScene.new(device=device)
        for _ in range(64):
            control.play_buffered(
                pt.Sine(rng.uniform(0, 6), rng.uniform(100, 1500)),
                pt.SpatialOptions(position=rng.uniform(-10, 10, 3),
                                  velocity=rng.uniform(-3, 3, 3)),
                max_distance=20.0, rate=ring_rate, buffer_duration=0.1,
            )
        r = pt.Renderer(scene, scene_rate)
        outs.append(r.render_frames(512 * 20))
    assert np.abs(outs[0] - outs[1]).max() <= 1e-5


def test_subpass_scene_on_card_matches_cpu(cuda):
    """A scene with family sub-pass voices (the second K2 call, over
    gathered rows) on the card against the CPU render."""
    voices = [([5.0, 2.0, 0.0], [2.0, 0.0, 0.0]), ([60.0, 5.0, 0.0], [0.0, 0.0, 0.0]),
              ([4.0, 0.0, 0.0], [100.0, 0.0, 0.0]), ([43.8, 0.0, 0.0], [2.0, 0.0, 0.0])]
    outs, subs = [], []
    for device in ("cpu", cuda):
        control, scene = pt.SpatialScene.new(device=device)
        for k, (p, v) in enumerate(voices):
            control.play_buffered(pt.Sine(0.1 * k, 300.0 + 70.0 * k),
                                  pt.SpatialOptions(position=p, velocity=v),
                                  max_distance=10.0, rate=8000, buffer_duration=0.1)
        r = pt.Renderer(scene, 8000)
        pool = next(iter(scene._buffered_pools.values()))
        blocks = []
        for _ in range(8):
            blocks.append(r.render_block(512))
            subs.append(pool._sub_cfg)
        outs.append(np.concatenate(blocks))
    assert any(s is not None for s in subs)
    assert np.abs(outs[0] - outs[1]).max() <= 1e-5
