"""The port's CUDA kernels on a card, against their plain PyTorch versions
(which the CPU tests hold against the JAX package).  Needs no JAX, so it
runs on a machine with the card:

    python -m pytest tests/test_torch_cuda.py -q

Every test skips without a CUDA card.  Bounds: K1 exact (a copy, in its
row and cursor forms, aligned and unaligned slabs); K2/K3
within ``ring_kernels.mix_tolerance`` elementwise (the kernel sums the same
products in another, fixed order; the tolerance follows how float32
rounding errors of such a sum grow, and fails a dropped voice or bf16
partial sums); K4 exact (a copy); K6 exact (the same f32 operations, each
rounded once); K7 within ``agc.agc_tolerance`` elementwise (another order
of the prefix sum); K5 within ``ring_kernels.strip_tolerance``
elementwise (its voice sum in another, fixed order); K8 within
``flat_kernels.window_select_tolerance`` (K2's), K9 exact (a copy), K10
within ``flat_kernels.dma_tolerance`` (as K5's); K1/K2 with a ScenePack's
scene axis as without it, per scene; the scenes and packs within the
PARITY.md 1e-5.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import oddio_tpu_torch as pt
from oddio_tpu_torch.ops import agc as A
from oddio_tpu_torch.ops import flat_kernels as FK
from oddio_tpu_torch.ops import ring_kernels as RK
from oddio_tpu_torch.ops import stream_kernels as SK
from oddio_tpu_torch.ops._dev import device_split_ds
from oddio_tpu_torch.utils.scene_profile import (build_config5_pack, build_host_pools,
                                                 build_mixer_agc, build_spatial_pack, feed)

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


@pytest.mark.parametrize("S", [1, 16])
@pytest.mark.parametrize("W", [128, 512, 1024, 2048])
@pytest.mark.parametrize("V", [1, 3, 1000, 4096])
def test_rows_append_forms_exact(cuda, V, W, S):
    """K1 through its row forms (device (S,) rows; host ints for one scene)
    and its cursor form, each exact against the plain version and one
    launch, with a stride-(W + 1) slab (the scalar-load form) and a
    contiguous one (16-byte loads); S scenes of V voices.  W > 512 takes
    more than one CUDA block per voice."""
    rng = np.random.default_rng(V + W + S)
    FP, cap, M = 1024, 4096, 1024
    RPV = (FP + cap + M + max(W, 1024)) // 128
    ring = torch.randn((S * V, RPV, 128), device=cuda)
    base = torch.randn((S * V, W + 1), device=cuda)
    start = torch.tensor(rng.integers(0, cap - W + 1, S).astype(np.int32), device=cuda)
    start[0] = M - 128  # a cursor inside the mirror span
    r0, rm = RK.cursor_rows(start, FP, cap, M)
    forms = [(RK.rows_append, (r0, rm)), (RK.rows_append_cursor, (start, FP, cap, M))]
    if S == 1:
        forms.append((RK.rows_append, (int(r0), int(rm))))
    for slab in (base[:, :W], base[:, :W].contiguous()):
        want = RK.rows_append_plain(ring.clone(), slab, r0, rm)
        for fn, args in forms:
            before = RK.LAUNCHES["append"]
            got = fn(ring.clone(), slab, *args)
            torch.cuda.synchronize()
            assert RK.LAUNCHES["append"] == before + 1
            assert torch.equal(got, want), (fn.__name__, slab.stride(0))


@pytest.mark.parametrize("form", ["rows", "cursor", "pages"])
def test_append_leg_outside_the_ring_trips_the_assert(cuda, form):
    """A device row, cursor or page whose leg leaves the ring trips K1's or
    K9's device-side assert (in a subprocess: the assert poisons the CUDA
    context)."""
    code = f"""
import torch
from oddio_tpu_torch.ops import flat_kernels as FK, ring_kernels as RK
dev, i32 = torch.device("cuda"), torch.int32
form = {form!r}
if form == "pages":
    ring, slab = torch.zeros((64, 4096), device=dev), torch.ones((64, 512), device=dev)
    FK.flat_append_aligned(ring, slab, torch.tensor([2, 8], dtype=i32, device=dev))
else:
    ring, slab = torch.zeros((64, 16, 128), device=dev), torch.ones((64, 512), device=dev)
    if form == "rows":
        RK.rows_append(ring, slab, torch.tensor(0, dtype=i32, device=dev),
                       torch.tensor(13, dtype=i32, device=dev))
    else:
        RK.rows_append_cursor(ring, slab, torch.tensor([3000], dtype=i32, device=dev),
                              1024, 4096, 1024)
torch.cuda.synchronize()
print("no assert")
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, cwd=Path(__file__).resolve().parents[1])
    assert r.returncode != 0 and "no assert" not in r.stdout, (r.stdout, r.stderr[-2000:])
    assert "assert" in r.stderr.lower(), r.stderr[-2000:]


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
    assert all(RK.LAUNCHES[k] > 0 for k in ("append", "select_ears", "select_multi")), RK.LAUNCHES
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


# --- stream and AGC kernels (config 5's shapes) --------------------------------

SIZE_PAD = 2816  # Stream(8000, 2528): the config-5 stream ring


@pytest.mark.parametrize("mw", [128, 2401])
def test_ring_place_exact(cuda, mw):
    rng = np.random.default_rng(40 + mw)
    V = 4096
    ring = torch.tensor(rng.standard_normal((V, SIZE_PAD)).astype(np.float32), device=cuda)
    chunk = torch.tensor(rng.standard_normal((V, mw)).astype(np.float32), device=cuda)
    wpos = torch.tensor(rng.integers(0, SIZE_PAD, V).astype(np.int32), device=cuda)
    wcount = torch.tensor(rng.integers(0, mw + 1, V).astype(np.int32), device=cuda)
    plain = SK.ring_place_plain(ring.clone(), chunk, wpos, wcount)
    before = SK.LAUNCHES["ring_place"]
    got = SK.ring_place(ring.clone(), chunk, wpos, wcount)
    torch.cuda.synchronize()
    assert SK.LAUNCHES["ring_place"] == before + 1
    assert torch.equal(got, plain)


@pytest.mark.parametrize("ds", [1.0 / 6.0, 1.0, 4.0])
def test_ring_resample_exact(cuda, ds):
    rng = np.random.default_rng(50)
    V, n = 4096, 512
    ring = torch.tensor(rng.standard_normal((V, SIZE_PAD)).astype(np.float32), device=cuda)
    dsv = torch.tensor(rng.uniform(ds * 0.9, ds, V).astype(np.float32), device=cuda)
    di, fh, fl = device_split_ds(dsv)
    t = torch.tensor(rng.uniform(-0.99, 1.0, V).astype(np.float32), device=cuda)
    start = torch.tensor(rng.integers(0, SIZE_PAD, V).astype(np.int32), device=cuda)
    len_ = torch.tensor(rng.integers(0, int(n * ds) + 3, V).astype(np.int32), device=cuda)
    args = (ring, t, di, fh, fl, start, len_, n)
    plain = SK.ring_resample_plain(*args)
    before = SK.LAUNCHES["ring_resample"]
    got = SK.ring_resample(*args)
    torch.cuda.synchronize()
    assert SK.LAUNCHES["ring_resample"] == before + 1
    assert torch.equal(got, plain)


@pytest.mark.parametrize("tau", [0.1, 3.34e-4])
def test_agc_gains_within_tolerance(cuda, tau):
    rng = np.random.default_rng(60)
    V, n = 4096, 512
    iv = np.float32(1.0 / 48000.0)
    alpha = np.float32(1.0) - np.exp(-iv / np.float32(tau), dtype=np.float32)

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=cuda)

    s = t(rng.standard_normal((V, n)) * 0.3)
    count = torch.tensor(rng.integers(0, n + 1, V).astype(np.int32), device=cuda)
    count[: V // 2] = n
    scal = A.pack_agc_scalars(
        t(rng.uniform(1e-3, 0.3, V)), t(np.full(V, alpha)), count,
        t(np.full(V, 0.1 / np.sqrt(2))), t(np.full(V, 0.5 / np.sqrt(2))),
        t(np.full(V, 4.0)),
    )
    gp, cp = A.agc_gains_plain(s, scal, n)
    before = A.LAUNCHES["agc_gains"]
    g, c = A.agc_gains(s, scal, n)
    torch.cuda.synchronize()
    assert A.LAUNCHES["agc_gains"] == before + 1
    tol_g, tol_c = A.agc_tolerance(s, scal, n)
    assert bool(((g - gp).abs().double() <= tol_g).all())
    assert bool(((c - cp).abs().double() <= tol_c).all())


def test_mixer_agc_scene_on_card_matches_cpu(cuda):
    """BASELINE config 5's scene at 256 voices on the card (K4, K6, K7)
    against the same scene on the CPU (plain versions), with a feed."""
    outs = []
    for device in ("cpu", cuda):
        SK.reset_launches()
        A.reset_launches()
        _, mixer, ctls, rng = build_mixer_agc(256, device)
        r = pt.Renderer(mixer, 48000)
        a = r.render_frames(512 * 24)
        feed(ctls, rng, 1024)
        outs.append(np.concatenate([a, r.render_frames(512 * 24)]))
    assert min(SK.LAUNCHES.values()) > 0 and A.LAUNCHES["agc_gains"] > 0
    assert np.abs(outs[0]).max() > 0.1
    assert np.abs(outs[0] - outs[1]).max() <= 1e-5


# --- K5 and the host pools ------------------------------------------------------


def _strip_operands(rng, dev, V, n, L, lo, hi):
    def t(x, dtype=np.float32):
        return torch.tensor(np.asarray(x, dtype), device=dev)

    mag = rng.uniform(lo, hi, (V, 2)) * rng.choice([-1.0, 1.0], (V, 2))
    di, fh, fl = device_split_ds(t(1.0 + mag))
    scal = torch.stack([t(rng.uniform(0, 1, (V, 2))), fh, fl, di.float()], -1).contiguous()
    return (t(rng.standard_normal((V, L))), t(rng.integers(0, L // 128, V), np.int32),
            t(rng.integers(0, 161, (V, 2)), np.int32), scal,
            t(rng.uniform(0, 0.1, (V, 2))), t(rng.uniform(-1e-4, 1e-4, (V, 2))),
            t(rng.uniform(0, 1, V) > 0.2))


@pytest.mark.parametrize("V,n,L,lo,hi", [
    (4096, 512, 16384, 0.0, 0.09),    # the host pool's main path
    (1, 512, 2048, 0.0, 0.09),        # the singleton (a submix)
    (1024, 512, 16384, 0.119, 0.125),  # near the gate: the SELECT_R clamp binds
])
def test_strip_select_within_tolerance(cuda, V, n, L, lo, hi):
    ops = _strip_operands(np.random.default_rng(70 + V), cuda, V, n, L, lo, hi)
    plain = RK.strip_select_plain(*ops, n=n, K=64)
    before = RK.LAUNCHES["strip_select"]
    got = RK.strip_select(*ops, n=n, K=64)
    torch.cuda.synchronize()
    assert RK.LAUNCHES["strip_select"] == before + 1
    tol = RK.strip_tolerance(*ops, n=n, K=64)
    assert bool(((got - plain).abs().double() <= tol).all())


def test_host_pool_scene_on_card_matches_cpu(cuda):
    """The host-pool scene at 256 Speed(Stream) voices, 32 Adapt(Stream)
    and a 64-voice submix on the card (K1, K2, K4, K5, K6) against the
    same scene on the CPU (plain versions), over 48 blocks with a feed and
    a set_speed between."""
    outs = []
    for device in ("cpu", cuda):
        RK.reset_launches()
        SK.reset_launches()
        _, scene, ctls, speeds, rng = build_host_pools(256, device, dr_voices=32,
                                                       submix_voices=64)
        r = pt.Renderer(scene, 48000)
        a = r.render_frames(512 * 24)
        feed(ctls, rng, 1024)
        for sc in speeds[:16]:
            sc.set_speed(1.1)
        outs.append(np.concatenate([a, r.render_frames(512 * 24)]))
    assert RK.LAUNCHES["strip_select"] > 0 and RK.LAUNCHES["append"] > 0
    assert min(SK.LAUNCHES.values()) > 0
    assert np.abs(outs[0]).max() > 1e-2
    assert np.abs(outs[0] - outs[1]).max() <= 1e-5


# --- K8-K10 and the ScenePack ---------------------------------------------------


def _flat_operands(rng, dev, V, n, K, emax2):
    def t(x, dtype=np.float32):
        return torch.tensor(np.asarray(x, dtype), device=dev)

    di, fh, fl = device_split_ds(t(rng.uniform(1 - K / n, 1 + K / n, (V, 2))))
    scal = torch.stack([t(rng.uniform(0, 1, (V, 2))), fh, fl, di.float()], -1).contiguous()
    return (scal, t(rng.uniform(0, 1, (V, 2))), t(rng.uniform(-1e-3, 1e-3, (V, 2))),
            t(rng.uniform(0, 1, V) > 0.3), t(rng.integers(0, emax2, (V, 2)), np.int32))


@pytest.mark.parametrize("V", [1, 1000])
@pytest.mark.parametrize("emax2", [36, 163])
def test_window_select_flat_within_tolerance(cuda, V, emax2):
    """K8 (K2's body on flat windows) against its plain version."""
    rng = np.random.default_rng(80 + V + emax2)
    n, K = 512, 64
    win = torch.tensor(rng.standard_normal((V, RK.select_window(n, emax2, K))).astype(np.float32),
                       device=cuda)
    ops = (win,) + _flat_operands(rng, cuda, V, n, K, emax2)
    plain = FK.window_select_plain(*ops, n=n, K=K, emax2=emax2)
    before = FK.LAUNCHES["window_select"]
    got = FK.window_select(*ops, n=n, K=K, emax2=emax2)
    torch.cuda.synchronize()
    assert FK.LAUNCHES["window_select"] == before + 1
    tol = FK.window_select_tolerance(*ops, n=n, K=K)
    assert bool(((got - plain).abs().double() <= tol).all())


@pytest.mark.parametrize("W", [512, 1024])
@pytest.mark.parametrize("form", ["mixed", "ints", "pair", "scalars"])
def test_flat_append_aligned_exact(cuda, form, W):
    rng = np.random.default_rng(90)
    V, rowlen = 1000, 4096
    ring = torch.tensor(rng.standard_normal((V, rowlen)).astype(np.float32), device=cuda)
    slab = torch.tensor(rng.standard_normal((V, W)).astype(np.float32), device=cuda)
    plain = FK.flat_append_aligned_plain(ring.clone(), slab, 1, 5)
    dev_page = {p: torch.tensor(p, dtype=torch.int32, device=cuda) for p in (1, 5)}
    pages = {"mixed": (1, dev_page[5]),
             "ints": (1, 5),
             "pair": (torch.tensor([1, 5], dtype=torch.int32, device=cuda),),
             "scalars": (dev_page[1], dev_page[5])}[form]
    before = FK.LAUNCHES["flat_append"]
    got = FK.flat_append_aligned(ring.clone(), slab, *pages)
    torch.cuda.synchronize()
    assert FK.LAUNCHES["flat_append"] == before + 1
    assert torch.equal(got, plain)


def test_dma_window_select_within_tolerance(cuda):
    """K10 against its plain version, windows past their row end included
    (they read the next row of the flat ring)."""
    rng = np.random.default_rng(100)
    V, rowlen, n, K, emax2 = 1000, 4096, 512, 64, 36
    ring = torch.tensor(rng.standard_normal((V, rowlen)).astype(np.float32), device=cuda)
    rs = rng.integers(0, rowlen - 2048 + 600, V).astype(np.int32)
    rs[-1] = 0
    ops = (ring, torch.tensor(rs, device=cuda)) + _flat_operands(rng, cuda, V, n, K, emax2)
    plain = FK.dma_window_select_plain(*ops, n=n, K=K, emax2=emax2)
    before = FK.LAUNCHES["dma_window_select"]
    got = FK.dma_window_select(*ops, n=n, K=K, emax2=emax2)
    torch.cuda.synchronize()
    assert FK.LAUNCHES["dma_window_select"] == before + 1
    tol = FK.dma_tolerance(*ops, n=n, K=K)
    assert bool(((got - plain).abs().double() <= tol).all())


def test_rows_append_scene_axis_exact(cuda):
    rng = np.random.default_rng(110)
    S, V, RPV = 16, 64, 160
    ring = torch.tensor(rng.standard_normal((S * V, RPV, 128)).astype(np.float32), device=cuda)
    slab = torch.tensor(rng.standard_normal((S * V, 512)).astype(np.float32), device=cuda)
    r0 = torch.tensor(rng.integers(0, RPV - 4, S).astype(np.int32), device=cuda)
    rm = torch.tensor(rng.integers(0, RPV - 4, S).astype(np.int32), device=cuda)
    plain = RK.rows_append_plain(ring.clone(), slab, r0, rm)
    before = RK.LAUNCHES["append"]
    got = RK.rows_append(ring.clone(), slab, r0, rm)
    torch.cuda.synchronize()
    assert RK.LAUNCHES["append"] == before + 1
    assert torch.equal(got, plain)


@pytest.mark.parametrize("S,V", [(16, 256), (3, 17)])
def test_window_select_ears_scene_axis(cuda, S, V):
    """K2 with the scene axis: (S, 2, n) in one launch, each scene within
    its own mix tolerance."""
    rng = np.random.default_rng(120 + S)
    n, K = 512, 32
    WIN = RK.select_window(n, EMAX2, K)
    S2 = -(-(GW - 1 + WIN) // GW) * GW
    wide, rowshift, scal01, g01, e01, frz01 = _select_inputs(rng, cuda, S * V, n, K, S2)
    rs = rowshift[:, 0].contiguous()
    kw = dict(n=n, K=K, emax2=EMAX2, hmax=8, frz01=frz01, scenes=S)
    plain = RK.window_select_ears_plain(wide, rs, scal01, g01, e01, **kw)
    before = RK.LAUNCHES["select_ears"]
    got = RK.window_select_ears(wide, rs, scal01, g01, e01, **kw)
    torch.cuda.synchronize()
    assert RK.LAUNCHES["select_ears"] == before + 1 and got.shape == (S, 2, n)
    samps = [RK.ear_samples(wide, 0, rs, 8, scal01[e], e01[e], frz01[e], n, K) for e in range(2)]
    tol = RK.mix_tolerance(samps, g01, n, scenes=S)
    assert bool(((got - plain).abs().double() <= tol).all())


def _pack_run(pack, ctls, pcm, nb0=4, nb1=8):
    a = np.concatenate([pack.render_block(512) for _ in range(nb0)], axis=1)
    for c, x in zip(ctls, pcm):
        c.write(x)
    b = torch.cat(pack.render_frames_device(512 * nb1)).cpu().numpy()  # (B, S, C, n)
    B, S, C, n = b.shape
    return np.concatenate([a, b.transpose(1, 0, 3, 2).reshape(S, B * n, C)], axis=1)


def test_pack_on_card_matches_cpu(cuda):
    """A 3 x 64-voice config-5 pack (K4, K6, K7) and a 3-scene spatial pack
    (K1, K2) on the card against the same packs on the CPU."""
    outs, pcm = [], None
    for device in ("cpu", cuda):
        SK.reset_launches()
        A.reset_launches()
        pack, ctls, rng = build_config5_pack(3, device, voices=64)
        if pcm is None:
            pcm = (rng.standard_normal((len(ctls), 1024)) * 0.1).astype(np.float32)
        outs.append(_pack_run(pack, ctls, pcm))
    assert min(SK.LAUNCHES.values()) > 0 and A.LAUNCHES["agc_gains"] > 0
    assert np.abs(outs[0]).max() > 0.1
    assert np.abs(outs[0] - outs[1]).max() <= 1e-5
    outs = []
    for device in ("cpu", cuda):
        RK.reset_launches()
        outs.append(_pack_run(build_spatial_pack(3, device, 16, 48), [], []))
    assert RK.LAUNCHES["append"] > 0 and RK.LAUNCHES["select_ears"] > 0
    assert np.abs(outs[0]).max() > 1e-2
    assert np.abs(outs[0] - outs[1]).max() <= 1e-5


def test_pack_launches_per_block_do_not_grow_with_scenes(cuda):
    """One launch per pool per block whatever S is: the config-5 pack
    launches K4/K6/K7 as often at 4 scenes as at 16."""
    counts = []
    for S in (4, 16):
        pack, ctls, rng = build_config5_pack(S, cuda, voices=64)
        pcm = (rng.standard_normal((len(ctls), 1024)) * 0.1).astype(np.float32)
        SK.reset_launches()
        A.reset_launches()
        _pack_run(pack, ctls, pcm)
        torch.cuda.synchronize()
        counts.append({**SK.LAUNCHES, **A.LAUNCHES})
    assert counts[0] == counts[1] and min(counts[0].values()) > 0, counts
