"""The port's CUDA kernels on a card, against their plain PyTorch versions
(which the CPU tests hold against the JAX package).  Needs no JAX, so it
runs on a machine with the card:

    python -m pytest tests/test_torch_cuda.py -q

Every test skips without a CUDA card.  Bounds: K1 exact (a copy, in its
row and cursor forms, aligned and unaligned slabs); K2/K3, read straight
from the ring, within ``ring_kernels.ring_select_ears_tolerance`` /
``ring_select_multi_tolerance`` elementwise (``mix_tolerance`` on their
reads: the kernel sums the same products in another, fixed order; the
tolerance follows how float32 rounding errors of such a sum grow, and
fails a dropped voice or bf16 partial sums), two runs bit-equal; K4 exact (a copy); K6 exact (the same f32 operations, each
rounded once), in its DR form (read and cursor release) and its ds form;
K6's arena form exact (the sampler reads), and as whole steps
(``arena_step``, ``arena_warp``, ``fader_step``) exact against their
plain versions (the Fader's but for the sign of an exact zero), and the
dense-mix, sampler, wavetable and seek-sampler scenes and a 2 s sampler
render within 1e-5 of the CPU;
K7, the whole Adapt step, within ``agc.agc_tolerance`` elementwise
(another order of the prefix sum) at every block length up to 1024; K5 within ``ring_kernels.strip_tolerance``
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
from oddio_tpu_torch.ops._dev import device_split_ds, split_ds
from oddio_tpu_torch.utils import kernel_bench as KB
from oddio_tpu_torch.utils.scene_profile import (build_config5_pack, build_host_pools,
                                                 build_mixer_agc, build_spatial_pack, feed)

torch.set_num_threads(1)


#: K4's and K6's stream-ring forms (K6's arena form reads sampler arenas)
STREAM_RING = ("ring_place", "ring_resample")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: runs the CUDA kernels")
    return torch.device("cuda")


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


#: the pool's ring geometry at 48 kHz, as the K2/K3 wrappers take it
READ_GEOM = dict(DMAX=KB.READ_DMAX, FP=KB.READ_FP, cap=KB.READ_CAP)


def _held(key, call, tol, plain):
    """Two calls: one launch each, bit-equal, within ``tol`` of ``plain``."""
    before = RK.LAUNCHES[key]
    got = call()
    again = call()
    torch.cuda.synchronize()
    assert RK.LAUNCHES[key] == before + 2
    assert torch.equal(got, again)
    assert got.shape == plain.shape and float(plain.abs().max()) > 1e-3
    assert bool(((got - plain).abs().double() <= tol).all())


@pytest.mark.parametrize("S", [1, 16])
@pytest.mark.parametrize("K", [32, 64, 256])
@pytest.mark.parametrize("V", [1, 17, 1000, 4096])
def test_ring_select_ears(cuda, V, K, S):
    """K2 on S scenes of V voices (K = 256 at its 256-frame read chunk,
    two chunks per 512-frame read), a fifth of the ears frozen and cursors
    anywhere, some windows ending in the mirror; the main pass with
    ``tight`` for one scene."""
    rng = np.random.default_rng(V + K + S)
    R = 256 if K == 256 else 512
    ring = KB.read_ring(cuda, S * V, seed=V + K)
    ro = KB.read_operands(cuda, rng, S * V, K, R)
    ro["base_c"][0][::3] = KB.READ_CAP + K - 5  # windows into the mirror
    kw = dict(n=512, K=K, R=R, scenes=None if S == 1 else S, **READ_GEOM)
    if S == 1:
        kw["tight"] = torch.tensor((rng.uniform(0, 1, V) > 0.2) | (np.arange(V) == 0),
                                   device=cuda).float()
    _held("select_ears", lambda: RK.ring_select_ears(ring, ro, **kw),
          RK.ring_select_ears_tolerance(ring, ro, **kw), RK.ring_select_ears_plain(ring, ro, **kw))


@pytest.mark.parametrize("R,K", [(256, 256), (128, 192)])
def test_ring_select_ears_sub_pass(cuda, R, K):
    """K2's family sub-pass: a 256-entry list naming 200 voices of a
    4096-voice pool (the rest off, naming voice 0), read in 512 / R
    chunks at every frame (frozen flags do not apply)."""
    rng = np.random.default_rng(R)
    V = 4096
    ring = KB.read_ring(cuda, V, seed=R)
    ro = KB.read_operands(cuda, rng, V, K, R, frozen=0.5)
    idx = np.zeros(256, np.int32)
    idx[:200] = rng.choice(V, 200, replace=False)
    kw = dict(n=512, K=K, R=R, sub_idx=torch.tensor(idx, device=cuda),
              sub_on=torch.tensor((np.arange(256) < 200).astype(np.float32), device=cuda),
              **READ_GEOM)
    _held("select_ears", lambda: RK.ring_select_ears(ring, ro, **kw),
          RK.ring_select_ears_tolerance(ring, ro, **kw), RK.ring_select_ears_plain(ring, ro, **kw))


@pytest.mark.parametrize("wrap", [False, True])
@pytest.mark.parametrize("V", [17, 1000, 4096])
def test_ring_select_multi(cuda, V, wrap):
    """K3 on a fused group of 4 blocks at K = 64, inside the ring or
    starting near its end so that every voice's later blocks wrap the
    modulus."""
    rng = np.random.default_rng(V + wrap)
    n, K, cap = 512, 64, KB.READ_CAP
    base0 = cap - rng.integers(200, 900, V) if wrap else rng.integers(0, cap // 2, V)
    ros, row0s, hs = KB.group_operands(cuda, rng, V, K, n, base0)
    ring = KB.read_ring(cuda, V, seed=V)
    kw = dict(n=n, K=K, row0s=row0s, hs=hs, **READ_GEOM)
    _held("select_multi", lambda: RK.ring_select_multi(ring, ros, **kw),
          RK.ring_select_multi_tolerance(ring, ros, **kw), RK.ring_select_multi_plain(ring, ros, **kw))


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
@pytest.mark.parametrize("V", [1, 512, 4096])
def test_ring_resample_exact(cuda, ds, V):
    """K6 in its DR form (the read at ``rate*interval`` and the cursor
    release) and its ds form, equal to the plain versions, at read offsets
    in [-0.99, 1) (the truncate-toward-zero branch included)."""
    rng = np.random.default_rng(50)
    n, iv = 512, float(np.float32(1.0 / 48000.0))

    def t(x, dtype=np.float32):
        return torch.tensor(np.asarray(x, dtype), device=cuda)

    ring = t(rng.standard_normal((V, SIZE_PAD)))
    rate = t(np.float32(ds * 48000.0) * rng.uniform(0.9, 1.0, V))
    ops = (ring, t(rng.uniform(-0.99, 1.0, V)), rate, iv, t(rng.integers(n - 1, n + 1, V), np.int32),
           t(rng.integers(0, SIZE_PAD, V), np.int32),
           t(rng.integers(0, int(n * ds) + 3, V), np.int32), n)
    before = SK.LAUNCHES["ring_resample"]
    got = SK.stream_step(*ops) + (SK.ring_resample(ring, ops[1], rate * iv, ops[5], ops[6], n),)
    torch.cuda.synchronize()
    assert SK.LAUNCHES["ring_resample"] == before + 2
    plain = SK.stream_step_plain(*ops) + (
        SK.ring_resample_plain(ring, ops[1], rate * iv, ops[5], ops[6], n),)
    for g, w in zip(got, plain):
        assert g.dtype == w.dtype and torch.equal(g, w)


def _agc_operands(cuda, rng, V, n, C, per_voice, tau):
    def t(x, dtype=np.float32):
        return torch.tensor(np.asarray(x, dtype), device=cuda)

    iv = np.float32(1.0 / 48000.0)
    shape = (V, n) if C == 1 else (V, C, n)
    amp = rng.choice([0.01, 0.1, 0.5, 1.0], (V,) + (1,) * (len(shape) - 1))
    count = np.where(np.arange(V) < V // 2, n, rng.integers(0, n + 1, V))
    return (t(rng.standard_normal(shape) * amp), t(rng.uniform(1e-3, 0.3, V)),
            t(np.full(V, np.float32(tau))),
            t(rng.uniform(0.8, 1.25, V) * iv) if per_voice else float(iv),
            t(count, np.int32), t(np.full(V, 0.1 / np.sqrt(2))),
            t(np.full(V, 0.5 / np.sqrt(2))), t(np.full(V, 4.0)), n)


def _agc_within(ops):
    out, carry = A.agc_step(*ops)
    torch.cuda.synchronize()
    pout, pcarry = A.agc_step_plain(*ops)
    tol_x, tol_c = A.agc_tolerance(*ops)
    assert bool(torch.isfinite(out).all())
    assert bool(((out - pout).abs().double() <= tol_x).all())
    assert bool(((carry - pcarry).abs().double() <= tol_c).all())


@pytest.mark.parametrize("tau", [0.1, 3.34e-4])
def test_agc_gains_within_tolerance(cuda, tau):
    """K7 (the whole Adapt step) at the mixer's shape: 4096 mono voices,
    n = 512, a host interval, counts below n on half the voices."""
    ops = _agc_operands(cuda, np.random.default_rng(60), 4096, 512, 1, False, tau)
    before = A.LAUNCHES["agc_gains"]
    _agc_within(ops)
    assert A.LAUNCHES["agc_gains"] == before + 1


@pytest.mark.parametrize("V", [1, 512, 3584])
@pytest.mark.parametrize("n", [100, 128, 513, 544])
@pytest.mark.parametrize("C,per_voice", [(1, True), (2, False), (2, True)])
def test_agc_step_any_block_within_tolerance(cuda, V, n, C, per_voice):
    """K7 at every block length the pools render (not only multiples of
    128), one and two channels, host and per-voice intervals, tau 0.1 s
    and one within 1% of the gate at that n."""
    rng = np.random.default_rng(V + n + C)
    iv_max = np.float32(1.0 / 48000.0) * (1.25 if per_voice else 1.0)
    for tau in (0.1, n * iv_max / (0.99 * A.EMA_GATE)):
        _agc_within(_agc_operands(cuda, rng, V, n, C, per_voice, tau))


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
    assert min(SK.LAUNCHES[k] for k in STREAM_RING) > 0 and A.LAUNCHES["agc_gains"] > 0
    assert SK.LAUNCHES["arena_resample"] == 0
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


def _wrapping_strip_operands(rng, dev, V, n, L, lo, hi):
    """``_strip_operands`` with every other voice's read window starting in
    the ring's last row, so its sub-blocks' windows cross the ring's end."""
    ops = list(_strip_operands(rng, dev, V, n, L, lo, hi))
    ops[1][::2] = L // 128 - 1
    return ops


@pytest.mark.parametrize("V,n,L,lo,hi", [
    (4096, 512, 16384, 0.0, 0.09),    # the host pool's main path
    (1, 512, 2048, 0.0, 0.09),        # the singleton: one cluster of one block
    (17, 512, 2048, 0.0, 0.09),       # a partial voice chunk, a cluster of two
    (1024, 512, 16384, 0.119, 0.125),  # near the gate: the SELECT_R clamp binds
    (300, 200, 1024, 0.0, 0.09),       # n not a multiple of 128, several clusters
    (40, 512, 1030, 0.0, 0.09),        # L not a multiple of 4: no window staged
])
def test_strip_select_record_within_tolerance(cuda, V, n, L, lo, hi):
    """K5's record form, as the host pool calls it, and the tensor form on
    the same operands: one launch each, windows crossing the ring's end
    included, within ``strip_tolerance`` of the plain version; two runs of
    the record form are bit-equal (the voice sum's order is fixed)."""
    ops = _wrapping_strip_operands(np.random.default_rng(80 + V), cuda, V, n, L, lo, hi)
    rec = RK.voice_record(*ops[1:])
    plain = RK.strip_select_plain(*ops, n=n, K=64)
    tol = RK.strip_tolerance(*ops, n=n, K=64)
    before = RK.LAUNCHES["strip_select"]
    got = RK.strip_select_record(ops[0], rec, n=n, K=64)
    again = RK.strip_select_record(ops[0], rec, n=n, K=64)
    tensor_form = RK.strip_select(*ops, n=n, K=64)
    torch.cuda.synchronize()
    assert RK.LAUNCHES["strip_select"] == before + 3
    assert torch.equal(got, again)
    for out in (got, tensor_form):
        assert bool(((out - plain).abs().double() <= tol).all())


def test_strip_select_redoes_a_sub_block_whose_walk_is_not_monotone(cuda):
    """K5 takes a sub-block's smallest walk offset from its two end frames
    and checks every frame against it, redoing the sub-block with the
    minimum over all frames where one falls below.  Steps whose products
    round at 2-sample granularity (|ds| ~ 5000, far outside the pool's
    walk bound) make the walk jitter, so the check fires; the kernel still
    agrees with the plain version."""
    rng = np.random.default_rng(95)
    V, n, L = 256, 4096, 16384
    ops = list(_strip_operands(rng, cuda, V, n, L, 0.0, 0.09))
    base = rng.integers(4200, 8000, V)
    f_lo = (base + rng.integers(-20, 20, V) * 2.0**-11).astype(np.float32)
    scal = ops[3].clone()
    scal[:, :, 1] = 0.0
    scal[:, :, 2] = torch.tensor(f_lo, device=cuda)[:, None]
    scal[:, :, 3] = torch.tensor((-base).astype(np.float32) + 1.0, device=cuda)[:, None]
    ops[3] = scal
    kk, _ = RK._positions(scal[:, 0], n, 64)
    kk = kk.view(V, n // 128, 128)
    ends = torch.minimum(kk[:, :, 0], kk[:, :, -1])
    assert bool((ends != kk.min(-1).values).any())  # the first pass's minimum is wrong
    plain = RK.strip_select_plain(*ops, n=n, K=64)
    got = RK.strip_select_record(ops[0], RK.voice_record(*ops[1:]), n=n, K=64)
    torch.cuda.synchronize()
    tol = RK.strip_tolerance(*ops, n=n, K=64)
    assert bool(((got - plain).abs().double() <= tol).all())


@pytest.mark.parametrize("C", [1, 2])
def test_ring_place_record_and_channel_map_exact(cuda, C):
    """K4 at the host pool's shape (4096 rings of 16384, 513-frame chunks,
    n_write 512 or 513, cursors anywhere, some writes wrapping) through its
    record form, and through the channel map with C rows per voice:
    exact, one launch each."""
    rng = np.random.default_rng(90 + C)
    V, L, mw = 4096, 16384, 513

    def t(x, dtype=np.float32):
        return torch.tensor(np.asarray(x, dtype), device=cuda)

    ring = t(rng.standard_normal((V * C, L)))
    chunk = t(rng.standard_normal((V * C, mw)))
    wpos = t(np.where(np.arange(V) % 3 == 0, rng.integers(L - mw, L, V),
                      rng.integers(0, L, V)), np.int32)
    wcount = t(rng.integers(mw - 1, mw + 1, V), np.int32)
    before = SK.LAUNCHES["ring_place"]
    plain = SK.ring_place_plain(ring.clone(), chunk, wpos, wcount, channels=C)
    got = SK.ring_place(ring.clone(), chunk, wpos, wcount, channels=C)
    torch.cuda.synchronize()
    assert torch.equal(got, plain)
    if C == 1:
        z = torch.zeros((V, 2), dtype=torch.int32, device=cuda)
        zf = torch.zeros((V, 2), device=cuda)
        rec = RK.voice_record(z[:, 0], z, torch.zeros((V, 2, 4), device=cuda), zf, zf,
                              zf[:, 0], wpos // 128, wpos % 128, wcount)
        got = SK.ring_place_record(ring.clone(), chunk, rec)
        torch.cuda.synchronize()
        assert torch.equal(got, plain)
    assert SK.LAUNCHES["ring_place"] == before + (2 if C == 1 else 1)


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
    assert min(SK.LAUNCHES[k] for k in STREAM_RING) > 0 and SK.LAUNCHES["arena_resample"] == 0
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
    assert min(SK.LAUNCHES[k] for k in STREAM_RING) > 0 and A.LAUNCHES["agc_gains"] > 0
    assert SK.LAUNCHES["arena_resample"] == 0
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
        counts.append({**{k: SK.LAUNCHES[k] for k in STREAM_RING}, **A.LAUNCHES})
    assert counts[0] == counts[1] and min(counts[0].values()) > 0, counts


@pytest.mark.parametrize("S,vps,L", [(16, 256, 16384), (1, 4096, 16384), (3, 17, 2048)])
def test_strip_select_scene_form_within_tolerance(cuda, S, vps, L):
    """K5's scene form (the host-pool pack's read): S scenes of vps voices
    (17 puts a scene boundary inside a block of 32 voices) mixed apart in
    one launch, each scene within ``strip_record_tolerance`` of the plain
    version, two runs bit-equal; at S = 1 equal to the (2, n) form."""
    ops = _wrapping_strip_operands(np.random.default_rng(90 + S), cuda, S * vps, 512, L,
                                   0.0, 0.125)
    ops[6][::9] = 0.0  # masked voices
    rec = RK.voice_record(*ops[1:])
    before = RK.LAUNCHES["strip_select"]
    got = RK.strip_select_record(ops[0], rec, n=512, K=64, scenes=S)
    again = RK.strip_select_record(ops[0], rec, n=512, K=64, scenes=S)
    torch.cuda.synchronize()
    assert RK.LAUNCHES["strip_select"] == before + 2
    assert got.shape == (S, 2, 512) and torch.equal(got, again)
    plain = RK.strip_select_record_plain(ops[0], rec, n=512, K=64, scenes=S)
    tol = RK.strip_record_tolerance(ops[0], rec, n=512, K=64, scenes=S)
    assert bool(((got - plain).abs().double() <= tol).all())
    if S == 1:
        assert torch.equal(got[0], RK.strip_select_record(ops[0], rec, n=512, K=64))


def test_host_and_sampler_packs_on_card_match_cpu_and_renderers(cuda):
    """The host-pool pack (host buffered Speed(Stream) voices through K4
    and K5's scene form, Adapt(Stream) voices, config-5 submixes) and the
    config-2 sampler pack at 4 scenes, on the card against the same packs
    on the CPU and against per-scene Renderers on the card, <= 1e-5."""
    from oddio_tpu_torch.utils.scene_profile import (RATE, build_host_pools_pack,
                                                     build_sampler_pack)

    outs = []
    for device in ("cpu", cuda, "single"):
        dev = cuda if device == "single" else device
        pack, ctls, _, _ = build_host_pools_pack(4, 32, dev)
        if device == "single":
            rs = [pt.Renderer(s, RATE) for s in pack.scenes]
            outs.append(np.concatenate(
                [np.stack([r.render_block(512) for r in rs]) for _ in range(6)], axis=1))
        else:
            outs.append(np.concatenate([pack.render_block(512) for _ in range(6)], axis=1))
    assert np.abs(outs[0]).max() > 0.01
    assert max(np.abs(outs[0] - o).max() for o in outs[1:]) <= 1e-5
    outs = []
    for device in ("cpu", cuda):
        drv = build_sampler_pack(4, 64, device, sounds=2, seconds=1.0)
        outs.append(np.concatenate(drv.render(16, device_out=False), axis=1))
    assert np.abs(outs[0]).max() > 0.1
    assert np.abs(outs[0] - outs[1]).max() <= 1e-5


def test_pack_host_stream_tiers_on_card(cuda):
    """Host-pool Streams stepping under 1 sample a frame in one scene and
    up to 3.5 in another: the pack reads both through K6's ds form
    (``ring_resample``) with the widest tier's window, equal to per-scene
    Renderers on the card and to the pack on the CPU."""
    from oddio_tpu_torch.parallel.mesh import make_mesh
    from oddio_tpu_torch.parallel.sharded import ScenePack

    class HostStream(pt.Stream):
        def dr_supported(self):
            return False

    def mixer(rates, device):
        control, m = pt.Mixer.new(channels=1, device=device)
        for k, rate in enumerate(rates):
            ctl, st = HostStream.new(rate, 8192)
            control.play(st)
            ctl.write((np.sin(np.arange(8000) * (0.02 + 0.01 * k)) * 0.5).astype(np.float32))
        return m

    def build(device):
        return [mixer([6400, 7200], device), mixer([12000, 28000], device)]

    outs = []
    for device in ("cpu", cuda):
        p = ScenePack(build(device), 8000, make_mesh(1, 1))
        SK.reset_launches()
        outs.append(np.concatenate([p.render_block(512) for _ in range(3)], axis=1))
    assert SK.LAUNCHES["ring_resample"] == 3
    rs = [pt.Renderer(m, 8000) for m in build(cuda)]
    own = np.concatenate([np.stack([r.render_block(512) for r in rs]) for _ in range(3)], axis=1)
    assert np.abs(outs[0]).max() > 0.1
    assert np.abs(outs[1] - outs[0]).max() <= 1e-5 and np.abs(outs[1] - own).max() <= 1e-5


# --- K6's arena form and the sampler scenes --------------------------------------


@pytest.mark.parametrize("kind", ["mono", "stereo", "looped"])
@pytest.mark.parametrize("rows,n", [(1024, 512), (4096, 513), (1, 128), (17, 100)])
def test_arena_resample_exact(cuda, kind, rows, n):
    """K6's arena form against its plain version, exactly (the same f32
    operations, each rounded once), over the smoke's shapes: every step
    tier and 44.1 -> 48 kHz at speed 1.2, cursors before, past and far
    outside a sound, negative fractions, stereo channel rows, a looped
    table; one launch per call, two runs bit-equal."""
    host, regions = KB.arena_setup(sounds=2, seconds=2.0)
    garena = torch.tensor(host, device=cuda)
    rng = np.random.default_rng(rows + n)
    ds12 = float(np.float32(44100.0) / np.float32(48000.0) * np.float32(1.2))
    for dsr in ((0.2, 1.0), (1.0, 2.0), (2.0, 4.0), (ds12, ds12)):
        ops = KB.arena_operands(cuda, rng, regions, rows, kind, dsr)
        before = SK.LAUNCHES["arena_resample"]
        got = SK.arena_resample(garena, *ops, n)
        again = SK.arena_resample(garena, *ops, n)
        torch.cuda.synchronize()
        assert SK.LAUNCHES["arena_resample"] == before + 2
        assert torch.equal(got, SK.arena_resample_plain(garena, *ops, n))
        assert torch.equal(got, again)


def test_arena_resample_at_the_arena_ends(cuda):
    """Reads that would leave the arena (a step past RESAMPLE_DSMAX on its
    last region, a clamp bound before its start) take its nearest end,
    exactly as the plain version's; a longer n than RESAMPLE_NMAX is
    refused."""
    host, regions = KB.arena_setup(sounds=1, seconds=0.5)
    garena = torch.tensor(host, device=cuda)
    loff, length, _ = regions["looped"][0]
    i32 = np.int32
    ops = [torch.tensor(x, device=cuda) for x in (
        np.array([loff + length - 2, -40, loff], i32), np.array([loff - 1, -50, loff - 1], i32),
        np.array([loff + length - 1, 10, loff + length - 1], i32), np.zeros(3, np.float32))]
    ops += [torch.tensor(x, device=cuda)
            for x in split_ds(np.array([64.0, 1.0, 33.3], np.float32))]
    got = SK.arena_resample(garena, *ops, SK.RESAMPLE_NMAX)
    assert torch.equal(got, SK.arena_resample_plain(garena, *ops, SK.RESAMPLE_NMAX))
    with pytest.raises(ValueError):
        SK.arena_resample(garena, *ops, SK.RESAMPLE_NMAX + 1)


def test_arena_resample_refuses_cpu_operands_with_a_card_arena(cuda):
    g = torch.zeros((4, 256), device=cuda)
    i4 = torch.zeros(4, dtype=torch.int32)
    f4 = torch.zeros(4)
    with pytest.raises(ValueError):
        SK.arena_resample(g, i4, i4, i4, f4, i4, f4, f4, 8)


def test_sampler_scenes_on_card_match_cpu(cuda):
    """The dense mix (no K6), the config-2 sampler (K6's arena form, both
    fader banks, fades) and the wavetable (K6) at small widths on the card
    against the CPU render, within 1e-5."""
    from oddio_tpu_torch.utils.scene_profile import (build_densemix, build_sampler,
                                                     build_wavetable)

    for label, build in (("dense", lambda d: build_densemix(64, d)[0]),
                         ("sampler", lambda d: build_sampler(64, d, sounds=2, seconds=1.0)),
                         ("wavetable", lambda d: build_wavetable(64, d)[0])):
        outs = []
        for device in ("cpu", cuda):
            SK.reset_launches()
            sig = build(device)
            if label == "sampler":
                r = pt.Renderer(sig.mixer, 48000)
                outs.append(np.concatenate(sig.render(r, 16, device_out=False)))
            else:
                outs.append(pt.Renderer(sig, 48000).render_frames(512 * 16))
        torch.cuda.synchronize()
        step = SK.LAUNCHES["arena_step"]
        assert SK.LAUNCHES["arena_resample"] == 0, label
        assert (step == 0) if label == "dense" else (step >= 16), (label, step)
        assert np.abs(outs[0]).max() > 1e-2
        assert np.abs(outs[0] - outs[1]).max() <= 1e-5, label


# --- K6's arena form as whole steps -------------------------------------------------


def _bits(x):
    """Bit patterns with -0.0 read as +0.0."""
    return torch.where(x == 0, torch.zeros_like(x), x).view(torch.int32)


def _trees_equal(a, b):
    return a.keys() == b.keys() and all(
        _trees_equal(a[k], b[k]) if isinstance(a[k], dict) else torch.equal(a[k], b[k])
        for k in a)


@pytest.mark.parametrize("mode", ["static", 1, 2, 4])
@pytest.mark.parametrize("V,n", [(1024, 512), (17, 513), (1, 128), (300, 100)])
@pytest.mark.parametrize("kind,C", [("frames", 1), ("frames", 2), ("cycle", 1)])
def test_arena_step_exact(cuda, kind, C, V, n, mode):
    """A FramesSignal or Cycle leaf's whole step (read and release) against
    its plain version, exactly; with a Speed factor in the step's tiers;
    one launch, two runs bit-equal."""
    host, regions = KB.arena_setup(sounds=2, seconds=2.0)
    garena = torch.tensor(host, device=cuda)
    rng = np.random.default_rng(V + n + 10 * C)
    st = KB.step_leaf(cuda, rng, regions, V, kind, C)
    sp = None if mode == "static" else KB.step_speeds(cuda, rng, V, mode)
    count = KB.step_count(cuda, rng, V, n)
    before = SK.LAUNCHES["arena_step"]
    st1, got = SK.arena_step(garena, kind, st, KB.STEP_IV, n, count, channels=C, speed=sp)
    st2, again = SK.arena_step(garena, kind, st, KB.STEP_IV, n, count, channels=C, speed=sp)
    plain_st, plain = SK.arena_step_plain(garena, kind, st, KB.STEP_IV, n, count, C, sp)
    torch.cuda.synchronize()
    assert SK.LAUNCHES["arena_step"] == before + 2
    assert torch.equal(got, plain) and torch.equal(got, again)
    assert _trees_equal(st1, plain_st) and _trees_equal(st1, st2)


@pytest.mark.parametrize("V,n", [(1024, 512), (17, 513), (1, 128), (300, 100)])
@pytest.mark.parametrize("kind", ["frames", "cycle"])
def test_arena_warp_exact(cuda, kind, V, n):
    host, regions = KB.arena_setup(sounds=2, seconds=2.0)
    garena = torch.tensor(host, device=cuda)
    rng = np.random.default_rng(V + n)
    st = KB.step_leaf(cuda, rng, regions, V, kind)
    t0, dt = KB.seek_offsets(cuda, rng, V)
    got = SK.arena_warp(garena, kind, st, t0, dt, n)
    assert torch.equal(got, SK.arena_warp_plain(garena, kind, st, t0, dt, n))
    assert torch.equal(got, SK.arena_warp(garena, kind, st, t0, dt, n))


@pytest.mark.parametrize("mode", ["static", 1, 2, 4])
@pytest.mark.parametrize("V,n", [(1024, 512), (17, 513), (1, 128), (300, 100)])
@pytest.mark.parametrize("kind,C", [("frames", 1), ("frames", 2), ("cycle", 1)])
def test_fader_step_exact(cuda, kind, C, V, n, mode):
    """A whole Fader step (both banks, the crossfade) against its plain
    version: equal values, bit-equal but for the sign of an exact zero (an
    idle voice's other bank is not read); its columns and both banks'
    cursors exactly."""
    host, regions = KB.arena_setup(sounds=2, seconds=2.0)
    garena = torch.tensor(host, device=cuda)
    rng = np.random.default_rng(3 * V + n + C)
    banks = (KB.step_leaf(cuda, rng, regions, V, kind, C),
             KB.step_leaf(cuda, rng, regions, V, kind, C))
    fs = KB.fade_columns(cuda, rng, V)
    sp = ((None, None) if mode == "static"
          else (KB.step_speeds(cuda, rng, V, mode), KB.step_speeds(cuda, rng, V, mode)))
    count = KB.step_count(cuda, rng, V, n)
    ivs = (KB.STEP_IV, KB.STEP_IV)
    core, a2, b2, got = SK.fader_step(garena, kind, fs, banks, ivs, n, count, C, sp)
    again = SK.fader_step(garena, kind, fs, banks, ivs, n, count, C, sp)[3]
    pc, pa, pb, plain = SK.fader_step_plain(garena, kind, fs, banks, ivs, n, count, C, sp)
    assert torch.equal(got, plain) and torch.equal(_bits(got), _bits(plain))
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    assert _trees_equal(core, pc) and _trees_equal(a2, pa) and _trees_equal(b2, pb)


def test_sampler_chain_two_seconds_card_vs_cpu(cuda):
    """188 blocks of the config-2 sampler (fades, speed writes) on the card
    against the CPU: the f64 cursors released in the step keep the two
    within 1e-5 to the end."""
    from oddio_tpu_torch.utils.scene_profile import build_sampler

    outs = []
    for device in ("cpu", cuda):
        drv = build_sampler(32, device, sounds=2, seconds=4.0)
        outs.append(np.concatenate(drv.render(pt.Renderer(drv.mixer, 48000), 188,
                                              device_out=False)))
    err = np.abs(outs[0] - outs[1])
    assert np.abs(outs[0]).max() > 1e-2
    assert err.max() <= 1e-5 and err[-512:].max() <= 1e-5


def test_seek_sampler_scene_on_card_matches_cpu(cuda):
    outs = []
    for device in ("cpu", cuda):
        SK.reset_launches()
        _, scene, hs, rng = KB.build_seek_sampler(64, device, sounds=2, seconds=2.0)
        r = pt.Renderer(scene, 48000)
        a = r.render_frames(512 * 8)
        for h in hs[::4]:
            h.set_motion(rng.uniform(-15, 15, 3), rng.uniform(-5, 5, 3), False)
        outs.append(np.concatenate([a, r.render_frames(512 * 8)]))
    torch.cuda.synchronize()
    assert SK.LAUNCHES["arena_step"] == 16 and SK.LAUNCHES["arena_resample"] == 0
    assert np.abs(outs[0]).max() > 1e-2
    assert np.abs(outs[0] - outs[1]).max() <= 1e-5


# --- checkpoints and the realtime driver on the card (chip_smoke.py 32-33) ---------------


@pytest.mark.parametrize("kind", ["buffered", "mixer", "hostpools", "sampler"])
def test_checkpoint_round_trip_on_card(cuda, kind):
    """Phase 32's scenes at 256 voices, their events queued at the
    snapshot: after a restore, and after a second one, the same blocks bit
    for bit (an exact zero's sign aside)."""
    from oddio_tpu_torch.utils import checkpoint as CK
    from oddio_tpu_torch.utils.scene_profile import BLOCK, build_checkpoint_scene

    eng, r = build_checkpoint_scene(kind, 256, "cuda")
    snap = CK.snapshot(eng)
    nblk = 64 if kind == "buffered" else 16
    a = r.render_frames(BLOCK * nblk)
    assert np.isfinite(a).all() and np.abs(a).max() > 1e-3
    for _ in range(2):
        CK.restore(eng, snap)
        b = r.render_frames(BLOCK * nblk)
        np.testing.assert_array_equal(np.where(a == 0, 0.0, a), np.where(b == 0, 0.0, b))


@pytest.mark.parametrize("kind", ["buffered", "mixer", "hostpools", "sampler"])
def test_checkpoint_card_to_cpu(cuda, kind, tmp_path):
    """A snapshot saved on the card loads into the same scene built on the
    CPU: 8 blocks within the PARITY.md 1e-5."""
    from oddio_tpu_torch.utils import checkpoint as CK
    from oddio_tpu_torch.utils.scene_profile import BLOCK, build_checkpoint_scene

    path = tmp_path / "snap.pkl"
    got = []
    for device in ("cuda", "cpu"):
        eng, r = build_checkpoint_scene(kind, 256, device)
        (CK.save if device == "cuda" else CK.load)(eng, path)
        got.append(r.render_frames(BLOCK * 8))
    assert np.abs(got[0] - got[1]).max() <= 1e-5


def test_realtime_driver_exact_on_card(cuda):
    """Phase 33(a) at 256 voices: 32 blocks through the driver equal a
    second mixer's render_block loop bit for bit; the thread lives."""
    import time

    from oddio_tpu_torch.control.realtime import RealtimeDriver
    from oddio_tpu_torch.utils.scene_profile import build_mixer_agc

    _, mixer, _, _ = build_mixer_agc(256, "cuda")
    _, twin, _, _ = build_mixer_agc(256, "cuda")
    drv = RealtimeDriver(mixer, 48000, block_size=512, lead_blocks=4).start()
    got = []
    try:
        deadline = time.time() + 120
        while len(got) < 32 and time.time() < deadline and drv.alive():
            if drv._ring.readable() >= 512:
                got.append(drv.read(512))
            else:
                time.sleep(0.0002)
        assert drv.alive() and drv.error is None and drv.blocks >= 32
    finally:
        drv.stop()
    r = pt.Renderer(twin, 48000)
    want = np.concatenate([r.render_block(512) for _ in range(32)])
    np.testing.assert_array_equal(np.concatenate(got), want)
