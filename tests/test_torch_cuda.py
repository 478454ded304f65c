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
render within 1e-5 of the CPU; the host-pool scene and pack graph
against eager bit for bit through a fly-by across K5's strip gate; the
spatial sampler and the seek chains graph against eager bit for bit, and
their steps captured again after a new ``Frames``;
the buffered pool's walk (``ops/walk.py``) bit-equal to the torch chain
run on the same CUDA tensors, in a graph too, one device kernel;
K7, the whole Adapt step, within ``agc.agc_tolerance`` elementwise
(another order of the prefix sum) at every block length up to 1024; K5 within ``ring_kernels.strip_tolerance``
elementwise (its voice sum in another, fixed order); K8 within
``flat_kernels.window_select_tolerance`` (K2's), K9 exact (a copy), K10
within ``flat_kernels.dma_tolerance`` (as K5's), K8 and K10 one device
kernel a call, bit-equal twice, operands read where they lie, their
cluster tickets left zeroed beside K2's; K1/K2 with a ScenePack's
scene axis as without it, per scene; the scenes and packs within the
PARITY.md 1e-5.  K2/K3 also on the 4096-voice buffered scene's own read
operands; one device kernel (the profiler's count) for each pool read,
each Adapt step (K7) and Stream step (K6) of the config-5 mixer, the
host-pool scene and the config-5 pack, and each whole arena step of the
sampler paths, also exact against their plain versions on the paths'
captured states; every path's kernels and no other launched, as often a
block at 4 as at 16 scenes; checkpoints, the realtime driver and the
example twins; ScenePacks on meshes against their 1 x 1 packs.  Every path
also at its full width (4096-voice scenes, 1024-voice samplers, config-5
packs of 16, 64 and 256 scenes): its launches a block, every kernel call
of each block step's first run held against its plain version on the
same operands, replays at least 90% of the calls.  This file is the
port's only check on the card; ``benchmark/`` times it.
"""

import collections
import concurrent.futures
import contextlib
import functools
import importlib
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import oddio_tpu_torch as pt
from oddio_tpu_torch import spatial as SPATIAL
from oddio_tpu_torch.ops import adapt as ADAPT
from oddio_tpu_torch.ops import agc as A
from oddio_tpu_torch.ops import flat_kernels as FK
from oddio_tpu_torch.ops import ring_kernels as RK
from oddio_tpu_torch.ops import stream as STREAM
from oddio_tpu_torch.ops import stream_kernels as SK
from oddio_tpu_torch.ops import walk as WALK
from oddio_tpu_torch.ops._dev import device_split_ds, split_ds
from oddio_tpu_torch.utils import kernel_bench as KB
from oddio_tpu_torch.core.run import eager
from oddio_tpu_torch.utils.scene_profile import (build_config5_pack, build_host_pools,
                                                 build_host_pools_pack, build_mixer_agc,
                                                 build_sampler_pack, build_seek_sampler,
                                                 build_spatial, build_spatial_pack, feed)

torch.set_num_threads(1)


#: K4's and K6's stream-ring forms (K6's arena form reads sampler arenas)
STREAM_RING = ("ring_place", "ring_resample")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: runs the CUDA kernels")


@pytest.fixture
def cuda():
    _need_card()
    return torch.device("cuda")


def _reset_all():
    for m in (RK, SK, A, FK, WALK):
        m.reset_launches()


def _all_launches():
    return {f"{m.__name__}.{k}": v for m in (RK, SK, A, FK, WALK)
            for k, v in m.LAUNCHES.items() if v}


#: the one-device-kernel checks (a function of this module and its
#: argument) that ``device_kernel_counts`` runs
DEVICE_KERNEL_CASES = (
    [("_pool_read_kernels", r) for r in ("alone", "delta block", "idle block", "idle group")]
    + [("_adapt_step_kernels", e) for e in ("mixer", "hostpools", "pack")]
    + [("_flat_kernels", k) for k in ("window_select", "dma_window_select")]
    + [("_arena_step_states", p) for p in ("sampler", "wavetable", "seek")]
    + [("_walk_kernels", c) for c in ("4096 voices", "pack 16 x 256")])


@pytest.fixture(scope="module")
def device_kernel_counts():
    """Every one-device-kernel check's outcome ("ok" or its output), each
    run in a Python process of its own, four at a time: ``torch.profiler``
    on the card loses every device record of most sessions once a process
    has taken a dozen heavy ones (ROADMAP Q3.6), and a fresh process
    starts a fresh tracer."""
    _need_card()
    here = Path(__file__).resolve().parent

    def run(case):
        code = (f"import sys; sys.path.insert(0, {str(here)!r}); import test_torch_cuda as T; "
                f"T.{case[0]}({case[1]!r})")
        r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                           timeout=900, cwd=here.parent)
        return "ok" if r.returncode == 0 else r.stdout[-1000:] + r.stderr[-3000:]

    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        return dict(zip(DEVICE_KERNEL_CASES, pool.map(run, DEVICE_KERNEL_CASES)))


def _one_device_kernel(counts, fn, arg):
    assert counts[fn, arg] == "ok", counts[fn, arg]


def _mode(mode):
    """``eager()`` for "eager", else replaying graphs (the default)."""
    return eager() if mode == "eager" else contextlib.nullcontext()


def _drain(batches):
    """A pack's ``render_frames_device`` list of (B, S, C, n) tensors as
    numpy (S, B*n, C)."""
    b = torch.cat(list(batches)).cpu().numpy()
    B, S, C, n = b.shape
    return b.transpose(1, 0, 3, 2).reshape(S, B * n, C)


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
    """Two calls: one launch each, bit-equal, within ``tol`` of ``plain``,
    the cluster sum's tickets left zeroed."""
    before = RK.LAUNCHES[key]
    got = call()
    again = call()
    torch.cuda.synchronize()
    assert RK.LAUNCHES[key] == before + 2
    assert torch.equal(got, again)
    assert got.shape == plain.shape and float(plain.abs().max()) > 1e-3
    assert bool(((got - plain).abs().double() <= tol).all())
    assert _tickets_zero(got.device)


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


@pytest.fixture(scope="module")
def buffered_scene():
    """The 4096-voice buffered scene's pool and its captured ``render`` and
    ``render_multi`` arguments, rendered op by op through a Renderer: (pool,
    the delta block's, idle single blocks', fused groups of 4)."""
    _need_card()
    return _buffered_states()


@functools.lru_cache(maxsize=1)
def _buffered_states():
    return KB.capture_states(build_spatial(True, 4096, "cuda")[1])


def _read_geometry(pool):
    """The pool's ring geometry as the K2/K3 wrappers take it."""
    return dict(DMAX=pool.emax2, FP=pool.W_CHUNK, cap=pool.cap_pool)


@pytest.mark.parametrize("case", ["idle block", "delta block", "frozen ears", "mirror", "tight",
                                  "sub-pass 256", "sub-pass 192", "three chunks",
                                  "captured group", "group across the modulus"])
def test_ring_reads_on_the_buffered_scene_operands(buffered_scene, case):
    """K2 and K3 on the 4096-voice buffered scene's own ring and read
    operands (``_advance_block``'s, at the pool's read tier): an idle
    block's read, the delta block's, the same with a third of the ears
    frozen, with every window ending in the mirror, the main pass with
    ``tight`` at K = 128, the family sub-pass at its two tiers, three
    512-frame chunks; a captured fused group and one that wraps the ring's
    modulus.  One launch a call, two runs bit-equal, within the
    tolerance."""
    pool, delta, singles, groups = buffered_scene
    dev, V = torch.device("cuda"), 4096
    rng = np.random.default_rng(3)
    geo = _read_geometry(pool)
    R, K = pool._read_cfg
    state, ros = KB.block_reads(pool, *singles[0])
    ring, ro = state["ring"], ros[0]
    if case.endswith("group") or case.endswith("modulus"):
        nb = groups[0][4]
        if case == "captured group":
            ros = KB.block_reads(pool, *groups[0])[1]
            row0s, hs = RK.multi_rows(pool._adv(), K, nb)
        else:
            K = 64
            ros, row0s, hs = KB.group_operands(dev, rng, V, K, 512,
                                               pool.cap_pool - rng.integers(200, 900, V), nb=nb)
        kw = dict(n=512, K=K, row0s=row0s, hs=hs, **geo)
        _held("select_multi", lambda: RK.ring_select_multi(ring, ros, **kw),
              RK.ring_select_multi_tolerance(ring, ros, **kw),
              RK.ring_select_multi_plain(ring, ros, **kw))
        return
    kw = dict(n=512, K=K, R=R, **geo)
    if case == "delta block":
        ro = KB.block_reads(pool, *delta)[1][0]
    elif case == "frozen ears":
        ro = dict(ro, frz_c=[torch.tensor(rng.uniform(0, 1, V) < 0.3, device=dev).float()
                             for _ in range(2)])
    elif case == "mirror":
        end = pool.cap_pool + K - torch.tensor(rng.integers(1, 48, V), dtype=torch.int32,
                                               device=dev)
        ro = dict(ro, base_c=[b + end - ro["base_c"][0] for b in ro["base_c"]])
    elif case == "tight":
        ro = KB.read_operands(dev, rng, V, 128, 512, frozen=0.3)
        kw.update(K=128, tight=torch.tensor(rng.uniform(0, 1, V) > 0.1, device=dev).float())
    elif case.startswith("sub-pass"):
        R, K = (256, 256) if case.endswith("256") else (128, 192)
        idx = np.zeros(256, np.int32)
        idx[:200] = rng.choice(V, 200, replace=False)
        ro = KB.read_operands(dev, rng, V, K, R)
        kw.update(K=K, R=R, sub_idx=torch.tensor(idx, device=dev), sub_on=torch.tensor(
            (np.arange(256) < 200).astype(np.float32), device=dev))
    elif case == "three chunks":
        ro = KB.read_operands(dev, rng, V, 64, 512)
        kw.update(n=3 * 512, K=64)
    _held("select_ears", lambda: RK.ring_select_ears(ring, ro, **kw),
          RK.ring_select_ears_tolerance(ring, ro, **kw), RK.ring_select_ears_plain(ring, ro, **kw))


@pytest.mark.parametrize("read", ["alone", "delta block", "idle block", "idle group"])
def test_pool_read_is_one_device_kernel(device_kernel_counts, read):
    """The 4096-voice buffered pool's read is one device kernel: K2 called
    alone on an idle block's operands, and a delta block's, an idle
    block's and an idle fused group's read within the pool's render (its
    ``render`` less ``_advance_block`` on the same captured state)."""
    _one_device_kernel(device_kernel_counts, "_pool_read_kernels", read)


def _pool_read_kernels(read):
    pool, delta, singles, groups = _buffered_states()
    if read == "alone":
        state, ros = KB.block_reads(pool, *singles[0])
        R, K = pool._read_cfg
        kw = dict(n=512, K=K, R=R, **_read_geometry(pool))
        count = KB.device_profile(lambda: RK.ring_select_ears(state["ring"], ros[0], **kw))
    else:
        state, whole = {"delta block": (delta, pool.render),
                        "idle block": (singles[1], pool.render),
                        "idle group": (groups[1], pool.render_multi)}[read]
        count = (KB.device_profile(lambda: whole(*state))
                 - KB.device_profile(lambda: KB.block_reads(pool, *state)))
    assert count == 1, count


# --- the buffered pool's walk ------------------------------------------------------------


def _walk_clone(st):
    return {k: v.clone() for k, v in st.items()}


def _differ(got, want, path="out"):
    """The leaves of two results that are not bit-equal (NaN bits
    included), each with its count of differing elements."""
    if isinstance(got, dict):
        return [d for k in got for d in _differ(got[k], want[k], f"{path}.{k}")]
    if isinstance(got, (tuple, list)):
        return [d for i, (g, w) in enumerate(zip(got, want))
                for d in _differ(g, w, f"{path}[{i}]")]
    if got is None or want is None:
        return [] if got is want else [(path, "None")]
    if got.dtype != want.dtype or got.shape != want.shape:
        return [(path, (got.dtype, tuple(got.shape), want.dtype, tuple(want.shape)))]
    a, b = ((x.view(torch.int32) if x.dtype == torch.float32 else x) for x in (got, want))
    n = int((a != b).sum())
    return [(path, n)] if n else []


@pytest.mark.parametrize("case", list(KB.WALK_CASES))
def test_voice_walk_exact(cuda, case):
    """The walk kernel bit-equal to its plain version, the torch chain run
    on the same CUDA tensors: every column it writes in place, every read
    operand, the frames each source renders and the late flags.  Cases
    (``kernel_bench.WALK_CASES``): 4096 voices with 64 motion lanes; a 16
    x 256 pack with (S, 4) rotations, per-scene write counts, lanes per
    scene, lingering and frozen voices on the late path; the late path
    alone; 200 lanes of distinct, padding and repeated slots, a third
    discontinuous; a third of the voices lingering (many expire) and as
    many newly finished; a third offset-clamped (frozen ears).  One
    launch a call, the columns written where they lie, two runs
    bit-equal."""
    (st, *rest), kw = KB.walk_operands(cuda, np.random.default_rng(11), case)
    cols = _walk_clone(st)
    before = WALK.LAUNCHES["voice_walk"]
    got = WALK.voice_walk(cols, *rest, **kw)
    again = WALK.voice_walk(_walk_clone(st), *rest, **kw)
    want = WALK.voice_walk_plain(_walk_clone(st), *rest, **kw)
    torch.cuda.synchronize()
    assert WALK.LAUNCHES["voice_walk"] == before + 2
    assert not _differ(got, want), _differ(got, want)
    assert not _differ(got, again), _differ(got, again)
    assert all(got[0][k] is cols[k] for k in got[0])
    assert got[1]["mask"] is cols["mask"]


def test_voice_walk_replays_in_a_graph(cuda):
    """The walk captures in a CUDA graph (no host read, fixed shapes, the
    block's scalars as kernel arguments): capturing runs nothing, and a
    replay writes what an eager call writes, bit for bit."""
    (st, *rest), kw = KB.walk_operands(cuda, np.random.default_rng(12), "pack 16 x 256")
    want = WALK.voice_walk(_walk_clone(st), *rest, **kw)
    cols = _walk_clone(st)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = WALK.voice_walk(cols, *rest, **kw)
    torch.cuda.synchronize()
    assert not _differ(cols, st)
    graph.replay()
    torch.cuda.synchronize()
    assert not _differ(got, want), _differ(got, want)


@pytest.mark.parametrize("case", ["4096 voices", "pack 16 x 256"])
def test_voice_walk_is_one_device_kernel(device_kernel_counts, case):
    """The walk is one device kernel (the profiler's count), at 4096 voices
    and in the 16 x 256 pack."""
    _one_device_kernel(device_kernel_counts, "_walk_kernels", case)


def _walk_kernels(case):
    (st, *rest), kw = KB.walk_operands(torch.device("cuda"), np.random.default_rng(13), case)
    WALK.voice_walk(st, *rest, **kw)  # builds the library
    count = KB.device_profile(lambda: WALK.voice_walk(st, *rest, **kw))
    assert count == 1, count


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
    on the CPU (plain versions): every kernel launches, K1 always through
    its cursor form, no K8-K10, and the renders agree within the
    contract."""
    a = pt.Renderer(_entry_scene("cpu"), 48000).render_frames(512 * 20)
    _reset_all()
    b = pt.Renderer(_entry_scene(cuda), 48000).render_frames(512 * 20)
    assert all(RK.LAUNCHES[k] > 0 for k in ("append", "select_ears", "select_multi")), RK.LAUNCHES
    assert RK.LAUNCHES["append_cursor"] == RK.LAUNCHES["append"]
    assert not any(FK.LAUNCHES.values()), FK.LAUNCHES
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
    """BASELINE config 5's scene at 256 voices on the card (K4, K6, K7; no
    ring, arena or flat kernel) against the same scene on the CPU (plain
    versions), with a feed."""
    outs = []
    for device in ("cpu", cuda):
        _reset_all()
        _, mixer, ctls, rng = build_mixer_agc(256, device)
        r = pt.Renderer(mixer, 48000)
        a = r.render_frames(512 * 24)
        feed(ctls, rng, 1024)
        outs.append(np.concatenate([a, r.render_frames(512 * 24)]))
    assert min(SK.LAUNCHES[k] for k in STREAM_RING) > 0 and A.LAUNCHES["agc_gains"] > 0
    assert SK.LAUNCHES["arena_resample"] == SK.LAUNCHES["arena_step"] == 0
    assert not any(RK.LAUNCHES.values()) and not any(FK.LAUNCHES.values())
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
    the record form are bit-equal (the voice sum's order is fixed); the
    walk clamp binds near the gate only."""
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
    # the SELECT_R walk clamp binds on the near-gate case's reads, no other's
    binds = sum(int((RK.strip_positions(ops[3][:, e], n, 64)[0]
                     != RK._positions(ops[3][:, e], n, 64)[0].long()).sum()) for e in range(2))
    assert (binds > 0) == (lo > 0.1), binds


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
    and a 64-voice submix on the card (K1, K2, K4, K5, K6; K7 once a block
    in each of its three Adapt pools) against the same scene on the CPU
    (plain versions), over 48 blocks with a feed and a set_speed
    between."""
    outs = []
    for device in ("cpu", cuda):
        _reset_all()
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
    assert SK.LAUNCHES["arena_step"] == 0 and not any(FK.LAUNCHES.values())
    assert A.LAUNCHES["agc_gains"] == 3 * 48  # three 513-frame Adapt pools, each once a block
    assert np.abs(outs[0]).max() > 1e-2
    assert np.abs(outs[0] - outs[1]).max() <= 1e-5


@pytest.mark.parametrize("engine", ["mixer", "hostpools", "pack"])
def test_adapt_and_stream_steps_are_one_device_kernel(device_kernel_counts, engine):
    """Each Adapt pool's step (its whole render less its inner's) is one
    device kernel, K7, and an Adapt(Stream) pool's Stream step one, K6,
    on the pools' own captured steps (the profiler's count, in a fresh
    process): the 4096-voice config-5 mixer (its Adapt(Stream) and
    Adapt(Sine) pools at n = 512), the 4096-voice host-pool scene (its
    three 513-frame Adapt pools, the submix's among them) and the 16 x 256
    config-5 pack (the stack's pools)."""
    _one_device_kernel(device_kernel_counts, "_adapt_step_kernels", engine)


def _adapt_step_kernels(engine):
    cuda = torch.device("cuda")
    if engine == "pack":
        pack, ctls, rng = build_config5_pack(16, cuda)
        owner, render = pack.scenes[0], lambda: pack.render_block(512)
        pack.render_block(512)
    else:
        if engine == "mixer":
            _, owner, ctls, rng = build_mixer_agc(4096, cuda)
        else:
            _, owner, ctls, _, rng = build_host_pools(4096, cuda)
        r = pt.Renderer(owner, 48000)
        r.render_frames(512 * 8)
        render = lambda: r.render_frames(512 * 2)  # noqa: E731
    feed(ctls, rng, 1024)
    caps = KB.capture_steps(KB.dr_pools(owner), render)
    steps = [(p, calls[-1]) for p, calls in caps.items()
             if calls and type(p.proto).__name__ == "Adapt"]
    assert len(steps) == {"mixer": 2, "hostpools": 3, "pack": 2}[engine], steps
    for p, args in steps:
        n = args[3]
        assert getattr(p.proto, "_pool_ema_fast", False) and n <= A.AGC_NMAX, (p.capacity, n)
        k_adapt, k_stream = KB.step_kernels(p.proto, args)
        assert k_adapt == 1, (p.capacity, n, k_adapt)
        if k_stream is not None and p.proto.inner._kernel_ok(n):
            assert k_stream == 1, (p.capacity, n, k_stream)


# --- K8-K10 and the ScenePack ---------------------------------------------------


def _tickets_zero(dev):
    """The cluster sum's tickets (shared by K2/K3, K5, K8/K10) all zero."""
    _, ticket = RK._CLUSTER_SCRATCH.get(dev, (None, None))
    return ticket is None or not bool(ticket.any())


def _flat_held(key, call, plain, tol):
    """Two calls of K8 or K10: one launch each, bit-equal, within ``tol``
    of ``plain``, the tickets left zeroed."""
    before = FK.LAUNCHES[key]
    got = call()
    again = call()
    torch.cuda.synchronize()
    assert FK.LAUNCHES[key] == before + 2
    assert torch.equal(got, again)
    assert got.shape == plain.shape and float(plain.abs().max()) > 1e-3
    assert bool(((got - plain).abs().double() <= tol).all())
    assert _tickets_zero(got.device)


def _k8_case(dev, V, n, emax2, strided, K=64):
    rng = np.random.default_rng(80 + V + n + emax2)
    win = torch.tensor(rng.standard_normal((V, RK.select_window(n, emax2, K) + 3))
                       .astype(np.float32), device=dev)[:, 3:]  # rows at a stride
    return (win,) + KB.flat_operands(dev, rng, V, n, K, emax2, strided), dict(n=n, K=K,
                                                                           emax2=emax2)


#: K10's (n, K): the two-page fetch holds 7*128 + select_window(n, 127 +
#: emax2, K) <= 2048, so n = 896 at K = 32 is the longest read it takes
K10_NK = ((200, 64), (512, 64), (896, 32))


def _k10_case(dev, V, n, K, strided, emax2=36, rowlen=4096):
    """K10 operands, windows anywhere in the row and past its end (they
    read the next row of the flat ring); rstart a column of a (V, 2)
    tensor when ``strided``."""
    rng = np.random.default_rng(100 + V + n)
    ring = torch.tensor(rng.standard_normal((V, rowlen)).astype(np.float32), device=dev)
    rs = KB.flat_rstart(dev, rng, V, rowlen)
    if strided:
        rs = torch.stack([rs, rs + 7], dim=1)[:, 0]
    return (ring, rs) + KB.flat_operands(dev, rng, V, n, K, emax2, strided), dict(
        n=n, K=K, emax2=emax2)


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("emax2", [36, 163])
@pytest.mark.parametrize("n", [200, 512, 1024])
@pytest.mark.parametrize("V", [1, 33, 256, 1000, 4096])
def test_window_select_flat_within_tolerance(cuda, V, n, emax2, strided):
    """K8 against its plain version: one block (V = 1), a partial block,
    one full cluster (256), several clusters through the ticket; operands
    as they lie (``strided``: views that are not contiguous, read in
    place); two calls bit-equal, the tickets left zeroed."""
    ops, kw = _k8_case(cuda, V, n, emax2, strided)
    _flat_held("window_select", lambda: FK.window_select(*ops, **kw),
               FK.window_select_plain(*ops, **kw), FK.window_select_tolerance(*ops, n=n, K=64))


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


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("n,K", K10_NK)
@pytest.mark.parametrize("V", [1, 33, 256, 1000, 4096])
def test_dma_window_select_within_tolerance(cuda, V, n, K, strided):
    """K10 against its plain version, windows past their row end included
    (they read the next row of the flat ring), at the block and cluster
    counts of K8's cases; two calls bit-equal, the tickets left zeroed."""
    ops, kw = _k10_case(cuda, V, n, K, strided)
    _flat_held("dma_window_select", lambda: FK.dma_window_select(*ops, **kw),
               FK.dma_window_select_plain(*ops, **kw), FK.dma_tolerance(*ops, n=n, K=K))


@pytest.mark.parametrize("kernel", ["window_select", "dma_window_select"])
def test_flat_select_is_one_device_kernel(device_kernel_counts, kernel):
    """K8 and K10 at 4096 voices, operands not contiguous: one device
    kernel a call (the profiler's count, in a fresh process; the wrapper
    issues nothing else but the output's allocation)."""
    _one_device_kernel(device_kernel_counts, "_flat_kernels", kernel)


def _flat_kernels(kernel):
    cuda = torch.device("cuda")
    if kernel == "window_select":
        ops, kw = _k8_case(cuda, 4096, 512, 36, True)
    else:
        ops, kw = _k10_case(cuda, 4096, 512, 64, True)
    fn = getattr(FK, kernel)
    fn(*ops, **kw)
    assert KB.device_profile(lambda: fn(*ops, **kw)) == 1


def test_ring_select_between_two_k8_calls(cuda):
    """A K2 read (several clusters: the same tickets) between two K8 calls
    on the same stream leaves both K8 results bit-equal, and K2's equal to
    its own call alone."""
    ops, kw = _k8_case(cuda, 4096, 512, 36, False)
    rng = np.random.default_rng(7)
    ring = KB.read_ring(cuda, 4096, seed=7)
    ro = KB.read_operands(cuda, rng, 4096, 64, 512)
    kw2 = dict(n=512, K=64, R=512, **READ_GEOM)
    alone = RK.ring_select_ears(ring, ro, **kw2)
    first = FK.window_select(*ops, **kw)
    between = RK.ring_select_ears(ring, ro, **kw2)
    second = FK.window_select(*ops, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second) and torch.equal(alone, between)
    assert _tickets_zero(first.device)


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
    (K1, K2) on the card against the same packs on the CPU and against
    per-scene Renderers on the card."""
    from oddio_tpu_torch.utils.scene_profile import build_pack_scene

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
    singles = []
    for s in range(3):
        _, mixer, ctls, _ = build_mixer_agc(64, cuda, s)
        r = pt.Renderer(mixer, 48000)
        a = [r.render_block(512) for _ in range(4)]
        for c, x in zip(ctls, pcm[len(ctls) * s:]):
            c.write(x)
        singles.append(np.concatenate(a + [r.render_frames(512 * 8)]))
    assert np.abs(outs[0]).max() > 0.1
    assert np.abs(outs[0] - outs[1]).max() <= 1e-5
    assert np.abs(outs[1] - np.stack(singles)).max() <= 1e-5
    outs = []
    for device in ("cpu", cuda):
        RK.reset_launches()
        outs.append(_pack_run(build_spatial_pack(3, device, 16, 48), [], []))
    assert RK.LAUNCHES["append"] > 0 and RK.LAUNCHES["select_ears"] > 0
    rs = [pt.Renderer(build_pack_scene(cuda, s, 16, 48), 48000) for s in range(3)]
    singles = np.concatenate([np.stack([r.render_block(512) for r in rs]) for _ in range(12)],
                             axis=1)
    assert np.abs(outs[0]).max() > 1e-2
    assert np.abs(outs[0] - outs[1]).max() <= 1e-5
    assert np.abs(outs[1] - singles).max() <= 1e-5


def _pack_fade_bits(pack):
    """(scenes whose device bank bits equal their host fade mirrors,
    scenes with a flipped voice) of a sampler pack, after ``sync``."""
    from oddio_tpu_torch.core.drctrl import _state_at

    pack.sync()
    same = flipped = 0
    for scene in pack.scenes:
        pool = next(iter(scene._pools.values()))
        path = pool.fade_paths[0]
        bits = _state_at(pool.state["inner"], path)["flip"].cpu().numpy()
        same += int(np.array_equal(bits, pool._fade_flip[path]))
        flipped += int(bits.any())
    return same, flipped


@pytest.mark.parametrize("kind", ["config5", "sampler", "hostpack"])
def test_pack_launches_per_block_do_not_grow_with_scenes(cuda, kind):
    """One launch per pool per block whatever S is: every kernel launches
    as often at 4 scenes as at 16 (and at 64 in the config-5 pack), and
    every scene is audible.  The config-5 pack (64 voices a scene):
    K4/K6/K7, no ring, arena or flat
    kernel; the sampler pack (64 Fader(Speed(FramesSignal)) voices a
    scene, each on its own script of speed writes and fades): one
    ``arena_step`` a block and no other kernel, every scene's fades
    released on the device (its bank bits equal its host mirrors and have
    flipped); the host-pool pack (256 Speed(Stream) host voices, 32
    Adapt(Stream) and a 64-voice submix a scene, with stream writes and
    speed writes): K5 twice a block, both in its scene form."""
    counts = []
    for S in (4, 16, 64) if kind == "config5" else (4, 16):
        _reset_all()
        if kind == "config5":
            pack, ctls, rng = build_config5_pack(S, cuda, voices=64)
            pcm = (rng.standard_normal((len(ctls), 1024)) * 0.1).astype(np.float32)
            out, nblk = _pack_run(pack, ctls, pcm), 12
        elif kind == "sampler":
            drv = build_sampler_pack(S, 64, cuda, sounds=2, seconds=2.0)
            out = np.concatenate(drv.render(8, device_out=False) + [_drain(drv.render(40))],
                                 axis=1)
            nblk = 48
            assert _pack_fade_bits(drv.pack) == (S, S)
        else:
            pack, ctls, speeds, rng = build_host_pools_pack(S, 256, cuda)
            a = np.concatenate([pack.render_block(512) for _ in range(8)], axis=1)
            feed(ctls, rng, 1024)
            for sc in speeds[:64]:
                sc.set_speed(float(rng.uniform(0.8, 1.25)))
            out, nblk = np.concatenate([a, _pack_frames(pack, 24)], axis=1), 32
        torch.cuda.synchronize()
        assert np.isfinite(out).all() and np.abs(out).max(axis=(1, 2)).min() > 1e-3
        counts.append(_all_launches())
    assert all(c == counts[0] for c in counts), counts
    got = counts[0]
    if kind == "config5":
        assert set(got) == {f"{SK.__name__}.{k}" for k in STREAM_RING} | {f"{A.__name__}.agc_gains"}
    elif kind == "sampler":
        assert got == {f"{SK.__name__}.arena_step": nblk}
    else:
        assert (got[f"{RK.__name__}.strip_select"] == got[f"{RK.__name__}.strip_select_scenes"]
                == 2 * nblk), got
        assert not any(k.startswith(FK.__name__) or ".arena" in k for k in got), got


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


def _mixer_host_scene(device, seed):
    """A Mixer of 8 Speed(Stream) host-pool voices, a Sine and a submix
    Mixer (a Speed(Stream) and a Sine) at 48 kHz, its streams prefilled
    from ``seed``."""
    rng = np.random.default_rng(seed)
    control, mixer = pt.Mixer.new(channels=1, device=device)
    ctls = []
    for _ in range(8):
        st = pt.Stream(8000, 4096)
        sc, sp = pt.Speed.new(st)
        sc.set_speed(float(rng.uniform(0.7, 1.3)))
        control.play(sp)
        ctls.append(st.control)
    control.play(pt.Sine(0.2, 330.0 + 20 * seed))
    ic, inner = pt.Mixer.new(channels=1, device=device)
    st = pt.Stream(8000, 4096)
    ic.play(pt.Speed(st))
    ic.play(pt.Sine(0.0, 520.0))
    ctls.append(st.control)
    control.play(inner)
    for c in ctls:
        c.write((np.sin(np.arange(3000) * rng.uniform(0.01, 0.1)) * 0.5).astype(np.float32))
    return mixer


@pytest.mark.parametrize("kind", ["hostpack", "sampler", "mixerpack"])
def test_host_and_sampler_packs_on_card_match_cpu_and_renderers(cuda, kind):
    """At 4 scenes, 16 blocks: the host-pool pack (host buffered
    Speed(Stream) voices through K4 and K5's scene form, Adapt(Stream)
    voices, config-5 submixes), the config-2 sampler pack (each scene on
    its own script) and a pack of Mixers of host-pool voices with a
    Mixer-in-Mixer submix, on the card against the same packs on the CPU
    and against per-scene Renderers on the card, <= 1e-5."""
    from oddio_tpu_torch.parallel.mesh import make_mesh
    from oddio_tpu_torch.parallel.sharded import ScenePack
    from oddio_tpu_torch.utils.scene_profile import RATE

    def build(device):
        if kind == "hostpack":
            return build_host_pools_pack(4, 32, device)[0]
        if kind == "sampler":
            return build_sampler_pack(4, 64, device, sounds=2, seconds=1.0)
        return ScenePack([_mixer_host_scene(device, s) for s in range(4)], RATE,
                         make_mesh(1, 1, [device]))

    def run(device, per_scene=False):
        p = build(device)
        if kind == "sampler" and per_scene:
            return np.stack([np.concatenate(d.render(pt.Renderer(d.mixer, RATE), 16,
                                                     device_out=False)) for d in p.drivers])
        if kind == "sampler":
            return np.concatenate(p.render(16, device_out=False), axis=1)
        if per_scene:
            rs = [pt.Renderer(s, RATE) for s in p.scenes]
            return np.concatenate([np.stack([r.render_block(512) for r in rs])
                                   for _ in range(16)], axis=1)
        return np.concatenate([p.render_block(512) for _ in range(16)], axis=1)

    cpu, card, own = run("cpu"), run(cuda), run(cuda, per_scene=True)
    assert np.abs(cpu).max() > (0.1 if kind == "sampler" else 0.01)
    assert np.abs(card - cpu).max() <= 1e-5 and np.abs(card - own).max() <= 1e-5


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
        p = ScenePack(build(device), 8000, make_mesh(1, 1, [device]))
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
    operations, each rounded once), at the paths' shapes: every step
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


def _same(got, want, signed_zero=True):
    """Two step results (tensors, or dicts and tuples of them) equal: bit
    for bit, or with ``signed_zero`` False equal values whose bits differ
    at most in the sign of an exact zero."""
    if isinstance(got, dict):
        return got.keys() == want.keys() and all(_same(got[k], want[k]) for k in got)
    if isinstance(got, (tuple, list)):
        return len(got) == len(want) and all(_same(g, w, signed_zero) for g, w in zip(got, want))
    if got is None or want is None:
        return got is want
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    if got.dtype != torch.float32:
        return torch.equal(got, want)
    # compared as bits: NaN columns (a playing voice's finished_for) too
    bits = (lambda x: x.view(torch.int32)) if signed_zero else _bits
    return torch.equal(bits(got), bits(want))


@pytest.mark.parametrize("path", ["sampler", "wavetable", "seek"])
def test_arena_step_on_the_paths_captured_states(device_kernel_counts, path):
    """K6's whole step on each sampler path's own captured states (1024
    voices, 10 blocks: the sampler's Fader pool under its speed writes and
    fades, the wavetable's Speed(Cycle) pool after speed writes, the seek
    sampler's seek pool): equal to its plain version on every block (the
    Fader's output but for the sign of an exact zero), one device kernel a
    step (the profiler's count, in a fresh process)."""
    _one_device_kernel(device_kernel_counts, "_arena_step_states", path)


def _arena_step_states(path):
    proto, method, kind, C, calls = KB.arena_states(torch.device("cuda"), path)
    signed = method != "dr_render" or "prog" not in calls[0][0]
    for args in calls:
        assert _same(KB.step_call(proto, method, kind, C, args)(),
                     KB.step_call(proto, method, kind, C, args, plain=True)(), signed)
    assert KB.device_profile(KB.step_call(proto, method, kind, C, calls[0])) == 1


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
        _, scene, hs, rng = build_seek_sampler(64, device, sounds=2, seconds=2.0)
        r = pt.Renderer(scene, 48000)
        a = r.render_frames(512 * 8)
        for h in hs[::4]:
            h.set_motion(rng.uniform(-15, 15, 3), rng.uniform(-5, 5, 3), False)
        outs.append(np.concatenate([a, r.render_frames(512 * 8)]))
    torch.cuda.synchronize()
    assert SK.LAUNCHES["arena_step"] == 16 and SK.LAUNCHES["arena_resample"] == 0
    assert np.abs(outs[0]).max() > 1e-2
    assert np.abs(outs[0] - outs[1]).max() <= 1e-5


# --- checkpoints, the realtime driver and the example twins on the card -----------------

#: the kernels each checkpoint scene's blocks launch
CHECKPOINT_KERNELS = {
    "buffered": [f"{RK.__name__}.{k}" for k in ("append", "select_ears", "select_multi")],
    "mixer": [f"{SK.__name__}.{k}" for k in STREAM_RING] + [f"{A.__name__}.agc_gains"],
    "hostpools": ([f"{RK.__name__}.{k}" for k in ("append", "select_ears", "strip_select")]
                  + [f"{SK.__name__}.{k}" for k in STREAM_RING] + [f"{A.__name__}.agc_gains"]),
    "sampler": [f"{SK.__name__}.arena_step"],
}


@pytest.mark.parametrize("kind", ["buffered", "mixer", "hostpools", "sampler"])
def test_checkpoint_round_trip_on_card(cuda, kind):
    """The checkpoint scenes at 256 voices, their events queued at the
    snapshot: after a restore, and after a second one, the same blocks bit
    for bit (an exact zero's sign aside), every kernel launched as often
    (the buffered scene's 64 blocks reach K3's fused groups)."""
    from oddio_tpu_torch.utils import checkpoint as CK
    from oddio_tpu_torch.utils.scene_profile import BLOCK, build_checkpoint_scene

    eng, r = build_checkpoint_scene(kind, 256, "cuda")
    snap = CK.snapshot(eng)
    nblk = 64 if kind == "buffered" else 16

    def run():
        _reset_all()
        x = r.render_frames(BLOCK * nblk)
        torch.cuda.synchronize()
        return x, _all_launches()

    a, la = run()
    assert np.isfinite(a).all() and np.abs(a).max() > 1e-3
    assert all(la.get(k) for k in CHECKPOINT_KERNELS[kind]), la
    assert not any(k.startswith(FK.__name__) for k in la), la
    for _ in range(2):
        CK.restore(eng, snap)
        b, lb = run()
        np.testing.assert_array_equal(np.where(a == 0, 0.0, a), np.where(b == 0, 0.0, b))
        assert lb == la


@pytest.mark.parametrize("kind", ["buffered", "mixer", "hostpools", "sampler"])
def test_checkpoint_card_to_cpu(cuda, kind, tmp_path):
    """A snapshot saved on the card loads into the same scene built on the
    CPU: 8 audible blocks within the PARITY.md 1e-5."""
    from oddio_tpu_torch.utils import checkpoint as CK
    from oddio_tpu_torch.utils.scene_profile import BLOCK, build_checkpoint_scene

    path = tmp_path / "snap.pkl"
    got = []
    for device in ("cuda", "cpu"):
        eng, r = build_checkpoint_scene(kind, 256, device)
        (CK.save if device == "cuda" else CK.load)(eng, path)
        got.append(r.render_frames(BLOCK * 8))
    assert np.isfinite(got[1]).all() and np.abs(got[1]).max() > 1e-3
    assert np.abs(got[0] - got[1]).max() <= 1e-5


def test_realtime_driver_exact_on_card(cuda):
    """The config-5 mixer at 256 voices, its PCM fed before start(): 32
    blocks read through the driver whenever 512 frames are readable equal
    a second mixer's render_block loop bit for bit; the thread lives and
    the render launched K4, K6 and K7."""
    from oddio_tpu_torch.control.realtime import RealtimeDriver

    _, mixer, _, _ = build_mixer_agc(256, "cuda")
    _, twin, _, _ = build_mixer_agc(256, "cuda")
    _reset_all()
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
    assert min(SK.LAUNCHES[k] for k in STREAM_RING) > 0 and A.LAUNCHES["agc_gains"] > 0
    r = pt.Renderer(twin, 48000)
    want = np.concatenate([r.render_block(512) for _ in range(32)])
    np.testing.assert_array_equal(np.concatenate(got), want)


@pytest.mark.parametrize("kind", ["buffered", "mixer"])
def test_realtime_driver_keeps_its_thread_on_card(cuda, kind):
    """The 4096-voice buffered scene and config-5 mixer under the
    RealtimeDriver, pulled a block at a time at a real-time pace for 3 s
    after the first audible block: the audio arrives and the render thread
    lives to the end."""
    from oddio_tpu_torch.control.realtime import RealtimeDriver

    eng = build_spatial(True, 4096, cuda)[1] if kind == "buffered" else build_mixer_agc(
        4096, cuda)[1]
    drv = RealtimeDriver(eng, 48000, block_size=512, lead_blocks=4).start()
    try:
        t0 = time.perf_counter()
        while np.abs(drv.read(512)).max() == 0:
            assert drv.alive() and time.perf_counter() - t0 < 300, drv.error
            time.sleep(0.005)
        period = 512 / 48000
        t_next = time.perf_counter()
        for _ in range(int(3.0 / period)):
            t_next += period
            drv.read(512)
            time.sleep(max(0.0, t_next - time.perf_counter()))
        assert drv.alive() and drv.error is None
    finally:
        drv.stop()


#: the WAV each offline example twin writes (game_mix and simple print
#: their peak, realtime_spatial returns its audio)
EXAMPLE_WAVS = {"offline": "offline.wav", "wav_playback": "wav_playback.wav",
                "adapt_agc": "adapt.wav", "crossfade_beds": "crossfade_beds.wav"}


@pytest.mark.parametrize("name", ["offline", "wav_playback", "adapt_agc", "crossfade_beds",
                                  "game_mix", "simple", "realtime_spatial"])
def test_example_twin_on_card(cuda, name, tmp_path, monkeypatch, capsys):
    """Each example twin (``oddio_tpu_torch.examples``) on the card, in a
    directory of its own at its own constants: its audio is finite and not
    silent."""
    from oddio_tpu_torch.utils.wav import read_wav

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", [sys.argv[0]])  # wav_playback reads argv[1]
    ret = importlib.import_module(f"oddio_tpu_torch.examples.{name}").main()
    torch.cuda.synchronize()
    if name in EXAMPLE_WAVS or name == "realtime_spatial":
        audio = read_wav(EXAMPLE_WAVS[name])[0] if name in EXAMPLE_WAVS else ret[1]
        assert np.isfinite(audio).all() and np.abs(audio).max() > 1e-3
    else:
        m = re.search(r"peak (\d+\.\d+)", capsys.readouterr().out)
        assert m and float(m.group(1)) > 1e-3


# --- ScenePacks on (scene, voice) meshes ---------------------------------------------


#: each mesh pack: its recipe, scenes and voices a scene
MESH_PACKS = {"config5": ("config5", 4, 64), "spatial": ("spatial", 4, None),
              "hostpack": ("hostpack", 4, 64), "sampler": ("sampler", 4, 64),
              "config5_256x256": ("config5", 256, 256), "hostpack_16x256": ("hostpack", 16, 256),
              "sampler_16x64": ("sampler", 16, 64)}


@pytest.mark.parametrize("kind", list(MESH_PACKS))
def test_mesh_packs_on_card_match_one_card_pack(cuda, kind):
    """A pack on a 2 x 2 logical mesh of the card (``[cuda] * 4``) against
    the 1 x 1 pack of the same script within 2e-6, every cell replaying
    graphs of its own, each key warmed up once, no recapture: the config-5
    pack (K4, K6, K7) of 4 x 64 and at its full width, 256 x 256; the
    spatial pack of 4 scenes (K1, K2); the sampler pack of 4 and of 16
    scenes of 64 Fader voices (each scene's bank bits, gathered from its
    shards, equal its host mirrors and have flipped), each with every
    kernel's launches exactly 4x (one per cell); and the host-pool pack of
    4 x 64 and of 16 x 256 through stream and speed writes, whose submixes
    run on voice shard 0 only: K5's scene form once a block per host pool
    and cell, once per submix pool and scene group."""
    from oddio_tpu_torch.parallel.mesh import make_mesh

    recipe, S, V = MESH_PACKS[kind]
    mesh = make_mesh(2, 2, [cuda] * 4)
    outs, counts, pools, pcm = [], [], None, None
    for m in (None, mesh):
        _reset_all()
        if recipe == "config5":
            pack, ctls, rng = build_config5_pack(S, cuda, voices=V, mesh=m)
            if pcm is None:
                pcm = (rng.standard_normal((len(ctls), 1024)) * 0.1).astype(np.float32)
            outs.append(_pack_run(pack, ctls, pcm))
        elif recipe == "spatial":
            pack = build_spatial_pack(S, cuda, 16, 48, mesh=m)
            outs.append(_pack_run(pack, [], []))
        elif recipe == "hostpack":
            pack, ctls, speeds, rng = build_host_pools_pack(S, V, cuda, mesh=m)
            out = []
            for k in range(2):
                feed(ctls, rng, 1024)
                for sc in speeds[V * k:V * k + V:4]:
                    sc.set_speed(float(rng.uniform(0.8, 1.25)))
                out.append(_pack_run(pack, [], [], nb0=4, nb1=4))
            outs.append(np.concatenate(out, axis=1))
            kinds = [type(p).__name__ for p in pack.scenes[0]._all_pools()]
            pools = (kinds.count("_BufferedPool"), kinds.count("_BufferedPoolSingleton"))
        else:
            drv = build_sampler_pack(S, V, cuda, sounds=2, seconds=2.0, mesh=m)
            outs.append(np.concatenate(drv.render(32, device_out=False), axis=1))
            pack = drv.pack
            assert _pack_fade_bits(pack) == (S, S)
        torch.cuda.synchronize()
        counts.append(_all_launches())
    assert np.abs(outs[0]).max() > 1e-2
    assert np.abs(outs[0] - outs[1]).max() <= 2e-6
    if recipe == "hostpack":
        h, u = pools
        key = f"{RK.__name__}.strip_select_scenes"
        assert (counts[0][key], counts[1][key]) == (16 * (h + u), 16 * (4 * h + 2 * u)), counts
    else:
        assert counts[0] and counts[1] == {k: 4 * v for k, v in counts[0].items()}, counts
    c = pack.graph_counts
    assert _cells_captured(pack) == set(pack._cells) and c["recaptures"] == 0, c
    assert c["eager"] == sum(len(s) for s in pack._steps.values()), c


def test_mesh_card_and_cpu_cells_match_the_card_pack(cuda):
    """A 1 x 2 mesh over ``[cuda, "cpu"]``: voice shard 1 renders on the
    CPU (the plain versions), so no cell may read its scenes' device; the
    spatial and config-5 packs match the 1 x 1 card pack within 2e-6, the
    card cell launching every kernel as often as the 1 x 1 pack."""
    from oddio_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(1, 2, [cuda, "cpu"])
    outs, counts = [], []
    for m in (None, mesh):
        _reset_all()
        outs.append(_pack_run(build_spatial_pack(2, cuda, 16, 48, mesh=m), [], []))
        counts.append(_all_launches())
    assert np.abs(outs[0]).max() > 1e-2
    assert np.abs(outs[0] - outs[1]).max() <= 2e-6
    assert counts[0] and counts[1] == counts[0], counts
    outs, counts, pcm = [], [], None
    for m in (None, mesh):
        pack, ctls, rng = build_config5_pack(2, cuda, voices=64, mesh=m)
        if pcm is None:
            pcm = (rng.standard_normal((len(ctls), 1024)) * 0.1).astype(np.float32)
        _reset_all()
        outs.append(_pack_run(pack, ctls, pcm))
        counts.append(_all_launches())
    assert np.abs(outs[0]).max() > 0.1
    assert np.abs(outs[0] - outs[1]).max() <= 2e-6
    assert counts[0] and counts[1] == counts[0], counts


@pytest.mark.xfail(strict=True, raises=torch.AcceleratorError,
                   reason="ROADMAP Q3.18: a cell on a second card cannot be captured "
                          "(cudaErrorStreamCaptureUnsupported inside the capture, then "
                          "cudaErrorStreamCaptureInvalidated at its end)")
def test_mesh_packs_over_distinct_cards(cuda):
    """Where the machine has two cards or more: the dry run on a mesh over
    distinct cards within its TOL of per-scene Renderers, and the config-5
    pack (4 x 64) on a 1 x 2 or 2 x 2 mesh of them within 2e-6 of the one-card
    pack, every kernel's launches one per cell.  Expected to fail with the
    capture error until the program captures such cells; strict, so it
    fails once it passes; one card skips it."""
    from oddio_tpu_torch.parallel.dryrun import TOL, dryrun_multichip
    from oddio_tpu_torch.parallel.mesh import make_mesh

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA cards or more: a mesh over distinct cards")
    cards = [torch.device("cuda", i) for i in range(n)]
    k = min(8, 2 * (n // 2))
    out = dryrun_multichip(k, cards[:k])
    assert out["max_abs_diff"] <= TOL and out["pack_launches"]["append"] > 0
    a = 2 if n >= 4 else 1
    outs, counts, pcm = [], [], None
    for m in (None, make_mesh(a, 2, cards[:2 * a])):
        pack, ctls, rng = build_config5_pack(4, cards[0], voices=64, mesh=m)
        if pcm is None:
            pcm = (rng.standard_normal((len(ctls), 1024)) * 0.1).astype(np.float32)
        _reset_all()
        outs.append(_pack_run(pack, ctls, pcm))
        for c in cards:
            torch.cuda.synchronize(c)
        counts.append(_all_launches())
    assert np.abs(outs[0]).max() > 0.1
    assert np.abs(outs[0] - outs[1]).max() <= 2e-6
    assert counts[0] and counts[1] == {key: 2 * a * v for key, v in counts[0].items()}, counts


def test_mesh_dryrun_on_card(cuda):
    """``dryrun_multichip`` on 8 logical devices of the card (2 x 4, 512
    voices a shard) against per-scene Renderers within its TOL."""
    from oddio_tpu_torch.parallel.dryrun import TOL, dryrun_multichip

    out = dryrun_multichip(8, [cuda] * 8)
    assert out["mesh"] == "2x4" and out["max_abs_diff"] <= TOL
    assert out["pack_launches"]["append"] > 0 and out["pack_launches"]["select_ears"] > 0


@pytest.mark.parametrize("shape", [(1, 1), (2, 2)])
def test_mesh_pack_checkpoint_resumes_bit_equal_on_card(cuda, shape):
    """``pack.sync()``, a snapshot of every scene, 4 more blocks, a restore
    of every scene and ``pack.drop_stack()``: the same 4 blocks again, bit
    for bit, on the card."""
    from oddio_tpu_torch.parallel.mesh import make_mesh
    from oddio_tpu_torch.utils import checkpoint as CK
    from oddio_tpu_torch.utils.scene_profile import build_host_pools_pack

    pack, ctls, speeds, rng = build_host_pools_pack(
        2, 32, cuda, mesh=make_mesh(*shape, [cuda] * (shape[0] * shape[1])))
    for _ in range(2):
        pack.render_block(512)
    pack.sync()
    snaps = [CK.snapshot(s) for s in pack.scenes]

    def blocks():
        out = []
        for k in range(4):
            if k == 1:
                speeds[0].set_speed(1.2)
            out.append(pack.render_block(512))
        return np.concatenate(out, axis=1)

    a = blocks()
    for s, snap in zip(pack.scenes, snaps):
        CK.restore(s, snap)
    pack.drop_stack()
    b = blocks()
    assert np.abs(a).max() > 0.01
    np.testing.assert_array_equal(a, b)


# -- the Renderer's block steps as CUDA graphs (core/run.py) ------------------------


def _graph_run(scene, control, hs, mode, script, **kw):
    """``script(r, control, hs)`` through a Renderer of ``scene`` (``kw``
    its options) under ``eager()`` or replaying graphs: (blocks (N, 2)
    numpy, launches, the Renderer)."""
    _reset_all()
    r = pt.Renderer(scene, 48000, **kw)
    with _mode(mode):
        out = script(r, control, hs)
    torch.cuda.synchronize()
    x = torch.cat([o.permute(0, 2, 1).reshape(-1, 2) for o in out]).cpu().numpy()
    return x, _all_launches(), r


def _motion_script(r, control, hs):
    out = list(r.render_frames_device(512 * 24))
    rng = np.random.default_rng(7)
    for h in hs[64:80]:
        h.set_motion(rng.uniform(-15, 15, 3), rng.uniform(-1, 1, 3), False)
    out += r.render_frames_device(512 * 47)
    control.set_listener_rotation([np.cos(0.2), 0.0, np.sin(0.2), 0.0])
    out += r.render_frames_device(512 * 20)
    return out


@pytest.mark.parametrize("kind", ["seek", "buffered", "buffered_mixed", "subpass"])
def test_graph_replay_matches_eager(cuda, kind):
    """bench.py's four SpatialScenes at 256 voices under motion and a
    listener rotation: graph replay bit-equal to ``eager()``, every
    kernel's launches equal, the rings where they were, every call after
    a key's warm-up and capture a replay."""
    from oddio_tpu_torch.utils.scene_profile import build_main_path

    runs = []
    for mode in ("eager", "graph"):
        control, scene, hs = build_main_path(kind, 256, cuda)
        rings = [p.dr_state()["ring"].data_ptr() for p in scene._buffered_pools.values()]
        runs.append(_graph_run(scene, control, hs, mode, _motion_script))
        assert [p.state["ring"].data_ptr() for p in scene._buffered_pools.values()] == rings
    (xe, le, re), (xg, lg, rg) = runs
    assert np.abs(xe).max() > 1e-3
    np.testing.assert_array_equal(xg, xe)
    assert lg == le
    c = rg.graph_counts
    assert re.graph_counts["replays"] == 0 and c["recaptures"] == 0
    assert c["replays"] > c["captures"] > 0
    assert c["eager"] == sum(len(s) for s in rg._steps.values())


def test_graph_capture_with_graphs_left_to_the_cyclic_gc(cuda):
    """ROADMAP Q3.12: a cyclic collection that fell inside a capture and
    freed another pack's graphs destroyed them mid-capture, which
    invalidated the capture (cudaErrorStreamCaptureInvalidated).  Here a
    captured host-pool pack becomes cyclic garbage inside a sampler pack's
    capture with the collector at its most eager: the capture runs with
    the cyclic GC off, and the render completes."""
    import gc

    from oddio_tpu_torch.core import run
    from oddio_tpu_torch.utils.scene_profile import build_host_pools_pack, build_sampler_pack

    hp, ctls, _, rng = build_host_pools_pack(2, 16, cuda)
    feed(ctls, rng, 700)
    for _ in range(3):
        hp.render_frames_device(512 * 8)
    assert hp.graph_counts["captures"] >= 1
    cyc = {"pack": hp}
    cyc["self"] = cyc
    keep = [cyc]  # the last reference: dropped inside the next capture
    del hp, ctls, cyc
    body, thresholds, seen = run.step_body, gc.get_threshold(), []

    def step_body(*a, **k):
        if torch.cuda.is_current_stream_capturing():
            seen.append(gc.isenabled())
            keep.clear()
            gc.set_threshold(1, 1, 1)
        return body(*a, **k)

    run.step_body = step_body
    try:
        drv = build_sampler_pack(2, 16, cuda, sounds=2, seconds=1.0)
        out = np.concatenate(drv.render(16, device_out=False), axis=1)
        torch.cuda.synchronize()
    finally:
        run.step_body = body
        gc.set_threshold(*thresholds)
    assert seen and not any(seen) and not keep
    assert drv.pack.graph_counts["captures"] >= 1 and np.isfinite(out).all()


def test_graph_recaptures_after_restore_and_growth(cuda):
    """A checkpoint restore and a play that grows the pools replace state
    leaves: the next replay of each step captures again (counted) and the
    audio stays bit-equal to ``eager()``'s."""
    from oddio_tpu_torch.utils import checkpoint as CK
    from oddio_tpu_torch.utils.scene_profile import build_main_path

    def script(r, control, hs):
        out = list(r.render_frames_device(512 * 24))
        snap = CK.snapshot(r.signal)
        out += r.render_frames_device(512 * 20)
        CK.restore(r.signal, snap)
        out += r.render_frames_device(512 * 20)
        control.play_buffered(pt.Sine(0.2, 300.0), pt.SpatialOptions(position=[2.0, 0.0, 1.0]),
                              max_distance=50.0, rate=48000, buffer_duration=0.1)
        out += r.render_frames_device(512 * 20)
        return out

    runs = []
    for mode in ("eager", "graph"):
        control, scene, hs = build_main_path("buffered", 64, cuda)
        runs.append(_graph_run(scene, control, hs, mode, script))
    (xe, le, _), (xg, lg, rg) = runs
    np.testing.assert_array_equal(xg[24 * 512:44 * 512], xg[44 * 512:64 * 512])
    np.testing.assert_array_equal(xg, xe)
    assert lg == le
    assert rg.graph_counts["recaptures"] > 0 and rg.graph_counts["replays"] > 0


def test_graph_unroll_matches_eager(cuda):
    """Graphs of 4 blocks a replay (``scan_unroll=4``) against ``eager()``
    one block at a time, runs split by the same ``scan_buckets``: the same
    kernels in the same order, bit-equal, launches equal."""
    from oddio_tpu_torch.utils.scene_profile import build_main_path

    runs = []
    buckets = (47, 12, 3, 1)
    for mode, kw in (("eager", dict(scan_buckets=buckets)),
                     ("graph", dict(scan_unroll=4, scan_buckets=buckets))):
        control, scene, hs = build_main_path("buffered_mixed", 256, cuda)
        runs.append(_graph_run(scene, control, hs, mode, _motion_script, **kw))
    (xe, le, _), (xg, lg, rg) = runs
    np.testing.assert_array_equal(xg, xe)
    assert lg == le
    assert any(k == 4 for steps in rg._steps.values() for k, _ in steps)
    assert rg.graph_counts["replays"] > 0 and rg.graph_counts["recaptures"] == 0


# -- BASELINE config 5's Mixer under CUDA graphs ------------------------------------


def _mixer_graph_run(mode, script, voices=256, **kw):
    """``script(r, control, ctls, rng)`` on the config-5 mixer of
    ``voices`` voices under ``eager()`` or replaying graphs: (its result,
    launches, the Renderer, the mixer)."""
    control, mixer, ctls, rng = build_mixer_agc(voices, "cuda")
    assert mixer.graph_capture
    _reset_all()
    r = pt.Renderer(mixer, 48000, **kw)
    with _mode(mode):
        out = script(r, control, ctls, rng)
    torch.cuda.synchronize()
    return out, _all_launches(), r, mixer


def _stream_rings(mixer):
    return [p.dr_state()["inner"]["inner"]["ring"] for p in mixer._pools.values()
            if "ring" in p.dr_state()["inner"]["inner"]]


def _mixer_control_script(r, control, ctls, rng):
    """24 blocks, then three ticks of new PCM on 8 streams, 4 Adapt(Sine)
    plays, 2 stops and a stream close, each followed by 20 blocks (the
    256-voice mixer's Sine pool has room: no growth)."""
    out = [r.render_frames(512 * 24)]
    hs = []
    for t in range(3):
        feed(ctls[8 * t:8 * (t + 1)], rng, 1024)
        hs += [control.play(pt.Adapt(pt.Sine(rng.uniform(0, 6), rng.uniform(50, 2000)), 0.1,
                                     pt.AdaptOptions(tau=0.1, max_gain=4.0)))
               for _ in range(4)]
        for h in hs[4 * t:4 * t + 2]:
            h.stop()
        ctls[24 + t].close()
        out.append(r.render_frames(512 * 20))
    return np.concatenate(out)


def test_mixer_graph_replay_matches_eager(cuda):
    """The 256-voice config-5 mixer through feeds, plays, stops and closes:
    graph replay bit-equal to ``eager()``, every kernel's launches equal
    (K4, K6 and K7 among them, no ring kernel), the rings where they were,
    every call after a key's warm-up and capture a replay."""
    runs = []
    for mode in ("eager", "graph"):
        def script(r, control, ctls, rng):
            rings = [x.data_ptr() for x in _stream_rings(r.signal)]
            out = _mixer_control_script(r, control, ctls, rng)
            assert [x.data_ptr() for x in _stream_rings(r.signal)] == rings
            return out

        runs.append(_mixer_graph_run(mode, script))
    (xe, le, re, _), (xg, lg, rg, _) = runs
    assert np.abs(xe).max() > 0.1
    np.testing.assert_array_equal(xg, xe)
    assert lg == le
    assert all(lg.get(k) for k in (f"{SK.__name__}.ring_place", f"{SK.__name__}.ring_resample",
                                   f"{A.__name__}.agc_gains"))
    assert not any(k.startswith(RK.__name__) for k in lg)
    c = rg.graph_counts
    assert re.graph_counts["replays"] == 0 and c["recaptures"] == 0
    assert c["replays"] > c["captures"] > 0
    assert c["eager"] == sum(len(s) for s in rg._steps.values())


def test_mixer_graph_tail_block_keeps_count_tensor(cuda):
    """512-frame blocks replayed, a render_frames with a 100-frame tail
    (another count tensor), then 512-frame blocks again: a graph reads its
    count tensor by address, so the tail's must not free the 512-frame
    one; the audio stays bit-equal to ``eager()``'s."""
    def script(r, control, ctls, rng):
        out = [r.render_frames(512 * 8)]
        feed(ctls, rng, 700)
        out += [r.render_frames(512 * 8 + 100), r.render_frames(512 * 8)]
        out += [r.render_block(300), r.render_frames(512 * 8)]
        return np.concatenate(out)

    (xe, le, _, _), (xg, lg, rg, mixer) = [_mixer_graph_run(mode, script, voices=64)
                                           for mode in ("eager", "graph")]
    np.testing.assert_array_equal(xg, xe)
    assert lg == le
    assert rg.graph_counts["replays"] > 0 and rg.graph_counts["recaptures"] == 0
    counts = {k[1] for p in mixer._pools.values() for k in p._count_t}
    assert counts == {512, 100, 300}


def test_mixer_graph_handle_readback_after_replay(cuda):
    """A closed stream drains on the card; its handle turns stopped one
    scan late, the same block as under ``eager()``, also when a readback
    was started one block before the query (a replay leaves the state
    tensors' versions unchanged: the readback keys on the store count)."""
    def drain(mode, lead):
        control, mixer = pt.Mixer.new(channels=1, device=cuda)
        for f in (220.0, 330.0):
            control.play(pt.Adapt(pt.Sine(0.5, f), 0.1, pt.AdaptOptions(tau=0.1, max_gain=4.0)))
        ctl, s = pt.Stream.new(8000, 512)
        ctl.write(np.full(200, 0.25, np.float32))
        ctl.close()
        h = control.play(pt.Adapt(s, 0.1, pt.AdaptOptions(tau=0.1, max_gain=4.0)))
        r = pt.Renderer(mixer, 48000)
        seq = []
        with _mode(mode):
            r.render_frames_device(512 * lead)
            for _ in range(6):
                r.render_frames_device(512)  # starts the readback
                r.render_frames_device(512, sync=False)
                seq.append(h.is_stopped())
        return seq, r

    for lead in (0, 1):
        want, _ = drain("eager", lead)
        got, r = drain("graph", lead)
        assert got == want and any(want) and not want[0]
        assert r.graph_counts["replays"] > 0


def test_graph_warms_up_again_after_growth(cuda):
    """A play that grows the buffered pool between a step's warm-up and its
    first capture: the step runs op by op again at the new shapes (sizing
    the read kernels' cluster scratch, which a capture must not grow)
    before it captures; bit-equal to ``eager()``.  The scratch cache starts
    empty, as in a fresh process."""
    from oddio_tpu_torch.utils.scene_profile import BLOCK, build_checkpoint_scene

    outs = []
    for mode in ("eager", "graph"):
        RK._CLUSTER_SCRATCH.clear()
        with _mode(mode):
            eng, r = build_checkpoint_scene("buffered", 256, "cuda")
            outs.append(r.render_frames(BLOCK * 24))
    np.testing.assert_array_equal(outs[1], outs[0])
    assert r.graph_counts["replays"] > 0


def test_mixer_graph_growth_between_warmup_and_capture(cuda, monkeypatch):
    """Plays that grow the Adapt(Sine) pool between the play-lane step's
    warm-up and its capture: the step runs op by op again at the new size,
    so no count tensor is made inside a capture; bit-equal to
    ``eager()``."""
    from oddio_tpu_torch.mixer import PoolDR

    made, count_tensor = [], PoolDR._count_tensor

    def spy(self, V):
        if (V, self._count, self.device) not in self._count_t:
            made.append(torch.cuda.is_current_stream_capturing())
        return count_tensor(self, V)

    monkeypatch.setattr(PoolDR, "_count_tensor", spy)

    def play(control, rng, k):
        for _ in range(k):
            control.play(pt.Adapt(pt.Sine(rng.uniform(0, 6), rng.uniform(50, 2000)), 0.1,
                                  pt.AdaptOptions(tau=0.1, max_gain=4.0)))

    def script(r, control, ctls, rng):
        out = [r.render_block(512) for _ in range(2)]
        play(control, rng, 1)  # the play-lane step's warm-up
        out.append(r.render_block(512))
        play(control, rng, 12)  # the pool grows: the same step at 128 voices
        out += [r.render_block(512) for _ in range(4)]
        return np.concatenate(out + [r.render_frames(512 * 8)])

    (xe, le, _, _), (xg, lg, rg, _) = [_mixer_graph_run(mode, script, voices=64)
                                       for mode in ("eager", "graph")]
    np.testing.assert_array_equal(xg, xe)
    assert lg == le and rg.graph_counts["replays"] > 0
    assert made and not any(made)


# -- ScenePacks under CUDA graphs (a 1 x 1 pack of graph-capturing scenes) -----------


def _pack_graph_run(kind, mode, script, S=4, mesh=None):
    """A config-5 pack (S x 64 voices) or a spatial pack (S scenes of 16
    buffered + 48 seek voices) on the card (on ``mesh``, default 1 x 1),
    under ``eager()`` or replaying graphs: one render_block (which stacks
    the scenes), then ``script(pack, ctls, rng)``: (the audio (S, N, C),
    launches, the pack, the rings' addresses after the first block and at
    the end)."""
    with _mode(mode):
        if kind == "config5":
            pack, ctls, rng = build_config5_pack(S, "cuda", voices=64, mesh=mesh)
        else:
            pack, ctls, rng = build_spatial_pack(S, "cuda", 16, 48, mesh=mesh), [], None
        assert pack.graph_capture
        _reset_all()
        out = [pack.render_block(512)]
        rings = _pack_rings(pack)
        out.append(script(pack, ctls, rng))
        torch.cuda.synchronize()
    return np.concatenate(out, axis=1), _all_launches(), pack, (rings, _pack_rings(pack))


def _pack_rings(pack):
    """Addresses of the stack's in-place leaves (the rings)."""
    out = []

    def walk(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v)
            elif k == "ring":
                out.append(v.data_ptr())

    walk(pack._dstate[0, 0])
    return out


def _pack_frames(pack, nb):
    return _drain(pack.render_frames_device(512 * nb))


def _pack_control_script(pack, ctls, rng):
    """Blocks through render_block and render_frames_device with new PCM,
    a play and a stop in scene 0 and a stream close (config 5), or a move
    and a listener rotation (spatial), and idle runs."""
    out = [pack.render_block(512) for _ in range(3)]
    out.append(_pack_frames(pack, 20))
    s0 = pack.scenes[0]
    if ctls:
        feed(ctls, rng, 1024)
        h = pt.MixerControl(s0).play(pt.Adapt(pt.Sine(0.2, 440.0), 0.1,
                                              pt.AdaptOptions(tau=0.1, max_gain=4.0)))
        out.append(_pack_frames(pack, 12))
        h.stop()
        ctls[3].close()
    else:
        pool = next(iter(s0._buffered_pools.values()))
        pt.Spatial(pool, 1, int(pool.slot_gen[1])).set_motion([3.0, 1.0, -2.0],
                                                              [0.0, 2.0, 0.0], False)
        out.append(_pack_frames(pack, 12))
        pt.SpatialSceneControl(pack.scenes[1]).set_listener_rotation(
            [np.cos(0.2), 0.0, np.sin(0.2), 0.0])
    out.append(_pack_frames(pack, 24))
    out.append(pack.render_block(512))
    return np.concatenate(out, axis=1)


@pytest.mark.parametrize("kind", ["config5", "spatial"])
def test_pack_graph_replay_matches_eager(cuda, kind):
    """A 4-scene config-5 pack (K4, K6, K7, no ring kernel) and a 4-scene
    spatial pack (K1, K2, no other ring kernel) under control traffic,
    every scene audible: graph replay bit-equal to ``eager()``, every
    kernel's launches equal, the rings where they were, every call after a
    key's warm-up and capture a replay."""
    (xe, le, pe, re), (xg, lg, pg, rg) = [_pack_graph_run(kind, mode, _pack_control_script)
                                          for mode in ("eager", "graph")]
    assert np.abs(xe).max(axis=(1, 2)).min() > 1e-3  # every scene audible
    assert np.abs(xe).max() > 1e-2
    np.testing.assert_array_equal(xg, xe)
    assert lg == le
    assert rg[0] == rg[1] and len(rg[0]) >= 1
    keys = ((f"{SK.__name__}.ring_place", f"{SK.__name__}.ring_resample",
             f"{A.__name__}.agc_gains") if kind == "config5"
            else (f"{RK.__name__}.append", f"{RK.__name__}.select_ears"))
    assert all(lg.get(k) for k in keys)
    # no other ring kernel: none on config 5, K1 (its cursor form) and K2 on the spatial pack
    ring = {k for k in lg if k.startswith(RK.__name__)}
    assert ring <= ({f"{RK.__name__}.{k}" for k in ("append", "append_cursor", "select_ears")}
                    if kind == "spatial" else set()), lg
    c = pg.graph_counts
    assert pe.graph_counts["replays"] == 0 and c["recaptures"] == 0
    assert c["replays"] > c["captures"] > 0
    assert c["eager"] == sum(len(s) for s in pg._steps.values())


def _ingest_script(pack, ctls, rng):
    """The prefill drained, then calls of 24 blocks whose writes alternate
    between the even and the odd scenes (two streams a scene), the first
    2500 samples a stream: past ``max_write_per_block`` (2400), two ingest
    blocks in one run."""
    S = len(pack.scenes)
    ns = len(ctls) // S
    out = [_pack_frames(pack, 32)]
    for call in range(4):
        feed([c for s in range(call % 2, S, 2) for c in ctls[s * ns:s * ns + 2]], rng,
             2048 if call else 2500)
        out.append(_pack_frames(pack, 24))
    return np.concatenate(out, axis=1)


def test_pack_graph_in_place_ingest_matches_eager(cuda):
    """The config-5 pack's persistent ingest chunks (``_IngestChunks``)
    under graph replay, over ``_ingest_script``: bit-equal to ``eager()``
    and to the replays of the concatenating path, every kernel's launches
    equal."""

    def concat(pack, ctls, rng):
        pack._ingest.arm = lambda pack: []
        return _ingest_script(pack, ctls, rng)

    (xe, le, _, _), (xg, lg, pg, _), (xc, lc, _, _) = [
        _pack_graph_run("config5", mode, script)
        for mode, script in (("eager", _ingest_script), ("graph", _ingest_script),
                             ("graph", concat))]
    assert np.abs(xe).max() > 1e-2
    np.testing.assert_array_equal(xg, xe)
    np.testing.assert_array_equal(xc, xg)
    assert lg == le == lc
    assert pg.graph_counts["replays"] > 0 and pg._ingest.held == []
    assert all(pg._ingest.free.values())


def test_pack_graph_recaptures_after_growth_and_drop_stack(cuda):
    """Plays that grow one scene's pool (every scene grows with it) and a
    ``sync()`` + ``drop_stack()`` both rebuild the stack: the next call of
    each step runs op by op or captures again (counted), and the audio
    stays bit-equal to ``eager()``'s."""
    def script(pack, ctls, rng):
        out = [_pack_frames(pack, 12), pack.render_block(512)]
        control = pt.MixerControl(pack.scenes[1])
        for _ in range(60):
            control.play(pt.Adapt(pt.Sine(rng.uniform(0, 6), rng.uniform(50, 2000)), 0.1,
                                  pt.AdaptOptions(tau=0.1, max_gain=4.0)))
        out += [_pack_frames(pack, 12), pack.render_block(512), _pack_frames(pack, 12)]
        pack.sync()
        pack.drop_stack()
        out += [_pack_frames(pack, 12), pack.render_block(512)]
        return np.concatenate(out, axis=1)

    (xe, le, _, _), (xg, lg, pg, _) = [_pack_graph_run("config5", mode, script, S=2)
                                       for mode in ("eager", "graph")]
    np.testing.assert_array_equal(xg, xe)
    assert lg == le
    assert {p.capacity for s in pg.scenes for p in s._all_pools()} == {8, 128}
    assert pg.graph_counts["recaptures"] > 0 and pg.graph_counts["replays"] > 0


def test_pack_graph_handle_readback_after_replay(cuda):
    """Closed streams of 1200 and 2000 samples (8 kHz) drain inside replayed
    graphs of a 2-scene pack: after ``pack.sync()`` the handles turn
    stopped on the same blocks as under ``eager()``; without a sync they
    read the stack the replays left (a replay leaves tensor versions alone:
    the scenes' store counts key the readback)."""
    from oddio_tpu_torch.parallel.mesh import make_mesh
    from oddio_tpu_torch.parallel.sharded import ScenePack

    def drain(mode, synced):
        hs, mixers = [], []
        for s in range(2):
            control, mixer = pt.Mixer.new(channels=1, device=cuda)
            for f in (220.0, 330.0):
                control.play(pt.Adapt(pt.Sine(0.5, f + s), 0.1,
                                      pt.AdaptOptions(tau=0.1, max_gain=4.0)))
            ctl, st = pt.Stream.new(8000, 2048)
            ctl.write(np.full(1200 + 800 * s, 0.25, np.float32))
            ctl.close()
            hs.append(control.play(pt.Adapt(st, 0.1, pt.AdaptOptions(tau=0.1, max_gain=4.0))))
            mixers.append(mixer)
        pack = ScenePack(mixers, 8000, make_mesh(1, 1, [cuda]))
        seq = []
        with _mode(mode):
            for k in range(8):
                pack.render_frames_device(512) if k % 2 else pack.render_block(512)
                if synced:
                    pack.sync()
                seq.append([h.is_stopped() for h in hs])
        return seq, pack

    want, _ = drain("eager", True)
    got, pack = drain("graph", True)
    late, _ = drain("graph", False)
    assert got == want == late and any(want[-1]) and not any(want[0])
    assert pack.graph_counts["replays"] > 0


# -- BASELINE config 4's dense mix and the wavetable under CUDA graphs --------------------


def _dense_graph_run(kind, mode, script, voices=256, capacity=512):
    """``script(r, mixer, ctls, rng, frames)`` on the dense mix (its
    ``Tanh(Reinhard(mixer))`` root, scan_unroll 4) or the wavetable of
    ``voices`` voices with bench.py's buckets, under ``eager()`` or
    replaying graphs: (its result, launches, the Renderer)."""
    from oddio_tpu_torch.utils.scene_profile import (BUCKETS, build_densemix,
                                                     build_wavetable, wavetable_frames)

    frames = None
    if kind == "densemix":
        root, mixer, ctls, rng = build_densemix(voices, "cuda", capacity=capacity)
        r = pt.Renderer(root, 48000, scan_unroll=4, scan_buckets=BUCKETS)
    else:
        frames = wavetable_frames()
        mixer, ctls, rng = build_wavetable(voices, "cuda", capacity=capacity, frames=frames)
        root = mixer
        r = pt.Renderer(root, 48000, scan_buckets=BUCKETS)
    assert root.graph_capture
    _reset_all()
    with _mode(mode):
        out = script(r, mixer, ctls, rng, frames)
    torch.cuda.synchronize()
    return out, _all_launches(), r


def _dense_control_script(r, mixer, ctls, rng, frames):
    """24 blocks, then three ticks of a write on 16 voices (set_gain, or
    set_speed: into the step tier 4, past the arena step's bound to the
    exact gather, back) and 4 plays, each followed by 20 blocks (the
    pools have room: no growth)."""
    from oddio_tpu_torch.utils.scene_profile import densemix_voice, wavetable_voice

    out = [r.render_frames(512 * 24)]
    for t in range(3):
        for c in ctls[16 * t:16 * (t + 1)] if t == 0 or frames is None else ctls[:16]:
            if frames is None:
                c.set_gain(float(rng.uniform(-20, 0)))
            else:
                c.set_speed({0: 3.0, 1: 5.0, 2: 1.1}[t])
        for _ in range(4):
            mixer.play((densemix_voice(rng) if frames is None
                        else wavetable_voice(frames, rng))[1])
        out.append(r.render_frames(512 * 20))
    return np.concatenate(out)


@pytest.mark.parametrize("kind", ["densemix", "wavetable"])
def test_dense_graph_replay_matches_eager(cuda, kind):
    """The 256-voice dense mix and wavetable through writes (the
    wavetable's across the arena step's bound and back) and plays: graph
    replay bit-equal to ``eager()``, every kernel's launches equal (the
    wavetable's ``arena_step`` on its arena blocks, no kernel on the dense
    mix, whose limiters keep it within tanh(1); no ring or AGC kernel),
    every call after a key's warm-up and capture a replay, no
    recapture."""
    (xe, le, re), (xg, lg, rg) = [_dense_graph_run(kind, mode, _dense_control_script)
                                  for mode in ("eager", "graph")]
    assert np.abs(xe).max() > 0.1
    np.testing.assert_array_equal(xg, xe)
    assert lg == le
    if kind == "wavetable":
        assert set(lg) == {f"{SK.__name__}.arena_step"}
        assert 0 < lg[f"{SK.__name__}.arena_step"] < xg.shape[0] // 512  # the gather's blocks
    else:
        assert lg == {}
        assert np.abs(xg).max() <= np.tanh(1.0) + 1e-6  # the limiters hold
    c = rg.graph_counts
    assert re.graph_counts["replays"] == 0 and c["recaptures"] == 0
    assert c["replays"] > c["captures"] > 0
    assert c["eager"] == sum(len(s) for s in rg._steps.values())


def test_wavetable_graph_recaptures_after_a_new_table(cuda):
    """Voices of a new table played after the wavetable's steps were
    captured: the sample arena is rebuilt (new tensors), so every step
    that reads it warms up and captures again before it replays; the
    audio stays bit-equal to ``eager()``, the old arena is held until
    then."""
    from oddio_tpu_torch.utils.scene_profile import wavetable_frames, wavetable_voice

    def script(r, mixer, ctls, rng, frames):
        out = [r.render_frames(512 * 24)]
        before = dict(r.graph_counts)
        table = wavetable_frames()
        for _ in range(4):
            mixer.play(wavetable_voice(table, rng)[1])
        out.append(r.render_frames(512 * 24))
        return np.concatenate(out), before

    ((xe, _), le, _), ((xg, before), lg, rg) = [
        _dense_graph_run("wavetable", mode, script) for mode in ("eager", "graph")]
    np.testing.assert_array_equal(xg, xe)
    assert lg == le and lg[f"{SK.__name__}.arena_step"] == 48
    assert before["recaptures"] == 0 and before["replays"] > 0
    assert rg.graph_counts["recaptures"] > 0


@pytest.mark.parametrize("kind", ["densemix", "wavetable"])
def test_dense_graph_growth_between_warmup_and_capture(cuda, kind, monkeypatch):
    """Plays that grow the pool between the play-lane step's warm-up and
    its capture: the step runs op by op again at the new size, so no
    count tensor is made inside a capture; bit-equal to ``eager()``."""
    from oddio_tpu_torch.mixer import PoolDR
    from oddio_tpu_torch.utils.scene_profile import densemix_voice, wavetable_voice

    made, count_tensor = [], PoolDR._count_tensor

    def spy(self, V):
        if (V, self._count, self.device) not in self._count_t:
            made.append(torch.cuda.is_current_stream_capturing())
        return count_tensor(self, V)

    monkeypatch.setattr(PoolDR, "_count_tensor", spy)

    def script(r, mixer, ctls, rng, frames):
        def play(k):
            for _ in range(k):
                mixer.play((densemix_voice(rng) if frames is None
                            else wavetable_voice(frames, rng))[1])

        # the first block's plays warm up the play-lane step, the second
        # the idle step
        out = [r.render_block(512) for _ in range(2)]
        play(40)  # the pool grows (128 -> 256) before the play-lane step's capture
        out += [r.render_block(512) for _ in range(2)]
        play(1)
        out += [r.render_block(512) for _ in range(4)]
        return np.concatenate(out + [r.render_frames(512 * 8)])

    (xe, le, _), (xg, lg, rg) = [_dense_graph_run(kind, mode, script, voices=100,
                                                  capacity=16)
                                 for mode in ("eager", "graph")]
    np.testing.assert_array_equal(xg, xe)
    assert lg == le and rg.graph_counts["replays"] > 0
    assert not any(made)


# -- the samplers under CUDA graphs -------------------------------------------------------


def _sampler_graph_run(kind, mode, script, voices=256):
    """``script(r, engine, ctl)`` on config 2's sampler (``build_sampler``:
    Fader(Speed(FramesSignal)) voices, ``ctl`` its ``SamplerDriver``), the
    seek sampler (``build_seek_sampler``, ``ctl`` its handles and rng) of
    ``voices`` voices with bench.py's buckets, or the sampler pack 4 x 64
    (``build_sampler_pack``, ``ctl`` its ``PackDriver``, ``r`` the pack),
    under ``eager()`` or replaying graphs: (its result, launches, the
    Renderer or pack, the engine)."""
    from oddio_tpu_torch.utils.scene_profile import BUCKETS, build_sampler

    if kind == "sampler_pack":
        ctl = build_sampler_pack(4, 64, "cuda", sounds=2, seconds=2.0)
        engine = r = ctl.pack
    else:
        if kind == "sampler":
            drv = build_sampler(voices, "cuda", sounds=2, seconds=2.0)
            engine, ctl = drv.mixer, drv
        else:
            _, engine, hs, rng = build_seek_sampler(voices, "cuda", sounds=2, seconds=2.0)
            ctl = (hs, rng)
        r = pt.Renderer(engine, 48000, scan_buckets=BUCKETS)
    assert engine.graph_capture
    _reset_all()
    with _mode(mode):
        out = script(r, engine, ctl)
    torch.cuda.synchronize()
    return out, _all_launches(), r, engine


def _sampler_script(r, engine, ctl):
    """The sampler's control script (speed writes on 32 voices and 0.05 s
    fades on 32 others every 8 blocks) over 48 blocks; the pack's, every
    scene's own script (8 and 8) before each of 6 periods of 8 blocks,
    through render_frames_device; the seek sampler's 24 blocks, set_motion
    on 16 voices, 24 blocks, on 16 others, 16 blocks."""
    if isinstance(ctl, tuple):
        hs, rng = ctl
        out = [r.render_frames(512 * 24)]
        for t in range(2):
            for h in hs[16 * t:16 * (t + 1)]:
                h.set_motion(rng.uniform(-15, 15, 3), rng.uniform(-5, 5, 3), False)
            out.append(r.render_frames(512 * (24 - 8 * t)))
        return np.concatenate(out)
    if hasattr(ctl, "drivers"):
        return _drain(ctl.render(48))
    ctl.k = 32
    return np.concatenate(ctl.render(r, 48, device_out=False))


@pytest.mark.parametrize("kind", ["sampler", "seek_sampler", "sampler_pack"])
def test_sampler_graph_replay_matches_eager(cuda, kind):
    """The 256-voice sampler and seek sampler and the sampler pack 4 x 64
    through their scripts: graph replay bit-equal to ``eager()``, every
    kernel's launches equal (one ``arena_step`` launch a block: the
    Fader's ``fader_step``, over the pack's stack too, or the seek pool's
    ``arena_warp``; no ring or AGC kernel), every call after a key's
    warm-up and capture a replay, no recapture."""
    (xe, le, re, _), (xg, lg, rg, _) = [_sampler_graph_run(kind, mode, _sampler_script)
                                        for mode in ("eager", "graph")]
    assert np.abs(xe).max() > 1e-2
    np.testing.assert_array_equal(xg, xe)
    assert lg == le == {f"{SK.__name__}.arena_step": xg.shape[-2] // 512}
    c = rg.graph_counts
    assert re.graph_counts["replays"] == 0 and c["recaptures"] == 0
    assert c["replays"] > c["captures"] > 0
    assert c["eager"] == sum(len(s) for s in rg._steps.values())


def test_sampler_graph_fade_after_capture_replays(cuda):
    """Fades released after the fade block's step was captured: the step
    replays (no recapture), the fade lanes ride in its row, and the
    device's bank bits equal the host's fade mirrors and eager's."""
    from oddio_tpu_torch.core.drctrl import _state_at

    def script(r, engine, drv):
        out = [np.concatenate(drv.render(r, 16, device_out=False))]
        before = dict(r.graph_counts)
        out.append(np.concatenate(drv.render(r, 24, device_out=False)))
        pool = next(iter(engine._pools.values()))
        path = pool.fade_paths[0]
        bits = _state_at(pool.state["inner"], path)["flip"].cpu().numpy()
        return np.concatenate(out), before, bits, pool._fade_flip[path].copy()

    ((xe, _, be, me), le, _, _), ((xg, before, bg, mg), lg, rg, _) = [
        _sampler_graph_run("sampler", mode, script) for mode in ("eager", "graph")]
    np.testing.assert_array_equal(xg, xe)
    assert lg == le
    assert before["captures"] > 0 and before["recaptures"] == 0
    c = rg.graph_counts
    assert c["recaptures"] == 0 and c["replays"] > before["replays"]
    assert c["captures"] == before["captures"]  # the later fade blocks replayed captured steps
    np.testing.assert_array_equal(bg, mg)
    np.testing.assert_array_equal(bg, be)
    assert bg.any() and np.array_equal(me, mg)


def _host_graph_run(kind, mode, flybys=1, voices=256, mesh=None):
    """The host-pool scene (``build_host_pools``: ``voices`` Speed(Stream)
    voices, ``voices // 8`` Adapt(Stream), a config-5 submix), the
    host-pool pack 2 x ``voices`` (``build_host_pools_pack``, on ``mesh``,
    default 1 x 1) or a Mixer of ``voices`` Speed(Stream) voices in its
    host ``Pool`` with a 64-voice config-5 submix
    (``build_mixer_host_pools``) under ``eager()`` or replaying graphs,
    through ``flybys`` passes of a script: in the scene and the pack,
    voice 0 jumps to a fly-by (10 m left, 60 m/s right: its pool leaves
    K5's strip gate, takes it and leaves it again inside one call); 8
    speed writes, PCM on every stream, 32 blocks.  Returns (audio,
    launches, the renderer or pack, its graph_counts after the first
    pass)."""
    from oddio_tpu_torch.utils.scene_profile import build_mixer_host_pools

    hs = []
    if kind == "hostpack":
        r, ctls, speeds, rng = build_host_pools_pack(2, voices, "cuda", handles=hs, mesh=mesh)
        engine = r
    else:
        if kind == "hostpools":
            _, engine, ctls, speeds, rng = build_host_pools(voices, "cuda", handles=hs)
        else:
            _, engine, ctls, speeds, rng = build_mixer_host_pools(voices, "cuda",
                                                                  submix_voices=64)
        r = pt.Renderer(engine, 48000)
    assert engine.graph_capture
    _reset_all()
    out, first = [], None
    with _mode(mode):
        for _ in range(flybys):
            if hs:
                hs[0].set_motion([-10.0, 5.0, 0.0], [60.0, 0.0, 0.0], True)
            for sc in speeds[:8]:
                sc.set_speed(float(rng.uniform(0.8, 1.25)))
            feed(ctls, rng, 1024)
            got = r.render_frames_device(512 * 32) if kind == "hostpack" else \
                r.render_frames_device(512 * 32, sync=False)
            out.append(torch.cat([x.reshape(-1) for x in got]).cpu().numpy())
            if first is None:
                first = dict(r.graph_counts)
    torch.cuda.synchronize()
    return np.concatenate(out), _all_launches(), r, first


@pytest.mark.parametrize("kind", ["hostpools", "hostpack", "hostmixer"])
def test_host_pool_graph_replay_matches_eager(cuda, kind):
    """The 256-voice host-pool scene and the host-pool pack 2 x 256 through
    a fly-by, and the Mixer of 256 host Speed(Stream) voices with a
    submix: graph replay bit-equal to ``eager()``, every kernel's launches
    equal (K1, K2, K4, K5, K6 and K7 among them; K4, K6 and K7 in the
    Mixer, which has no delay ring), every call after a key's warm-up and
    capture a replay, no recapture."""
    (xe, le, re, _), (xg, lg, rg, _) = [_host_graph_run(kind, mode)
                                        for mode in ("eager", "graph")]
    assert np.abs(xe).max() > 1e-3
    np.testing.assert_array_equal(xg, xe)
    assert lg == le
    for k in ("append", "select_ears", "strip_select") if kind != "hostmixer" else ():
        assert lg.get(f"{RK.__name__}.{k}"), lg
    for k in ("ring_place", "ring_resample"):
        assert lg.get(f"{SK.__name__}.{k}"), lg
    assert lg.get(f"{A.__name__}.agc_gains"), lg
    c = rg.graph_counts
    assert re.graph_counts["replays"] == 0 and c["recaptures"] == 0
    assert c["replays"] > c["captures"] > 0
    assert c["eager"] == sum(len(s) for s in rg._steps.values())


def test_host_pool_graph_flyby_replays_without_recapture(cuda):
    """A second fly-by after the first captured its keys (the strip gate
    off, on, off): its blocks replay captured steps (its first block, the
    ingest block without the first's plays, is a key of its own; at most
    one key first met once in the first pass is captured now), no step is
    captured again, and the audio equals ``eager()``'s."""
    (xe, _, _, _), (xg, _, rg, first) = [_host_graph_run("hostpools", mode, flybys=2)
                                         for mode in ("eager", "graph")]
    np.testing.assert_array_equal(xg, xe)
    c = rg.graph_counts
    assert c["recaptures"] == 0 and first["captures"] > 0
    assert c["captures"] - first["captures"] <= 1
    assert c["replays"] - first["replays"] >= 30


# -- ScenePacks on meshes under CUDA graphs (one graph per cell and key) ----------------


def _cells_captured(pack):
    """The cells that captured a graph of their own."""
    return {key[-1] for key, steps in pack._steps.items()
            if any(st.graph is not None for st in steps.values())}


def _mesh_script_run(kind, mode, mesh):
    """On ``mesh``, under ``eager()`` or replaying graphs: the sampler pack
    4 x 64 (every scene's script before each of 6 periods of 8 blocks) or
    the dry-run twin (2 scenes of 64 buffered and 1984 seek Sine voices at
    8 kHz: its three blocks of 256 with plays and moves, then 48 idle
    blocks).  Returns (the audio (S, N, C), launches, the pack)."""
    from oddio_tpu_torch.parallel import dryrun as D
    from oddio_tpu_torch.parallel.sharded import ScenePack

    with _mode(mode):
        if kind == "sampler":
            drv = build_sampler_pack(4, 64, "cuda", sounds=2, seconds=2.0, mesh=mesh)
            pack = drv.pack
            _reset_all()
            x = _drain(drv.render(48))
        else:
            cap = 512 * 4
            built = [D._build_scene(64, cap - 64, mesh.first, cap) for _ in range(2)]
            pack = ScenePack([b[1] for b in built], D.RATE, mesh)
            _reset_all()
            got, _ = D._run([b[0] for b in built], lambda: pack.render_block(D.BLOCK))
            idle = pack.render_frames_device(D.BLOCK * 48, block_size=D.BLOCK)
            x = np.concatenate([got, _drain(idle)], axis=1)
        torch.cuda.synchronize()
    return x, _all_launches(), pack


@pytest.mark.parametrize("kind", ["config5", "hostpack", "sampler", "dryrun"])
def test_mesh_pack_graph_replay_matches_eager(cuda, kind):
    """A 4 x 64-voice config-5 pack under control traffic, the host-pool
    pack 2 x 64 through a fly-by and the sampler pack 4 x 64 through its
    scripts, each on a logical 2 x 2 mesh of the card, and the dry-run
    twin on 2 x 4: every cell replays graphs of its own, bit-equal to the
    same mesh's ``eager()``, every kernel's launches equal, every call
    after a key's warm-up and capture a replay, no recapture."""
    from oddio_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(2, 4, [cuda] * 8) if kind == "dryrun" else make_mesh(2, 2, [cuda] * 4)
    if kind == "config5":
        (xe, le, pe, _), (xg, lg, pg, rg) = [
            _pack_graph_run("config5", mode, _pack_control_script, mesh=mesh)
            for mode in ("eager", "graph")]
        keys = (f"{SK.__name__}.ring_place", f"{SK.__name__}.ring_resample",
                f"{A.__name__}.agc_gains")
        assert rg[0] == rg[1]
    elif kind == "hostpack":
        (xe, le, pe, _), (xg, lg, pg, _) = [
            _host_graph_run("hostpack", mode, voices=64, mesh=mesh)
            for mode in ("eager", "graph")]
        keys = (f"{RK.__name__}.append", f"{RK.__name__}.select_ears",
                f"{RK.__name__}.strip_select_scenes", f"{SK.__name__}.ring_place",
                f"{SK.__name__}.ring_resample", f"{A.__name__}.agc_gains")
    else:
        (xe, le, pe), (xg, lg, pg) = [_mesh_script_run(kind, mode, mesh)
                                      for mode in ("eager", "graph")]
        keys = ((f"{SK.__name__}.arena_step",) if kind == "sampler"
                else (f"{RK.__name__}.append", f"{RK.__name__}.select_ears"))
    assert np.abs(xe).max() > 1e-3
    np.testing.assert_array_equal(xg, xe)
    assert lg == le and all(lg.get(k) for k in keys), lg
    assert pg.graph_capture and _cells_captured(pg) == set(pg._cells)
    c = pg.graph_counts
    assert pe.graph_counts["replays"] == 0 and c["recaptures"] == 0
    assert c["replays"] > c["captures"] > 0
    assert c["eager"] == sum(len(s) for s in pg._steps.values())


def test_mesh_card_cpu_graph_matches_eager(cuda):
    """A 2 x 64-voice config-5 pack on a 1 x 2 mesh over ``[cuda, "cpu"]``:
    the card cell replays its graphs, the CPU cell runs the same steps
    uncaptured, and the audio is bit-equal to the same mesh's ``eager()``
    and within 2e-6 of the 1 x 1 card pack."""
    from oddio_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(1, 2, [cuda, "cpu"])
    (xe, le, _, _), (xg, lg, pg, _), (x1, _, _, _) = [
        _pack_graph_run("config5", mode, _pack_control_script, S=2, mesh=m)
        for mode, m in (("eager", mesh), ("graph", mesh), ("graph", None))]
    assert np.abs(xe).max() > 0.1
    np.testing.assert_array_equal(xg, xe)
    assert lg == le
    assert np.abs(xg - x1).max() <= 2e-6
    assert _cells_captured(pg) == {(0, 0)}
    c = pg.graph_counts
    assert c["recaptures"] == 0 and c["replays"] > c["captures"] > 0
    # each card step: one warm-up op by op, then replays; the CPU cell's
    # calls, all uncaptured, are as many
    warm = sum(len(steps) for key, steps in pg._steps.items() if key[-1] == (0, 0))
    assert c["eager"] - warm == warm + c["replays"]


# -- the last spatial pools under CUDA graphs ---------------------------------------------


#: the arena step's forms each engine launches: 0 a leaf's step
#: (``arena_step``), 1 a seek read (``arena_warp``), 2 a Fader
#: (``fader_step``)
ARENA_FORMS = {"spatial_sampler": {0, 2}, "seek_chains": {1}, "spatial_pack": {0, 2}}


def _arena_graph_run(kind, mode, script):
    """``script(r, render, drvs)`` on the spatial sampler
    (``build_spatial_sampler``: FramesSignal, Speed, Fader and Cycle voices
    in device-resident buffered pools) or the seek chains
    (``build_seek_chains``: Cycle, FixedGain(FramesSignal) and
    Tanh(FixedGain(Sine)) voices in device-resident seek pools) at 256
    voices, or a 1 x 1 pack of 4 spatial samplers of 64 voices (scene s
    from seed s), pools opened at 32 voices, under ``eager()`` or
    replaying graphs; ``render(nb)`` renders nb blocks to numpy, ``r`` is
    the Renderer or pack.  Returns (its result, launches, ``r``, the
    control scripts' ``SpatialDriver``s, the arena step's forms launched
    inside a capture and outside one)."""
    from oddio_tpu_torch.parallel.mesh import make_mesh
    from oddio_tpu_torch.parallel.sharded import ScenePack
    from oddio_tpu_torch.utils.scene_profile import build_seek_chains, build_spatial_sampler

    if kind == "spatial_pack":
        drvs = [build_spatial_sampler(64, "cuda", seed=s, sounds=2, capacity=32, k=16)
                for s in range(4)]
        r = ScenePack([d.scene for d in drvs], 48000, make_mesh(1, 1, ["cuda"]))
        render = lambda nb: _pack_frames(r, nb)  # noqa: E731
    else:
        build = build_spatial_sampler if kind == "spatial_sampler" else build_seek_chains
        drvs = [build(256, "cuda", sounds=2, capacity=32, k=16)]
        r = pt.Renderer(drvs[0].scene, 48000)
        render = lambda nb: r.render_frames(512 * nb)  # noqa: E731
    assert all(d.scene.graph_capture for d in drvs)
    forms, launch = {"eager": set(), "captured": set()}, SK._step_launch

    def spy(garena, kind_, form, *a, **kw):
        forms["captured" if torch.cuda.is_current_stream_capturing() else "eager"].add(form)
        return launch(garena, kind_, form, *a, **kw)

    _reset_all()
    SK._step_launch = spy
    try:
        with _mode(mode):
            out = script(r, render, drvs)
        torch.cuda.synchronize()
    finally:
        SK._step_launch = launch
    if kind == "spatial_pack":
        r.sync()
    return out, _all_launches(), r, drvs, forms


def _arena_rings(r):
    """Addresses of the buffered pools' rings of a Renderer's scene or of a
    pack's stack."""
    if hasattr(r, "scenes"):
        return _pack_rings(r)
    return [p.dr_state()["ring"].data_ptr() for p in r.signal._buffered_pools.values()]


def _arena_script(r, render, drvs):
    """8 blocks; 6 ticks of 16 moves a scene (every second tick 16 speed
    writes and 16 fades), each followed by 4 blocks, Speed voice 0 past the
    arena step's bound at tick 1 and back at tick 3, 16 plays that grow a
    pool at tick 2; 96 blocks (idle after the moves' smoothing: fused
    groups in a Renderer).  Returns (the audio, whether the rings stayed
    where they were over the idle run, the graphs held at the growth: the
    most it may recapture)."""
    out, held = [render(8)], 0
    for t in range(6):
        if t == 2:
            held = sum(st.graph is not None for steps in r._steps.values()
                       for st in steps.values())
        for d in drvs:
            d.tick()
            if d.speeds and t in (1, 3):
                d.speeds[0].set_speed(5.0 if t == 1 else 1.0)
            if t == 2:
                d.play(16)
        out.append(render(4))
    rings = _arena_rings(r)
    out.append(render(96))
    return np.concatenate(out, axis=-2), _arena_rings(r) == rings, held


@pytest.mark.parametrize("kind", ["spatial_sampler", "seek_chains", "spatial_pack"])
def test_spatial_arena_graph_replay_matches_eager(cuda, kind):
    """The 256-voice spatial sampler and seek chains and the spatial
    sampler pack 4 x 64 through their script: graph replay bit-equal to
    ``eager()`` (-0.0 as 0.0), every kernel's launches equal (K1, K2, K3
    and the arena step in the buffered pools' scene, K1, K2 and the arena
    step in the pack, the arena step alone in the seek pools'), the arena
    step's forms captured inside the graphs, the rings unmoved over the
    idle run, recaptures after the growth and no more than the graphs it
    held, replays in the idle run, the handles' ``is_finished`` equal."""
    ((xe, ue, _), le, re, de, fe), ((xg, ug, held), lg, rg, dg, fg) = [
        _arena_graph_run(kind, mode, _arena_script) for mode in ("eager", "graph")]
    assert np.abs(xe).max() > 1e-2
    np.testing.assert_array_equal(xg + np.float32(0.0), xe + np.float32(0.0))
    assert lg == le
    ring = {"spatial_sampler": ("append", "select_ears", "select_multi"),
            "spatial_pack": ("append", "select_ears")}.get(kind, ())
    keys = [f"{RK.__name__}.{k}" for k in ring] + [f"{SK.__name__}.arena_step"]
    assert all(lg.get(k) for k in keys), lg
    assert fg["captured"] == fe["eager"] == ARENA_FORMS[kind], (fg, fe)
    assert ue and ug
    c = rg.graph_counts
    assert re.graph_counts["replays"] == 0 and c["replays"] > c["captures"] > 0
    assert 0 < c["recaptures"] <= held, (c, held)
    assert ([h.is_finished() for d in dg for h in d.voices]
            == [h.is_finished() for d in de for h in d.voices])


@pytest.mark.parametrize("kind", ["spatial_sampler", "seek_chains"])
def test_spatial_arena_graph_recaptures_after_a_new_frames(cuda, kind):
    """A new ``Frames`` (and a FramesSignal over it) after the scene's steps
    were captured replaces the sample arena's tensors: every step that
    reads it warms up and captures again before it replays, never reading
    the old arena's address; bit-equal to ``eager()``."""

    def script(r, render, drvs):
        out = [render(24)]
        before = dict(r.graph_counts)
        pt.FramesSignal(pt.Frames.from_slice(44100, np.linspace(-0.1, 0.1, 3000,
                                                                dtype=np.float32)))
        out.append(render(24))
        return np.concatenate(out), before

    ((xe, _), _, _, _, _), ((xg, before), _, rg, _, _) = [
        _arena_graph_run(kind, mode, script) for mode in ("eager", "graph")]
    np.testing.assert_array_equal(xg + np.float32(0.0), xe + np.float32(0.0))
    assert before["recaptures"] == 0 and before["replays"] > 0
    assert rg.graph_counts["recaptures"] > 0


def test_no_wait_sync_leaves_the_call_in_flight(cuda):
    """A game's per-call sync from the digest it prefetched at the last
    call returns while the call it just dispatched still runs; with no
    digest prefetched, the sync reads the current state and so waits for
    that call.  The 4096-voice spatial sampler, 47-block calls."""
    from oddio_tpu_torch.utils.scene_profile import build_spatial_sampler

    drv = build_spatial_sampler(4096, cuda)
    r = pt.Renderer(drv.scene, 48000)
    for _ in range(3):  # warm-up, capture, replay
        r.render_frames_device(47 * 512, sync=False)
    torch.cuda.synchronize()
    for prefetch in (True, False):
        if prefetch:
            drv.scene.sync_prefetch()
        r.render_frames_device(47 * 512, sync=False)
        in_flight = torch.cuda.Event()
        in_flight.record()
        drv.scene.sync()
        assert in_flight.query() is not prefetch, prefetch
        torch.cuda.synchronize()


# -- every path at its full width ---------------------------------------------------------


#: each kernel wrapper a path may call: its module, the modules that
#: import it by name, its plain version, its bound (None: bit for bit;
#: "zero sign": bit for bit but for the sign of an exact zero; else its
#: elementwise tolerance) and the operand it writes in place (or None)
PATH_KERNELS = {
    "rows_append": (RK, (), RK.rows_append_plain, None, 0),
    "rows_append_cursor": (RK, (SPATIAL,), RK.rows_append_cursor_plain, None, 0),
    "ring_select_ears": (RK, (SPATIAL,), RK.ring_select_ears_plain,
                         RK.ring_select_ears_tolerance, None),
    "ring_select_multi": (RK, (SPATIAL,), RK.ring_select_multi_plain,
                          RK.ring_select_multi_tolerance, None),
    "strip_select": (RK, (), RK.strip_select_plain, RK.strip_tolerance, None),
    "strip_select_record": (RK, (SPATIAL,), RK.strip_select_record_plain,
                            RK.strip_record_tolerance, None),
    "ring_place": (SK, (STREAM,), SK.ring_place_plain, None, 0),
    "ring_place_record": (SK, (SPATIAL,), SK.ring_place_record_plain, None, 0),
    "ring_resample": (SK, (STREAM,), SK.ring_resample_plain, None, None),
    "stream_step": (SK, (STREAM,), SK.stream_step_plain, None, None),
    "arena_step": (SK, (), SK.arena_step_plain, None, None),
    "arena_warp": (SK, (), SK.arena_warp_plain, None, None),
    "fader_step": (SK, (), SK.fader_step_plain, "zero sign", None),
    "agc_step": (A, (ADAPT,), A.agc_step_plain, A.agc_tolerance, None),
    "voice_walk": (WALK, (SPATIAL,), WALK.voice_walk_plain, None, 0),
}

#: each launch counter and the wrappers that count in it
COUNTED_BY = {
    "append": ("rows_append", "rows_append_cursor"), "append_cursor": ("rows_append_cursor",),
    "select_ears": ("ring_select_ears",), "select_multi": ("ring_select_multi",),
    "strip_select": ("strip_select", "strip_select_record"),
    "strip_select_scenes": ("strip_select_record",),
    "ring_place": ("ring_place", "ring_place_record"),
    "ring_resample": ("ring_resample", "stream_step"),
    "arena_step": ("arena_step", "arena_warp", "fader_step"), "agc_gains": ("agc_step",),
    "voice_walk": ("voice_walk",),
}


def _tensors(x):
    return list(x) if isinstance(x, tuple) else [x]


def _hold_path_kernels(monkeypatch):
    """Hold every kernel wrapper call made outside a graph capture against
    its plain version on the same operands: a key's first call runs its
    block step op by op, so each step's kernels are held once, at the
    path's own shapes and state.  Returns the calls held, per wrapper."""
    held = collections.Counter()
    for name, (home, users, plain, bound, inplace) in PATH_KERNELS.items():
        kernel = getattr(home, name)

        def spy(*a, _name=name, _kernel=kernel, _plain=plain, _bound=bound, _inplace=inplace,
                **kw):
            if torch.cuda.is_current_stream_capturing():
                return _kernel(*a, **kw)
            pa = list(a)
            if _inplace is not None:
                x = a[_inplace]
                pa[_inplace] = ({k: v.clone() for k, v in x.items()} if isinstance(x, dict)
                                else x.clone())
            got = _kernel(*a, **kw)
            want = _plain(*pa, **kw)
            if callable(_bound):
                tol = _bound(*pa, **kw)
                for g, w, t in zip(*(_tensors(x) for x in (got, want, tol))):
                    assert bool(((g - w).abs().double() <= t).all()), _name
            else:
                assert _same(got, want, _bound is None), _name
            held[_name] += 1
            return got

        for m in (home, *users):
            monkeypatch.setattr(m, name, spy)
    return held


def _device_audio(out):
    """A render_frames_device list of (k, C, n) tensors as numpy (k*n, C)."""
    return torch.cat([o.permute(0, 2, 1).reshape(-1, o.shape[1]) for o in out]).cpu().numpy()


def _renderer_path(r, between, blocks=94):
    """1 s through render_frames, ``between()``, ``blocks`` blocks through
    render_frames_device: (audio (1, N, C), blocks rendered)."""
    a = r.render_frames(48000)
    between()
    b = _device_audio(r.render_frames_device(512 * blocks))
    return np.concatenate([a, b])[None], -(-48000 // 512) + blocks


def _full_width_path(kind, dev):
    """``kind``'s engine at its full width and its script: (the Renderer
    or pack, ``script()`` -> (audio (scenes, N, C), blocks rendered))."""
    from oddio_tpu_torch.utils.scene_profile import (BUCKETS, build_densemix, build_sampler,
                                                     build_spatial_sampler, build_wavetable)

    if kind in ("buffered", "seek"):
        r = pt.Renderer(build_spatial(kind == "buffered", 4096, dev)[1], 48000)
        return r, lambda: _renderer_path(r, lambda: None)
    if kind == "mixer":
        _, mixer, ctls, rng = build_mixer_agc(4096, dev)
        r = pt.Renderer(mixer, 48000)
        return r, lambda: _renderer_path(r, lambda: feed(ctls, rng, 1024))
    if kind == "hostpools":
        _, scene, ctls, speeds, rng = build_host_pools(4096, dev)
        r = pt.Renderer(scene, 48000)

        def between():
            feed(ctls, rng, 1024)
            for sc in speeds[:64]:
                sc.set_speed(float(rng.uniform(0.8, 1.25)))

        return r, lambda: _renderer_path(r, between)
    if kind == "spatial_sampler":
        drv = build_spatial_sampler(4096, dev)
        r = pt.Renderer(drv.scene, 48000)
        return r, lambda: _renderer_path(r, drv.tick)
    if kind == "sampler":
        drv = build_sampler(1024, dev)
        r = pt.Renderer(drv.mixer, 48000, scan_buckets=BUCKETS)

        def script():
            a = np.concatenate(drv.render(r, 96, device_out=False))
            return np.concatenate([a, _device_audio(drv.render(r, 96))])[None], 192

        return r, script
    if kind == "wavetable":
        mixer, ctls, rng = build_wavetable(1024, dev)
        r = pt.Renderer(mixer, 48000, scan_buckets=BUCKETS)
        return r, lambda: _renderer_path(r, lambda: [c.set_speed(1.1) for c in ctls[:64]])
    if kind == "seek_sampler":
        _, engine, hs, rng = build_seek_sampler(1024, dev)
        r = pt.Renderer(engine, 48000, scan_buckets=BUCKETS)
        return r, lambda: _renderer_path(r, lambda: [
            h.set_motion(rng.uniform(-15, 15, 3), rng.uniform(-5, 5, 3), False) for h in hs[:64]])
    if kind == "densemix":
        root, _, ctls, rng = build_densemix(1024, dev)
        r = pt.Renderer(root, 48000, scan_unroll=4, scan_buckets=BUCKETS)
        return r, lambda: _renderer_path(r, lambda: [c.set_gain(float(rng.uniform(-20, 0)))
                                                     for c in ctls[:64]])
    if kind == "spatial_pack":
        pack = build_spatial_pack(16, dev)
        return pack, lambda: (_pack_run(pack, [], [], 4, 60), 64)
    S = int(kind.removeprefix("config5_pack"))
    pack, ctls, rng = build_config5_pack(S, dev)
    pcm = (rng.standard_normal((len(ctls), 1024)) * 0.1).astype(np.float32)
    return pack, lambda: (_pack_run(pack, ctls, pcm, 4, 60), 64)


#: each path's kernels (launch counter -> launches a block; None: some);
#: a config-5 pack's as its Mixer's, whatever its scenes
FULL_WIDTH = {
    "buffered": {"append": None, "append_cursor": None, "select_ears": None,
                 "select_multi": None, "voice_walk": 1},
    "seek": {},
    "mixer": {"ring_place": None, "ring_resample": 1, "agc_gains": 2},
    "hostpools": {"append": None, "append_cursor": None, "select_ears": 1,
                  "strip_select": 2, "ring_place": None, "ring_resample": 2, "agc_gains": 3,
                  "voice_walk": 1},
    "spatial_sampler": {"append": None, "append_cursor": None, "select_ears": None,
                        "select_multi": None, "arena_step": None, "voice_walk": 4},
    "sampler": {"arena_step": 1}, "wavetable": {"arena_step": 1},
    "seek_sampler": {"arena_step": 1}, "densemix": {},
    "spatial_pack": {"append": 1, "append_cursor": 1, "select_ears": 1, "voice_walk": 1},
    **{f"config5_pack{S}": {"ring_place": None, "ring_resample": 1, "agc_gains": 2}
       for S in (16, 64, 256)},
}


@pytest.mark.parametrize("kind", list(FULL_WIDTH))
def test_path_at_full_width(cuda, kind, monkeypatch):
    """Each path at its full width (the 4096-voice buffered, seek,
    config-5 mixer, host-pool and spatial-sampler scenes over 1 s and 94
    blocks with their control between; config 2's sampler, the
    wavetable, the seek sampler and config 4's dense mix at 1024 voices;
    the 16-scene spatial pack and the config-5 pack of 16, 64 and 256
    scenes of 256 voices over 64 blocks), replaying graphs: bit-equal to
    the same script under ``eager()`` (-0.0 as 0.0), every kernel's
    launches equal; finite and audible in every scene (the dense mix
    within tanh(1)); its kernels and no other launched, K1 only through
    its cursor form, as often a block as ``FULL_WIDTH`` says; every
    kernel call outside a capture (each block step's first run, every
    eager call) held against its plain version on the same operands
    (within the kernel's tolerance, or bit for bit); no recapture; then 32
    single-block calls, replays at least 90% of them."""
    held = _hold_path_kernels(monkeypatch)
    runs = []
    for mode in ("eager", "graph"):
        engine, script = _full_width_path(kind, cuda)
        _reset_all()
        with _mode(mode):
            x, nblk = script()
        torch.cuda.synchronize()
        runs.append((x + np.float32(0.0), {k.rsplit(".", 1)[1]: v
                                           for k, v in _all_launches().items()}))
    (xe, le), (x, got) = runs
    assert np.isfinite(x).all() and np.abs(x).max(axis=(1, 2)).min() > 1e-3, kind
    np.testing.assert_array_equal(x, xe)
    assert got == le, (got, le)
    if kind == "densemix":
        assert np.abs(x).max() <= np.tanh(1.0) + 1e-6
    want = FULL_WIDTH[kind]
    assert set(got) == set(want), got
    assert all(got[k] == v * nblk for k, v in want.items() if v is not None), (nblk, got)
    assert got.get("append_cursor") == got.get("append"), got
    for counter in got:
        assert any(held[w] for w in COUNTED_BY[counter]), (counter, dict(held))
    before = dict(engine.graph_counts)
    for _ in range(32):
        engine.render_frames_device(512)
    torch.cuda.synchronize()
    c = engine.graph_counts
    replays, calls = (c["replays"] - before["replays"],
                      c["replays"] + c["eager"] - before["replays"] - before["eager"])
    assert c["recaptures"] == 0 and replays >= 0.9 * calls, (before, c)
