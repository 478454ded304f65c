"""The port's ScenePack (oddio_tpu_torch/parallel/) on the CPU, against
per-scene port Renderers, per-scene JAX Renderers and the JAX ScenePack at
``make_mesh(1, 1)``.

The scenes are the JAX package's ``tests/test_sharding.py`` scenes at a 1 x
1 mesh (``CASES``).  The port stacks a pack's scenes along the voice axis
and renders them with the same pools' code as one scene, so against its
own per-scene Renderers it agrees to a few float32 roundings (<= 2e-6
spatial, <= 1e-6 streams, <= 1e-5 for the 48 kHz Sine mixer, as the JAX
test holds its pack; 2e-5 for the walk-tier scenes, as there); against
the JAX package the PARITY.md 1e-5 holds (2e-5 for the walk-tier scenes).
The spatial cases against the JAX package's per-scene Renderers are in
``test_torch_pack_jax.py`` (each file stays well inside a minute).  The
names avoid the JAX tests' (``conftest.py`` marks tests slow by name).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import oddio_tpu as ot  # noqa: E402
import oddio_tpu_torch as pt  # noqa: E402
from oddio_tpu.parallel.mesh import make_mesh as jax_mesh  # noqa: E402
from oddio_tpu.parallel.sharded import ScenePack as JaxPack  # noqa: E402
from oddio_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from oddio_tpu_torch.parallel.sharded import ScenePack  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-5


def kw(m):
    return {"device": "cpu"} if m is pt else {}


def renderers(m, scenes, rate, nblocks, before):
    """Per-scene Renderers of package ``m``: (S, nblocks*512, C);
    ``before(b)`` runs before block b."""
    rs = [m.Renderer(s, rate) for s in scenes]
    out = []
    for b in range(nblocks):
        before(b)
        out.append(np.stack([np.asarray(r.render_block(512)) for r in rs]))
    return np.concatenate(out, axis=1)


def pack(m, scenes, rate, nblocks, before):
    """The same through package ``m``'s ScenePack on a 1 x 1 mesh."""
    p = (ScenePack(scenes, rate, make_mesh(1, 1, ["cpu"])) if m is pt
         else JaxPack(scenes, rate, jax_mesh(1, 1)))
    out = []
    for b in range(nblocks):
        before(b)
        out.append(p.render_block(512))
    return np.concatenate(out, axis=1)


def build_spatial_scene(m, seed):
    """test_sharding.py:19: 8 buffered and 8 seek Sine voices at 8 kHz."""
    rng = np.random.default_rng(seed)
    control, scene = m.SpatialScene.new(**kw(m))
    handles = []
    for _ in range(8):
        handles.append(control.play_buffered(
            m.Sine(rng.uniform(0, 6), rng.uniform(100, 1000)),
            m.SpatialOptions(position=rng.uniform(-20, 20, 3),
                             velocity=rng.uniform(-5, 5, 3)),
            max_distance=50.0, rate=8000, buffer_duration=0.1,
        ))
    for _ in range(8):
        handles.append(control.play(
            m.Sine(rng.uniform(0, 6), rng.uniform(100, 1000)),
            m.SpatialOptions(position=rng.uniform(-20, 20, 3)),
        ))
    return control, scene, handles


def case_spatial(m, render):
    """test_sharding.py:41: 4 spatial scenes, 3 blocks."""
    scenes = [build_spatial_scene(m, s)[1] for s in range(4)]
    return render(m, scenes, 8000, 3, lambda b: None), scenes


def case_events(m, render):
    """Motion deltas in one scene and a listener rotation in another
    before block 1: the pack forces every scene onto the delta path."""
    built = [build_spatial_scene(m, s) for s in range(3)]

    def before(b):
        if b == 1:
            built[0][2][2].set_motion([4.0, 0.0, -6.0], [0.0, 3.0, 0.0], False)
            built[0][2][9].set_motion([-3.0, 1.0, 2.0], [1.0, 0.0, 0.0], True)
            built[1][0].set_listener_rotation([np.cos(0.3), 0.0, np.sin(0.3), 0.0])

    return render(m, [b[1] for b in built], 8000, 4, before), built


def case_clamped(m, render):
    """test_sharding.py:61: scene 1 holds a frozen far voice and a 100 m/s
    mover, which rides the family sub-pass on its own Renderer."""

    def build(seed):
        rng = np.random.default_rng(seed)
        control, scene = m.SpatialScene.new(**kw(m))
        for _ in range(6):
            control.play_buffered(
                m.Sine(rng.uniform(0, 6), rng.uniform(100, 1000)),
                m.SpatialOptions(position=rng.uniform(-10, 10, 3),
                                 velocity=rng.uniform(-2, 2, 3)),
                max_distance=10.0, rate=8000, buffer_duration=0.1,
            )
        if seed == 1:
            control.play_buffered(
                m.Sine(0.0, 700.0), m.SpatialOptions(position=[60.0, 0.0, 0.0]),
                max_distance=10.0, rate=8000, buffer_duration=0.1,
            )
            control.play_buffered(
                m.Sine(0.5, 520.0),
                m.SpatialOptions(position=[4.0, 0.0, 0.0], velocity=[100.0, 0.0, 0.0]),
                max_distance=10.0, rate=8000, buffer_duration=0.1,
            )
        return scene

    scenes = [build(s) for s in range(2)]
    return render(m, scenes, 8000, 3, lambda b: None), scenes


def case_walk_tier(m, render):
    """test_sharding.py:367: a fully clamped far voice (frozen reads) in
    one scene of two."""

    def build(far):
        control, scene = m.SpatialScene.new(**kw(m))
        control.play_buffered(
            m.Sine(0.0, 440.0),
            m.SpatialOptions(position=[3.0, 0.0, -1.0], velocity=[4.0, 0.0, 0.0]),
            max_distance=10.0, rate=8000, buffer_duration=0.1,
        )
        if far:
            control.play_buffered(
                m.Sine(1.0, 620.0), m.SpatialOptions(position=[60.0, 5.0, 0.0]),
                max_distance=10.0, rate=8000, buffer_duration=0.1,
            )
        return scene

    scenes = [build(False), build(True)]
    return render(m, scenes, 8000, 4, lambda b: None), scenes


def case_growth(m, render):
    """test_sharding.py:190: 12 plays (> k_play: the eager path) past the
    16-slot capacity (growth) in every scene before block 2."""

    def wave(control, rng, k):
        for _ in range(k):
            control.play(
                m.Sine(rng.uniform(0, 6), rng.uniform(100, 1000)),
                m.SpatialOptions(position=rng.uniform(-20, 20, 3),
                                 velocity=rng.uniform(-3, 3, 3)),
            )

    built = []
    for seed in range(2):
        rng = np.random.default_rng(seed)
        control, scene = m.SpatialScene.new(initial_capacity=16, **kw(m))
        wave(control, rng, 8)
        built.append((control, scene, rng))

    def before(b):
        if b == 2:
            for control, _, rng in built:
                wave(control, rng, 12)

    scenes = [b[1] for b in built]
    return render(m, scenes, 8000, 5, before), scenes


def case_sines48k(m, render):
    """test_sharding.py:238: 16 Sine voices per mixer at 48 kHz."""
    scenes = []
    for seed in range(2):
        rng = np.random.default_rng(seed)
        control, mixer = m.Mixer.new(channels=1, **kw(m))
        for _ in range(16):
            control.play(m.Sine(rng.uniform(0, 6), rng.uniform(50, 2000)))
        scenes.append(mixer)
    return render(m, scenes, 48000, 2, lambda b: None), scenes


def stream_mixers(m, S=2, voices=6):
    out = []
    for _ in range(S):
        control, mixer = m.Mixer.new(channels=1, **kw(m))
        ctls = []
        for _ in range(voices):
            sc, stream = m.Stream.new(8000, 2048)
            control.play(stream)
            ctls.append(sc)
        out.append((mixer, ctls))
    return out


def case_bare_stream(m, render):
    """test_sharding.py:324: bare streams in device-resident pools, 600
    new samples per stream before each of 4 blocks."""
    built = stream_mixers(m)
    rng = np.random.default_rng(9)

    def before(b):
        for _, ctls in built:
            for c in ctls:
                c.write(rng.standard_normal(600).astype(np.float32) * 0.2)

    scenes = [b[0] for b in built]
    return render(m, scenes, 8000, 4, before), scenes


def config5_mini(m, seed):
    """test_sharding.py:480: 2 Adapt(Stream) + 6 Adapt(Sine), capacity 2."""
    rng = np.random.default_rng(seed)
    mixer = m.Mixer(1, initial_capacity=2, **kw(m))
    mc = m.MixerControl(mixer)
    sctls = []
    for i in range(8):
        opt = m.AdaptOptions(tau=0.1, max_gain=4.0)
        if i < 2:
            stream = m.Stream(8000, 1024 + 128, max_write_per_block=1024)
            sctls.append(stream.control)
            mc.play(m.Adapt(stream, 0.1, opt))
        else:
            mc.play(m.Adapt(m.Sine(rng.uniform(0, 6), rng.uniform(50, 2000)), 0.1, opt))
    return mixer, sctls


PCM = np.random.default_rng(7).standard_normal((4, 1024)).astype(np.float32) * 0.1


def case_config5_mini(m, render):
    """The config-5 mini pack, 1024 samples per stream before block 0 and
    512 more before block 5."""
    scenes, ctls = zip(*[config5_mini(m, s) for s in range(2)])
    flat = [c for group in ctls for c in group]

    def before(b):
        if b in (0, 5):
            for j, ctl in enumerate(flat):
                ctl.write(PCM[j, : 1024 if b == 0 else 512])

    return render(m, list(scenes), 8000, 8, before), list(scenes)


#: name -> (case, tolerance pack vs the port's Renderers, vs the JAX package)
CASES = {
    "spatial": (case_spatial, 2e-6, TOL),
    "events": (case_events, 2e-6, TOL),
    "clamped": (case_clamped, 2e-6, TOL),
    "walk_tier": (case_walk_tier, 2e-5, 2e-5),
    "growth": (case_growth, 2e-6, TOL),
    "sines48k": (case_sines48k, TOL, TOL),
    "bare_stream": (case_bare_stream, 1e-6, TOL),
    "config5_mini": (case_config5_mini, 1e-6, TOL),
}


def _pools(scenes):
    return [p for s in scenes for p in s._all_pools()]


@pytest.mark.parametrize("name", sorted(CASES))
def test_pack_matches_port_renderers(name):
    case, tol, _ = CASES[name]
    own, singles = case(pt, renderers)
    got, scenes = case(pt, pack)
    assert got.shape == own.shape and got.dtype == np.float32
    assert np.abs(own).max() > 1e-2
    np.testing.assert_allclose(got, own, rtol=0, atol=tol)
    if name == "clamped":
        # the sub-pass on its own Renderer; under the pack-wide floor the
        # sub-pass is off and the pack's tier demoted
        sp = list(singles[1]._buffered_pools.values())[0]
        assert sp._sub_cfg is not None and sp._read_cfg[0] == 512
        pp = list(scenes[1]._buffered_pools.values())[0]
        assert pp._sub_cfg is None and pp._read_cfg[0] < 512
    elif name == "walk_tier":
        # frozen voices demote nothing: both scenes keep the tight tier
        tiers = {p._read_cfg for p in _pools(scenes) if hasattr(p, "_read_cfg")}
        assert tiers == {(512, 32)}, tiers
    elif name == "growth":
        assert {p.capacity for p in _pools(scenes)} == {32}


@pytest.mark.parametrize("name", ["bare_stream", "config5_mini", "sines48k"])
def test_pack_matches_jax_renderers(name):
    """The mixer cases against per-scene JAX Renderers (the spatial ones
    are in test_torch_pack_jax.py)."""
    case, _, tol = CASES[name]
    ref, _ = case(ot, renderers)
    got, _ = case(pt, pack)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)


def test_pack_matches_the_jax_pack():
    """The 4-scene spatial case through both packages' ScenePacks."""
    ref, _ = case_spatial(ot, pack)
    got, _ = case_spatial(pt, pack)
    assert got.shape == (4, 1536, 2)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


def test_pack_growth_in_one_scene_grows_the_others():
    """The pack keeps one capacity per pool: plays past capacity in one
    scene grow that pool, and the next block grows it in every scene (the
    stacked rows of scene s start at s*V); the audio is unchanged."""

    def build(seed):
        rng = np.random.default_rng(seed)
        control, mixer = pt.Mixer.new(channels=1, device="cpu")
        for _ in range(16):
            control.play(pt.Sine(rng.uniform(0, 6), rng.uniform(100, 1000)))
        return control, mixer, rng

    def run(render):
        built = [build(s) for s in range(2)]

        def more():
            control, _, rng = built[1]
            for _ in range(4):
                control.play(pt.Sine(rng.uniform(0, 6), rng.uniform(100, 1000)))

        mixers = [b[1] for b in built]
        return render(pt, mixers, 8000, 3, lambda b: b == 1 and more()), mixers

    own, _ = run(renderers)
    got, mixers = run(pack)
    assert [p.capacity for m in mixers for p in m._all_pools()] == [32, 32]
    np.testing.assert_allclose(got, own, rtol=0, atol=1e-6)


def test_pack_stream_writes_in_some_scenes_only():
    """Scenes need not share a write schedule: a scene with no queued PCM
    ships zero ingest rows for the block."""
    built = stream_mixers(pt, S=3, voices=2)
    singles = stream_mixers(pt, S=3, voices=2)
    rs = [pt.Renderer(mx, 8000) for mx, _ in singles]
    pack = ScenePack([mx for mx, _ in built], 8000, make_mesh(1, 1, ["cpu"]))
    rng = np.random.default_rng(3)
    a, b = [], []
    for blk in range(4):
        s = blk % 3
        x = rng.standard_normal((2, 700)).astype(np.float32) * 0.2
        for c1, c2, row in zip(built[s][1], singles[s][1], x):
            c1.write(row)
            c2.write(row)
        a.append(pack.render_block(512))
        b.append(np.stack([r.render_block(512) for r in rs]))
    a, b = np.concatenate(a, axis=1), np.concatenate(b, axis=1)
    assert np.abs(b).max() > 0.05
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_pack_params_follow_the_pools_declared_layouts():
    """Every slot-index param a pool ships is one it declares, and the
    merged params hold each scene's slot indices in its own stacked rows
    (padding at S*V) and one write cursor per scene."""
    built = [build_spatial_scene(pt, s) for s in range(3)]
    built[0][2][2].set_motion([4.0, 0.0, -6.0], [0.0, 3.0, 0.0], False)
    mixers = stream_mixers(pt, S=3)
    mixers[1][1][2].close()
    for scenes in ([b[1] for b in built], [m for m, _ in mixers]):
        p = ScenePack(scenes, 8000, make_mesh(1, 1, ["cpu"]))
        merged = p._block_params(512)[0, 0]  # the one cell of a 1 x 1 mesh
        S, real = p.S, False
        for group in p._groups():
            pool = group[0]
            V, got = pool.capacity, merged[pool.name]
            index_keys = pool.params_index_keys()
            assert {k for k in got if "_idx" in k} <= set(index_keys) | set(pool.SCENE_PARAMS)
            shipped = [k for k in index_keys if k in got]
            assert shipped
            for k in shipped:
                v = np.asarray(got[k])
                lanes = len(v) // S
                scene = np.arange(len(v)) // lanes
                assert ((v == S * V) | (v // V == scene)).all(), k
                real |= bool((v < S * V).any())
            for k in pool.cursor_params():
                assert np.shape(got[k]) == (S,), k
        assert real


def _drain(batches):
    """list of (B, S, C, n) tensors -> (S, n_total, C)."""
    x = np.concatenate([np.asarray(a) for a in batches])
    B, S, C, n = x.shape
    return x.transpose(1, 0, 3, 2).reshape(S, B * n, C)


@pytest.mark.parametrize("unroll", [1, 8])
def test_pack_frames_device_matches_render_block(unroll):
    """test_sharding.py:480: the config-5 mini pack through
    render_frames_device (the idle run-length path) with mid-run ingest,
    at ``scan_unroll`` 1 and 8 (block steps of 1 and 8 blocks a call),
    against render_block."""
    want, _ = case_config5_mini(pt, pack)
    scenes, ctls = zip(*[config5_mini(pt, s) for s in range(2)])
    flat = [c for group in ctls for c in group]
    p = ScenePack(list(scenes), 8000, make_mesh(1, 1, ["cpu"]), scan_unroll=unroll)
    for j, ctl in enumerate(flat):
        ctl.write(PCM[j])
    parts = p.render_frames_device(512 * 5)
    for j, ctl in enumerate(flat):
        ctl.write(PCM[j, :512])
    parts += p.render_frames_device(512 * 3)
    got = _drain(parts)
    assert got.shape == want.shape == (2, 4096, 1)
    np.testing.assert_array_equal(got, want)


def test_pack_sync_reclaims_finished_voices():
    """Closed, drained streams finish on the device; ``sync`` reads the
    pack's handle state once per pool group and reclaims the slots, as a
    scene's own Renderer does."""

    def build():
        control, mixer = pt.Mixer.new(channels=1, device="cpu")
        handles = []
        for k in range(3):
            ctl, st = pt.Stream.new(8000, 2048)
            ctl.write(np.full(100 * (k + 1), 0.5, np.float32))
            if k < 2:
                ctl.close()
            handles.append(control.play(st))
        return mixer, handles

    built = [build() for _ in range(2)]
    p = ScenePack([b[0] for b in built], 8000, make_mesh(1, 1, ["cpu"]))
    for _ in range(3):
        p.render_block(512)
    p.sync()
    single, hs = build()
    r = pt.Renderer(single, 8000)
    for _ in range(3):
        r.render_block(512)
    single.sync()
    want = [h.is_stopped() for h in hs]
    assert want == [True, True, False]
    assert [[h.is_stopped() for h in b[1]] for b in built] == [want, want]
    pool = next(iter(built[1][0]._pools.values()))
    assert len(pool._free) == pool.capacity - 1


def test_pack_idle_runs_skip_prepare():
    """An idle pack run prepares once and advances the rest in O(1)."""
    scenes, _ = zip(*[config5_mini(pt, s) for s in range(2)])
    pack = ScenePack(list(scenes), 8000, make_mesh(1, 1, ["cpu"]))
    pack.render_frames_device(512 * 2)
    calls = []
    for s in scenes:
        inner = s.host_prepare

        def counted(*a, _inner=inner, **k):
            calls.append(1)
            return _inner(*a, **k)

        s.host_prepare = counted
    out = pack.render_frames_device(512 * 10)
    assert out[0].shape == (10, 2, 1, 512)
    assert len(calls) == 2  # one block's prepare per scene


def test_pack_refusals():
    """What a pack cannot take raises, and nothing falls back: a mesh of
    more devices than it is given, and scenes of different archetypes."""
    with pytest.raises(ValueError, match="mesh 2x4 needs 8 devices, have 3"):
        make_mesh(2, 4, ["cpu"] * 3)

    a = build_spatial_scene(pt, 0)[1]
    b = pt.SpatialScene.new(device="cpu")[1]
    with pytest.raises(ValueError, match="archetype"):
        ScenePack([a, b], 8000, make_mesh(1, 1, ["cpu"]))
