"""The port's ScenePack on (scene, voice) meshes larger than 1 x 1, on
logical CPU meshes (``make_mesh(a, b, ["cpu"] * n)``: every cell renders
in turn on the CPU).

A mesh splits the pack's scenes into a groups and each pool's slots into b
voice shards, renders every cell and sums each group's shards' partial
mixes, so against the port's own 1 x 1 pack it agrees to the float32
roundings of those partial sums (2e-6).  The scenes are
``test_torch_pack.py``'s ``CASES`` at every mesh up to 2 x 4 that their
scene counts and capacities divide, and the host-pool, submix, Fader and
sampler scenes of ``test_torch_pack_host.py`` and
``test_torch_pack_fades.py``.  The spatial case matches the JAX package's
own ScenePack on its virtual 8-device CPU mesh at 2 x 4 within 1e-5, and
a JAX 2 x 4 pack carries into a port 2 x 4 pack; the cases against the
JAX package's per-scene Renderers are in ``test_torch_mesh_jax.py``.  The
names avoid the JAX tests' (``conftest.py`` marks tests slow by name).
"""

import numpy as np
import pytest

pytest.importorskip("jax")  # test_torch_pack's scenes import both packages
import torch  # noqa: E402

import oddio_tpu as ot  # noqa: E402
import oddio_tpu_torch as pt  # noqa: E402
import test_torch_pack as TP  # noqa: E402
import test_torch_pack_fades as TF  # noqa: E402
import test_torch_pack_host as TH  # noqa: E402
from oddio_tpu.parallel.mesh import make_mesh as jax_mesh  # noqa: E402
from oddio_tpu.parallel.sharded import ScenePack as JaxPack  # noqa: E402
from oddio_tpu_torch.core.drctrl import host_lanes  # noqa: E402
from oddio_tpu_torch.parallel import context  # noqa: E402
from oddio_tpu_torch.parallel.dryrun import dryrun_multichip  # noqa: E402
from oddio_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from oddio_tpu_torch.parallel.sharded import ScenePack  # noqa: E402
from oddio_tpu_torch.utils import checkpoint  # noqa: E402
from oddio_tpu_torch.utils.scene_profile import (  # noqa: E402
    build_host_pools_pack,
    build_sampler_pack,
    feed,
)

torch.set_num_threads(1)

F = np.float32
#: max |mesh pack - 1 x 1 pack|
TOL = 2e-6
SHAPES = [(2, 2), (1, 4), (2, 4)]


def cpu_mesh(a, b):
    return make_mesh(a, b, ["cpu"] * (a * b))


def mesh_render(shape):
    """A ``render(m, scenes, rate, nblocks, before)`` for the test files'
    cases: the port's ScenePack on a logical CPU mesh of ``shape``."""

    def render(m, scenes, rate, nblocks, before, n=512):
        p = ScenePack(scenes, rate, cpu_mesh(*shape))
        render.last = p
        out = []
        for b in range(nblocks):
            before(b)
            out.append(p.render_block(n))
        return np.concatenate(out, axis=1)

    return render


def _divides(case, shape):
    """Whether the case's scene count and pool capacities split over
    ``shape`` (read from the scenes a 1 x 1 render leaves)."""
    _, built = case(pt, TP.pack)
    scenes = [s if isinstance(s, pt.Signal) else s[1] for s in built]
    a, b = shape
    return len(scenes) % a == 0 and all(
        p.capacity % b == 0 for s in scenes for p in s._all_pools())


MESH_CASES = [
    ("spatial", (2, 2)), ("spatial", (1, 4)), ("spatial", (2, 4)),
    ("events", (1, 4)),
    ("clamped", (2, 2)), ("clamped", (1, 4)), ("clamped", (2, 4)),
    ("walk_tier", (2, 2)), ("walk_tier", (2, 4)),
    ("growth", (2, 2)), ("growth", (1, 4)), ("growth", (2, 4)),
    ("sines48k", (2, 2)), ("sines48k", (2, 4)),
    ("bare_stream", (2, 2)), ("bare_stream", (1, 4)), ("bare_stream", (2, 4)),
    ("config5_mini", (2, 2)),
]


#: the Mixer cases, whose pools all sum their voices in float64: bit-equal
MIXER_CASES = ("sines48k", "bare_stream", "config5_mini")


@pytest.mark.parametrize("name, shape", MESH_CASES)
def test_mesh_pack_matches_one_card_pack(name, shape):
    """``test_torch_pack.CASES`` on a mesh against the same case through
    the 1 x 1 pack, within 2e-6, the Mixer cases bit for bit (every mesh
    up to 2 x 4 that the case's scene count and capacities divide)."""
    case = TP.CASES[name][0]
    want, _ = case(pt, TP.pack)
    render = mesh_render(shape)
    got, _ = case(pt, render)
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    if name in MIXER_CASES:  # each pool's float64 shard sums add before the round
        np.testing.assert_array_equal(got, want)
    p = render.last
    assert set(p._dstate) == {(g, k) for g in range(shape[0]) for k in range(shape[1])}
    if name == "clamped":  # the pack-wide floor turns the sub-pass off on a mesh too
        pp = list(p.scenes[1]._buffered_pools.values())[0]
        assert pp._sub_cfg is None and pp._read_cfg[0] < 512
    elif name == "growth":
        assert {q.capacity for s in p.scenes for q in s._all_pools()} == {32}


def test_mesh_cases_cover_every_split_they_allow():
    """MESH_CASES holds each case at every mesh of SHAPES its scene count
    and capacities divide (``events`` has 3 scenes, ``config5_mini`` a
    capacity of 2), beyond the two 2 x 2 cases the 1 x 4 split leaves to
    ``test_mesh_one_by_four_of_two_scene_cases``."""
    allowed = {(n, s) for n in TP.CASES for s in SHAPES if _divides(TP.CASES[n][0], s)}
    missing = allowed - set(MESH_CASES)
    assert missing <= {("walk_tier", (1, 4)), ("sines48k", (1, 4))}, missing


@pytest.mark.parametrize("name", ["walk_tier", "sines48k"])
def test_mesh_one_by_four_of_two_scene_cases(name):
    """The remaining 1 x 4 splits of the two-scene cases."""
    case = TP.CASES[name][0]
    want, _ = case(pt, TP.pack)
    got, _ = case(pt, mesh_render((1, 4)))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


# --- host pools, submixes, faders, samplers ------------------------------------------


def test_mesh_host_pools_with_writes_and_a_submix():
    """``test_torch_pack_host.py``'s host scenes (Speed(Stream) host
    voices, device-resident Sines, an Adapt(Stream) submix) with writes in
    scenes 0 and 2 and a set_speed in scene 1, at 1 x 2: the submix
    renders on voice shard 0 only (counted once) and K5 reads each cell's
    stack in scene form."""
    def run(render):
        built = [TH.host_scene(pt, s, n_speed=12) for s in range(3)]  # slots 0-11: both shards
        return render(pt, [b[0] for b in built], 8000, 5, TH._script(built, (0, 2), 1))

    want = run(TP.pack)
    render = mesh_render((1, 2))
    got = run(render)
    assert np.abs(want).max() > 0.01
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    sub = render.last.scenes[0]._all_pools()[2]
    assert getattr(sub, "is_singleton", False)
    assert sub.name in render.last._dstate[0, 0] and sub.name not in render.last._dstate[0, 1]


@pytest.mark.parametrize("build, nblocks, shape", [
    (TH.spatial_submix, 3, (1, 2)), (TH.spatial_submix, 3, (2, 2)),
    (TH.mixer_submix, 2, (1, 2)), (TH.mixer_submix, 2, (2, 4)),
])
def test_mesh_submix_counts_once(build, nblocks, shape):
    """The submix twins of ``test_sharding.py:119`` and ``:164``: the
    submix counts once whatever the voice shards."""
    want = TP.pack(pt, [build(pt, s) for s in range(2)], 8000, nblocks, TH._none)
    got = mesh_render(shape)(pt, [build(pt, s) for s in range(2)], 8000, nblocks, TH._none)
    assert np.abs(want).max() > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_mesh_wrapped_submixes():
    """Submixes under wrappers (Adapt(Mixer), Speed(Mixer) in a nested
    Mixer), a set_speed in one scene, on a 2 x 2 mesh."""
    def run(render):
        built = [TH.wrapped_submixes(pt, s) for s in range(2)]

        def before(b):
            if b == 2:
                built[1][1].set_speed(1.5)

        return render(pt, [b[0] for b in built], 8000, 5, before)

    want = run(TP.pack)
    got = run(mesh_render((2, 2)))
    assert np.abs(want).max() > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_mesh_submix_frame_counts_per_scene_group():
    """Mixer submixes played buffered at 6.1 kHz into 8 kHz scenes advance
    390 or 391 frames a block by their scene's own write cursor: on a 2 x 2
    mesh each scene group's cells take its own scenes' counts."""
    def build(seed):
        rng = np.random.default_rng(seed)
        control, scene = pt.SpatialScene.new(device="cpu")
        mc, mixer = pt.Mixer.new(channels=1, device="cpu")
        for _ in range(2):
            st = pt.Stream(6000, 4096)
            mc.play(pt.Adapt(st, 0.1, pt.AdaptOptions(tau=0.1, max_gain=4.0)))
            st.control.write((rng.standard_normal(3000) * 0.3).astype(F))
        mc.play(pt.Sine(0.0, 300.0 + 50 * seed))
        for _ in range(2):
            control.play_buffered(pt.Sine(rng.uniform(0, 6), rng.uniform(100, 900)),
                                  pt.SpatialOptions(position=rng.uniform(-5, 5, 3)),
                                  max_distance=20.0, rate=8000, buffer_duration=0.1)
        # scene s's submix ring starts at its own write cursor
        control.play_buffered(mixer, pt.SpatialOptions(position=[1.0 + 2.5 * seed, 0.0, 0.0]),
                              max_distance=20.0, rate=6100)
        return scene

    own = TP.renderers(pt, [build(s) for s in range(4)], 8000, 5, TH._none)
    render = mesh_render((2, 2))
    got = render(pt, [build(s) for s in range(4)], 8000, 5, TH._none)
    pools = [q for q in render.last.scenes[0]._all_pools()[-1].sig._all_pools() if q.is_dr]
    assert any(q._pack_counts is not None for q in pools)
    assert np.abs(own).max() > 0.05
    np.testing.assert_allclose(got, own, rtol=0, atol=TOL)


@pytest.mark.parametrize("shape", [(1, 2), (1, 8)])
def test_mesh_mixer_host_pools_and_reclamation(shape):
    """Mixers of host-pool voices with a submix, a stream closed in one
    scene and a submix stopped in the other, at 1 x 2 and 1 x 8 (two slots
    a shard: the four host voices on two shards): the audio matches the 1
    x 1 pack, and after ``sync`` each scene's handles see their own voices
    finish."""
    def run(render):
        built = [TH.mixer_host_scene(pt, s) for s in range(2)]

        def before(b):
            if b == 1:
                built[0][1][1].close()
                built[1][3].stop()

        out = render(pt, [b[0] for b in built], 8000, 10, before)
        render.last.sync()
        return out, [[h.is_stopped() for h in b[2]] + [b[3].is_stopped()] for b in built]

    def one(m, scenes, rate, nblocks, before):
        p = ScenePack(scenes, rate, make_mesh(1, 1, ["cpu"]))
        one.last = p
        out = []
        for b in range(nblocks):
            before(b)
            out.append(p.render_block(512))
        return np.concatenate(out, axis=1)

    want, seen1 = run(one)
    got, seen = run(mesh_render(shape))
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert seen == seen1
    assert seen[0][1] and not seen[1][1] and seen[1][-1] and not seen[0][-1]


@pytest.mark.parametrize("shape", [(1, 2), (1, 8)])
def test_mesh_fader_voices_with_fades_in_some_scenes(shape):
    """The twin of ``test_sharding.py:441`` with fades in scenes 0 and 2 of
    three, at 1 x 2 and 1 x 8 (two slots a shard: slot 0's fade lands in
    shard 0's cell, slot 3's in shard 1's), each applied once."""
    want = TF.pack(pt, *TF._args(TF.fader_sines(pt, 3, (0, 2))))
    got = mesh_render(shape)(pt, *TF._args(TF.fader_sines(pt, 3, (0, 2))))
    assert np.abs(want).max() > 0.5
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_mesh_sampler_pack_with_fades_and_speed_writes():
    """The config-2 sampler pack (``build_sampler_pack``: each scene on its
    own script of speed writes and fades) on a 1 x 2 mesh against 1 x 1,
    and the fader banks' bits on the device equal each scene's host
    mirrors, shard by shard."""
    def run(mesh):
        drv = build_sampler_pack(2, 16, "cpu", sounds=2, seconds=1.0, mesh=mesh)
        return drv, np.concatenate(drv.render(24, device_out=False), axis=1)

    _, want = run(None)
    drv, got = run(cpu_mesh(1, 2))
    assert min(d.fades for d in drv.drivers) > 0 and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    p = drv.pack
    p.sync()
    for s, scene in enumerate(p.scenes):
        pool = next(iter(scene._pools.values()))
        np.testing.assert_array_equal(pool.state["inner"]["flip"].numpy(), pool._fade_flip[()])


def test_mesh_host_pools_pack_builder():
    """``build_host_pools_pack`` on a 2 x 2 mesh (4 scenes of 16 host
    Speed(Stream) voices, 2 device-resident Adapt(Stream) voices and a
    64-voice config-5 submix each), with writes and set_speed between
    blocks, against its 1 x 1 twin."""
    def run(mesh):
        p, ctls, speeds, rng = build_host_pools_pack(4, 16, "cpu", mesh=mesh)
        out = []
        for k in range(3):
            feed(ctls, rng, 400)
            speeds[5 * k].set_speed(1.15)
            out.append(np.concatenate([p.render_block(512) for _ in range(2)], axis=1))
        return np.concatenate(out, axis=1)

    want = run(None)
    got = run(cpu_mesh(2, 2))
    assert np.abs(want).max() > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("shape", [(1, 2), (1, 8)])
def test_mesh_host_pool_plays_mid_pack(shape):
    """Plays into a host buffered pool after the stack was built, on 1 x 2
    and 1 x 8 meshes (slots 2 and 3 on shard 1 of 8): a host pool's
    in-place slot reset cannot write through views of a voice-sharded
    stack, so the pack writes its state back, drops it and restacks; the
    audio matches 1 x 1."""
    def run(render):
        built = [TH.host_scene(pt, s, n_speed=2) for s in range(2)]

        def before(b):
            if b in (1, 3):
                for control_scene, ctls, _ in built:
                    st = pt.Stream(8000, 4096)
                    sc, sp = pt.Speed.new(st)
                    sc.set_speed(0.9 + 0.1 * b)
                    st.control.write((np.sin(np.arange(2000) * 0.05 * b) * 0.3).astype(F))
                    pt.SpatialSceneControl(control_scene).play_buffered(
                        sp, pt.SpatialOptions(position=[2.0, 1.0, -b]), max_distance=40.0,
                        rate=8000, buffer_duration=0.1)

        return render(pt, [b[0] for b in built], 8000, 5, before)

    want = run(TP.pack)
    got = run(mesh_render(shape))
    assert np.abs(want).max() > 0.01
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


# --- the pack's output paths, sync and checkpoints -------------------------------------


def test_mesh_frames_device_matches_render_block():
    """``render_frames_device`` (the idle run-length path) with mid-run
    ingest on a 2 x 2 mesh equals ``render_block`` on it."""
    want, _ = TP.case_config5_mini(pt, mesh_render((2, 2)))
    scenes, ctls = zip(*[TP.config5_mini(pt, s) for s in range(2)])
    flat = [c for group in ctls for c in group]
    p = ScenePack(list(scenes), 8000, cpu_mesh(2, 2))
    for j, ctl in enumerate(flat):
        ctl.write(TP.PCM[j])
    parts = p.render_frames_device(512 * 5)
    for j, ctl in enumerate(flat):
        ctl.write(TP.PCM[j, :512])
    parts += p.render_frames_device(512 * 3)
    got = TP._drain(parts)
    assert got.shape == want.shape == (2, 4096, 1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_mesh_sync_gives_each_handle_its_state(shape):
    """Streams that close and drain in slots of both voice shards finish
    on the device; ``sync`` reads each cell once per pool group and gives
    every scene's handles their own state, as the scenes' own Renderers
    do, and reclaims their slots."""
    def build(seed):
        control, mixer = pt.Mixer.new(channels=1, device="cpu")
        handles = []
        for k in range(12):
            ctl, st = pt.Stream.new(8000, 2048)
            ctl.write(np.full(100 * (k % 5 + 1), 0.5, F))
            if (k + seed) % 3:
                ctl.close()
            handles.append(control.play(st))
        return mixer, handles

    built = [build(s) for s in range(2)]
    p = ScenePack([b[0] for b in built], 8000, cpu_mesh(*shape))
    for _ in range(3):
        p.render_block(512)
    p.sync()  # the pack's own readback reclaims, before any handle reads
    free = [len(next(iter(m._pools.values()))._free) for m, _ in built]
    want = []
    for s in range(2):
        single, hs = build(s)
        r = pt.Renderer(single, 8000)
        for _ in range(3):
            r.render_block(512)
        single.sync()
        want.append([h.is_stopped() for h in hs])
    assert any(w[:8].count(True) for w in want) and any(w[8:].count(True) for w in want)
    for (mixer, _), w, f in zip(built, want, free):
        assert f == next(iter(mixer._pools.values())).capacity - 12 + sum(w)
    got = [[h.is_stopped() for h in b[1]] for b in built]
    assert got == want


@pytest.mark.parametrize("shape", [(1, 1), (2, 2)])
def test_mesh_checkpoint_of_pack_scenes_resumes_bit_equal(shape):
    """``pack.sync()``, a snapshot of every scene, more blocks, then a
    restore of every scene and ``pack.drop_stack()``: the pack renders the
    same blocks again, bit for bit."""
    built = [TH.host_scene(pt, s, n_speed=2) for s in range(2)]
    p = ScenePack([b[0] for b in built], 8000, cpu_mesh(*shape))
    for _ in range(2):
        p.render_block(512)
    p.sync()
    snaps = [checkpoint.snapshot(b[0]) for b in built]

    def blocks():
        out = []
        for k in range(4):
            if k == 1:
                built[0][2][0].set_speed(1.2)
            out.append(p.render_block(512))
        return np.concatenate(out, axis=1)

    a = blocks()
    for b, snap in zip(built, snaps):
        checkpoint.restore(b[0], snap)
    p.drop_stack()
    b = blocks()
    assert np.abs(a).max() > 0.01
    np.testing.assert_array_equal(a, b)


def test_mesh_dryrun_checksum():
    """``dryrun_multichip(8, devices=["cpu"] * 8)``: a 2 x 4 mesh of two
    2048-voice scenes (512 a shard), plays and motion mid-run, against
    per-scene Renderers within its TOL."""
    out = dryrun_multichip(8, devices=["cpu"] * 8)
    assert out["mesh"] == "2x4" and out["voices_per_shard"] == 512
    assert out["max_abs_diff"] <= 2e-6


# --- the mesh, the index map, the refusals ---------------------------------------------


def test_slot_index_map_to_shards():
    """A scene's slot indices map to the cell's stacked rows: slot ``i`` of
    scene ``s`` lies on voice shard ``i // (V/b)`` at row ``s*V/b + i %
    (V/b)``; padding and other shards' slots become padding (``S*V/b``),
    which ``host_lanes`` drops, so each slot lands in exactly one cell; one
    shard maps as ``s*V + i``."""
    V, S, b = 16, 3, 4
    idx = np.array([0, 3, 4, 9, 15, V, V], np.int32)
    for s in range(S):
        seen = {}
        for k in range(b):
            rows = context.stack_index(idx, s, V, S, k, b)
            keep, real = host_lanes(rows, S * V // b)
            for i, r in zip(idx[keep], real):
                seen[int(i)] = (k, int(r))
        assert seen == {int(i): (int(i) // 4, s * 4 + int(i) % 4) for i in idx if i < V}
        np.testing.assert_array_equal(context.stack_index(idx, s, V, S),
                                      np.where(idx < V, idx + s * V, S * V))


def test_out_of_shard_lanes_are_dropped_in_a_cell():
    """A stop lane whose slot another shard holds is padding in this
    cell: the merged params of a 1 x 2 pack name each stop once, in the
    cell of its slot, and no cell sees the other's."""
    built = TP.stream_mixers(pt, S=2, voices=12)
    mixers = [m for m, _ in built]
    handles = []
    for m in mixers:
        pool = next(iter(m._pools.values()))
        handles.append(pool)
    p = ScenePack(mixers, 8000, cpu_mesh(1, 2))
    p.render_block(512)
    pool0 = handles[0]
    V = pool0.capacity
    taken = sorted(set(range(V)) - set(pool0._free))
    lo, hi = taken[0], taken[-1]
    assert lo < V // 2 <= hi
    for pool in handles:
        pool.push_stop(lo, int(pool.slot_gen[lo]))
        pool.push_stop(hi, int(pool.slot_gen[hi]))
    merged = p._block_params(512)
    Vb, S = V // 2, 2
    for k in range(2):
        lanes = merged[0, k][pool0.name]["stop_idx"]
        keep, rows = host_lanes(lanes, S * Vb)
        want = [s * Vb + (i % Vb) for s in range(S) for i in (lo, hi) if i // Vb == k]
        assert sorted(rows.tolist()) == sorted(want)


def test_make_mesh_layouts_and_refusals():
    """``make_mesh`` lays a device list out (scene, voice) in order, may
    repeat a device, raises for too few devices, and without a card
    ``devices=None`` raises rather than fall back to the CPU."""
    m = make_mesh(2, 3, ["cpu"] * 7)
    assert m.shape == {"scene": 2, "voice": 3}
    assert [[str(d) for d in r] for r in m.devices] == [["cpu"] * 3] * 2
    with pytest.raises(ValueError, match="mesh 2x4 needs 8 devices, have 1"):
        make_mesh(2, 4, ["cpu"])
    with pytest.raises(ValueError):
        make_mesh(0, 1, ["cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="mesh 1x1 needs 1 devices, have 0"):
            make_mesh()


def test_mesh_refuses_what_it_cannot_split():
    """S must divide by the scene axis and every pool's capacity (a
    submix's aside) by the voice axis."""
    scenes = [TP.build_spatial_scene(pt, s)[1] for s in range(3)]
    with pytest.raises(ValueError, match="3 scenes do not split into 2 scene groups"):
        ScenePack(scenes, 8000, cpu_mesh(2, 1))
    with pytest.raises(ValueError, match="capacity 16 does not split into 32 voice shards"):
        ScenePack(scenes, 8000, make_mesh(1, 32, ["cpu"] * 32))
    mixers = [TP.config5_mini(pt, s)[0] for s in range(2)]
    with pytest.raises(ValueError, match="capacity 2 does not split into 4 voice shards"):
        ScenePack(mixers, 8000, cpu_mesh(1, 4))


def test_render_device_follows_the_mesh_cell():
    """Inside a cell's render every pool's and signal's ``device`` is the
    cell's; outside it is where they were built."""
    scene = TP.build_spatial_scene(pt, 0)[1]
    pool = scene._all_pools()[0]
    assert pool.device == torch.device("cpu") and scene.device == torch.device("cpu")
    with context.mesh_cell((0, 1), "meta"):
        assert pool.device == torch.device("meta") and scene.device == torch.device("meta")
        assert pool.proto.device == torch.device("meta")
        assert context.current_cell() == ((0, 1), torch.device("meta"))
    assert pool.device == torch.device("cpu") and context.current_cell() is None
    assert vars(pool)["device"] == torch.device("cpu")


# --- against the JAX package's own sharded ScenePack -----------------------------------


def test_mesh_spatial_matches_the_jax_pack_on_its_mesh():
    """The 4-scene spatial case through the JAX package's ScenePack on
    ``make_mesh(2, 4)`` of its virtual 8-device CPU mesh and the port's on
    a logical 2 x 4 CPU mesh, within 1e-5."""
    def jax_render(m, scenes, rate, nblocks, before):
        p = JaxPack(scenes, rate, jax_mesh(2, 4))
        out = []
        for b in range(nblocks):
            before(b)
            out.append(p.render_block(512))
        return np.concatenate(out, axis=1)

    ref, _ = TP.case_spatial(ot, jax_render)
    got, _ = TP.case_spatial(pt, mesh_render((2, 4)))
    assert got.shape == (4, 1536, 2) and np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_mesh_carries_from_the_jax_pack_on_its_mesh():
    """A JAX ScenePack on ``make_mesh(2, 4)`` of Mixers with host-pool
    voices, a submix and Fader voices mid-fade renders 2 blocks;
    ``carry_pack`` (``src.sync()`` gathers its sharded state) hands it to
    a port pack on a logical 2 x 4 mesh; both render the next 3 blocks,
    with writes, within 1e-5."""
    from oddio_tpu_torch.utils.convert import carry_pack

    def build(m):
        built = [TH.mixer_host_scene(m, s, fader=True) for s in range(2)]
        return [b[0] for b in built], [c for b in built for c in b[1]], [b[4] for b in built]

    sj, cj, fj = build(ot)
    jp = JaxPack(sj, 8000, jax_mesh(2, 4))
    jp.render_block(512)
    for k, f in enumerate(fj):
        f.fade_to(ot.Sine(0.0, 700.0 + 30 * k), 0.2)
    jp.render_block(512)
    sp, cp, fp = build(pt)
    for k, f in enumerate(fp):
        f.fade_to(pt.Sine(0.0, 700.0 + 30 * k), 0.2)
    pp = ScenePack(sp, 8000, cpu_mesh(2, 4))
    carry_pack(jp, pp)
    a, b = [], []
    for i in range(3):
        if i == 1:
            for c1, c2 in zip(cj, cp):
                x = np.full(200, 0.1 * (i + 1), F)
                assert c1.write(x) == c2.write(x)
        a.append(jp.render_block(512))
        b.append(pp.render_block(512))
    a, b = np.concatenate(a, axis=1), np.concatenate(b, axis=1)
    assert np.abs(a).max() > 0.1
    assert np.abs(a - b).max() <= 1e-5, np.abs(a - b).max()
