"""The port's ScenePack with Fader, sampler and Gain voices on the CPU:
the fade lanes under a pack (ROADMAP PK3) and K6's arena steps over the
stacked rows, against per-scene port Renderers, per-scene JAX Renderers
and the exact oracle.

A pack renders its scenes' rows with the same pools' code as one scene,
so against its own per-scene Renderers it agrees to a few float32
roundings of the voice sums (2e-6, as ``tests/test_sharding.py`` holds its
fade pack) or exactly where no sum reorders; against the JAX package the
PARITY.md 1e-5 holds (2e-6 for the Fader(Sine) twin, as there).  Sampler
voices are held to the oracle at 1e-5, not to the JAX package, which sits
8.6e-4 off on them (ROADMAP Q3.5).  The names avoid the JAX tests'
(``conftest.py`` marks tests slow by name).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import oddio_tpu as ot  # noqa: E402
import oddio_tpu_torch as pt  # noqa: E402
import reference_impl as ref  # noqa: E402
from oddio_tpu.parallel.mesh import make_mesh as jax_mesh  # noqa: E402
from oddio_tpu.parallel.sharded import ScenePack as JaxPack  # noqa: E402
from oddio_tpu_torch.core import drctrl  # noqa: E402
from oddio_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from oddio_tpu_torch.parallel.sharded import ScenePack  # noqa: E402

torch.set_num_threads(1)

F = np.float32


def kw(m):
    return {"device": "cpu"} if m is pt else {}


def renderers(m, scenes, rate, nblocks, before, n=512):
    """Per-scene Renderers of package ``m``: (S, nblocks*n, C);
    ``before(b)`` runs before block b."""
    rs = [m.Renderer(s, rate) for s in scenes]
    out = []
    for b in range(nblocks):
        before(b)
        out.append(np.stack([np.asarray(r.render_block(n)) for r in rs]))
    return np.concatenate(out, axis=1)


def pack(m, scenes, rate, nblocks, before, n=512):
    """The same through package ``m``'s ScenePack on a 1 x 1 mesh."""
    p = (ScenePack(scenes, rate, make_mesh(1, 1, ["cpu"])) if m is pt
         else JaxPack(scenes, rate, jax_mesh(1, 1)))
    out = []
    for b in range(nblocks):
        before(b)
        out.append(p.render_block(n))
    return np.concatenate(out, axis=1)


def fader_sines(m, S, fade_scenes):
    """test_sharding.py:441: S mixers of 8 Fader(Sine) voices at 8 kHz;
    before block 1, the scenes in ``fade_scenes`` fade voices 0 and 3."""

    def build(seed):
        rng = np.random.default_rng(seed)
        mc, mixer = m.Mixer.new(channels=1, **kw(m))
        fcs = []
        for _ in range(8):
            fc, f = m.Fader.new(m.Sine(rng.uniform(0, 6), rng.uniform(100, 900)))
            fcs.append(fc)
            mc.play(f)
        return mixer, fcs

    built = [build(s) for s in range(S)]

    def before(b):
        if b == 1:
            for s in fade_scenes:
                built[s][1][0].fade_to(m.Sine(0.5, 620.0 + 10 * s), 0.05)
                built[s][1][3].fade_to(m.Sine(0.1, 340.0), 0.02)

    fader_sines.controls = [b[1] for b in built]
    return [b[0] for b in built], before


def test_pack_fader_voices_with_fades_in_some_scenes():
    """The twin of test_sharding.py:441 with fades in scenes 0 and 2 of
    three only: against per-scene port and JAX Renderers at 2e-6."""
    results = {}
    for m, render in ((pt, pack), (pt, renderers), (ot, renderers)):
        scenes, before = fader_sines(m, 3, (0, 2))
        results[(m, render)] = render(m, scenes, 8000, 4, before)
    got = results[(pt, pack)]
    assert got.shape == (3, 2048, 1) and np.abs(got).max() > 0.5
    np.testing.assert_allclose(got, results[(pt, renderers)], rtol=0, atol=2e-6)
    np.testing.assert_allclose(got, results[(ot, renderers)], rtol=0, atol=2e-6)


def test_pack_fade_on_one_slot_number_lands_in_each_scenes_row():
    """Slot 3 of scene 0 and slot 3 of scene 1 fade to different targets in
    one block: the merged lanes name rows 3 and V + 3, each fader starts
    its fade in its own row with its own target, and scene 2's slot 3 keeps
    its voice."""
    scenes, _ = fader_sines(pt, 3, ())
    ctl = fader_sines.controls
    pool = next(iter(scenes[0]._pools.values()))
    name, V = pool.name, pool.capacity
    p = ScenePack(scenes, 8000, make_mesh(1, 1, ["cpu"]))
    p.render_block(512)
    ctl[0][3].fade_to(pt.Sine(0.0, 700.0), 0.02)
    ctl[1][3].fade_to(pt.Sine(0.0, 250.0), 0.02)
    merged = p._block_params(512)[0, 0]  # the one cell of a 1 x 1 mesh
    lanes = merged[name]["fade_idx0"]
    assert sorted(int(x) for x in lanes if x < 3 * V) == [3, V + 3]
    before = {k: v.clone() for k, v in p._dstate[0, 0][name]["inner"]["b"].items()}
    p._render({(0, 0): merged}, 512)
    st = p._dstate[0, 0][name]["inner"]
    assert [bool(st["fading"][r]) for r in (3, V + 3, 2 * V + 3)] == [True, True, False]
    for k, v in st["b"].items():  # both targets written, each in its row
        if torch.is_floating_point(v):
            assert not torch.equal(v[3], v[V + 3]), k
            assert torch.equal(v[2 * V + 3], before[k][2 * V + 3]), k


def test_pack_fade_lanes_ship_as_one_record_per_block(monkeypatch):
    """A block that releases fades in several scenes copies its fade lanes
    (indices, increments, rows of every scene) to the device once: the
    pack of Fader voices takes block steps, and the lanes ride in the
    block's one packed row (``BlockSteps._rows_to``, one copy a call);
    nothing goes up through another upload (``PinnedUpload``)."""
    from oddio_tpu_torch.core import run as prun

    calls, rows = [], []
    real = drctrl.PinnedUpload.__call__
    real_rows = prun.BlockSteps._rows_to

    def counted(self, arr):
        calls.append(arr.shape)
        return real(self, arr)

    def rows_to(self, pend, dst):
        rows.append([sorted(k for pool in params.values() for k in pool if "fade" in k)
                     for params in pend])
        return real_rows(self, pend, dst)

    monkeypatch.setattr(drctrl.PinnedUpload, "__call__", counted)
    monkeypatch.setattr(prun.BlockSteps, "_rows_to", rows_to)
    scenes, before = fader_sines(pt, 3, (0, 1, 2))
    p = ScenePack(scenes, 8000, make_mesh(1, 1, ["cpu"]))
    assert p.graph_capture
    p.render_block(512)
    assert len(rows) == 1
    before(1)
    p.render_block(512)
    assert rows[1] == [["fade_idx0", "fade_inc0", "fade_row0"]] and calls == []


def _sampler_scene(m, sounds, seed, voices=4):
    """Fader(Speed(FramesSignal)) voices over the scene's own stereo
    ``sounds`` (44.1 kHz data, rendered at 48 kHz); returns (mixer, speed
    controls, fader controls, oracle mixer, oracle speeds, rng)."""
    rng = np.random.default_rng(seed)
    frames = [m.Frames.from_slice(44100, d) for d in sounds]
    oframes = [ref.OFrames(44100, d) for d in sounds]
    mc, mixer = m.Mixer.new(channels=2, **kw(m))
    om = ref.OMixer(channels=2)
    scs, fcs, osp = [], [], []
    for i in range(voices):
        t0, sp_ = float(rng.uniform(0, 0.05)), float(rng.uniform(0.8, 1.25))
        sc, sp = m.Speed.new(m.FramesSignal(frames[i % len(frames)], t0))
        sc.set_speed(sp_)
        fc, f = m.Fader.new(sp)
        mc.play(f)
        scs.append(sc)
        fcs.append(fc)
        o = ref.OSpeed(ref.OFramesSignal(oframes[i % len(frames)], t0, exact=True), F(sp_))
        om.play(o)
        osp.append(o)
    return mixer, scs, fcs, om, osp, frames, rng


def _sounds(seed, k=2, n=30000):
    rng = np.random.default_rng(seed)
    t = np.arange(n)[:, None]
    return [(0.4 * np.sin(t * rng.uniform(0.01, 0.05, 2) + rng.uniform(0, 6, 2))
             + 0.05 * rng.standard_normal((n, 2))).astype(F) for _ in range(k)]


def test_pack_sampler_scenes_of_different_sounds():
    """Two sampler scenes, each over its own sounds: the first blocks
    (speed writes only) within 1e-5 of the exact oracle per scene, then
    fades in one scene; every block equal to per-scene port Renderers."""
    sounds = [_sounds(40 + s) for s in range(2)]

    def run(render):
        built = [_sampler_scene(pt, sounds[s], s) for s in range(2)]

        def before(b):
            if b == 2:
                built[1][1][2].set_speed(1.1)
                built[1][4][2].speed = F(1.1)
            if b == 4:
                mixer, scs, fcs, _, _, frames, rng = built[0]
                sc, sp = pt.Speed.new(pt.FramesSignal(frames[1], 0.01))
                sc.set_speed(0.9)
                fcs[1].fade_to(sp, 0.02)

        return render(pt, [b[0] for b in built], 48000, 7, before), built

    own, _ = run(renderers)
    got, built = run(pack)
    assert np.abs(got).max() > 0.3
    np.testing.assert_array_equal(got, own)
    # the oracle, for the blocks before the fade (it has no Fader)
    ob = [_sampler_scene(pt, sounds[s], s)[3:5] for s in range(2)]
    want = np.zeros((2, 4 * 512, 2), F)
    for s, (om, osp) in enumerate(ob):
        for b in range(4):
            if s == 1 and b == 2:
                osp[2].speed = F(1.1)
            buf = np.zeros((512, 2), F)
            ref.oddio_run(om, 48000, buf)
            want[s, b * 512:(b + 1) * 512] = buf
    assert np.abs(got[:, :2048] - want).max() <= 1e-5


def seek_sampler_scenes(m):
    """test_sharding.py:414: FramesSignal voices on the device-resident
    seek path, 8 per scene."""
    snd = m.Frames.from_slice(8000, np.sin(np.linspace(0, 900, 16000)).astype(F))

    def build(seed):
        r2 = np.random.default_rng(seed)
        c, s = m.SpatialScene.new(**kw(m))
        for i in range(8):
            c.play(m.FramesSignal(snd, -0.01 * i), m.SpatialOptions(
                position=r2.uniform(-15, 15, 3), velocity=r2.uniform(-3, 3, 3)))
        return s

    return [build(k) for k in range(2)]


def test_pack_seek_sampler_voices():
    """The twin of test_sharding.py:414: against per-scene port Renderers
    at 2e-6 and per-scene JAX Renderers at 1e-5."""
    got = pack(pt, seek_sampler_scenes(pt), 8000, 3, lambda b: None)
    own = renderers(pt, seek_sampler_scenes(pt), 8000, 3, lambda b: None)
    jx = renderers(ot, seek_sampler_scenes(ot), 8000, 3, lambda b: None)
    assert np.abs(got).max() > 0.02
    np.testing.assert_allclose(got, own, rtol=0, atol=2e-6)
    np.testing.assert_allclose(got, jx, rtol=0, atol=1e-5)


def gain_sines(m, S=3):
    """Mixers of Gain(Sine) voices; scene 1 ramps two gains before block
    1."""
    built = []
    for seed in range(S):
        rng = np.random.default_rng(seed)
        mc, mixer = m.Mixer.new(channels=1, **kw(m))
        gcs = []
        for _ in range(6):
            gc, g = m.Gain.new(m.Sine(rng.uniform(0, 6), rng.uniform(100, 900)))
            gc.set_gain(float(rng.uniform(-12, 0)))
            mc.play(g)
            gcs.append(gc)
        built.append((mixer, gcs))

    def before(b):
        if b == 1:
            built[1][1][0].set_gain(-30.0)
            built[1][1][4].set_gain(-3.0)

    return [b[0] for b in built], before


def test_pack_gain_voices():
    """Gain(Sine) voices with a gain ramp in one scene: against per-scene
    port Renderers at 1e-6 and per-scene JAX Renderers at 1e-5."""
    got = pack(pt, *_args(gain_sines(pt)))
    own = renderers(pt, *_args(gain_sines(pt)))
    jx = renderers(ot, *_args(gain_sines(ot)))
    assert np.abs(got).max() > 0.2
    np.testing.assert_allclose(got, own, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, jx, rtol=0, atol=1e-5)


def _args(built):
    scenes, before = built
    return scenes, 8000, 4, before


def test_pack_sampler_frames_device_releases_fades_on_the_device():
    """The config-2 sampler pack (``build_sampler_pack``) through
    ``render_frames_device``, each scene on its own script: equal to the
    same pack through ``render_block``; the fader banks' bits on the
    device equal each scene's host mirrors and have flipped."""
    from oddio_tpu_torch.utils.scene_profile import build_sampler_pack

    def run(device_out):
        drv = build_sampler_pack(3, 16, "cpu", sounds=2, seconds=1.0)
        out = drv.render(24, device_out=device_out)
        return drv, out

    drv_a, a = run(True)
    drv_b, b = run(False)
    x = np.concatenate([np.asarray(t) for t in a])  # (B, S, C, n)
    B, S, C, n = x.shape
    x = x.transpose(1, 0, 3, 2).reshape(S, B * n, C)
    np.testing.assert_array_equal(x, np.concatenate(b, axis=1))
    assert min(d.fades for d in drv_a.drivers) > 0
    p = drv_a.pack
    p.sync()
    flips = []
    for s, scene in enumerate(p.scenes):
        pool = next(iter(scene._pools.values()))
        V = pool.capacity
        dev = p._dstate[0, 0][pool.name]["inner"]["flip"][s * V:(s + 1) * V].numpy()
        host = pool._fade_flip[()]
        np.testing.assert_array_equal(dev, host)
        flips.append(host.any())
    assert all(flips)
