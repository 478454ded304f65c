"""The port's ScenePack with host and singleton (submix) pools on the CPU
(ROADMAP PK1): the host buffered pool's K4/K5 pair over stacked rows, the
seek and Mixer host pools, submix engines stacked inside their singleton
pools, against per-scene port Renderers, per-scene JAX Renderers and the
JAX ScenePack on ``make_mesh(1, 1)``; and K5's scene form.

A pack renders its scenes' rows with the same pools' code as one scene;
against its own per-scene Renderers it agrees to a few float32 roundings
of the voice sums (2e-6 spatial, 1e-6 streams, 1e-5 for the Mixer-in-Mixer
twin, as ``tests/test_sharding.py`` holds its packs), and against the JAX
package the PARITY.md 1e-5 holds (2e-6 for the spatial submix twin, as
there).  K5's scene form's plain version is bit-equal to single-scene
calls, and each scene within the JAX kernel's own distance of the
interpreted ``strip_select``.  The names avoid the JAX tests'
(``conftest.py`` marks tests slow by name).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import oddio_tpu as ot  # noqa: E402
import oddio_tpu_torch as pt  # noqa: E402
from oddio_tpu.parallel.mesh import make_mesh as jax_mesh  # noqa: E402
from oddio_tpu.parallel.sharded import ScenePack as JaxPack  # noqa: E402
from oddio_tpu_torch.ops import ring_kernels as RK  # noqa: E402
from oddio_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from oddio_tpu_torch.parallel.sharded import ScenePack  # noqa: E402
from oddio_tpu_torch.utils.scene_profile import (  # noqa: E402
    build_host_pools,
    build_host_pools_pack,
    feed,
)

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
    pack.last = p
    out = []
    for b in range(nblocks):
        before(b)
        out.append(p.render_block(n))
    return np.concatenate(out, axis=1)


def _none(b):
    return None


# --- the JAX package's submix packs --------------------------------------------------


def spatial_submix(m, seed):
    """test_sharding.py:119: 6 buffered Sine voices and a Mixer of two
    Sines played buffered into the scene, at 8 kHz."""
    rng = np.random.default_rng(seed)
    control, scene = m.SpatialScene.new(**kw(m))
    for _ in range(6):
        control.play_buffered(
            m.Sine(rng.uniform(0, 6), rng.uniform(100, 1000)),
            m.SpatialOptions(position=rng.uniform(-10, 10, 3),
                             velocity=rng.uniform(-2, 2, 3)),
            max_distance=20.0, rate=8000, buffer_duration=0.1,
        )
    mc, mixer = m.Mixer.new(channels=1, **kw(m))
    mc.play(m.Sine(0.0, 300.0 + 40 * seed))
    mc.play(m.Sine(0.0, 520.0 + 40 * seed))
    control.play_buffered(mixer, m.SpatialOptions(position=[2.0, 0.0, -1.0]),
                          max_distance=20.0, rate=8000)
    return scene


def mixer_submix(m, seed):
    """test_sharding.py:164: 8 Sines and a Mixer of one Sine in a Mixer."""
    rng = np.random.default_rng(seed)
    control, mixer = m.Mixer.new(channels=1, **kw(m))
    for _ in range(8):
        control.play(m.Sine(rng.uniform(0, 6), rng.uniform(50, 2000)))
    ic, inner = m.Mixer.new(channels=1, **kw(m))
    ic.play(m.Sine(0.0, 640.0 + 80 * seed))
    control.play(inner)
    return mixer


@pytest.mark.parametrize("build, nblocks, tol", [(spatial_submix, 3, 2e-6),
                                                 (mixer_submix, 2, 1e-5)])
def test_pack_submix_twins(build, nblocks, tol):
    """The twins of test_sharding.py:119 and :164: against per-scene port
    Renderers and the JAX ScenePack on a 1 x 1 mesh."""
    got = pack(pt, [build(pt, s) for s in range(2)], 8000, nblocks, _none)
    assert any(getattr(p, "is_singleton", False) for p in pack.last.scenes[0]._all_pools())
    own = renderers(pt, [build(pt, s) for s in range(2)], 8000, nblocks, _none)
    jx = pack(ot, [build(ot, s) for s in range(2)], 8000, nblocks, _none)
    assert np.abs(got).max() > 0.05
    np.testing.assert_allclose(got, own, rtol=0, atol=tol)
    np.testing.assert_allclose(got, jx, rtol=0, atol=tol)


def test_pack_submix_counts_differ_per_scene():
    """A Mixer submix played buffered at 6.1 kHz into 8 kHz scenes: each
    scene's ring takes 390 or 391 samples a block, by its own write
    cursor, so the submixes' device-resident pools advance different frame
    counts in one stacked render (``PoolDR._pack_counts``).  Against
    per-scene port Renderers at 1e-6."""
    def build(seed):
        rng = np.random.default_rng(seed)
        control, scene = pt.SpatialScene.new(device="cpu")
        mc, mixer = pt.Mixer.new(channels=1, device="cpu")
        for _ in range(3):
            st = pt.Stream(6000, 4096)
            mc.play(pt.Adapt(st, 0.1, pt.AdaptOptions(tau=0.1, max_gain=4.0)))
            st.control.write((rng.standard_normal(3000) * 0.3).astype(F))
        mc.play(pt.Sine(0.0, 300.0 + 50 * seed))
        control.play_buffered(mixer, pt.SpatialOptions(position=rng.uniform(-5, 5, 3)),
                              max_distance=20.0, rate=6100)
        return scene

    own = renderers(pt, [build(s) for s in range(3)], 8000, 4, _none)
    p = ScenePack([build(s) for s in range(3)], 8000, make_mesh(1, 1, ["cpu"]))
    pools = [q for q in p.scenes[0]._all_pools()[0].sig._all_pools() if q.is_dr]
    got, differ = [], 0
    for _ in range(4):
        got.append(p.render_block(512))
        differ += any(q._pack_counts is not None for q in pools)
    got = np.concatenate(got, axis=1)
    assert differ > 0
    assert np.abs(own).max() > 0.05
    np.testing.assert_allclose(got, own, rtol=0, atol=1e-6)


def wrapped_submixes(m, seed):
    """test_torch_host_pools.py's wrapped submixes in one scene: an
    Adapt(Mixer) played buffered and a Speed(Mixer) played into a Mixer
    that is itself played buffered; returns (scene, the Speed control)."""
    def sub(freqs):
        c, mixer = m.Mixer.new(channels=1, **kw(m))
        for f in freqs:
            c.play(m.Sine(0.1, f + 30 * seed))
        return mixer

    sc, scene = m.SpatialScene.new(**kw(m))
    sc.play_buffered(m.Adapt(sub([300.0, 450.0]), 0.3, m.AdaptOptions(tau=0.1, max_gain=4.0)),
                     m.SpatialOptions(position=[2.0, 0.0, -1.0 - seed]),
                     max_distance=20.0, rate=8000)
    mc, top = m.Mixer.new(channels=1, **kw(m))
    speed, fast = m.Speed.new(sub([200.0]))
    mc.play(fast)
    mc.play(m.Sine(0.0, 150.0))
    sc.play_buffered(top, m.SpatialOptions(position=[-1.0, 1.0, 0.5]), max_distance=20.0,
                     rate=8000)
    return scene, speed


def test_pack_wrapped_submixes():
    """Submixes under wrappers (Adapt(Mixer), Speed(Mixer) inside a nested
    Mixer), a set_speed in one scene: against per-scene port Renderers and
    per-scene JAX Renderers at 1e-5, as the single-scene test holds them."""
    def run(m, render):
        built = [wrapped_submixes(m, s) for s in range(2)]

        def before(b):
            if b == 2:
                built[1][1].set_speed(1.5)

        return render(m, [b[0] for b in built], 8000, 5, before)

    got = run(pt, pack)
    own = run(pt, renderers)
    jx = run(ot, renderers)
    assert np.abs(got).max() > 0.05
    np.testing.assert_allclose(got, own, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, jx, rtol=0, atol=1e-5)


# --- host pools -----------------------------------------------------------------------


def host_scene(m, seed, n_speed=4, fast=None):
    """Speed(Stream) voices in the host buffered pool, two Sines in the
    device-resident one and an Adapt(Stream) submix Mixer, at 8 kHz;
    ``fast``: a velocity for one more Speed(Stream) voice, a mover that
    leaves the strip gate.  Returns (scene, stream controls, speeds)."""
    rng = np.random.default_rng(seed)
    control, scene = m.SpatialScene.new(**kw(m))
    ctls, speeds = [], []

    def opts(vel=None):
        return m.SpatialOptions(position=rng.uniform(-10, 10, 3),
                                velocity=rng.uniform(-1, 1, 3) if vel is None else vel)

    def speed_stream(vel=None):
        st = m.Stream(8000, 4096)
        sc, sp = m.Speed.new(st)
        sc.set_speed(rng.uniform(0.8, 1.25))
        control.play_buffered(sp, opts(vel), max_distance=40.0, rate=8000,
                              buffer_duration=0.1)
        ctls.append(st.control)
        speeds.append(sc)

    for _ in range(n_speed):
        speed_stream()
    if fast is not None:
        speed_stream(fast)
    for _ in range(2):
        control.play_buffered(m.Sine(rng.uniform(0, 6), rng.uniform(100, 900)), opts(),
                              max_distance=40.0, rate=8000, buffer_duration=0.1)
    mc, mixer = m.Mixer.new(channels=1, **kw(m))
    for _ in range(2):
        st = m.Stream(8000, 4096)
        mc.play(m.Adapt(st, 0.1, m.AdaptOptions(tau=0.1, max_gain=4.0)))
        ctls.append(st.control)
    control.play_buffered(mixer, opts(), max_distance=40.0, rate=8000)
    for c in ctls:
        c.write((rng.standard_normal(1500) * 0.2).astype(F))
    return scene, ctls, speeds


def _script(built, write_scenes, speed_scene=None):
    """Before blocks 1 and 3, 600 samples to every stream of the scenes in
    ``write_scenes``; before block 2, a set_speed in ``speed_scene``."""
    rngs = [np.random.default_rng(100 + s) for s in range(len(built))]

    def before(b):
        if b in (1, 3):
            for s in write_scenes:
                for c in built[s][1]:
                    c.write((rngs[s].standard_normal(600) * 0.2).astype(F))
        if b == 2 and speed_scene is not None:
            built[speed_scene][2][1].set_speed(1.3)

    return before


def test_pack_host_pools_with_writes_in_some_scenes_only():
    """Host buffered Speed(Stream) voices, device-resident voices and a
    submix: stream writes in scenes 0 and 2 of three, a set_speed in scene
    1.  Against per-scene port Renderers at 1e-6 (whose host pools the
    host-pool tests hold to the JAX package); K5 reads the stack with its
    scene form."""
    def run(m, render):
        built = [host_scene(m, s) for s in range(3)]
        return render(m, [b[0] for b in built], 8000, 5, _script(built, (0, 2), 1))

    got = run(pt, pack)
    scene0 = pack.last.scenes[0]
    assert [type(p).__name__ for p in scene0._all_pools()] == [
        "_BufferedPool", "_BufferedPoolDR", "_BufferedPoolSingleton"]
    assert next(iter(scene0._buffered_pools.values()))._use_strips
    own = run(pt, renderers)
    assert np.abs(got).max() > 0.01
    np.testing.assert_allclose(got, own, rtol=0, atol=1e-6)


class HostStream(pt.Stream):
    """A bare Stream forced into the Mixer's host pool, which reads it
    through K6's ds form (``Stream.render_batched``)."""

    def dr_supported(self):
        return False


def host_stream_mixer(rates, device="cpu"):
    """A Mixer of host-pool Streams of the given rates in an 8 kHz mixer
    (each voice steps ``rate / 8000`` samples a frame), prefilled with a
    seeded sine."""
    control, mixer = pt.Mixer.new(channels=1, device=device)
    for k, rate in enumerate(rates):
        ctl, st = HostStream.new(rate, 8192)
        control.play(st)
        ctl.write((np.sin(np.arange(8000) * (0.02 + 0.01 * k)) * 0.5).astype(F))
    return mixer


def test_pack_host_stream_step_tier_is_pack_wide():
    """Scene 0's host streams step under 1 sample a frame (K6's tier 1),
    scene 1's up to 3.5 (tier 4): scene 0's template, which reads every
    scene's rows, takes the pack's widest tier (K6's window on the card
    is sized by it); the audio follows per-scene Renderers."""
    def build():
        return [host_stream_mixer([6400, 7200]), host_stream_mixer([12000, 28000])]

    own = renderers(pt, build(), 8000, 3, _none)
    got = pack(pt, build(), 8000, 3, _none)
    st = [next(iter(m._pools.values())).sig for m in pack.last.scenes]
    assert not next(iter(pack.last.scenes[0]._pools.values())).is_dr
    assert (st[0]._ds_tier, st[1]._ds_tier) == (4, 4) and st[0]._kernel_ok(512)
    assert np.abs(own).max() > 0.1
    np.testing.assert_allclose(got, own, rtol=0, atol=1e-6)


def test_pack_one_scene_leaves_the_strip_gate():
    """Scene 1 holds a 60 m/s mover, whose walk leaves K5's gate: the
    pack reads every scene's host buffered voices on the exact elementwise
    route that block, while scene 0 alone stays on K5; the audio agrees
    with per-scene Renderers at 2e-6."""
    def build(s):
        return host_scene(pt, s, n_speed=5 if s == 0 else 4,
                          fast=[60.0, 0.0, 0.0] if s == 1 else None)

    own = renderers(pt, [build(s)[0] for s in range(2)], 8000, 3, _none)
    singles = [build(s)[0] for s in range(2)]
    rs = [pt.Renderer(s, 8000) for s in singles]
    for r in rs:
        r.render_block(512)
    strips = [next(iter(s._buffered_pools.values()))._use_strips for s in singles]
    assert strips == [True, False]
    got = pack(pt, [build(s)[0] for s in range(2)], 8000, 3, _none)
    pool = next(iter(pack.last.scenes[0]._buffered_pools.values()))
    assert not pool._use_strips
    assert np.abs(got).max() > 0.01
    np.testing.assert_allclose(got, own, rtol=0, atol=2e-6)


def test_pack_host_pool_growth_in_one_scene():
    """Scene 1 plays past its host buffered pool's capacity mid-pack: the
    pool grows, the pack grows it in scene 0 too, and the audio follows
    per-scene Renderers."""
    def run(render):
        built = [host_scene(pt, s, n_speed=14) for s in range(2)]
        rng = np.random.default_rng(7)

        def before(b):
            if b == 1:
                for _ in range(4):
                    st = pt.Stream(8000, 4096)
                    st.control.write((rng.standard_normal(900) * 0.2).astype(F))
                    built[1][0]._play_buffered(
                        pt.Speed(st), pt.SpatialOptions(position=rng.uniform(-5, 5, 3)),
                        40.0, 8000, 0.1)

        return render(pt, [b[0] for b in built], 8000, 3, before), built

    own, _ = run(renderers)
    got, built = run(pack)
    caps = [next(iter(b[0]._buffered_pools.values())).capacity for b in built]
    assert caps == [32, 32]
    np.testing.assert_allclose(got, own, rtol=0, atol=1e-6)


def test_pack_adopts_a_host_pool_opened_mid_pack():
    """Both scenes open a host buffered pool (a Speed(Stream) voice) and a
    host seek pool after the pack's first block: the next block adopts
    them (restack) and renders as per-scene Renderers do."""
    class FiniteSine(pt.Sine):
        def host_is_finished(self):
            return np.asarray(self.phase) > 2.0

    def run(render):
        built = [spatial_submix(pt, s) for s in range(2)]
        ctls = [c for c in (pt.SpatialSceneControl(s) for s in built)]
        rng = np.random.default_rng(3)

        def before(b):
            if b == 1:
                for c in ctls:
                    st = pt.Stream(8000, 4096)
                    st.control.write((rng.standard_normal(1200) * 0.2).astype(F))
                    c.play_buffered(pt.Speed(st), pt.SpatialOptions(position=[1.0, 2.0, 0.0]),
                                    max_distance=20.0, rate=8000)
                    c.play(FiniteSine(0.3, 440.0), pt.SpatialOptions(position=[0.0, 3.0, 1.0]))

        return render(pt, built, 8000, 4, before), built

    own, _ = run(renderers)
    got, built = run(pack)
    kinds = [type(p).__name__ for p in built[0]._all_pools()]
    assert "_SeekPool" in kinds and kinds.count("_BufferedPool") == 1
    np.testing.assert_allclose(got, own, rtol=0, atol=2e-6)


def mixer_host_scene(m, seed, fader=False):
    """A Mixer of Speed(Stream) host-pool voices, a Sine, and a submix
    Mixer of a Speed(Stream) (a host pool inside the submix); with
    ``fader``, a Fader(Sine) voice too (its control last in the result)."""
    rng = np.random.default_rng(seed)
    control, mixer = m.Mixer.new(channels=1, **kw(m))
    ctls, hs = [], []
    for _ in range(4):
        st = m.Stream(8000, 4096)
        sc, sp = m.Speed.new(st)
        sc.set_speed(rng.uniform(0.7, 1.3))
        hs.append(control.play(sp))
        ctls.append(st.control)
    control.play(m.Sine(0.2, 330.0 + 20 * seed))
    ic, inner = m.Mixer.new(channels=1, **kw(m))
    st = m.Stream(8000, 4096)
    ih = ic.play(m.Speed(st))
    ic.play(m.Sine(0.0, 520.0))
    ctls.append(st.control)
    control.play(inner)
    for c in ctls:
        c.write((np.sin(np.arange(3000) * rng.uniform(0.01, 0.1)) * 0.5).astype(F))
    if not fader:
        return mixer, ctls, hs, ih
    fc, f = m.Fader.new(m.Sine(0.1, 200.0 + 50 * seed))
    control.play(f)
    return mixer, ctls, hs, ih, fc


def test_pack_mixer_host_pools_and_reclamation():
    """Mixers of host-pool voices with a submix: one scene closes a stream
    (the voice finishes when drained) and stops a submix voice; the pack
    matches per-scene port Renderers at 1e-6 and JAX Renderers at 1e-5,
    and each scene's handles see its own voices finish."""
    def run(m, render):
        built = [mixer_host_scene(m, s) for s in range(2)]

        def before(b):
            if b == 1:
                built[0][1][1].close()
                built[1][3].stop()

        out = render(m, [b[0] for b in built], 8000, 10, before)
        if render is pack and m is pt:
            pack.last.sync()
        return out, built

    got, built = run(pt, pack)
    own, singles = run(pt, renderers)
    jx, _ = run(ot, renderers)
    assert np.abs(got).max() > 0.1
    np.testing.assert_allclose(got, own, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, jx, rtol=0, atol=1e-5)
    seen = [[h.is_stopped() for h in b[2]] + [b[3].is_stopped()] for b in built]
    want = [[h.is_stopped() for h in b[2]] + [b[3].is_stopped()] for b in singles]
    assert seen == want
    assert seen[0][1] and not seen[1][1] and seen[1][-1] and not seen[0][-1]


def test_pack_host_pools_frames_device_matches_render_block():
    """``render_frames_device`` on a host-pool pack (no idle run: host
    pools prepare every block) equals ``render_block``, with writes and
    set_speed between calls."""
    def run(device_out):
        p, ctls, speeds, rng = build_host_pools_pack(2, 16, "cpu")
        out = []
        for k in range(3):
            feed(ctls, rng, 300)
            speeds[3 * k].set_speed(1.1)
            if device_out:
                x = np.concatenate([np.asarray(t) for t in p.render_frames_device(512 * 2)])
                B, S, C, n = x.shape
                out.append(x.transpose(1, 0, 3, 2).reshape(S, B * n, C))
            else:
                out.append(np.concatenate([p.render_block(512) for _ in range(2)], axis=1))
        return np.concatenate(out, axis=1)

    a, b = run(True), run(False)
    assert np.abs(b).max() > 0.05
    np.testing.assert_array_equal(a, b)


def test_pack_host_pools_builder_matches_its_scenes():
    """``build_host_pools_pack`` is its scenes' ``build_host_pools``:
    against per-scene Renderers of the same builds, with writes."""
    p, ctls, _, _ = build_host_pools_pack(2, 16, "cpu")
    singles = [build_host_pools(16, "cpu", s, dr_voices=2, submix_voices=64)
               for s in range(2)]
    rs = [pt.Renderer(s[1], 48000) for s in singles]
    sctls = [c for s in singles for c in s[2]]
    r1, r2 = np.random.default_rng(9), np.random.default_rng(9)
    a, b = [], []
    for k in range(3):
        feed(ctls, r1, 700)
        feed(sctls, r2, 700)
        a.append(p.render_block(512))
        b.append(np.stack([r.render_block(512) for r in rs]))
    a, b = np.concatenate(a, axis=1), np.concatenate(b, axis=1)
    assert np.abs(b).max() > 0.05
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_pack_carries_from_the_jax_pack():
    """A JAX ScenePack of Mixers with host-pool voices, a submix and Fader
    voices mid-fade renders 2 blocks; ``carry_pack`` hands its state to a
    port pack of the same scenes; both render the next 3 blocks within
    1e-5."""
    from oddio_tpu_torch.utils.convert import carry_pack

    def build(m):
        built = [mixer_host_scene(m, s, fader=True) for s in range(2)]
        return [b[0] for b in built], [c for b in built for c in b[1]], [b[4] for b in built]

    sj, cj, fj = build(ot)
    jp = JaxPack(sj, 8000, jax_mesh(1, 1))
    jp.render_block(512)
    for k, f in enumerate(fj):
        f.fade_to(ot.Sine(0.0, 700.0 + 30 * k), 0.2)
    jp.render_block(512)
    sp, cp, fp = build(pt)
    for k, f in enumerate(fp):
        f.fade_to(pt.Sine(0.0, 700.0 + 30 * k), 0.2)
    pp = ScenePack(sp, 8000, make_mesh(1, 1, ["cpu"]))
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


# --- K5's scene form -----------------------------------------------------------------


def _k5_record(rng, V, L=2048, n=512, K=64):
    """A host buffered pool's K5 operands for V voices: windows across the
    ring's end, frozen voices (ds = 0) and voices near the strip gate,
    some masked out.  Returns (ring, rrow, extra, scal, gain0, d_gain,
    maskf) as numpy."""
    ring = (rng.standard_normal((V, L)) * 0.3).astype(F)
    rrow = rng.integers(0, L // 128, V).astype(np.int32)
    rrow[::5] = L // 128 - 1  # windows across the ring's end
    extra = rng.integers(0, 128 + 33, (V, 2)).astype(np.int32)
    ds = rng.uniform(0.95, 1.05, (V, 2)).astype(F)
    ds[::7] = 0.0  # frozen
    ds[3::11] = F(1.124)  # near the gate: the SELECT_R clamp binds
    from oddio_tpu_torch.ops._dev import split_ds

    ds_int, f_hi, f_lo = split_ds(ds)
    scal = np.stack([rng.uniform(0, 1, (V, 2)).astype(F), f_hi, f_lo,
                     ds_int.astype(F)], axis=-1).astype(F)
    gain0 = rng.uniform(0.1, 1.0, (V, 2)).astype(F)
    d_gain = (rng.uniform(-1, 1, (V, 2)) * 1e-4).astype(F)
    maskf = (rng.uniform(0, 1, V) > 0.2).astype(F)
    return ring, rrow, extra, scal, gain0, d_gain, maskf


@pytest.mark.parametrize("S, vps", [(1, 40), (3, 17), (4, 32)])
def test_k5_scene_form_plain_is_each_scene_apart(S, vps):
    """K5's scene form (plain version): (S, 2, n), bit-equal to S
    single-scene calls on each scene's rows, and S = 1 equal to the (2, n)
    form."""
    rng = np.random.default_rng(S * 100 + vps)
    ops = _k5_record(rng, S * vps)
    ring = torch.from_numpy(ops[0])
    rec = RK.voice_record(*(torch.from_numpy(x) for x in ops[1:]))
    got = RK.strip_select_record(ring, rec, n=512, K=64, scenes=S)
    assert got.shape == (S, 2, 512)
    for s in range(S):
        rows = slice(s * vps, (s + 1) * vps)
        one = RK.strip_select_record(ring[rows].contiguous(), rec[rows].contiguous(),
                                     n=512, K=64)
        assert torch.equal(got[s], one)
    if S == 1:
        assert torch.equal(got[0], RK.strip_select_record(ring, rec, n=512, K=64))
    tol = RK.strip_record_tolerance(ring, rec, n=512, K=64, scenes=S)
    assert tol.shape == got.shape and bool((tol > 0).any())
    with pytest.raises(ValueError, match="scenes"):
        RK.strip_select_record(ring, rec, n=512, K=64, scenes=S * vps + 1)


def test_k5_scene_form_matches_the_interpreted_pallas_kernel():
    """Each scene of K5's scene form against the JAX package's
    ``strip_select`` run in interpret mode on that scene's rows, within
    the 1e-6 the single-scene form is held to (near-gate steps, so the
    SELECT_R clamp binds)."""
    from test_torch_ring_kernels import _pallas_strip_select, _strip_inputs

    S, vps, n, K = 2, 9, 256, 64
    ops = _strip_inputs(np.random.default_rng(5), S * vps, n, 2048, 0.0, 0.125)
    rec = RK.voice_record(*ops[1:])
    got = RK.strip_select_record(torch.tensor(ops[0]), torch.tensor(rec), n=n, K=K,
                                 scenes=S).numpy()
    for s in range(S):
        rows = slice(s * vps, (s + 1) * vps)
        want = _pallas_strip_select(*(x[rows] for x in ops), n, K)
        assert np.abs(want).max() > 0.1
        np.testing.assert_allclose(got[s], want, rtol=0, atol=1e-6)
