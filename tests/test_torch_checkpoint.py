"""The port's checkpoints (oddio_tpu_torch/utils/checkpoint.py) against
themselves and the JAX package's (oddio_tpu/utils/checkpoint.py).

Each script builds an engine in both packages from seeded numpy draws,
renders a few blocks, queues control events, snapshots, renders (a),
restores and renders again (b).  The port's b equals its a bit for bit
(an exact zero's sign aside, ROADMAP Q3.7), as does a second restore of
the same snapshot, a restore into a second engine built by the same
script, and a restore from the pickled snapshot; the port's a and b are
within 1e-5 (PARITY.md) of the JAX package's.  The twins of the JAX
package's own checkpoint tests (tests/test_native.py:147,
tests/test_stream_adapt_fader.py:504, :525, :615 and the checkpoint leg
of tests/test_spatial.py:467) run the same steps on the port.
"""

import pickle

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import oddio_tpu as ot  # noqa: E402
import oddio_tpu_torch as pt  # noqa: E402
from oddio_tpu.utils import checkpoint as ock  # noqa: E402
from oddio_tpu_torch.utils import checkpoint as pck  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-5
RATE = 8000
CK = {ot: ock, pt: pck}


def kw(m):
    """The port renders on the CPU only when asked to."""
    return {"device": "cpu"} if m is pt else {}


def z(x):
    """-0.0 as 0.0 (the sign of an exact zero may differ, ROADMAP Q3.7)."""
    return np.where(x == 0, np.float32(0.0), x)


def assert_same(a, b):
    np.testing.assert_array_equal(z(a), z(b))


class _HostFaderJ(ot.Fader):
    def dr_supported(self):
        return False


class _HostFaderP(pt.Fader):
    def dr_supported(self):
        return False


def _finite_sine(m):
    class FiniteSine(m.Sine):
        """Finishes once its phase passes 2 rad: a seekable chain with its
        own finish rule, so the scene's host seek pool takes it."""

        def host_is_finished(self):
            return np.asarray(self.phase) > 2.0

    return FiniteSine


# --- scripts: (engine, render(k blocks) -> numpy, events()) ---------------------------------


def _renderer(m, eng, n=256):
    r = m.Renderer(eng, RATE)
    return lambda k: np.asarray(r.render_frames(n * k, block_size=n))


def spatial_dr(m):
    """_BufferedPoolDR and _SeekPoolDR (Sine voices); a set_motion, a
    play_buffered and a play are queued at the snapshot."""
    rng = np.random.default_rng(1)
    control, scene = m.SpatialScene.new(**kw(m))
    hs = []
    for _ in range(5):
        hs.append(control.play_buffered(
            m.Sine(rng.uniform(0, 6), rng.uniform(100, 900)),
            m.SpatialOptions(position=rng.uniform(-8, 8, 3), velocity=rng.uniform(-1, 1, 3)),
            max_distance=20.0, rate=RATE, buffer_duration=0.1))
    for _ in range(3):
        control.play(m.Sine(rng.uniform(0, 6), rng.uniform(100, 900)),
                     m.SpatialOptions(position=rng.uniform(-8, 8, 3)))

    def events():
        hs[1].set_motion([3.0, 0.0, -1.0], [2.0, 0.0, 0.0], False)
        control.play_buffered(m.Sine(0.2, 610.0), m.SpatialOptions(position=[1.0, 2.0, 0.0]),
                              max_distance=20.0, rate=RATE, buffer_duration=0.1)
        control.play(m.Sine(0.4, 330.0), m.SpatialOptions(position=[-2.0, 0.0, 1.0]))

    return scene, _renderer(m, scene), events


def spatial_host_buffered(m):
    """_BufferedPool: Speed(Stream) voices, writes and a set_speed queued."""
    rng = np.random.default_rng(2)
    control, scene = m.SpatialScene.new(**kw(m))
    ctls, scs = [], []
    for _ in range(4):
        st = m.Stream(RATE, 4096)
        sc, sp = m.Speed.new(st)
        sc.set_speed(rng.uniform(0.8, 1.25))
        control.play_buffered(sp, m.SpatialOptions(position=rng.uniform(-8, 8, 3)),
                              max_distance=20.0, rate=RATE, buffer_duration=0.1)
        st.control.write((rng.standard_normal(1500) * 0.3).astype(np.float32))
        ctls.append(st.control)
        scs.append(sc)
    pcm = (rng.standard_normal((4, 700)) * 0.3).astype(np.float32)

    def events():
        for c, x in zip(ctls, pcm):
            c.write(x)
        scs[2].set_speed(1.2)

    return scene, _renderer(m, scene), events


def spatial_host_seek(m):
    """_SeekPool: seekable voices with their own finish rule, lingering."""
    rng = np.random.default_rng(3)
    control, scene = m.SpatialScene.new(**kw(m))
    cls = _finite_sine(m)
    hs = [control.play(cls(rng.uniform(0, 1), rng.uniform(100, 900)),
                       m.SpatialOptions(position=rng.uniform(-20, 20, 3),
                                        velocity=rng.uniform(-5, 5, 3)))
          for _ in range(4)]

    def events():
        hs[1].set_motion([3.0, 0.0, 1.0], [0.0, 2.0, 0.0], True)

    return scene, _renderer(m, scene), events


def _submix(m, rng):
    mc, mixer = m.Mixer.new(channels=1, **kw(m))
    mc.play(m.Sine(rng.uniform(0, 6), 300.0))
    h = mc.play(m.Sine(rng.uniform(0, 6), 520.0))
    return mixer, h


def spatial_submix(m):
    """_BufferedPoolSingleton: a Mixer played as one spatial voice; a stop
    queued in the submix at the snapshot."""
    rng = np.random.default_rng(4)
    mixer, h = _submix(m, rng)
    control, scene = m.SpatialScene.new(**kw(m))
    control.play_buffered(mixer, m.SpatialOptions(position=[2.0, 0.0, -1.0]),
                          max_distance=20.0, rate=RATE)
    return scene, _renderer(m, scene), h.stop


def mixer_stream_dr(m):
    """PoolDR: Stream and Adapt(Sine) voices; PCM written, not ingested.
    (The JAX package's snapshot of an Adapt(Stream) pool raises: it looks
    for the producer queues on the Adapt; the port's Adapt(Stream) pools
    are held in test_torch_roundtrip_bench_scenes.)"""
    rng = np.random.default_rng(5)
    control, mixer = m.Mixer.new(channels=1, **kw(m))
    ctls = []
    for _ in range(3):
        st = m.Stream(RATE, 4096)
        control.play(st)
        st.control.write((rng.standard_normal(1200) * 0.1).astype(np.float32))
        ctls.append(st.control)
    for _ in range(3):
        control.play(m.Adapt(m.Sine(rng.uniform(0, 6), rng.uniform(100, 900)), 0.1,
                             m.AdaptOptions(tau=0.1, max_gain=4.0)))
    pcm = (rng.standard_normal((3, 900)) * 0.1).astype(np.float32)

    def events():
        for c, x in zip(ctls, pcm):
            c.write(x)

    return mixer, _renderer(m, mixer), events


def mixer_host_pool(m):
    """Pool: Speed(Stream) host voices with queued writes and a set_speed."""
    rng = np.random.default_rng(6)
    control, mixer = m.Mixer.new(channels=1, **kw(m))
    ctls, scs = [], []
    for _ in range(3):
        st = m.Stream(RATE, 4096)
        sc, sp = m.Speed.new(st)
        sc.set_speed(rng.uniform(0.8, 1.25))
        control.play(sp)
        st.control.write((rng.standard_normal(1500) * 0.3).astype(np.float32))
        ctls.append(st.control)
        scs.append(sc)
    pcm = (rng.standard_normal((3, 600)) * 0.3).astype(np.float32)

    def events():
        for c, x in zip(ctls, pcm):
            c.write(x)
        scs[0].set_speed(0.9)

    return mixer, _renderer(m, mixer), events


def mixer_submix(m):
    """PoolSingleton: a submix with a stop queued inside it."""
    rng = np.random.default_rng(7)
    sub, h = _submix(m, rng)
    control, mixer = m.Mixer.new(channels=1, **kw(m))
    control.play(sub)
    control.play(m.Sine(0.3, 440.0))
    return mixer, _renderer(m, mixer), h.stop


def _faders(m, cls):
    rng = np.random.default_rng(8)
    control, mixer = m.Mixer.new(channels=1, **kw(m))
    fcs = []
    for _ in range(4):
        fc, f = cls.new(m.Gain.new(m.Sine(rng.uniform(0, 6), rng.uniform(100, 900)))[1])
        control.play(f)
        fcs.append(fc)
    r = _renderer(m, mixer)

    def warm(k):
        out = r(k)
        # one fade in flight (0.1 s), and a waiting one queued behind it
        fcs[0].fade_to(m.Gain.new(m.Sine(0.1, 250.0))[1], 0.1)
        return out

    def events():
        fcs[0].fade_to(m.Gain.new(m.Sine(0.2, 700.0))[1], 0.05)
        fcs[2].fade_to(m.Gain.new(m.Sine(0.3, 330.0))[1], 0.05)

    return mixer, r, events, warm


def fader_dr(m):
    """A device-resident Fader voice with a fade in flight and fades queued."""
    mixer, r, events, warm = _faders(m, m.Fader)
    return mixer, _Warm(r, warm), events


def fader_host(m):
    """A host-pool Fader (two banks) with a fade in flight and fades queued."""
    mixer, r, events, warm = _faders(m, _HostFaderJ if m is ot else _HostFaderP)
    return mixer, _Warm(r, warm), events


class _Warm:
    """A render whose first call (the warm-up) runs ``warm`` instead."""

    def __init__(self, render, warm):
        self.render, self.warm = render, warm

    def __call__(self, k):
        w, self.warm = self.warm, None
        if w is not None:
            out = w(k - 1)
            self.render(1)  # the in-flight fade ships
            return out
        return self.render(k)


def mixer_cycle(m):
    """Speed(Cycle) wavetable voices; a set_speed queued."""
    rng = np.random.default_rng(9)
    table = np.sin(np.linspace(0, 2 * np.pi, 512, endpoint=False)).astype(np.float32)
    frames = m.Frames.from_slice(RATE, table)
    control, mixer = m.Mixer.new(channels=1, **kw(m))
    scs = []
    for _ in range(3):
        c = m.Cycle(frames)
        c.seek(float(rng.uniform(0, 0.04)))
        sc, sp = m.Speed.new(c)
        sc.set_speed(rng.uniform(0.5, 1.5))
        control.play(sp)
        scs.append(sc)

    def events():
        scs[1].set_speed(1.3)

    return mixer, _renderer(m, mixer), events


SCRIPTS = {f.__name__: f for f in (
    spatial_dr, spatial_host_buffered, spatial_host_seek, spatial_submix,
    mixer_stream_dr, mixer_host_pool, mixer_submix, fader_dr, fader_host, mixer_cycle,
)}
POOLS = {
    "spatial_dr": ["_BufferedPoolDR", "_SeekPoolDR"],
    "spatial_host_buffered": ["_BufferedPool"],
    "spatial_host_seek": ["_SeekPool"],
    "spatial_submix": ["_BufferedPoolSingleton"],
    "mixer_stream_dr": ["PoolDR", "PoolDR"],
    "mixer_host_pool": ["Pool"],
    "mixer_submix": ["PoolSingleton", "PoolDR"],
    "fader_dr": ["PoolDR"],
    "fader_host": ["Pool"],
    "mixer_cycle": ["PoolDR"],
}
WARM, N = 3, 6
#: scripts the JAX package cannot restore: its host-pool Fader keeps the
#: queued fade's target by reference, and a release after the snapshot has
#: moved it, so its next release raises; the port's b is held against the
#: JAX package's a there
JAX_NO_RESTORE = {"fader_host"}
#: scripts whose JAX restore loses the PCM queued at the snapshot (its
#: host pools' producer queues are not host fields); the port keeps it
#: (Stream.host_aux_snapshot), and its b is held against the JAX a
JAX_LOSES_QUEUE = {"mixer_host_pool", "spatial_host_buffered"}


def _pools(eng):
    pools = eng._all_pools() if hasattr(eng, "_buffered_pools") else eng._pools.values()
    return sorted(type(p).__name__ for p in pools)


def _prepared(script, m):
    eng, render, events = script(m)
    render(WARM)
    events()
    return eng, render


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_torch_roundtrip_every_pool_kind(name):
    script = SCRIPTS[name]
    out = {}
    for m in (ot, pt):
        ck = CK[m]
        eng, render = _prepared(script, m)
        assert _pools(eng) == sorted(POOLS[name])
        snap = ck.snapshot(eng)
        a = render(N)
        if m is ot and name in JAX_NO_RESTORE:
            out[m] = (a, a)
            continue
        ck.restore(eng, snap)
        b = render(N)
        out[m] = (a, b)
        if m is pt:
            assert_same(a, b)
            ck.restore(eng, snap)  # once more from the same snapshot
            assert_same(a, render(N))
            eng2, render2 = _prepared(script, m)  # a second engine, same script
            ck.restore(eng2, snap)
            assert_same(a, render2(N))
            ck.restore(eng2, pickle.loads(pickle.dumps(snap)))
            assert_same(a, render2(N))
    (ja, jb), (pa, pb) = out[ot], out[pt]
    assert np.abs(pa).max() > 1e-3
    assert np.abs(pa - ja).max() <= TOL, np.abs(pa - ja).max()
    if name in JAX_LOSES_QUEUE:
        assert np.abs(jb - ja).max() > 1e-3  # still so in the JAX package?
        jb = ja
    assert np.abs(pb - jb).max() <= TOL, np.abs(pb - jb).max()


# --- twins of the JAX package's checkpoint tests ----------------------------------------------


def test_torch_checkpoint_resume_scene_twin():
    """tests/test_native.py:147: a scene snapshotted mid-stream renders the
    same audio after a restore."""
    outs = []
    for m in (ot, pt):
        control, scene = m.SpatialScene.new(**kw(m))
        control.play_buffered(m.Sine(0.3, 330.0), m.SpatialOptions(position=[2.0, 0.0, -1.0]),
                              max_distance=20.0, rate=8000, buffer_duration=0.1)
        control.play(m.Sine(0.1, 220.0), m.SpatialOptions(position=[-1.0, 0.0, -2.0]))
        r = m.Renderer(scene, 8000)
        r.render_frames(512 * 4)
        snap = CK[m].snapshot(scene)
        a = np.asarray(r.render_frames(512 * 4))
        CK[m].restore(scene, snap)
        b = np.asarray(r.render_frames(512 * 4))
        np.testing.assert_array_equal(a, b)
        outs.append(a)
    assert np.abs(outs[0] - outs[1]).max() <= TOL


def test_torch_stream_dr_checkpoint_twin():
    """tests/test_stream_adapt_fader.py:504: a device-resident stream pool
    restores its ring, cursors and the PCM queued at the snapshot."""
    outs = []
    for m in (ot, pt):
        rng = np.random.default_rng(3)
        data = (rng.standard_normal(3000) * 0.3).astype(np.float32)
        control, mixer = m.Mixer.new(channels=1, **kw(m))
        ctl, s = m.Stream.new(8000, 4096)
        control.play(s)
        r = m.Renderer(mixer, 8000)
        ctl.write(data[:2000])
        r.render_frames(512)
        ctl.write(data[2000:])  # still queued at snapshot time
        snap = CK[m].snapshot(mixer)
        a = np.concatenate([r.render_frames(512) for _ in range(4)])
        CK[m].restore(mixer, snap)
        b = np.concatenate([r.render_frames(512) for _ in range(4)])
        np.testing.assert_array_equal(a, b)
        outs.append(a)
    assert np.abs(outs[0] - outs[1]).max() <= TOL
    assert np.abs(outs[1][1400:2000]).max() > 0.1  # the queued PCM plays


def test_torch_pooled_fader_pending_fade_into_second_mixer_twin():
    """tests/test_stream_adapt_fader.py:525: a queued fade crosses a
    restore into a second mixer built by the same script."""
    for m in (ot, pt):
        def build():
            mc, mixer = m.Mixer.new(channels=1, **kw(m))
            fc, f = m.Fader.new(m.Constant(1.0))
            mc.play(f)
            return mixer, fc

        mixer, fc = build()
        r = m.Renderer(mixer, 8000)
        r.render_block(256)
        fc.fade_to(m.Constant(5.0), 0.05)  # queued, not yet applied
        snap = CK[m].snapshot(mixer)
        mixer2, _ = build()
        r2 = m.Renderer(mixer2, 8000)
        r2.render_block(256)
        CK[m].restore(mixer2, snap)
        for _ in range(4):  # the 0.05 s fade completes
            out = r2.render_block(256)
        np.testing.assert_allclose(out, 5.0, atol=1e-5)


def test_torch_fader_dr_pending_fade_twin():
    """tests/test_stream_adapt_fader.py:615: a snapshot between fade_to()
    and the next block keeps the queued fade."""
    outs = []
    for m in (ot, pt):
        mc, mixer = m.Mixer.new(channels=1, **kw(m))
        fc, f = m.Fader.new(m.Constant(1.0))
        mc.play(f)
        r = m.Renderer(mixer, 8000)
        r.render_block(256)
        fc.fade_to(m.Constant(3.0), 0.02)
        snap = CK[m].snapshot(mixer)
        r.render_frames(512)
        expect = np.asarray(r.render_block(64))
        CK[m].restore(mixer, snap)
        r.render_frames(512)
        got = np.asarray(r.render_block(64))
        np.testing.assert_allclose(got, expect, atol=1e-6)
        outs.append(got)
    np.testing.assert_allclose(outs[1], 3.0, atol=1e-6)
    assert np.abs(outs[0] - outs[1]).max() <= TOL


def test_torch_submix_checkpoint_through_aux_twin():
    """The checkpoint leg of tests/test_spatial.py:467: a Mixer played as a
    spatial voice checkpoints through the aux hook; a stop issued after
    the snapshot is undone by the restore."""
    outs = []
    for m in (ot, pt):
        mc, mixer = m.Mixer.new(channels=1, **kw(m))
        mc.play(m.Sine(0.0, 300.0))
        h_inner = mc.play(m.Sine(0.0, 520.0))
        sc, scene = m.SpatialScene.new(**kw(m))
        sc.play_buffered(mixer, m.SpatialOptions(position=[2.0, 0.0, -1.0]),
                         max_distance=20.0, rate=8000)
        r = m.Renderer(scene, 8000)
        r.render_frames(4096)
        snap = CK[m].snapshot(scene)
        h_inner.stop()
        a = np.asarray(r.render_frames(2048))
        spec2 = np.abs(np.fft.rfft(a[1024:, 0]))
        assert abs(np.argmax(spec2) * 8000 / 1024 - 300) < 16  # 520 gone
        CK[m].restore(scene, snap)
        b = np.asarray(r.render_frames(2048))
        spec3 = np.abs(np.fft.rfft(b[1024:, 0]))
        top2 = set((np.argsort(spec3)[-2:] * 8000 // 1024).tolist())
        assert any(abs(p - 520) < 16 for p in top2)  # restored pre-stop state
        outs.append((a, b))
    for x, y in zip(*outs):
        assert np.abs(x - y).max() <= TOL


def test_torch_snapshot_is_numpy_and_restores_across_devices():
    """The device part of a snapshot is numpy; restore uploads copies to the
    engine's own device, so the snapshot is never aliased by the engine's
    in-place leaves."""
    scene, render, events = spatial_dr(pt)
    render(WARM)
    snap = pck.snapshot(scene)
    leaves = []

    def walk(t):
        for v in t.values():
            walk(v) if isinstance(v, dict) else leaves.append(v)

    walk(snap["device"])
    assert leaves and all(isinstance(x, np.ndarray) for x in leaves)
    before = pickle.dumps(snap["device"])
    render(N)
    pck.restore(scene, snap)
    render(N)
    assert pickle.dumps(snap["device"]) == before


def test_torch_restore_refuses_a_different_structure():
    scene, render, events = spatial_dr(pt)
    render(WARM)
    snap = pck.snapshot(scene)
    control, other = pt.SpatialScene.new(device="cpu")
    control.play(pt.Sine(0.0, 100.0), pt.SpatialOptions())
    control.play(_finite_sine(pt)(0.0, 100.0), pt.SpatialOptions())  # pool s1
    with pytest.raises(ValueError):
        pck.restore(other, snap)


# --- the card tests' checkpoint scenes (test_torch_cuda.py) at a CPU size -----------------


def _bench_prepared(kind, voices):
    from oddio_tpu_torch.utils.scene_profile import BLOCK, build_checkpoint_scene

    kw = dict(sounds=2, seconds=1.0) if kind == "sampler" else {}
    eng, r = build_checkpoint_scene(kind, voices, "cpu", **kw)
    return eng, lambda k: r.render_frames(BLOCK * k)


@pytest.mark.parametrize("kind", ["buffered", "mixer", "hostpools", "sampler"])
def test_torch_roundtrip_bench_scenes(kind, tmp_path):
    """build_spatial, build_mixer_agc (Adapt(Stream) in a device-resident
    pool), build_host_pools (every buffered pool kind) and build_sampler
    (a fade in flight and fades queued): snapshot, 16 blocks, restore, the
    same 16 blocks bit for bit, twice; ``save`` into a file and ``load``
    into a second engine of the same script: the same blocks again."""
    eng, render = _bench_prepared(kind, 64)
    snap = pck.snapshot(eng)
    a = render(16)
    assert np.isfinite(a).all() and np.abs(a).max() > 1e-3
    for _ in range(2):
        pck.restore(eng, snap)
        assert_same(a, render(16))
    path = tmp_path / "snap.pkl"
    pck.restore(eng, snap)
    pck.save(eng, path)
    eng2, render2 = _bench_prepared(kind, 64)
    pck.load(eng2, path)
    assert_same(a, render2(16))
