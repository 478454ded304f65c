"""The port's host voice pools, Speed and submixes against the JAX package
(and, for the submix, the numpy oracle), and the two repairs before them:
stream voices in the scene's device-resident buffered pool, and entry
points that run on the card unless asked for the CPU.

Every scene is built by the same control script in both packages from
seeded numpy draws.  Bound: max |err| <= 1e-5, the PARITY.md contract.
The packages differ by XLA:CPU's fused multiply-adds in the JAX package's
jitted programs (ROADMAP R7), by the order of the voice sums, and by a few
ulps of the AGC scan (ROADMAP R9).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import oddio_tpu as ot  # noqa: E402
import oddio_tpu_torch as pt  # noqa: E402
import reference_impl as ref  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-5
F = np.float32


def kw(m):
    """The port renders on the CPU only when asked to."""
    return {"device": "cpu"} if m is pt else {}


def pool_kinds(scene):
    return [type(p).__name__ for p in scene._buffered_pools.values()]


# --- R-a: streams in the device-resident buffered pool ----------------------------


def test_stream_spatial_at_48k_matches_jax():
    """One Stream played buffered at 48 kHz: the port rendered silence here
    before its device-resident pool learned the stream ingest; now it
    takes the same pool as the JAX package and matches it."""
    data = (np.random.default_rng(0).standard_normal(2048) * 0.5).astype(F)
    outs = []
    for m in (ot, pt):
        control, scene = m.SpatialScene.new(**kw(m))
        ctl, s = m.Stream.new(48000, 4096)
        control.play_buffered(s, m.SpatialOptions(position=[2.0, 1.0, 0.0]))
        ctl.write(data)
        assert pool_kinds(scene) == ["_BufferedPoolDR"]
        outs.append(m.Renderer(scene, 48000).render_frames(2048))
    a, b = outs
    assert np.abs(b).max() > 0.01
    assert np.abs(a - b).max() <= TOL, np.abs(a - b).max()


def _stream_scene(m, adapt, rate):
    """test_stream_adapt_fader.py:346 (bare Stream) and :432 (Adapt(Stream))
    through the device-resident pool, with a mid-run write."""
    rng = np.random.default_rng(8 if adapt else 21)
    data = (rng.standard_normal(6000) * (0.5 if adapt else 0.2)).astype(F)
    if adapt:
        data[2000:] *= 0.15
    control, scene = m.SpatialScene.new(**kw(m))
    ctls = []
    for i in range(2 if adapt else 1):
        ctl, s = m.Stream.new(8000, 8192)
        spec = s
        if adapt:
            spec = m.Adapt(s, 0.2, m.AdaptOptions(tau=0.05, low=0.1, high=0.3,
                                                  max_gain=3.0))
        control.play_buffered(
            spec, m.SpatialOptions(position=[1.0 + i, 0.0, -2.0]),
            max_distance=10.0, rate=rate, buffer_duration=0.1,
        )
        ctls.append(ctl)
    assert pool_kinds(scene) == ["_BufferedPoolDR"]
    for ctl in ctls:
        ctl.write(data[:4000])
    r = m.Renderer(scene, 8000)
    out = [r.render_block(512) for _ in range(3)]
    for ctl in ctls:
        ctl.write(data[4000:])  # mid-run ingest
    out += [r.render_block(512) for _ in range(5)]
    return np.concatenate(out), [c.free() for c in ctls]


@pytest.mark.parametrize("adapt,rate", [(False, 8000), (True, 8000), (True, 48000)])
def test_stream_dr_spatial_matches_jax(adapt, rate):
    (a, fa), (b, fb) = (_stream_scene(m, adapt, rate) for m in (ot, pt))
    assert np.abs(a).max() > 1e-3
    assert np.abs(a - b).max() <= TOL, np.abs(a - b).max()
    assert fa == fb  # the host cursor mirrors agree


def test_stream_dr_spatial_at_48k_matches_oracle():
    """The bare-stream scene with its ring at 48 kHz (read at ratio 6 by
    the exact elementwise read).  Here the JAX render drifts from the
    oracle past the contract (ROADMAP Q3.4: 1.63e-5 by block 8, the port
    7.9e-6), so the port is held to the oracle: an exact FramesSignal over
    the same samples, which the stream reads in full (no underrun)."""
    b, _ = _stream_scene(pt, False, 48000)
    data = (np.random.default_rng(21).standard_normal(6000) * 0.2).astype(F)
    oscene = ref.OSpatialScene(exact=True)
    oscene.play_buffered(
        ref.OFramesSignal(ref.OFrames(8000, data), 0.0, exact=True),
        [1.0, 0.0, -2.0], max_distance=10.0, rate=48000, buffer_duration=0.1,
    )
    want = np.zeros((8 * 512, 2), F)
    for k in range(8):
        ref.oddio_run(oscene, 8000, want[512 * k : 512 * (k + 1)])
    assert np.abs(want).max() > 0.01
    assert np.abs(b - want).max() <= TOL, np.abs(b - want).max()


# --- R-b: the card by default --------------------------------------------------------


def test_entry_points_need_a_card_unless_given_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (pt.SpatialScene.new, lambda: pt.Mixer.new(1), pt.SpatialScene,
                 pt.Mixer, lambda: pt.run(pt.Sine(0.0, 440.0), 8000, 64),
                 lambda: pt.Renderer(pt.Sine(0.0, 440.0), 8000)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    _, scene = pt.SpatialScene.new(device="cpu")
    assert scene.device == torch.device("cpu")
    sig = pt.Sine(0.0, 440.0)
    assert pt.run(sig, 8000, 64, device="cpu").shape == (64, 1)
    assert sig.device == torch.device("cpu")


# --- the host buffered pool -------------------------------------------------------------


class _HostStreamJ(ot.Stream):
    def dr_supported(self):
        return False


class _HostStreamP(pt.Stream):
    def dr_supported(self):
        return False


@pytest.mark.parametrize("branch", ["strips", "elementwise"])
def test_forced_host_stream_pool_matches_jax(branch):
    """Streams forced into the host buffered pool (the JAX test's
    _HostStream): 48 kHz blocks of 512 frames take the strip branch (K4
    write, K5 read); a fast mover takes the exact elementwise branch."""
    fast = branch == "elementwise"
    outs = []
    for m, cls in ((ot, _HostStreamJ), (pt, _HostStreamP)):
        rng = np.random.default_rng(3)
        control, scene = m.SpatialScene.new(**kw(m))
        ctls = []
        for i in range(3):
            ctl, s = cls.new(16000, 4096)
            pos, vel = rng.uniform(-6, 6, 3), [0.3, 0.0, 0.0]
            if fast and i == 0:  # 150 m/s radially: |ds - 1|*n > K
                pos, vel = [4.0, 0.0, -1.0], [150.0, 0.0, -35.0]
            control.play_buffered(
                s, m.SpatialOptions(position=pos, velocity=vel),
                max_distance=20.0, rate=48000, buffer_duration=0.1,
            )
            ctls.append(ctl)
        pool = next(iter(scene._buffered_pools.values()))
        assert not getattr(pool, "is_dr", False)
        for ctl in ctls:
            ctl.write((rng.standard_normal(3000) * 0.3).astype(F))
        r = m.Renderer(scene, 48000)
        blocks = [r.render_block(512) for _ in range(4)]
        assert pool._use_strips == (not fast)
        ctls[1].write((rng.standard_normal(500) * 0.3).astype(F))
        blocks += [r.render_block(512) for _ in range(3)]
        outs.append(np.concatenate(blocks))
    a, b = outs
    assert np.abs(a).max() > 1e-3
    assert np.abs(a - b).max() <= TOL, np.abs(a - b).max()


def test_speed_stream_host_pool_with_set_speed_matches_jax():
    """Speed(Stream) voices (dr_ingest_ok is False) take the host buffered
    pool in both packages; set_speed mid-run and a second write."""
    outs = []
    for m in (ot, pt):
        rng = np.random.default_rng(1)
        control, scene = m.SpatialScene.new(**kw(m))
        ctls, speeds = [], []
        for _ in range(6):
            st = m.Stream(8000, 2528, max_write_per_block=2400)
            sc, sp = m.Speed.new(st)
            sc.set_speed(rng.uniform(0.8, 1.25))
            control.play_buffered(
                sp, m.SpatialOptions(position=rng.uniform(-5, 5, 3),
                                     velocity=rng.uniform(-0.2, 0.2, 3)),
                max_distance=50.0, rate=48000, buffer_duration=0.1,
            )
            ctls.append(st.control)
            speeds.append(sc)
        assert pool_kinds(scene) == ["_BufferedPool"]
        for c in ctls:
            c.write((rng.standard_normal(2400) * 0.3).astype(F))
        r = m.Renderer(scene, 48000)
        blocks = [r.render_block(512) for _ in range(5)]
        speeds[0].set_speed(0.9)
        speeds[3].set_speed(1.2)
        for c in ctls:
            c.write((rng.standard_normal(1024) * 0.3).astype(F))
        for _ in range(12):  # past the initial 16 slots: pool and ring grow
            st = m.Stream(8000, 2528, max_write_per_block=2400)
            control.play_buffered(
                m.Speed(st), m.SpatialOptions(position=rng.uniform(-5, 5, 3)),
                max_distance=50.0, rate=48000, buffer_duration=0.1,
            )
            st.control.write((rng.standard_normal(1500) * 0.3).astype(F))
        blocks += [r.render_block(512) for _ in range(5)]
        assert next(iter(scene._buffered_pools.values())).capacity == 32
        assert abs(speeds[0].speed() - 0.9) < 1e-6
        outs.append((np.concatenate(blocks), [c.free() for c in ctls]))
    (a, fa), (b, fb) = outs
    assert np.abs(a).max() > 1e-3
    assert np.abs(a - b).max() <= TOL, np.abs(a - b).max()
    assert fa == fb


# --- submixes ---------------------------------------------------------------------------


def _submix_scene(m):
    mc, mixer = m.Mixer.new(channels=1, **kw(m))
    mc.play(m.Sine(0.0, 300.0))
    h_inner = mc.play(m.Sine(0.0, 520.0))
    sc, scene = m.SpatialScene.new(**kw(m))
    h = sc.play_buffered(mixer, m.SpatialOptions(position=[2.0, 0.0, -1.0]),
                         max_distance=20.0, rate=8000)
    return scene, h, h_inner


def test_submix_play_buffered_matches_jax():
    """test_spatial.py:467 without its checkpoint: a Mixer played as one
    spatial voice renders through the singleton pool, is panned right,
    and an inner voice's stop reaches it."""
    outs = []
    for m in (ot, pt):
        scene, h, h_inner = _submix_scene(m)
        pool = next(iter(scene._buffered_pools.values()))
        assert getattr(pool, "is_singleton", False)
        r = m.Renderer(scene, 8000)
        out = r.render_frames(4096)
        spec = np.abs(np.fft.rfft(out[2048:, 0]))
        peaks = set((np.argsort(spec)[-2:] * 8000 // 2048).tolist())
        assert any(abs(p - 300) < 16 for p in peaks)
        assert any(abs(p - 520) < 16 for p in peaks)
        assert np.sqrt((out[:, 1] ** 2).mean()) > np.sqrt((out[:, 0] ** 2).mean())
        assert not h.is_finished()
        h_inner.stop()
        out2 = r.render_frames(2048)
        spec2 = np.abs(np.fft.rfft(out2[1024:, 0]))
        assert abs(np.argmax(spec2) * 8000 / 1024 - 300) < 16
        outs.append(np.concatenate([out, out2]))
    a, b = outs
    assert np.abs(a - b).max() <= TOL, np.abs(a - b).max()


def test_submix_play_buffered_matches_oracle():
    scene, _, _ = _submix_scene(pt)
    r = pt.Renderer(scene, 8000)
    omix = ref.OMixer()
    omix.play(ref.OSine(0.0, 300.0, exact=True))
    omix.play(ref.OSine(0.0, 520.0, exact=True))
    oscene = ref.OSpatialScene(exact=True)
    oscene.play_buffered(omix, [2.0, 0.0, -1.0], max_distance=20.0, rate=8000)
    errs = []
    for _ in range(8):
        got = r.render_block(512)
        want = np.zeros((512, 2), F)
        ref.oddio_run(oscene, 8000, want)
        errs.append(np.abs(got - want).max())
    assert np.abs(want).max() > 0.01
    assert max(errs) <= TOL, errs


# --- the host seek pool --------------------------------------------------------------------


def _finite_sine(m):
    class FiniteSine(m.Sine):
        """A Sine that reports finished once its phase passes 2 rad: a
        seekable chain with its own finish rule, so not device-resident."""

        def host_is_finished(self):
            return np.asarray(self.phase) > 2.0

    return FiniteSine


def test_seek_host_pool_with_lingering_matches_jax():
    outs, seqs = [], []
    for m in (ot, pt):
        cls = _finite_sine(m)
        rng = np.random.default_rng(4)
        control, scene = m.SpatialScene.new(**kw(m))
        hs = [
            control.play(cls(rng.uniform(0, 1), rng.uniform(100, 900)),
                         m.SpatialOptions(position=rng.uniform(-20, 20, 3),
                                          velocity=rng.uniform(-5, 5, 3)))
            for _ in range(5)
        ]
        assert [type(p).__name__ for p in scene._seek_pools.values()] == ["_SeekPool"]
        r = m.Renderer(scene, 8000)
        blocks, seq = [], []
        for b in range(10):
            if b == 3:
                hs[1].set_motion([3.0, 0.0, 1.0], [0.0, 2.0, 0.0], True)
            blocks.append(r.render_block(256))
            seq.append([h.is_finished() for h in hs])
        outs.append(np.concatenate(blocks))
        seqs.append(seq)
    a, b = outs
    assert seqs[0] == seqs[1]
    assert any(any(s) for s in seqs[1]) and not all(seqs[1][0])
    assert np.abs(a).max() > 1e-3
    assert np.abs(a - b).max() <= TOL, np.abs(a - b).max()


# --- the mixer's host pools ------------------------------------------------------------------


def test_mixer_host_pool_speed_stream_matches_jax():
    """Speed(Stream) voices in the mixer's host Pool (the JAX package's
    routing), with set_speed and a write mid-run, and a stop."""
    outs = []
    for m in (ot, pt):
        rng = np.random.default_rng(6)
        control, mixer = m.Mixer.new(channels=1, **kw(m))
        ctls, speeds, hs = [], [], []
        for _ in range(4):
            st = m.Stream(8000, 4096)
            sc, sp = m.Speed.new(st)
            sc.set_speed(rng.uniform(0.7, 1.3))
            hs.append(control.play(sp))
            ctls.append(st.control)
            speeds.append(sc)
        hs.append(control.play(m.Sine(0.2, 330.0)))
        assert [p.is_dr for p in mixer._pools.values()] == [False, True]
        for c in ctls:
            c.write((np.sin(np.arange(3000) * rng.uniform(0.01, 0.1)) * 0.5).astype(F))
        r = m.Renderer(mixer, 48000)
        a = r.render_frames(512 * 3)
        speeds[1].set_speed(1.5)
        hs[2].stop()
        ctls[0].write(np.full(200, 0.25, F))
        for _ in range(14):  # past the initial 16 slots: the pool grows
            st = m.Stream(8000, 4096)
            control.play(m.Speed(st))
            st.control.write(np.full(300, rng.uniform(-0.5, 0.5), F))
        pool = next(iter(mixer._pools.values()))
        assert pool.capacity == 32
        b = r.render_frames(512 * 3)
        assert hs[2].is_stopped() and not hs[0].is_stopped()
        outs.append(np.concatenate([a, b]))
    a, b = outs
    assert np.abs(a).max() > 0.1
    assert np.abs(a - b).max() <= TOL, np.abs(a - b).max()


def test_mixer_submix_singleton_and_replay_rebind_match_jax():
    """test_ops.py:545 and :571: a Mixer played into a Mixer renders
    through a singleton pool and stops; a same-archetype replay rebinds
    the freed pool instead of adding one."""
    outs = []
    for m in (ot, pt):
        def make_sub(freq):
            c, sub = m.Mixer.new(channels=1, **kw(m))
            c.play(m.Sine(0.0, freq))
            return sub

        mc, top = m.Mixer.new(channels=1, **kw(m))
        h1 = mc.play(make_sub(300.0))
        mc.play(m.Sine(0.0, 100.0))
        assert [getattr(p, "is_singleton", False) for p in top._pools.values()] == [True, False]
        r = m.Renderer(top, 8000)
        a = r.render_frames(1024)
        npools = len(top._pools)
        h1.stop()
        b = r.render_frames(1024)
        assert h1.is_stopped()
        h2 = mc.play(make_sub(500.0))
        c = r.render_frames(2048)
        assert len(top._pools) == npools
        assert not h2.is_stopped()
        s = np.abs(np.fft.rfft(c[1024:, 0]))
        assert any(abs(p - 500) < 16 for p in (np.argsort(s)[-2:] * 8000 // 1024).tolist())
        outs.append(np.concatenate([a, b, c]))
    a, b = outs
    assert np.abs(a - b).max() <= TOL, np.abs(a - b).max()


@pytest.mark.parametrize("agc", [False, True])
def test_speed_sine_dr_mixer_pool_matches_jax(agc):
    """test_drctrl.py:49 with Sine sources (the port has no FramesSignal
    yet): Speed(Sine), and Speed(Adapt(Sine)) whose AGC alpha follows the
    warped interval, ride the device-resident pool, whose per-voice
    interval re-derives each step on the device; set_speed ships as a
    control delta."""
    outs = []
    for m in (ot, pt):
        control, mixer = m.Mixer.new(channels=1, **kw(m))
        scs = []
        for j in range(4):
            src = m.Sine(0.3 * j, 220.0 + 110.0 * j)
            if agc:
                src = m.Adapt(src, 0.3, m.AdaptOptions(tau=0.1, max_gain=4.0))
            sc, s = m.Speed.new(src)
            scs.append(sc)
            control.play(s)
        assert [p.is_dr for p in mixer._pools.values()] == [True]
        r = m.Renderer(mixer, 8000)
        a = r.render_frames(1024)
        for j, sc in enumerate(scs):
            sc.set_speed(0.5 + 0.5 * j)
        b = r.render_frames(1024)
        assert abs(scs[2].speed() - 1.5) < 1e-6
        outs.append(np.concatenate([a, b]))
    a, b = outs
    assert np.abs(a).max() > 0.5
    assert np.abs(a - b).max() <= TOL, np.abs(a - b).max()


def test_host_pool_near_gate_scene_matches_jax_and_the_clamp_shows_against_oracle():
    """A 1500 Hz voice closing at 42 m/s, forced into the host buffered
    pool: |ds - 1| about 0.122, inside the strip gate, so K5 reads it with
    the TPU kernel's SELECT_R clamp binding.  The port matches the JAX
    package; both depart from the exact oracle by the same 7.0e-4
    (ROADMAP R10: a reference-side effect, about a fifth of the peak)."""
    pos, vel = [-30.0, 0.0, -2.0], [42.0, 0.0, 0.0]
    outs = []
    for m in (ot, pt):
        class HostSine(m.Sine):
            def dr_supported(self):
                return False

        control, scene = m.SpatialScene.new(**kw(m))
        control.play_buffered(HostSine(0.2, 1500.0), m.SpatialOptions(position=pos, velocity=vel),
                              max_distance=50.0, rate=48000, buffer_duration=0.1)
        r = m.Renderer(scene, 48000)
        outs.append(np.concatenate([r.render_block(512) for _ in range(8)]))
        assert next(iter(scene._buffered_pools.values()))._use_strips
    oscene = ref.OSpatialScene(exact=True)
    oscene.play_buffered(ref.OSine(0.2, 1500.0, exact=True), pos, vel, 0.1,
                         max_distance=50.0, rate=48000, buffer_duration=0.1)
    want = np.zeros((8 * 512, 2), F)
    for k in range(8):
        ref.oddio_run(oscene, 48000, want[512 * k : 512 * (k + 1)])
    a, b = outs
    assert np.abs(a - b).max() <= TOL, np.abs(a - b).max()
    dev_jax, dev_port = np.abs(a - want).max(), np.abs(b - want).max()
    assert dev_port > 1e-4 and abs(dev_port - dev_jax) <= TOL


def test_wrapped_submixes_match_jax():
    """A submix under a wrapper is still one voice: Adapt(Mixer) played
    buffered into a scene, and Speed(Mixer) with a set_speed played into a
    mixer, render through the singleton pools as in the JAX package."""
    outs = []
    for m in (ot, pt):
        def sub(freqs):
            c, mixer = m.Mixer.new(channels=1, **kw(m))
            for f in freqs:
                c.play(m.Sine(0.1, f))
            return mixer

        sc, scene = m.SpatialScene.new(**kw(m))
        sc.play_buffered(m.Adapt(sub([300.0, 450.0]), 0.3,
                                 m.AdaptOptions(tau=0.1, max_gain=4.0)),
                         m.SpatialOptions(position=[2.0, 0.0, -1.0]),
                         max_distance=20.0, rate=8000)
        mc, top = m.Mixer.new(channels=1, **kw(m))
        speed, fast = m.Speed.new(sub([200.0]))
        mc.play(fast)
        assert [getattr(p, "is_singleton", False) for p in scene._buffered_pools.values()] == [True]
        assert [getattr(p, "is_singleton", False) for p in top._pools.values()] == [True]
        rs, rt = m.Renderer(scene, 8000), m.Renderer(top, 8000)
        a = [rs.render_frames(1024), rt.render_frames(1024)]
        speed.set_speed(1.5)
        a += [rs.render_frames(1024), rt.render_frames(1024)]
        outs.append(np.concatenate([x.reshape(-1) for x in a]))
    a, b = outs
    assert np.abs(a).max() > 0.1
    assert np.abs(a - b).max() <= TOL, np.abs(a - b).max()
