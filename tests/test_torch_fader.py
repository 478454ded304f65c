"""The port's Fader: the standalone (structural) form, the host-pool
two-bank form and the device-resident twin-bank/flip-bit form with the
pools' fade lanes (core/drctrl.py), against fader.rs's semantics, each
other and the JAX package.  The fader cases of
tests/test_stream_adapt_fader.py:180-278 and :558-735 (its checkpoint
cases are P5's).

Bounds: exact where the reference's values are (dyadic ramps); 1e-6
between the standalone and the pooled forms and between the host-pool and
device-resident forms (only Sine's device phase accumulator separates
them); 1e-5 (PARITY.md) against the JAX package.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import oddio_tpu as ot  # noqa: E402
import oddio_tpu_torch as pt  # noqa: E402
from oddio_tpu_torch.core.drctrl import _state_at  # noqa: E402

torch.set_num_threads(1)

F = np.float32


def kw(m):
    return {"device": "cpu"} if m is pt else {}


def sample(sig, interval, n):
    r = getattr(sig, "_test_renderer", None)
    if r is None:
        r = pt.Renderer(sig, 1, device="cpu")
        sig._test_renderer = r
    return r.render_block(n, interval=np.float32(interval))[:, 0]


class _HostPoolFader(pt.Fader):
    """Forces the host pool's two-bank form."""

    def dr_supported(self):
        return False


# --- standalone (fader.rs:99-117) ------------------------------------------------


def test_fader_smoke():
    control, s = pt.Fader.new(pt.Constant(1.0))
    np.testing.assert_array_equal(sample(s, 0.1, 12), np.ones(12, F))
    control.fade_to(pt.Constant(0.0), 1.0)
    out = sample(s, 0.1, 12)
    assert out[0] == 1.0 and out[11] == 0.0
    assert abs(out[5] - np.sqrt(0.5)) < 1e-6


def test_fader_swaps_and_fades_again():
    control, s = pt.Fader.new(pt.Constant(1.0))
    control.fade_to(pt.Constant(3.0), 0.5)
    sample(s, 0.25, 4)  # completes the fade (p: 0, .5, 1, 1)
    np.testing.assert_array_equal(sample(s, 0.25, 2), [3.0, 3.0])
    control.fade_to(pt.Constant(9.0), 0.5)  # replaced by the next (last wins)
    control.fade_to(pt.Constant(5.0), 1.0)
    np.testing.assert_allclose(sample(s, 0.5, 4), [3.0, np.sqrt(0.5) * 8.0, 5.0, 5.0],
                               atol=1e-6)


def test_fader_mid_fade_command_waits():
    control, s = pt.Fader.new(pt.Constant(1.0))
    control.fade_to(pt.Constant(0.0), 1.0)
    sample(s, 0.25, 2)  # p reaches 0.5, still fading
    control.fade_to(pt.Constant(7.0), 1.0)  # waits
    np.testing.assert_allclose(sample(s, 0.25, 2), [np.sqrt(0.5), np.sqrt(0.25)], atol=1e-6)
    out = sample(s, 0.25, 4)  # done at block start; the new fade begins
    np.testing.assert_allclose(out[-1], np.sqrt(0.75) * 7.0, atol=1e-5)
    np.testing.assert_allclose(sample(s, 0.25, 2), [7.0, 7.0], atol=1e-6)


# --- pooled forms ------------------------------------------------------------------


@pytest.mark.parametrize("cls", [pt.Fader, _HostPoolFader])
def test_fader_inside_mixer_pool(cls):
    """A Fader voice in a mixer (mixer.rs:18-26), device-resident or in the
    host pool, matches the standalone fader, swaps on completion and fades
    again."""
    def run(pooled):
        control_f, fader = cls.new(pt.Sine(0.25, 220.0))
        if pooled:
            mc, mixer = pt.Mixer.new(channels=1, device="cpu")
            mc.play(fader)
            assert [p.is_dr for p in mixer._pools.values()] == [cls is pt.Fader]
            r = pt.Renderer(mixer, 8000)
        else:
            r = pt.Renderer(fader, 8000, device="cpu")
        pieces = [r.render_frames(512)]
        control_f.fade_to(pt.Sine(0.75, 440.0), 0.1)
        pieces.append(r.render_frames(1536))  # the fade (800) and idle after the swap
        control_f.fade_to(pt.Sine(0.1, 330.0), 0.05)
        pieces.append(r.render_frames(1024))
        return np.concatenate(pieces)

    assert np.abs(run(False) - run(True)).max() < 1e-6


@pytest.mark.parametrize("cls", [pt.Fader, _HostPoolFader])
def test_fader_pool_waiting_and_last_wins(cls):
    """A fade_to during a fade waits, and a newer waiter replaces it
    (fader.rs:38-47); a device-resident pool releases it from its host
    mirrors, with no device read."""
    mc, mixer = pt.Mixer.new(channels=1, device="cpu")
    controls = []
    for _ in range(3):
        fc, f = cls.new(pt.Constant(1.0))
        controls.append(fc)
        mc.play(f)
    r = pt.Renderer(mixer, 8000)
    r.render_block(256)
    controls[0].fade_to(pt.Constant(0.0), 0.05)
    r.render_block(256)
    controls[0].fade_to(pt.Constant(9.0), 0.05)  # waits (a fade is in flight)
    controls[0].fade_to(pt.Constant(5.0), 0.05)  # replaces the waiter
    for _ in range(6):
        r.render_block(256)
    np.testing.assert_allclose(r.render_block(256), 7.0, atol=1e-5)
    if cls is pt.Fader:
        pool = next(iter(mixer._pools.values()))
        assert pool._fade_quiet  # every fade resolved: the idle path is open


def _dr_vs_host(m, cls):
    rng = np.random.default_rng(11)
    mc, mixer = m.Mixer.new(channels=1, **kw(m))
    fcs, gcs = [], []
    for _ in range(6):
        gc, g = m.Gain.new(m.Sine(rng.uniform(0, 6), rng.uniform(100, 900)))
        fc, f = cls.new(g)
        fcs.append(fc)
        gcs.append(gc)
        mc.play(f)
    r = m.Renderer(mixer, 8000)
    out = [r.render_frames(512)]
    for j, fc in enumerate(fcs[:4]):
        fc.fade_to(m.Gain.new(m.Sine(0.1 * j, 200.0 + 50 * j))[1], 0.08)
    out.append(r.render_frames(1024))
    fcs[0].fade_to(m.Gain.new(m.Sine(0.3, 720.0))[1], 0.03)  # waits
    fcs[0].fade_to(m.Gain.new(m.Sine(0.4, 760.0))[1], 0.03)  # replaces
    gcs[1].set_gain(-6.0)  # a control write into the original (a) bank
    out.append(r.render_frames(2048))
    return np.concatenate(out)


def test_fader_dr_pool_matches_host_pool_and_jax():
    """The device-resident fader (flip bit, twin banks, fade lanes) against
    the host pool's two-bank fader and the JAX package's device-resident
    fader, across a fade start, a waiting command replaced, completion and
    a second fade."""
    dr = _dr_vs_host(pt, pt.Fader)
    assert np.abs(dr - _dr_vs_host(pt, _HostPoolFader)).max() < 2e-6
    assert np.abs(dr - _dr_vs_host(ot, ot.Fader)).max() <= 1e-5


def test_fader_dr_incoming_handle_routing():
    """A fade target's control handles keep working after the fade
    completes (gain.rs:58-93): they bind to the bank it landed in."""
    mc, mixer = pt.Mixer.new(channels=1, device="cpu")
    fc, f = pt.Fader.new(pt.Gain.new(pt.Constant(1.0))[1])
    mc.play(f)
    r = pt.Renderer(mixer, 8000)
    r.render_block(256)
    gc2, g2 = pt.Gain.new(pt.Constant(1.0))
    gc2.set_gain(-6.0)
    fc.fade_to(g2, 0.01)
    r.render_frames(2048)  # the fade (80) and a whole smoothing ramp (800)
    out1 = float(r.render_block(64).mean())
    gc2.set_gain(0.0)  # after the swap: must reach the live voice
    r.render_frames(1024)
    out2 = float(r.render_block(64).mean())
    np.testing.assert_allclose(out1, 10 ** (-6.0 / 20.0), atol=1e-6)
    np.testing.assert_allclose(out2, 1.0, atol=1e-6)


def test_fader_mirrors_follow_consumed_frames_in_a_submix():
    """The host fade mirrors advance by the frames the voices consume: a
    mixer played through play_buffered renders 513 frames a block but
    consumes 512, and a mirror advanced by 513 would release a waiting
    fade into the wrong bank (fader.rs:38-47, :66-70)."""
    RATE, BLOCK = 8000, 512
    mc, mixer = pt.Mixer.new(channels=1, device="cpu")
    fh, fsig = pt.Fader.new(pt.Sine(0.0, 300.0))
    mc.play(fsig)
    sc, scene = pt.SpatialScene.new(device="cpu")
    sc.play_buffered(mixer, pt.SpatialOptions(position=[0.0, 0.0, -2.0]),
                     max_distance=20.0, rate=RATE)
    r = pt.Renderer(scene, RATE)
    r.render_frames(BLOCK)
    fh.fade_to(pt.Sine(0.0, 520.0), 4100 / RATE)  # 512*8 < 4100 <= 513*8
    r.render_frames(BLOCK)
    fh.fade_to(pt.Sine(0.0, 700.0), 0.25)  # waits for the first
    out = r.render_frames(BLOCK * 16)
    mp = next(p for p in mixer._pools.values() if getattr(p, "fade_paths", None))
    path = mp.fade_paths[0]
    dev = _state_at(mp.state["inner"], path)
    np.testing.assert_array_equal(dev["flip"].numpy()[:1], mp._fade_flip[path][:1])
    assert not bool(dev["fading"][0])
    spec = np.abs(np.fft.rfft(out[-2048:, 0]))
    assert abs(np.argmax(spec) * RATE / 2048 - 700) < 8


def test_fader_outgoing_heavy_target_keeps_exact_path():
    """A completed fade's target renders on as the outgoing bank of the
    next fade, so its step bound stays in the pool's sweep: a crossfade
    away from a speed-8 target keeps the whole-arena gather to its end
    (a spec table keyed by slot alone would narrow the route mid-fade)."""
    RATE = 8000
    tt = np.arange(16 * RATE, dtype=F) / F(RATE)
    data = np.sin(tt * F(2 * np.pi * 400)).astype(F)
    frames = pt.Frames.from_slice(RATE, data)

    def run(cls):
        def voice():
            return pt.Speed.new(pt.FramesSignal(frames, 0.0))

        mc, mixer = pt.Mixer.new(channels=1, device="cpu")
        fc, f = cls.new(voice()[1])
        mc.play(f)
        r = pt.Renderer(mixer, RATE)
        out = [r.render_frames(512)]
        sc1, s1 = voice()
        sc1.set_speed(8.0)  # ds = 8 > RESAMPLE_DSMAX
        fc.fade_to(s1, 0.05)
        out.append(r.render_frames(1024))
        fc.fade_to(voice()[1], 0.25)
        routes = []
        for _ in range(4):
            out.append(r.render_frames(512))
            routes.append(getattr(next(iter(mixer._pools.values())), "_ds_small", None))
        return np.concatenate(out), routes

    host, host_routes = run(_HostPoolFader)
    assert host_routes == [None] * 4  # the host pool reads the plain arena
    dr, routes = run(pt.Fader)
    assert routes == [False] * 4  # the heavy bank is audible throughout
    # the port's device cursor is the reference's f64 one (Q3.5), so the
    # two forms agree far inside the JAX test's 1e-3
    assert np.abs(host - dr).max() < 1e-5


def test_fader_as_buffered_spatial_voice():
    """Fader chains play into the device-resident buffered pool; after the
    swap the voice plays the target's pitch."""
    control, scene = pt.SpatialScene.new(device="cpu")
    fc, f = pt.Fader.new(pt.Sine(0.0, 300.0))
    control.play_buffered(f, pt.SpatialOptions(position=[-5.0, 0.0, 0.0]),
                          max_distance=20.0, rate=8000, buffer_duration=0.05)
    assert [p.is_dr for p in scene._buffered_pools.values()] == [True]
    r = pt.Renderer(scene, 8000)
    before = r.render_frames(1024)
    fc.fade_to(pt.Sine(0.0, 600.0), 0.05)
    r.render_frames(1024)
    after = r.render_frames(2048)
    assert np.abs(before).max() > 0
    spec = np.abs(np.fft.rfft(after[:, 0]))
    assert abs(np.argmax(spec) * 8000 / len(after) - 600.0) < 8.0


def test_fade_target_must_share_the_archetype():
    mc, mixer = pt.Mixer.new(channels=1, device="cpu")
    fc, f = pt.Fader.new(pt.Sine(0.0, 300.0))
    mc.play(f)
    with pytest.raises(ValueError):
        fc.fade_to(pt.Constant(1.0), 0.1)
    with pytest.raises(ValueError):
        fc.fade_to(pt.Constant([1.0, 1.0]), 0.1)  # channel count
