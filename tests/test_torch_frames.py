"""The port's Frames, FramesSignal and Cycle (BASELINE config 2's sampler
and the wavetable line) against the reference's inline vectors, the numpy
oracle and the JAX package.

* The reference vectors of tests/test_ops.py:31-77 (Frames, FramesSignal
  resampling and zero padding, the playback-position readout) and
  :148 and :183-225 (Speed, the Cycle wrap cases): exact, as the JAX
  tests are (dyadic values).
* ``test_golden_frames_speed_resample`` (test_golden.py:78, config 2:
  Speed(FramesSignal) 44.1 -> 48 kHz at speed 1.2) and
  ``test_golden_heavy_downsample`` (:472, ds = 8 past the kernel's step
  bound: the exact whole-arena gather, then back to K6's arena form after
  a set_speed) on the port, standalone and in a device-resident mixer:
  within 1e-5 of the exact oracle.
* Device-resident mono and stereo FramesSignal voices (negative starts,
  voices that finish, Speed chains, 513-frame blocks in two chunks) and
  Cycle voices (the chunk cursor re-wrapped mod len): FramesSignal within
  1e-5 of the exact oracle and of the JAX package within its own distance
  from the oracle; Cycle within 1e-5 of the JAX package and no farther
  from the oracle (whose Cycle has only the reference's f32 offset
  accumulation); the control readout of a device-resident voice.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import oddio_tpu as ot  # noqa: E402
import oddio_tpu_torch as pt  # noqa: E402
import reference_impl as ref  # noqa: E402

torch.set_num_threads(1)

F = np.float32
TOL = 1e-5


def kw(m):
    return {"device": "cpu"} if m is pt else {}


def sample(sig, interval, n):
    r = getattr(sig, "_test_renderer", None)
    if r is None:
        r = pt.Renderer(sig, 1, device="cpu")
        sig._test_renderer = r
    return r.render_block(n, interval=np.float32(interval))


def mono(block):
    assert block.shape[1] == 1
    return block[:, 0]


def render_oracle(osig, rate, total, block=512):
    chunks = []
    for _ in range(total // block):
        buf = np.zeros(block, F)
        ref.oddio_run(osig, rate, buf)
        chunks.append(buf.copy())
    return np.concatenate(chunks)[:, None]


# --- reference vectors (test_ops.py:31-77, :148, :183-225) -------------------------


def test_frames_from_slice_and_interpolate():
    f = pt.Frames.from_slice(1, [1.0, 2.0, 3.0])
    assert len(f) == 3 and f.rate() == 1 and f.runtime() == 3.0
    np.testing.assert_array_equal(f.data, F([1.0, 2.0, 3.0]))
    assert f.interpolate(0.5) == 1.5
    assert f.interpolate(-1.0) == 0.0
    assert f.interpolate(2.5) == pytest.approx(1.5)
    assert f.interpolate(5.0) == 0.0


def test_frames_sample():
    """frames.rs:269-275: resampling and out-of-range zero padding."""
    sig = pt.FramesSignal(pt.Frames.from_slice(1, [1.0, 2.0, 3.0, 4.0]), -2.0)
    np.testing.assert_array_equal(mono(sample(sig, 0.25, 4)), [0.0, 0.0, 0.0, 0.0])
    np.testing.assert_array_equal(mono(sample(sig, 0.5, 3)), [0.0, 0.5, 1.0])
    np.testing.assert_array_equal(mono(sample(sig, 1.0, 5)), [1.5, 2.5, 3.5, 2.0, 0.0])


def test_frames_playback_position():
    """frames.rs:277-303."""
    control, sig = pt.FramesSignal.new(pt.Frames.from_slice(1, [1.0, 2.0, 3.0]), -2.0)
    assert control.playback_position() == -2.0
    assert not control.is_finished()
    sample(sig, 0.2, 10)
    assert control.playback_position() == 0.0
    assert not control.is_finished()
    sample(sig, 0.1, 10)
    assert control.playback_position() == 1.0
    sample(sig, 0.1, 10)
    assert control.playback_position() == 2.0
    sample(sig, 0.2, 10)
    assert control.is_finished()
    assert control.playback_position() == 4.0
    sample(sig, 0.5, 10)
    assert control.playback_position() == 9.0


def test_speed_scales_interval():
    control, sig = pt.Speed.new(
        pt.FramesSignal(pt.Frames.from_slice(1, [0.0, 1.0, 2.0, 3.0]), 0.0))
    control.set_speed(2.0)
    np.testing.assert_array_equal(mono(sample(sig, 0.5, 3)), [0.0, 1.0, 2.0])


def _cycle():
    return pt.Cycle(pt.Frames.from_slice(1, [1.0, 2.0, 3.0]))


@pytest.mark.parametrize("seek,steps", [
    (0.0, [(1.0, [1.0, 2.0, 3.0, 1.0, 2.0])]),  # cycle.rs wrap_single
    (0.0, [(1.0, [1.0, 2.0]), (1.0, [3.0, 1.0, 2.0])]),  # wrap_multi
    (0.0, [(0.5, [1.0, 1.5]), (0.5, [2.0, 2.5, 3.0, 2.0, 1.0, 1.5])]),  # wrap_fract
    (0.25, [(0.5, [1.25, 1.75]), (0.5, [2.25, 2.75, 2.5, 1.5, 1.25])]),  # fract_offset
    (0.0, [(10.0, [1.0, 2.0]), (10.0, [3.0])]),  # wrap_large_interval
])
def test_cycle_wrap(seek, steps):
    s = _cycle()
    s.host_seek(seek)
    for interval, want in steps:
        np.testing.assert_array_equal(mono(sample(s, interval, len(want))), want)


def test_cycle_wrap_single_frame():
    s = pt.Cycle(pt.Frames.from_slice(1, [1.0]))
    s.host_seek(0.25)
    np.testing.assert_array_equal(mono(sample(s, 1.0, 2)), [1.0, 1.0])
    np.testing.assert_array_equal(mono(sample(s, 1.0, 1)), [1.0])


# --- goldens (test_golden.py:78, :472) ------------------------------------------------


@pytest.mark.parametrize("in_mixer", [False, True])
def test_golden_frames_speed_resample_port(in_mixer):
    """BASELINE config 2: FramesSignal + Speed 44.1 -> 48 kHz at speed 1.2,
    standalone (host render) and as a device-resident mixer voice (K6's
    arena form on the CPU: its plain version)."""
    rng = np.random.default_rng(7)
    data = rng.uniform(-1, 1, 44100).astype(F)
    RATE, TOTAL = 48000, 16384
    sctl, sp = pt.Speed.new(pt.FramesSignal(pt.Frames.from_slice(44100, data), 0.0))
    sctl.set_speed(1.2)
    if in_mixer:
        control, mixer = pt.Mixer.new(channels=1, device="cpu")
        control.play(sp)
        assert [p.is_dr for p in mixer._pools.values()] == [True]
        eng = pt.Renderer(mixer, RATE).render_frames(TOTAL)
    else:
        eng = pt.Renderer(sp, RATE, device="cpu").render_frames(TOTAL)
    exact = render_oracle(
        ref.OSpeed(ref.OFramesSignal(ref.OFrames(44100, data), 0.0, exact=True), 1.2),
        RATE, TOTAL,
    )
    assert np.abs(eng - exact).max() <= TOL


def test_golden_heavy_downsample_port():
    """ds = 8: the device-resident pools read with the exact whole-arena
    gather past the kernel's step bound, return to K6's arena form when a
    set_speed brings the bound down, and match the oracle throughout."""
    RATE, BLOCK = 8000, 256
    data = np.sin(np.linspace(0, 700.0, 48000), dtype=F)
    table = np.sin(np.linspace(0, 2 * np.pi, 1024, endpoint=False), dtype=F).astype(F)
    mc, mixer = pt.Mixer.new(channels=1, device="cpu")
    mc.play(pt.FramesSignal(pt.Frames.from_slice(8 * RATE, data), 0.0))
    spc, sp = pt.Speed.new(pt.Cycle(pt.Frames.from_slice(RATE, table)))
    spc.set_speed(8.0)
    mc.play(sp)
    pools = list(mixer._pools.values())
    assert all(p.is_dr for p in pools) and len(pools) == 2
    r = pt.Renderer(mixer, RATE)
    om = ref.OMixer(channels=1)
    om.play(ref.OFramesSignal(ref.OFrames(8 * RATE, data), 0.0, exact=True))
    osp = ref.OSpeed(ref.OCycle(ref.OFrames(RATE, table)), 8.0)
    om.play(osp)
    errs, routes = [], []
    for i in range(8):
        if i == 4:
            spc.set_speed(1.0)  # the bound drops: K6's arena form again
            osp.speed = np.float32(1.0)
        eng = r.render_block(BLOCK)
        buf = np.zeros(BLOCK, F)
        ref.oddio_run(om, RATE, buf)
        errs.append(np.abs(eng[:, 0] - buf).max())
        routes.append(pools[1]._ds_small)
    assert max(errs) <= TOL, errs
    assert routes == [False] * 4 + [True] * 4
    assert pools[0]._ds_small is False  # the 64 kHz sound stays on the gather


# --- device-resident voices against the JAX package -----------------------------------


def _sampler_mixer(m, channels, kind, speeds):
    """Six sampler voices in a mixer: FramesSignal voices starting before
    the sound and one near its end (it finishes early), or Cycle voices
    seeked into their table; each under a Speed when ``speeds``.  ``m`` is
    a package or the oracle (``ref``)."""
    rng = np.random.default_rng(5)
    snd = (rng.standard_normal((9000, 2) if channels == 2 else 9000) * 0.3).astype(F)
    tab = np.sin(np.arange(2048) * 2 * np.pi / 2048).astype(F)
    if m is ref:
        mc = mixer = ref.OMixer(channels=channels)
        frames, table = ref.OFrames(44100, snd), ref.OFrames(44100, tab)
    else:
        mc, mixer = m.Mixer.new(channels=channels, **kw(m))
        frames = m.Frames.from_slice(44100, snd)
    ctls, hs = [], []
    for i in range(6):
        start = float(rng.uniform(-0.05, 0.1)) + (0.15 if i == 5 else 0.0)
        seek = float(rng.uniform(0, 0.05))
        speed = float(rng.uniform(0.8, 1.25))
        if m is ref:
            if kind == "frames":
                sig = ref.OFramesSignal(frames, start, exact=True)
            else:
                sig = ref.OCycle(table)
                sig.seek(seek)
            if speeds:
                sig = ref.OSpeed(sig, speed)
                ctls.append(sig)
            mc.play(sig)
            continue
        if kind == "frames":
            sig = m.FramesSignal(frames, start)
        else:
            sig = m.Cycle(m.Frames.from_slice(44100, tab))
            sig.seek(seek)
        if speeds:
            c, sig = m.Speed.new(sig)
            c.set_speed(speed)
            ctls.append(c)
        hs.append(mc.play(sig))
    return mixer, ctls, hs


@pytest.mark.parametrize("channels,kind,speeds,n", [
    (1, "frames", False, 512),
    (2, "frames", False, 512),
    (1, "frames", True, 513),
    (2, "frames", True, 128),
    (1, "cycle", False, 512),
    (1, "cycle", True, 513),
    (1, "cycle", False, 100),
])
def test_dr_sampler_voices_match_oracle_and_jax(channels, kind, speeds, n):
    """Device-resident sampler voices: within 1e-5 of the exact oracle, and
    of the JAX package within its own distance from the oracle (its
    device cursor drifts by the f32 step's rounding, ROADMAP Q3.5)."""
    outs, stopped = [], []
    for m in (ot, pt):
        mixer, ctls, hs = _sampler_mixer(m, channels, kind, speeds)
        r = m.Renderer(mixer, 48000)
        a = r.render_frames(n * 6, block_size=n)
        for c in ctls:
            c.set_speed(1.7)
        b = r.render_frames(n * 6, block_size=n)
        outs.append(np.concatenate([a, b]))
        stopped.append([h.is_stopped() for h in hs])
        if m is pt:
            assert [p.is_dr for p in mixer._pools.values()] == [True]
    om, octls, _ = _sampler_mixer(ref, channels, kind, speeds)
    chunks = []
    for blk in range(12):
        if blk == 6:
            for c in octls:
                c.speed = F(1.7)
        buf = np.zeros((n, channels) if channels == 2 else n, F)
        ref.oddio_run(om, 48000, buf)
        chunks.append(buf.reshape(n, channels))
    orc = np.concatenate(chunks)
    err, err_jax = np.abs(outs[1] - orc).max(), np.abs(outs[0] - orc).max()
    assert np.abs(outs[1]).max() > 0.05
    if kind == "frames":
        assert err <= TOL, (err, err_jax)
        assert np.abs(outs[1] - outs[0]).max() <= err_jax + TOL
    else:
        # the oracle's Cycle has no exact mode: its sequential f32 offset
        # (cycle.rs:34-47) wobbles ~1e-4 here, for both packages alike
        assert err <= err_jax + 1e-6, (err, err_jax)
        assert np.abs(outs[1] - outs[0]).max() <= TOL
    assert stopped[0] == stopped[1]
    if kind == "frames" and n >= 512:
        assert stopped[1][5]  # the late start ran out of sound


def test_dr_frames_control_readout():
    """playback_position and is_finished of a device-resident voice read
    the pool's device cursor (frames.rs:229-248), as the JAX package."""
    reads = []
    for m in (ot, pt):
        mc, mixer = m.Mixer.new(channels=1, **kw(m))
        ctl, sig = m.FramesSignal.new(m.Frames.from_slice(8000, np.ones(3000, F)), -0.05)
        mc.play(sig)
        r = m.Renderer(mixer, 8000)
        seq = [(ctl.playback_position(), ctl.is_finished())]
        for _ in range(8):
            r.render_block(512)
            seq.append((ctl.playback_position(), ctl.is_finished()))
        reads.append(seq)
    assert reads[1] == reads[0]
    assert reads[1][-1][1] and not reads[1][1][1]


def test_arena_is_per_device_and_current():
    """A pool reads the current arena: a Frames added after the pool first
    rendered is on the device at the next dispatch."""
    mc, mixer = pt.Mixer.new(channels=1, device="cpu")
    mc.play(pt.FramesSignal(pt.Frames.from_slice(8000, np.full(4000, 0.5, F)), 0.0))
    r = pt.Renderer(mixer, 8000)
    r.render_frames(512)
    late = pt.Frames.from_slice(8000, np.full(4000, 0.25, F))
    mc.play(pt.FramesSignal(late, 0.0))
    out = r.render_frames(512)
    np.testing.assert_allclose(out[-1], 0.75, atol=1e-7)
