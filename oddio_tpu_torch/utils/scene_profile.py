"""The port's scene recipes: the bench scenes and packs of the CUDA card
tests and of README's examples, each built from a seed on a given device.

``build_main_path`` gives bench.py's four SpatialScenes of Sine voices
(``build_spatial`` the buffered and seek ones); ``build_mixer_agc`` the
config-5 mixer (BASELINE config 5's scene) and ``build_host_pools`` the
host-pool scene (Speed(Stream) voices in the host buffered pool,
Adapt(Stream) in the device-resident one and a config-5 submix), with
``build_mixer_host_pools`` its Mixer form; ``build_config5_pack``,
``build_spatial_pack``, ``build_host_pools_pack`` and
``build_sampler_pack`` the ScenePacks; ``build_densemix``,
``build_sampler`` and ``build_wavetable`` BASELINE configs 4 and 2 and
the wavetable line; ``build_seek_sampler``, ``build_spatial_sampler``
and ``build_seek_chains`` the sampler scenes of the seek and buffered
pools; ``build_checkpoint_scene`` a scene with control events queued for
a snapshot.  ``feed`` writes stream PCM.  Timing lives in
``benchmark/``.
"""

from __future__ import annotations

import numpy as np

import oddio_tpu_torch as pt
from oddio_tpu_torch.mixer import DEFAULT_CAPACITY

__all__ = ["build_spatial", "build_main_path", "MAIN_PATH", "BUCKETS", "build_mixer_agc",
           "build_host_pools", "build_config5_pack",
           "build_pack_scene", "build_spatial_pack", "build_densemix", "densemix_voice",
           "build_wavetable", "wavetable_frames", "wavetable_voice",
           "build_sampler", "SamplerDriver", "build_seek_sampler", "build_sampler_pack",
           "build_spatial_sampler", "build_seek_chains", "SpatialDriver",
           "build_host_pools_pack", "build_mixer_host_pools", "PackDriver",
           "build_checkpoint_scene", "feed"]

RATE = 48000
BLOCK = 512
#: bench.py's dispatch-size buckets (``bench.py:75``: 1504, CHUNK = 47, 46,
#: 12, 3, 1), with which it renders the dense mix and the wavetable
BUCKETS = (1504, 47, 46, 12, 3, 1)


def build_spatial(buffered, voices, device):
    """bench.py's ``build_spatial``: Sine voices at realistic spreads,
    all ``play_buffered()`` (delay-ring pool) or all ``play()`` (seek
    pool), drawn from seed 0.  Returns ``(control, scene)``."""
    control, scene, _ = build_main_path("buffered" if buffered else "seek", voices, device)
    return control, scene


#: the main path's scenes (bench.py's SpatialScene cells)
MAIN_PATH = ("seek", "buffered", "buffered_mixed", "subpass")


def build_main_path(kind, voices, device, seed=0):
    """One of bench.py's SpatialScenes of Sine voices, drawn from ``seed``:
    "seek" (``play()``, +-30 m, +-5 m/s), "buffered" (``play_buffered()``,
    +-15 m, +-0.2 m/s: ``build_spatial``), "buffered_mixed" (buffered at
    the seek scene's spread and speeds, so voices cross the max_delay*c
    clamp and the family sub-pass list changes, bench.py:266) and
    "subpass" (buffered, the first 64 voices 100-150 m out on each axis,
    offset-clamped, the rest +-15 m at +-0.05 m/s, bench.py:224).  Every
    buffered voice has max_distance 50 m and a 0.1 s buffer.  Returns
    ``(control, scene, handles)``."""
    if kind not in MAIN_PATH:
        raise ValueError(f"unknown main-path scene {kind!r}; one of {MAIN_PATH}")
    rng = np.random.default_rng(seed)
    control, scene = pt.SpatialScene.new(initial_capacity=voices, device=device)
    handles = []
    for i in range(voices):
        sig = pt.Sine(rng.uniform(0, 6), rng.uniform(100, 2000))
        if kind == "buffered":
            opts = pt.SpatialOptions(position=rng.uniform(-15, 15, 3),
                                     velocity=rng.uniform(-0.2, 0.2, 3))
        elif kind == "subpass" and i < 64:
            opts = pt.SpatialOptions(
                position=rng.uniform(100, 150, 3) * rng.choice([-1.0, 1.0], 3))
        elif kind == "subpass":
            opts = pt.SpatialOptions(position=rng.uniform(-15, 15, 3),
                                     velocity=rng.uniform(-0.05, 0.05, 3))
        else:
            opts = pt.SpatialOptions(position=rng.uniform(-30, 30, 3),
                                     velocity=rng.uniform(-5, 5, 3))
        if kind == "seek":
            handles.append(control.play(sig, opts))
        else:
            handles.append(control.play_buffered(sig, opts, max_distance=50.0, rate=RATE,
                                                 buffer_duration=0.1))
    return control, scene, handles


#: samples each config-5 stream is prefilled with: 0.3 s at 8 kHz
FILL = 2400


def build_mixer_agc(voices, device, seed=0):
    """BASELINE config 5's scene (``bench.py:324-356`` ``_build_pack``) as one
    ``Mixer`` of ``voices`` voices: the first eighth ``Adapt(Stream)``, the
    rest ``Adapt(Sine)``.  Streams are ``Stream(8000, FILL + 128,
    max_write_per_block=FILL)`` prefilled with FILL samples of N(0, 0.1²)
    PCM; sines have phases uniform in [0, 6) and frequencies uniform in
    [50, 2000) Hz; every Adapt has ``AdaptOptions(tau=0.1, max_gain=4.0)``
    and initial rms 0.1; all drawn from ``seed``.  Renders at 48 kHz.
    Returns ``(control, mixer, stream_controls, rng)``; ``rng`` continues
    the draws (for ``feed``)."""
    rng = np.random.default_rng(seed)
    ns = voices // 8
    mixer = pt.Mixer(1, initial_capacity=max(ns, 1), device=device)
    control = pt.MixerControl(mixer)
    ctls = []
    for i in range(voices):
        opt = pt.AdaptOptions(tau=0.1, max_gain=4.0)
        if i < ns:
            stream = pt.Stream(8000, FILL + 128, max_write_per_block=FILL)
            ctls.append(stream.control)
            control.play(pt.Adapt(stream, 0.1, opt))
        else:
            control.play(pt.Adapt(
                pt.Sine(rng.uniform(0, 6), rng.uniform(50, 2000)), 0.1, opt
            ))
    feed(ctls, rng, FILL)
    return control, mixer, ctls, rng


def build_host_pools(voices, device, seed=0, dr_voices=None, submix_voices=None,
                     handles=None):
    """A scene that exercises every buffered pool kind at once, at 48 kHz:
    ``voices`` ``Speed(Stream)`` voices (speeds uniform in [0.8, 1.25];
    Speed over a Stream is not device-resident capable, so they take the
    host buffered pool: K4 ring writes, K5 reads), ``dr_voices`` (default
    ``voices // 8``) ``Adapt(Stream)`` voices (tau 0.1 s, max_gain 4) in the
    device-resident buffered pool, and one ``build_mixer_agc`` mixer of
    ``submix_voices`` voices (default ``max(voices // 16, 64)``) played as a
    submix (the singleton pool).  Streams are config 5's: ``Stream(8000,
    FILL + 128, max_write_per_block=FILL)`` prefilled with FILL samples of
    N(0, 0.1²) PCM.  Voices sit uniformly in [-15, 15]³ m moving at up to
    0.2 m/s per axis, ``max_distance`` 50 m, ``buffer_duration`` 0.1 s.
    All drawn from ``seed``.  Returns ``(control, scene, stream_controls,
    speed_controls, rng)``; ``stream_controls`` covers every stream,
    the submix's included, and ``rng`` continues the draws (for
    ``feed``).  A list given as ``handles`` receives the Speed(Stream)
    voices' ``Spatial`` handles, then the Adapt(Stream) voices'."""
    rng = np.random.default_rng(seed)
    nd = voices // 8 if dr_voices is None else dr_voices
    ns = max(voices // 16, 64) if submix_voices is None else submix_voices
    # the device-resident pool holds exactly its voices; the host pool
    # doubles up to its own
    control, scene = pt.SpatialScene.new(initial_capacity=max(nd, 1), device=device)
    ctls, speeds = [], []

    def opts():
        return pt.SpatialOptions(position=rng.uniform(-15, 15, 3),
                                 velocity=rng.uniform(-0.2, 0.2, 3))

    kw = dict(max_distance=50.0, rate=RATE, buffer_duration=0.1)
    for _ in range(voices):
        stream = pt.Stream(8000, FILL + 128, max_write_per_block=FILL)
        sc, sp = pt.Speed.new(stream)
        sc.set_speed(rng.uniform(0.8, 1.25))
        h = control.play_buffered(sp, opts(), **kw)
        ctls.append(stream.control)
        speeds.append(sc)
        if handles is not None:
            handles.append(h)
    for _ in range(nd):
        stream = pt.Stream(8000, FILL + 128, max_write_per_block=FILL)
        h = control.play_buffered(
            pt.Adapt(stream, 0.1, pt.AdaptOptions(tau=0.1, max_gain=4.0)), opts(), **kw
        )
        ctls.append(stream.control)
        if handles is not None:
            handles.append(h)
    feed(ctls, rng, FILL)
    _, mixer, mctls, _ = build_mixer_agc(ns, device, seed + 1)  # prefilled
    control.play_buffered(mixer, opts(), **kw)
    return control, scene, ctls + mctls, speeds, rng


def build_mixer_host_pools(voices, device, seed=0, submix_voices=256):
    """The Mixer's host pools: ``voices`` ``Speed(Stream)`` voices in a mono
    Mixer's host ``Pool`` (speeds uniform in [0.8, 1.25]; config 5's
    streams, ``Stream(8000, FILL + 128, max_write_per_block=FILL)``
    prefilled with FILL samples of N(0, 0.1²) PCM) and one
    ``build_mixer_agc`` mixer of ``submix_voices`` voices played as a
    submix (its ``PoolSingleton``), all drawn from ``seed``, at 48 kHz.
    Returns ``(control, mixer, stream_controls, speed_controls, rng)``;
    ``stream_controls`` covers the submix's streams too, and ``rng``
    continues the draws (for ``feed``)."""
    rng = np.random.default_rng(seed)
    mixer = pt.Mixer(1, initial_capacity=max(voices, 1), device=device)
    control = pt.MixerControl(mixer)
    ctls, speeds = [], []
    for _ in range(voices):
        stream = pt.Stream(8000, FILL + 128, max_write_per_block=FILL)
        sc, sp = pt.Speed.new(stream)
        sc.set_speed(rng.uniform(0.8, 1.25))
        control.play(sp)
        ctls.append(stream.control)
        speeds.append(sc)
    feed(ctls, rng, FILL)
    _, sub, mctls, _ = build_mixer_agc(submix_voices, device, seed + 1)  # prefilled
    control.play(sub)
    return control, mixer, ctls + mctls, speeds, rng


def _pack(scenes, device, mesh, **kw):
    """A ScenePack of ``scenes`` at 48 kHz on ``mesh``, by default 1 x 1 on
    ``device``."""
    from ..parallel.mesh import make_mesh
    from ..parallel.sharded import ScenePack

    return ScenePack(scenes, RATE, make_mesh(1, 1, [device]) if mesh is None else mesh, **kw)


def build_config5_pack(scenes, device, voices=256, seed=0, mesh=None):
    """BASELINE config 5 as a ScenePack (``bench.py:324-356``
    ``_build_pack``): ``scenes`` config-5 mixers of ``voices`` voices each
    (``build_mixer_agc``, scene s drawn from ``seed + s``: 1/8 Adapt(Stream)
    prefilled with FILL samples, the rest Adapt(Sine) at 50-2000 Hz, tau
    0.1 s, max_gain 4), built on ``device``, on ``mesh`` (default 1 x 1 on
    ``device``) at 48 kHz.  Returns ``(pack, stream_controls, rng)``."""
    mixers, ctls = [], []
    for s in range(scenes):
        _, mixer, c, rng = build_mixer_agc(voices, device, seed + s)
        mixers.append(mixer)
        ctls.extend(c)
    return _pack(mixers, device, mesh, scan_unroll=8), ctls, rng


def build_host_pools_pack(scenes, voices, device, seed=0, mesh=None, handles=None):
    """Every buffered pool kind per session: a ScenePack of ``scenes``
    ``build_host_pools(voices, dr_voices=voices // 8, submix_voices=64)``
    scenes, scene s drawn from ``seed + s``, on ``mesh`` (default 1 x 1 on
    ``device``) at 48 kHz.  Returns ``(pack, stream_controls,
    speed_controls, rng)`` (the last scene's ``rng``, which continues its
    draws, for ``feed``); a list given as ``handles`` receives each
    scene's voice handles in turn (``build_host_pools``)."""
    out, ctls, speeds = [], [], []
    for s in range(scenes):
        _, scene, c, sp, rng = build_host_pools(voices, device, seed + s,
                                                dr_voices=voices // 8, submix_voices=64,
                                                handles=handles)
        out.append(scene)
        ctls.extend(c)
        speeds.extend(sp)
    return _pack(out, device, mesh), ctls, speeds, rng


def build_pack_scene(device, seed, n_buffered=64, n_seek=192):
    """One spatial scene of ``__graft_entry__._build_scene``'s make-up:
    ``n_buffered`` buffered (delay-ring) Sine voices within 30 m moving at
    up to 10 m/s per axis, max_distance 50 m, buffer_duration 0.1 s, and
    ``n_seek`` seek (time-warp) Sine voices within 30 m; phases uniform in
    [0, 6), frequencies in [100, 2000) Hz; drawn from ``seed``; 48 kHz."""
    rng = np.random.default_rng(seed)
    control, scene = pt.SpatialScene.new(initial_capacity=n_buffered, device=device)
    for _ in range(n_buffered):
        control.play_buffered(
            pt.Sine(rng.uniform(0, 6), rng.uniform(100, 2000)),
            pt.SpatialOptions(position=rng.uniform(-30, 30, 3),
                              velocity=rng.uniform(-10, 10, 3)),
            max_distance=50.0, rate=RATE, buffer_duration=0.1,
        )
    for _ in range(n_seek):
        control.play(pt.Sine(rng.uniform(0, 6), rng.uniform(100, 2000)),
                     pt.SpatialOptions(position=rng.uniform(-30, 30, 3)))
    return scene


def build_spatial_pack(scenes, device, n_buffered=64, n_seek=192, seed=0, mesh=None):
    """A ScenePack of ``scenes`` ``build_pack_scene`` scenes, scene s drawn
    from ``seed + s``, on ``mesh`` (default 1 x 1 on ``device``) at 48
    kHz."""
    out = [build_pack_scene(device, seed + s, n_buffered, n_seek) for s in range(scenes)]
    return _pack(out, device, mesh)


def densemix_voice(rng):
    """A dense-mix voice: ``Gain(Sine)`` at a phase uniform in [0, 6), a
    frequency in [50, 4000) Hz and a gain in [-20, 0] dB; returns
    ``(gain_control, voice)``."""
    gc, g = pt.Gain.new(pt.Sine(rng.uniform(0, 6), rng.uniform(50, 4000)))
    gc.set_gain(rng.uniform(-20, 0))
    return gc, g


def build_densemix(voices, device, seed=0, capacity=DEFAULT_CAPACITY):
    """BASELINE config 4, ``bench.py:434``'s densemix scene: ``voices``
    ``densemix_voice``s in a mono Mixer under ``Tanh(Reinhard(mixer))``,
    drawn from ``seed``; its pools open at ``capacity`` voices.  Returns
    ``(chain, mixer, gain_controls, rng)``; ``rng`` continues the
    draws."""
    rng = np.random.default_rng(seed)
    mixer = pt.Mixer(1, initial_capacity=capacity, device=device)
    gcs = []
    for _ in range(voices):
        gc, g = densemix_voice(rng)
        gcs.append(gc)
        mixer.play(g)
    return pt.Tanh(pt.Reinhard(mixer)), mixer, gcs, rng


def wavetable_frames():
    """``bench.py:470``'s table: one cycle of a sine in 2048 samples, as
    ``Frames`` at 48 kHz (a new table in the sample arena)."""
    table = np.sin(np.linspace(0, 2 * np.pi, 2048, endpoint=False)).astype(np.float32)
    return pt.Frames.from_slice(RATE, table)


def wavetable_voice(frames, rng):
    """A wavetable voice: ``Speed(Cycle(frames))`` seeked uniform in [0,
    0.04) s; returns ``(speed_control, voice)``."""
    c = pt.Cycle(frames)
    c.seek(float(rng.uniform(0, 0.04)))
    return pt.Speed.new(c)


def build_wavetable(voices, device, seed=0, capacity=DEFAULT_CAPACITY, frames=None):
    """``bench.py:470``'s wavetable scene: ``voices`` ``wavetable_voice``s
    over ``frames`` (default a new ``wavetable_frames()``) in a mono Mixer
    whose pools open at ``capacity`` voices, drawn from ``seed``.  Returns
    ``(mixer, speed_controls, rng)``."""
    rng = np.random.default_rng(seed)
    frames = wavetable_frames() if frames is None else frames
    mixer = pt.Mixer(1, initial_capacity=capacity, device=device)
    scs = []
    for _ in range(voices):
        sc, sp = wavetable_voice(frames, rng)
        scs.append(sc)
        mixer.play(sp)
    return mixer, scs, rng


#: config 2's sounds: stereo, 44.1 kHz
SAMPLER_RATE = 44100


def build_sampler(voices, device, seed=0, sounds=8, seconds=10.0):
    """BASELINE config 2 at a sampler's width: ``sounds`` stereo ``Frames``
    of ``seconds`` at 44.1 kHz made from ``seed`` (a few partials and
    noise per channel), and ``voices`` ``Fader(Speed(FramesSignal))``
    voices in a stereo Mixer rendering at 48 kHz, each on a sound drawn
    uniformly, starting uniform in [0, seconds/2) s, at a speed uniform in
    [0.8, 1.25].  Returns a ``SamplerDriver``."""
    rng = np.random.default_rng(seed)
    return _sampler_scene(_sampler_sounds(rng, sounds, seconds), rng, voices, device,
                          seconds)


def _sampler_sounds(rng, sounds, seconds):
    """``sounds`` stereo ``Frames`` of ``seconds`` at 44.1 kHz drawn from
    ``rng``: a few partials and noise per channel."""
    n = int(seconds * SAMPLER_RATE)
    t = np.arange(n, dtype=np.float64) / SAMPLER_RATE
    frames = []
    for _ in range(sounds):
        data = np.empty((n, 2), np.float32)
        for c in range(2):
            f = rng.uniform(80, 2000, 3)
            x = sum(np.sin(2 * np.pi * fk * t + rng.uniform(0, 6)) for fk in f) / 3
            data[:, c] = 0.4 * x + 0.05 * rng.standard_normal(n)
        frames.append(pt.Frames.from_slice(SAMPLER_RATE, data))
    return frames


def _sampler_scene(frames, rng, voices, device, seconds, **script):
    """The config-2 Mixer over ``frames``, its voices drawn from ``rng``
    (``build_sampler``), with its ``SamplerDriver``."""
    control, mixer = pt.Mixer.new(channels=2, device=device)
    drv = SamplerDriver(mixer, frames, rng, seconds, **script)
    for _ in range(voices):
        sc, sp = drv.voice()
        fc, f = pt.Fader.new(sp)
        drv.speeds.append(sc)
        drv.faders.append(fc)
        control.play(f)
    return drv


#: the spatial samplers' sounds: mono, 44.1 kHz, 2.5 s, voices starting
#: in their first 2 s (they end, linger and are reclaimed inside a run)
SPATIAL_SECONDS, SPATIAL_START = 2.5, 2.0


def _mono_sounds(rng, sounds, seconds):
    """``sounds`` mono ``Frames`` of ``seconds`` at 44.1 kHz drawn from
    ``rng``: a few partials and noise."""
    n = int(seconds * SAMPLER_RATE)
    t = np.arange(n, dtype=np.float64) / SAMPLER_RATE
    frames = []
    for _ in range(sounds):
        f = rng.uniform(80, 2000, 3)
        x = sum(np.sin(2 * np.pi * fk * t + rng.uniform(0, 6)) for fk in f) / 3
        frames.append(pt.Frames.from_slice(SAMPLER_RATE, (0.4 * x + 0.05 * rng.standard_normal(n))
                                           .astype(np.float32)))
    return frames


def build_seek_sampler(voices, device, seed=0, sounds=8, seconds=10.0):
    """Sound effects placed in the world: ``voices`` mono ``FramesSignal``
    voices over ``sounds`` mono sounds of ``seconds`` at 44.1 kHz (a few
    partials and noise, from ``seed``), each starting uniform in [0,
    seconds/2) s, played at positions within 15 m and velocities up to
    5 m/s into a SpatialScene's device-resident seek pool (two ears: its
    warped read is 2*voices rows).  Returns ``(control, scene, handles,
    rng)``."""
    rng = np.random.default_rng(seed)
    frames = _mono_sounds(rng, sounds, seconds)
    control, scene = pt.SpatialScene.new(initial_capacity=voices, device=device)
    hs = []
    for _ in range(voices):
        sig = pt.FramesSignal(frames[int(rng.integers(sounds))],
                              float(rng.uniform(0, seconds / 2)))
        hs.append(control.play(sig, pt.SpatialOptions(position=rng.uniform(-15, 15, 3),
                                                      velocity=rng.uniform(-5, 5, 3))))
    return control, scene, hs, rng


class SpatialDriver:
    """A spatial scene of sampler voices and its control script (``tick``
    every 4 blocks): ``move``, ``set_motion`` on the next ``k`` voices (a
    smoothed move of up to 1 m, the first of them a discontinuous jump
    within 30 m), and every second tick ``retune``, ``set_speed`` on the
    next ``k`` Speed voices (uniform in [0.8, 1.25]) and ``fade_to`` a
    fresh ``Speed(FramesSignal)`` on the next ``k`` Fader voices over 0.05
    s; ``play(k)`` plays ``k`` more voices of the scene's growth kind.
    ``voices`` are the motion handles, ``pos`` their positions, ``speeds``
    the Speed handles (a speed of 5.0 steps past ``RESAMPLE_DSMAX``: the
    whole-arena gather)."""

    def __init__(self, scene, frames, rng, k, play):
        self.scene, self.frames, self.rng, self.k, self._play = scene, frames, rng, k, play
        self.voices, self.pos, self.speeds, self.faders = [], [], [], []
        self._next = {"voices": 0, "speeds": 0, "faders": 0}
        self.ticks = 0

    def add(self, handle, pos):
        self.voices.append(handle)
        self.pos.append(np.asarray(pos, np.float64))

    def source(self):
        """A ``Speed(FramesSignal)`` on a sound drawn uniformly, starting
        uniform in [0, SPATIAL_START) s, at a speed uniform in [0.8, 1.25]."""
        fr = self.frames[int(self.rng.integers(len(self.frames)))]
        sc, sp = pt.Speed.new(pt.FramesSignal(fr, float(self.rng.uniform(0, SPATIAL_START))))
        sc.set_speed(float(self.rng.uniform(0.8, 1.25)))
        return sc, sp

    def _take(self, name):
        items = getattr(self, name)
        if not items:
            return []
        i0 = self._next[name]
        idx = [(i0 + j) % len(items) for j in range(min(self.k, len(items)))]
        self._next[name] = (i0 + len(idx)) % len(items)
        return idx

    def move(self):
        rng = self.rng
        for j, i in enumerate(self._take("voices")):
            if j == 0:
                self.pos[i] = rng.uniform(-30, 30, 3)
                self.voices[i].set_motion(self.pos[i], rng.uniform(-5, 5, 3), True)
            else:
                self.pos[i] = self.pos[i] + rng.uniform(-1, 1, 3)
                self.voices[i].set_motion(self.pos[i], rng.uniform(-5, 5, 3), False)

    def retune(self):
        for i in self._take("speeds"):
            self.speeds[i].set_speed(float(self.rng.uniform(0.8, 1.25)))
        for i in self._take("faders"):
            self.faders[i].fade_to(self.source()[1], 0.05)

    def tick(self):
        self.move()
        if self.ticks % 2 == 0:
            self.retune()
        self.ticks += 1

    def play(self, k):
        for _ in range(k):
            self._play(self)


def build_spatial_sampler(voices, device, seed=0, sounds=8, capacity=512, k=64):
    """Sound effects placed in the world with propagation delay and
    doppler, at bench.py's spatial width: ``voices`` voices played with
    ``play_buffered(max_distance=100, rate=48000, buffer_duration=0.1)``
    into a SpatialScene's device-resident buffered pools, opened at
    ``capacity`` voices each: half ``FramesSignal``, a quarter
    ``Speed(FramesSignal)``, an eighth ``Fader(Speed(FramesSignal))`` and an
    eighth ``Cycle`` over bench.py's wavetable (``wavetable_frames``,
    seeked uniform in [0, 0.04) s).  The FramesSignal voices draw from
    ``sounds`` mono sounds of 2.5 s at 44.1 kHz (from ``seed``), each
    starting uniform in [0, 2) s at a speed uniform in [0.8, 1.25] (Speed
    voices); positions uniform within 30 m, velocities within 5 m/s a
    component.  Returns a ``SpatialDriver`` (``k`` handles a tick; its
    ``play`` adds Cycle voices)."""
    rng = np.random.default_rng(seed)
    frames = _mono_sounds(rng, sounds, SPATIAL_SECONDS)
    table = wavetable_frames()
    control, scene = pt.SpatialScene.new(initial_capacity=capacity, device=device)

    def play(drv, kind="cycle"):
        pos, vel = rng.uniform(-30, 30, 3), rng.uniform(-5, 5, 3)
        if kind == "frames":
            fr = frames[int(rng.integers(sounds))]
            sig = pt.FramesSignal(fr, float(rng.uniform(0, SPATIAL_START)))
        elif kind == "speed":
            sc, sig = drv.source()
            drv.speeds.append(sc)
        elif kind == "fader":
            sc, sp = drv.source()
            drv.speeds.append(sc)
            fc, sig = pt.Fader.new(sp)
            drv.faders.append(fc)
        else:
            sig = pt.Cycle(table)
            sig.seek(float(rng.uniform(0, 0.04)))
        drv.add(control.play_buffered(sig, pt.SpatialOptions(position=pos, velocity=vel),
                                      max_distance=100.0, rate=RATE, buffer_duration=0.1), pos)

    drv = SpatialDriver(scene, frames, rng, k, play)
    for kind, share in (("frames", 2), ("speed", 4), ("fader", 8), ("cycle", 8)):
        for _ in range(voices // share):
            play(drv, kind)
    return drv


def build_seek_chains(voices, device, seed=0, sounds=8, capacity=1024, k=64):
    """Wavetable and limited voices placed with ``play()``: ``voices``
    voices in a SpatialScene's device-resident seek pools, opened at
    ``capacity`` voices each: half ``Cycle`` over bench.py's wavetable
    (seeked uniform in [0, 0.04) s), a quarter ``FixedGain(FramesSignal)``
    (-12 to 0 dB, on ``sounds`` mono sounds of 2.5 s at 44.1 kHz from
    ``seed``, starting uniform in [0, 2) s) and a quarter
    ``Tanh(FixedGain(Sine))`` (0 to 12 dB into the limiter, 50-2000 Hz);
    positions uniform within 30 m, velocities within 5 m/s a component.
    Returns a ``SpatialDriver`` (``k`` handles a tick; its ``play`` adds
    Tanh voices)."""
    rng = np.random.default_rng(seed)
    frames = _mono_sounds(rng, sounds, SPATIAL_SECONDS)
    table = wavetable_frames()
    control, scene = pt.SpatialScene.new(initial_capacity=capacity, device=device)

    def play(drv, kind="tanh"):
        pos, vel = rng.uniform(-30, 30, 3), rng.uniform(-5, 5, 3)
        if kind == "cycle":
            sig = pt.Cycle(table)
            sig.seek(float(rng.uniform(0, 0.04)))
        elif kind == "frames":
            fr = frames[int(rng.integers(sounds))]
            sig = pt.FixedGain(pt.FramesSignal(fr, float(rng.uniform(0, SPATIAL_START))),
                               float(rng.uniform(-12, 0)))
        else:
            sig = pt.Tanh(pt.FixedGain(pt.Sine(rng.uniform(0, 6), rng.uniform(50, 2000)),
                                       float(rng.uniform(0, 12))))
        drv.add(control.play(sig, pt.SpatialOptions(position=pos, velocity=vel)), pos)

    drv = SpatialDriver(scene, frames, rng, k, play)
    for kind, share in (("cycle", 2), ("frames", 4), ("tanh", 4)):
        for _ in range(voices // share):
            play(drv, kind)
    return drv


def build_sampler_pack(scenes, voices, device, seed=0, sounds=8, seconds=10.0, mesh=None):
    """BASELINE config 2 per session: a ScenePack of ``scenes`` sampler
    Mixers (``build_sampler``) of ``voices`` voices each, sharing one set of
    ``sounds`` stereo sounds drawn from ``seed``; scene s's voices and its
    own ``SamplerDriver`` script (every 8 blocks, ``voices // 8`` speed
    writes and as many 0.05 s fades) are drawn from ``seed + s``; on
    ``mesh`` (default 1 x 1 on ``device``).  Returns a ``PackDriver``."""
    frames = _sampler_sounds(np.random.default_rng(seed), sounds, seconds)
    drivers = [_sampler_scene(frames, np.random.default_rng(seed + s), voices, device,
                              seconds, k=max(voices // 8, 1))
               for s in range(scenes)]
    return PackDriver(_pack([d.mixer for d in drivers], device, mesh), drivers)


class PackDriver:
    """A ScenePack whose scenes each run their own control script (a
    ``SamplerDriver`` per scene), applied before every period of blocks."""

    def __init__(self, pack, drivers):
        self.pack, self.drivers = pack, drivers
        self.period = drivers[0].period

    def render(self, nblocks, device_out=True):
        """Render ``nblocks`` blocks of 512 frames; returns per period the
        pack's (1, B, S, C, n) device tensors, or numpy (S, B*n, C) with
        ``device_out`` False."""
        out = []
        for b0 in range(0, nblocks, self.period):
            for d in self.drivers:
                d.control()
            nb = min(self.period, nblocks - b0)
            if device_out:
                out.extend(self.pack.render_frames_device(BLOCK * nb))
            else:
                out.append(np.concatenate(
                    [self.pack.render_block(BLOCK) for _ in range(nb)], axis=1))
        return out

    def render_frames_device(self, total):
        return self.render(total // BLOCK)


class SamplerDriver:
    """The config-2 scene and its control script: every ``period`` blocks,
    ``set_speed`` (uniform in [0.8, 1.25]) on the next ``k`` voices, and
    ``fade_to`` a fresh ``Speed(FramesSignal)`` of the same archetype on
    the ``k`` after them, over ``fade`` seconds; voices taken in turn."""

    def __init__(self, mixer, frames, rng, seconds, k=64, period=8, fade=0.05):
        self.mixer, self.frames, self.rng, self.seconds = mixer, frames, rng, seconds
        self.k, self.period, self.fade = k, period, fade
        self.speeds, self.faders = [], []
        self._next = 0
        self.fades = 0

    def voice(self):
        fr = self.frames[int(self.rng.integers(len(self.frames)))]
        sc, sp = pt.Speed.new(pt.FramesSignal(fr, float(self.rng.uniform(0, self.seconds / 2))))
        sc.set_speed(float(self.rng.uniform(0.8, 1.25)))
        return sc, sp

    def _take(self):
        V = len(self.faders)
        idx = [(self._next + j) % V for j in range(min(self.k, V))]
        self._next = (self._next + len(idx)) % V
        return idx

    def control(self):
        """One period's control: the speed writes, then the fades (the
        faded-in voice's Speed handle replaces the voice's)."""
        for i in self._take():
            self.speeds[i].set_speed(float(self.rng.uniform(0.8, 1.25)))
        for i in self._take():
            sc, sp = self.voice()
            self.faders[i].fade_to(sp, self.fade)
            self.speeds[i] = sc
            self.fades += 1

    def render(self, renderer, nblocks, device_out=True):
        """Render ``nblocks`` blocks of 512 frames, the control script
        applied before each period; returns what the renderer returns per
        period (device tensors, or numpy with ``device_out`` False)."""
        out = []
        for b0 in range(0, nblocks, self.period):
            self.control()
            nb = min(self.period, nblocks - b0)
            if device_out:
                out.extend(renderer.render_frames_device(BLOCK * nb, sync=False))
            else:
                out.append(renderer.render_frames(BLOCK * nb))
        return out


def build_checkpoint_scene(kind, voices, device, **sampler_kw):
    """A scene with control events queued for a snapshot: ``kind`` is
    "buffered" (``build_spatial``; a ``play_buffered`` and a
    ``set_motion`` queued), "mixer" (``build_mixer_agc``; stream PCM
    written, not ingested), "hostpools" (``build_host_pools``; a
    ``set_speed`` and PCM queued) or "sampler" (``build_sampler`` with
    ``sampler_kw``; fades in flight and fades queued behind them).  Renders 2 blocks, issues the first controls,
    renders 1 block, queues the rest; returns ``(engine, renderer)``."""
    if kind == "buffered":
        control, eng = build_spatial(True, voices, device)
        kw = dict(max_distance=50.0, rate=RATE, buffer_duration=0.1)
        first = lambda: control.play_buffered(  # noqa: E731
            pt.Sine(0.1, 300.0), pt.SpatialOptions(position=[2.0, 0.0, 0.0]), **kw)

        def rest(h):
            control.play_buffered(pt.Sine(0.3, 700.0),
                                  pt.SpatialOptions(position=[4.0, 1.0, 0.0]), **kw)
            h.set_motion([1.0, 2.0, -3.0], [0.5, 0.0, 0.0], False)
    elif kind == "mixer":
        _, eng, ctls, rng = build_mixer_agc(voices, device)
        first = lambda: None  # noqa: E731
        rest = lambda _: feed(ctls, rng, 700)  # noqa: E731
    elif kind == "hostpools":
        _, eng, ctls, speeds, rng = build_host_pools(voices, device)
        first = lambda: feed(ctls, rng, 300)  # noqa: E731

        def rest(_):
            speeds[1].set_speed(1.15)
            feed(ctls, rng, 500)
    elif kind == "sampler":
        drv = build_sampler(voices, device, **sampler_kw)
        eng = drv.mixer
        first = drv.control  # speed writes, and fades in flight after a block

        def rest(_):
            for i in drv._take():  # a fade queued behind each one in flight
                drv.faders[(i - drv.k) % len(drv.faders)].fade_to(drv.voice()[1], 0.05)
    else:
        raise ValueError(f"no checkpoint scene {kind!r}")
    r = pt.Renderer(eng, RATE)
    r.render_frames(2 * BLOCK)
    h = first()
    r.render_frames(BLOCK)
    rest(h)
    return eng, r


def feed(ctls, rng, k):
    """Write ``k`` more N(0, 0.1²) samples to every stream (as many as each
    has room for); returns the samples each took."""
    pcm = (rng.standard_normal((len(ctls), k)) * 0.1).astype(np.float32)
    return [c.write(x) for c, x in zip(ctls, pcm)]
