"""Where a block's time goes on a CUDA card: the bench scenes at 4096 voices
through ``Renderer.render_frames_device``, timed and traced.

    python -m oddio_tpu_torch.utils.scene_profile [buffered|seek|buffered_mixed|subpass|mixer|hostpools|pack|pack256|pack2x2|spatialpack|densemix|sampler|wavetable|seek_sampler|sampler_pack|hostpack|hostpack2x2|spatial_sampler|seek_chains|LABEL_eager ...]

For the main path's four scenes (``build_main_path``: bench.py's seek,
buffered, buffered_mixed and subpass scenes at 4096 voices), the AGC
mixer scene (``build_mixer_agc``, BASELINE config 5's scene at 4096
voices) and the host-pool scene (``build_host_pools``: 4096
Speed(Stream) voices in the host buffered pool, 512 Adapt(Stream) in
the device-resident one and a 256-voice config-5 submix; these
Renderers, and the packs below, replay CUDA graphs, and the ``_eager``
twins run under ``core.run.eager()``, op by op), and the
ScenePacks (``build_config5_pack``: BASELINE config 5's 256 x 256 pack at
16 scenes, bench.py's ``scenepack_xrt`` line, as ``pack``, and at its
stated 256 scenes as ``pack256``; ``build_spatial_pack``: 16 scenes of 64
buffered + 192 seek Sine voices, as ``spatialpack``), and the 1024-voice
scenes of BASELINE configs 4 and 2 and the wavetable line
(``build_densemix``, ``build_sampler`` with its control script of speed
writes and fades every 8 blocks, ``build_wavetable``; the dense mix and
the wavetable with bench.py's dispatch, ``scan_unroll`` 4 and
``BUCKETS`` for the dense mix, ``BUCKETS`` for the wavetable), the seek
sampler (``build_seek_sampler``: 1024 mono FramesSignal voices in a
SpatialScene's seek pool), the 4096-voice spatial sampler
(``build_spatial_sampler``: FramesSignal, Speed, Fader and Cycle voices
in device-resident buffered pools) and seek chains
(``build_seek_chains``: Cycle, FixedGain(FramesSignal) and
Tanh(FixedGain(Sine)) voices in device-resident seek pools), all
replaying CUDA graphs, with their ``_eager`` twins op by op, and the two
packs
of one session each (``build_sampler_pack``: 16 sampler scenes of 64
voices, each on its own script, as ``sampler_pack``, replaying graphs,
and ``sampler_pack_eager``;
``build_host_pools_pack``: 16 host-pool scenes of 256 voices, as
``hostpack``, replaying graphs, and ``hostpack_eager``), and two packs on
a logical 2 x 2 mesh of the card (``[cuda] * 4``; each cell replays its
own graphs): config 5 at its stated 256 scenes as ``pack2x2`` and the
host-pool pack 16 x 256 as ``hostpack2x2``, with their ``_eager`` twins,
it prints, for each of three timed 188-block
runs, the wall time per 512-frame block, the host time per block spent in
the engine's ``host_prepare`` and the real-time factor (xRT, after
``torch.cuda.synchronize()``; for a pack, per scene: one scene's audio
seconds per wall second, as bench.py counts it); then, for one 47-block run under
``torch.profiler``, the device kernel time per block, the device's busy
share of the wall time (kernel time / wall time), the device kernels per
block, the host-to-device copies from pageable memory per block, the
kernels with the most device time and the host-side torch ops with the
most self time.  The mixer and host-pool scenes' streams get 1024
new samples before each run, so the traced run includes an ingest block.
The card's name and power limit head the output.  With no arguments every
scene runs.
"""

from __future__ import annotations

import collections
import subprocess
import time

import numpy as np
import torch

import oddio_tpu_torch as pt
from oddio_tpu_torch.mixer import DEFAULT_CAPACITY

__all__ = ["build_spatial", "build_main_path", "MAIN_PATH", "BUCKETS", "build_mixer_agc",
           "build_host_pools", "build_config5_pack",
           "build_pack_scene", "build_spatial_pack", "build_densemix", "densemix_voice",
           "build_wavetable", "wavetable_frames", "wavetable_voice",
           "build_sampler", "SamplerDriver", "build_seek_sampler", "build_sampler_pack",
           "build_spatial_sampler", "build_seek_chains", "SpatialDriver",
           "build_host_pools_pack", "build_mixer_host_pools", "PackDriver",
           "build_checkpoint_scene", "feed", "card_line", "main"]

RATE = 48000
BLOCK = 512
VOICES = 4096
BLOCKS = 188  # 2.005 s of audio per timed run
RUNS = 3
TOP = 12  # kernels and host ops listed per scene
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
    """A scene of ``chip_smoke.py``'s phase 32 with control events queued
    for a snapshot: ``kind`` is "buffered" (``build_spatial``; a
    ``play_buffered`` and a ``set_motion`` queued), "mixer"
    (``build_mixer_agc``; stream PCM written, not ingested), "hostpools"
    (``build_host_pools``; a ``set_speed`` and PCM queued) or "sampler"
    (``build_sampler`` with ``sampler_kw``; fades in flight and fades
    queued behind them).  Renders 2 blocks, issues the first controls,
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


def card_line():
    """``name, power limit`` of card 0, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def _timed_prepare(scenes):
    """Wrap each scene's ``host_prepare`` to add its host seconds to one
    list."""
    spent = [0.0]
    for scene in scenes:
        inner = scene.host_prepare

        def host_prepare(*a, _inner=inner, **kw):
            t0 = time.perf_counter()
            try:
                return _inner(*a, **kw)
            finally:
                spent[0] += time.perf_counter() - t0

        scene.host_prepare = host_prepare
    return spent


class _Driven:
    """A Renderer whose ``render_frames_device`` runs a driver's control
    script (``SamplerDriver.render``)."""

    def __init__(self, renderer, driver):
        self.renderer, self.driver = renderer, driver

    def render_frames_device(self, total, sync=False):
        return self.driver.render(self.renderer, total // BLOCK)


def _run(renderer, nblocks):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # a Renderer skips its handle readback; a ScenePack starts none
    kw = {"sync": False} if isinstance(renderer, (pt.Renderer, _Driven)) else {}
    renderer.render_frames_device(BLOCK * nblocks, **kw)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def profile_scene(label):
    """Profile one scene; a label with ``_eager`` (``buffered_eager``,
    ``mixer_eager``, ``hostpools_eager``, ``pack_eager``,
    ``pack2x2_eager``, ``densemix_eager``, ``wavetable_eager``,
    ``sampler_eager``, ``seek_sampler_eager``, ``sampler_pack_eager``,
    ``hostpack_eager``, ``hostpack2x2_eager``, ``spatial_sampler_eager``,
    ``seek_chains_eager``)
    runs it under ``core.run.eager()``, op by op, where the plain label
    replays the Renderer's or the pack's CUDA graphs."""
    if label.endswith("_eager"):
        from ..core.run import eager

        with eager():
            return _profile_scene(label[: -len("_eager")], label)
    return _profile_scene(label, label)


def _logical_2x2():
    """A 2 x 2 mesh of logical devices on the card."""
    from ..parallel.mesh import make_mesh

    return make_mesh(2, 2, ["cuda"] * 4)


def _profile_scene(label, shown):
    nblocks = BLOCKS
    before = None
    kw = {}  # the Renderer's dispatch options
    if label in ("pack", "pack256", "pack2x2"):
        r, ctls, rng = build_config5_pack(16 if label == "pack" else 256, "cuda",
                                          mesh=_logical_2x2() if label == "pack2x2" else None)

        def before():
            feed(ctls, rng, 1024)
    elif label == "spatialpack":
        r = build_spatial_pack(16, "cuda")
    elif label == "sampler_pack":
        r = build_sampler_pack(16, 64, "cuda")
        scene = None
    elif label in ("hostpack", "hostpack2x2"):
        r, ctls, _, rng = build_host_pools_pack(
            16, 256, "cuda", mesh=_logical_2x2() if label == "hostpack2x2" else None)

        def before():
            feed(ctls, rng, 1024)
    elif label == "mixer":
        _, scene, ctls, rng = build_mixer_agc(VOICES, "cuda")

        def before():
            feed(ctls, rng, 1024)
    elif label == "hostpools":
        _, scene, ctls, _, rng = build_host_pools(VOICES, "cuda")

        def before():
            feed(ctls, rng, 1024)
    elif label == "densemix":
        scene, _, _, _ = build_densemix(1024, "cuda")
        kw = {"scan_unroll": 4, "scan_buckets": BUCKETS}
    elif label == "wavetable":
        scene, _, _ = build_wavetable(1024, "cuda")
        kw = {"scan_buckets": BUCKETS}
    elif label == "sampler":
        drv = build_sampler(1024, "cuda")
        scene = drv.mixer
    elif label == "seek_sampler":
        _, scene, _, _ = build_seek_sampler(1024, "cuda")
    elif label == "spatial_sampler":
        scene = build_spatial_sampler(VOICES, "cuda").scene
    elif label == "seek_chains":
        scene = build_seek_chains(VOICES, "cuda").scene
    else:
        _, scene, _ = build_main_path(label, VOICES, "cuda")
    if label == "sampler_pack":
        # the scenes' control scripts run inside the timed window
        spent = _timed_prepare(r.pack.scenes)
    elif label in ("pack", "pack256", "pack2x2", "spatialpack", "hostpack", "hostpack2x2"):
        spent = _timed_prepare(r.scenes)
    else:
        spent = _timed_prepare([scene])
        r = pt.Renderer(scene, RATE, **kw)
    if label == "sampler":
        # the control script runs inside the timed window (every 8 blocks)
        r = _Driven(r, drv)
    _run(r, nblocks // 2)  # warm-up
    for _ in range(RUNS):
        spent[0] = 0.0
        if before is not None:
            before()
        wall = _run(r, nblocks)
        print(f"{shown}: wall/block {1e3 * wall / nblocks:.3f} ms, "
              f"host_prepare/block {1e3 * spent[0] / nblocks:.3f} ms, "
              f"xRT {nblocks * BLOCK / RATE / wall:.2f}")
    ntr = max(nblocks // 4, 1)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    if before is not None:
        before()
    with torch.profiler.profile(activities=acts) as prof:
        wall = _run(r, ntr)
    kern_us = collections.Counter()
    kern_n = collections.Counter()
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kern_us[ev.name] += ev.time_range.elapsed_us()
            kern_n[ev.name] += 1
    dev_ms = sum(kern_us.values()) / 1e3
    pageable = sum(v for k, v in kern_n.items() if "Pageable" in k)
    print(f"{shown} traced: wall {1e3 * wall:.1f} ms for {ntr} blocks; device kernel "
          f"time {dev_ms:.3f} ms ({dev_ms / ntr:.4f} ms/block), busy share "
          f"{dev_ms / (1e3 * wall):.3f}, device kernels/block "
          f"{sum(kern_n.values()) / ntr:.1f}, pageable uploads/block {pageable / ntr:.1f}")
    if not kern_n:
        print(f"{shown} traced: the profiler saw no device kernels")
    for name, us in kern_us.most_common(TOP):
        print(f"  {us / ntr:10.2f} us/block  x{kern_n[name] / ntr:5.1f}  {name[:90]}")
    cpu = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CPU]
    cpu.sort(key=lambda e: e.self_cpu_time_total, reverse=True)
    for e in cpu[:TOP]:
        print(f"  cpu {e.self_cpu_time_total / ntr:10.2f} us/block  "
              f"x{e.count / ntr:5.1f}  {e.key}")


SCENES = ("buffered", "seek", "buffered_mixed", "subpass", "mixer", "hostpools", "pack",
          "pack256", "pack2x2", "spatialpack", "densemix", "sampler", "wavetable",
          "seek_sampler", "sampler_pack", "hostpack", "hostpack2x2", "spatial_sampler",
          "seek_chains") + tuple(
              f"{k}_eager" for k in MAIN_PATH + ("mixer", "hostpools", "pack", "pack256",
                                                 "pack2x2", "spatialpack", "densemix",
                                                 "wavetable", "sampler", "seek_sampler",
                                                 "sampler_pack", "hostpack", "hostpack2x2",
                                                 "spatial_sampler", "seek_chains"))


def main(argv=None):
    import sys

    labels = (sys.argv[1:] if argv is None else argv) or SCENES
    for label in labels:
        if label not in SCENES:
            raise SystemExit(f"scene_profile: unknown scene {label!r}; one of {SCENES}")
    if not torch.cuda.is_available():
        raise SystemExit("scene_profile: needs a CUDA card")
    print(f"card: {card_line()}")
    for label in labels:
        profile_scene(label)


if __name__ == "__main__":
    main()
