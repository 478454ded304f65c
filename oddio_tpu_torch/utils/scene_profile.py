"""Where a block's time goes on a CUDA card: the bench scenes at 4096 voices
through ``Renderer.render_frames_device``, timed and traced.

    python -m oddio_tpu_torch.utils.scene_profile [buffered|seek|mixer|hostpools|pack|pack256|spatialpack ...]

For the buffered and the seek scene (``bench.py``'s ``build_spatial``,
4096 voices), the AGC mixer scene (``build_mixer_agc``, BASELINE config
5's scene at 4096 voices) and the host-pool scene (``build_host_pools``:
4096 Speed(Stream) voices in the host buffered pool, 512 Adapt(Stream) in
the device-resident one and a 256-voice config-5 submix), and the
ScenePacks (``build_config5_pack``: BASELINE config 5's 256 x 256 pack at
16 scenes, bench.py's ``scenepack_xrt`` line, as ``pack``, and at its
stated 256 scenes as ``pack256``; ``build_spatial_pack``: 16 scenes of 64
buffered + 192 seek Sine voices, as ``spatialpack``) it
prints, for each of three timed 188-block
runs, the wall time per 512-frame block, the host time per block spent in
the engine's ``host_prepare`` and the real-time factor (xRT, after
``torch.cuda.synchronize()``; for a pack, per scene: one scene's audio
seconds per wall second, as bench.py counts it); then, for one 47-block run under
``torch.profiler``, the device kernel time per block, the device's busy
share of the wall time (kernel time / wall time), the device kernels per
block, the kernels with the most device time and the host-side torch ops
with the most self time.  The mixer and host-pool scenes' streams get 1024
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

__all__ = ["build_spatial", "build_mixer_agc", "build_host_pools", "build_config5_pack",
           "build_pack_scene", "build_spatial_pack", "feed", "card_line", "main"]

RATE = 48000
BLOCK = 512
VOICES = 4096
BLOCKS = 188  # 2.005 s of audio per timed run
RUNS = 3
TOP = 12  # kernels and host ops listed per scene


def build_spatial(buffered, voices, device):
    """bench.py's ``build_spatial``: Sine voices at realistic spreads,
    all ``play_buffered()`` (delay-ring pool) or all ``play()`` (seek
    pool), drawn from seed 0.  Returns ``(control, scene)``."""
    rng = np.random.default_rng(0)
    control, scene = pt.SpatialScene.new(initial_capacity=voices, device=device)
    for _ in range(voices):
        sig = pt.Sine(rng.uniform(0, 6), rng.uniform(100, 2000))
        if buffered:
            opts = pt.SpatialOptions(position=rng.uniform(-15, 15, 3),
                                     velocity=rng.uniform(-0.2, 0.2, 3))
            control.play_buffered(sig, opts, max_distance=50.0, rate=RATE,
                                  buffer_duration=0.1)
        else:
            opts = pt.SpatialOptions(position=rng.uniform(-30, 30, 3),
                                     velocity=rng.uniform(-5, 5, 3))
            control.play(sig, opts)
    return control, scene


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


def build_host_pools(voices, device, seed=0, dr_voices=None, submix_voices=None):
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
    ``feed``)."""
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
        control.play_buffered(sp, opts(), **kw)
        ctls.append(stream.control)
        speeds.append(sc)
    for _ in range(nd):
        stream = pt.Stream(8000, FILL + 128, max_write_per_block=FILL)
        control.play_buffered(
            pt.Adapt(stream, 0.1, pt.AdaptOptions(tau=0.1, max_gain=4.0)), opts(), **kw
        )
        ctls.append(stream.control)
    feed(ctls, rng, FILL)
    _, mixer, mctls, _ = build_mixer_agc(ns, device, seed + 1)  # prefilled
    control.play_buffered(mixer, opts(), **kw)
    return control, scene, ctls + mctls, speeds, rng


def build_config5_pack(scenes, device, voices=256, seed=0):
    """BASELINE config 5 as a ScenePack (``bench.py:324-356``
    ``_build_pack``): ``scenes`` config-5 mixers of ``voices`` voices each
    (``build_mixer_agc``, scene s drawn from ``seed + s``: 1/8 Adapt(Stream)
    prefilled with FILL samples, the rest Adapt(Sine) at 50-2000 Hz, tau
    0.1 s, max_gain 4), on a 1 x 1 mesh at 48 kHz.  Returns ``(pack,
    stream_controls, rng)``."""
    from ..parallel.mesh import make_mesh
    from ..parallel.sharded import ScenePack

    mixers, ctls = [], []
    for s in range(scenes):
        _, mixer, c, rng = build_mixer_agc(voices, device, seed + s)
        mixers.append(mixer)
        ctls.extend(c)
    return ScenePack(mixers, RATE, make_mesh(1, 1), scan_unroll=8), ctls, rng


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


def build_spatial_pack(scenes, device, n_buffered=64, n_seek=192, seed=0):
    """A ScenePack of ``scenes`` ``build_pack_scene`` scenes, scene s drawn
    from ``seed + s``, on a 1 x 1 mesh at 48 kHz."""
    from ..parallel.mesh import make_mesh
    from ..parallel.sharded import ScenePack

    out = [build_pack_scene(device, seed + s, n_buffered, n_seek) for s in range(scenes)]
    return ScenePack(out, RATE, make_mesh(1, 1))


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


def _run(renderer, nblocks):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # a Renderer skips its handle readback; a ScenePack starts none
    kw = {"sync": False} if isinstance(renderer, pt.Renderer) else {}
    renderer.render_frames_device(BLOCK * nblocks, **kw)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def profile_scene(label):
    nblocks = BLOCKS
    before = None
    if label in ("pack", "pack256"):
        r, ctls, rng = build_config5_pack(16 if label == "pack" else 256, "cuda")

        def before():
            feed(ctls, rng, 1024)
    elif label == "spatialpack":
        r = build_spatial_pack(16, "cuda")
    elif label == "mixer":
        _, scene, ctls, rng = build_mixer_agc(VOICES, "cuda")

        def before():
            feed(ctls, rng, 1024)
    elif label == "hostpools":
        _, scene, ctls, _, rng = build_host_pools(VOICES, "cuda")

        def before():
            feed(ctls, rng, 1024)
    else:
        _, scene = build_spatial(label == "buffered", VOICES, "cuda")
    if label in ("pack", "pack256", "spatialpack"):
        spent = _timed_prepare(r.scenes)
    else:
        spent = _timed_prepare([scene])
        r = pt.Renderer(scene, RATE)
    _run(r, nblocks // 2)  # warm-up
    for _ in range(RUNS):
        spent[0] = 0.0
        if before is not None:
            before()
        wall = _run(r, nblocks)
        print(f"{label}: wall/block {1e3 * wall / nblocks:.3f} ms, "
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
    print(f"{label} traced: wall {1e3 * wall:.1f} ms for {ntr} blocks; device kernel "
          f"time {dev_ms:.3f} ms ({dev_ms / ntr:.4f} ms/block), busy share "
          f"{dev_ms / (1e3 * wall):.3f}, device kernels/block "
          f"{sum(kern_n.values()) / ntr:.1f}")
    if not kern_n:
        print(f"{label} traced: the profiler saw no device kernels")
    for name, us in kern_us.most_common(TOP):
        print(f"  {us / ntr:10.2f} us/block  x{kern_n[name] / ntr:5.1f}  {name[:90]}")
    cpu = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CPU]
    cpu.sort(key=lambda e: e.self_cpu_time_total, reverse=True)
    for e in cpu[:TOP]:
        print(f"  cpu {e.self_cpu_time_total / ntr:10.2f} us/block  "
              f"x{e.count / ntr:5.1f}  {e.key}")


SCENES = ("buffered", "seek", "mixer", "hostpools", "pack", "pack256", "spatialpack")


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
