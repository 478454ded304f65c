"""Where a block's time goes on a CUDA card: the bench scenes at 4096 voices
through ``Renderer.render_frames_device``, timed and traced.

    python -m oddio_tpu_torch.utils.scene_profile

For the buffered and the seek scene (``bench.py``'s ``build_spatial``,
4096 voices) it prints, for each of three timed 188-block runs, the wall
time per 512-frame block, the host time per block spent in
``SpatialScene.host_prepare`` and the real-time factor (xRT, after
``torch.cuda.synchronize()``); then, for one 47-block run under
``torch.profiler``, the device kernel time per block, the device's busy
share of the wall time (kernel time / wall time), the device kernels per
block, the kernels with the most device time and the host-side torch ops
with the most self time.  The card's name and power limit head the
output.
"""

from __future__ import annotations

import collections
import subprocess
import time

import numpy as np
import torch

import oddio_tpu_torch as pt

__all__ = ["build_spatial", "card_line", "main"]

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


def card_line():
    """``name, power limit`` of card 0, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def _timed_prepare(scene):
    """Wrap ``scene.host_prepare`` to add its host seconds to a list."""
    spent = [0.0]
    inner = scene.host_prepare

    def host_prepare(*a, **kw):
        t0 = time.perf_counter()
        try:
            return inner(*a, **kw)
        finally:
            spent[0] += time.perf_counter() - t0

    scene.host_prepare = host_prepare
    return spent


def _run(renderer, nblocks):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    renderer.render_frames_device(BLOCK * nblocks, sync=False)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def profile_scene(label, buffered):
    nblocks = BLOCKS
    _, scene = build_spatial(buffered, VOICES, "cuda")
    spent = _timed_prepare(scene)
    r = pt.Renderer(scene, RATE)
    _run(r, nblocks // 2)  # warm-up
    for _ in range(RUNS):
        spent[0] = 0.0
        wall = _run(r, nblocks)
        print(f"{label}: wall/block {1e3 * wall / nblocks:.3f} ms, "
              f"host_prepare/block {1e3 * spent[0] / nblocks:.3f} ms, "
              f"xRT {nblocks * BLOCK / RATE / wall:.2f}")
    ntr = max(nblocks // 4, 1)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("scene_profile: needs a CUDA card")
    print(f"card: {card_line()}")
    for label, buffered in (("buffered", True), ("seek", False)):
        profile_scene(label, buffered)


if __name__ == "__main__":
    main()
