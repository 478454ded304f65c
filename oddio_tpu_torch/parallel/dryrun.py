"""A dry run of a ScenePack on a mesh of ``n_devices`` cells, checked
against a checksum (the twin of ``__graft_entry__.py``'s
``dryrun_multichip``).

The mesh factors as the JAX dry run factors it: two scene groups where
``n_devices`` is even, the rest of the devices on the voice axis.  Each
scene holds 64 buffered and ``512*voice - 64`` seek Sine voices at 8 kHz
(512 voices a shard); the pack renders three blocks of 256 frames, with
16 seek plays and one buffered play per scene before the second (more
than ``k_play``, so the eager path runs too) and motion deltas before the
third.  Every block is held against the same scripts through per-scene
one-device ``Renderer``s, within ``TOL``; after ``sync`` the first play's
handle must not be finished.  The scenes declare ``graph_capture``, so the
pack takes block steps, each cell its own (on a card, CUDA graphs).
``dryrun_multichip(8, ["cpu"] * 8)`` runs it on a logical 8-cell mesh on
the CPU.
"""

from __future__ import annotations

import numpy as np

__all__ = ["dryrun_multichip", "TOL"]

#: max |pack - per-scene Renderers| allowed
TOL = 2e-6
RATE = 8000
BLOCK = 256


def _build_scene(n_buffered, n_seek, device, capacity):
    """``__graft_entry__._build_scene``: ``n_buffered`` buffered Sine
    voices within 30 m moving at up to 10 m/s per axis and ``n_seek`` seek
    Sine voices within 30 m, drawn from seed 0, at 8 kHz."""
    from .. import Sine, SpatialOptions, SpatialScene

    rng = np.random.default_rng(0)
    control, scene = SpatialScene.new(initial_capacity=capacity, device=device)
    for _ in range(n_buffered):
        control.play_buffered(
            Sine(rng.uniform(0, 6), rng.uniform(100, 2000)),
            SpatialOptions(position=rng.uniform(-30, 30, 3), velocity=rng.uniform(-10, 10, 3)),
            max_distance=50.0, rate=RATE, buffer_duration=0.1,
        )
    for _ in range(n_seek):
        control.play(Sine(rng.uniform(0, 6), rng.uniform(100, 2000)),
                     SpatialOptions(position=rng.uniform(-30, 30, 3)))
    return control, scene


def _launches():
    """Every kernel wrapper's launch count so far, by its counter's key."""
    from ..ops import agc, ring_kernels, stream_kernels

    return {**ring_kernels.LAUNCHES, **stream_kernels.LAUNCHES, **agc.LAUNCHES}


def _run(controls, render):
    """The dry run's script over ``controls``, rendering each block with
    ``render()``: (S, 3*BLOCK, 2) and the first play's handle."""
    from .. import Sine, SpatialOptions

    out = [render()]
    rng = np.random.default_rng(7)
    handles = []
    for control in controls:
        for _ in range(16):  # > k_play: the eager path too
            handles.append(control.play(
                Sine(rng.uniform(0, 6), rng.uniform(100, 2000)),
                SpatialOptions(position=rng.uniform(-30, 30, 3)),
            ))
        handles.append(control.play_buffered(
            Sine(0.0, 440.0),
            SpatialOptions(position=[1.0, 0.0, -1.0], velocity=[3.0, 0.0, 0.0]),
            max_distance=50.0, rate=RATE, buffer_duration=0.1,
        ))
    out.append(render())
    for h in handles[:len(controls)]:
        h.set_motion([5.0, 1.0, -2.0], [0.0, 0.0, 0.0], False)
    out.append(render())
    return np.concatenate(out, axis=1), handles[0]


def dryrun_multichip(n_devices, devices=None):
    """Render the dry run on a mesh of ``n_devices`` cells over
    ``devices`` (default: every CUDA card; repeats make a logical mesh);
    raises ``AssertionError`` if the pack leaves ``TOL`` of the per-scene
    Renderers, or on a non-finite or misshapen block.  Returns a summary
    dict, with the kernels the pack's three blocks launched
    (``pack_launches``, by the wrappers' counter keys)."""
    from ..core.run import Renderer
    from .mesh import make_mesh
    from .sharded import ScenePack

    n_devices = int(n_devices)
    scene_ax = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    voice_ax = n_devices // scene_ax
    mesh = make_mesh(scene_ax, voice_ax, devices)
    home = mesh.first
    cap = 512 * voice_ax
    S = max(2, scene_ax)

    built = [_build_scene(64, cap - 64, home, cap) for _ in range(S)]
    pack = ScenePack([b[1] for b in built], RATE, mesh)
    before = _launches()
    got, h0 = _run([b[0] for b in built], lambda: pack.render_block(BLOCK))
    launched = {k: v - before[k] for k, v in _launches().items()}
    pack.sync()
    finished = h0.is_finished()

    ref = [_build_scene(64, cap - 64, home, cap) for _ in range(S)]
    rs = [Renderer(scene, RATE) for _, scene in ref]
    want, _ = _run([c for c, _ in ref],
                   lambda: np.stack([np.asarray(r.render_block(BLOCK)) for r in rs]))

    assert got.shape == (S, 3 * BLOCK, 2), got.shape
    assert np.isfinite(got).all(), "non-finite samples"
    err = float(np.abs(got - want).max())
    assert err <= TOL, f"pack vs per-scene Renderers: max |diff| {err} > {TOL}"
    assert np.abs(want).max() > 1e-2, "silent reference"
    assert not finished, "the first play's handle finished"
    summary = {"mesh": f"{scene_ax}x{voice_ax}", "devices": [str(d) for r in mesh.devices for d in r],
               "scenes": S, "voices_per_scene": cap, "voices_per_shard": cap // voice_ax,
               "max_abs_diff": err, "checksum": float(np.abs(got).astype(np.float64).sum()),
               "pack_launches": {k: v for k, v in launched.items() if v}}
    return summary
