"""The host-pool scene (``scene_profile.build_host_pools`` at 64 voices:
64 Speed(Stream) voices in the host buffered pool, 8 Adapt(Stream) in the
device-resident one, a 64-voice config-5 submix) in the port and in the
JAX package, built by the same control script from the same draws, 8
blocks with a write and a speed change between.  Its three Adapt pools
render 513 frames a block, where the port takes the closed-form step
(``agc.agc_step``) and the JAX package its scan: within the PARITY.md
1e-5 (measured 9.0e-7).  The same pools against the exact oracle are in
``test_torch_host_pools.py`` (the DR Adapt(Stream) pool and the submix)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import oddio_tpu as ot  # noqa: E402
import oddio_tpu_torch as pt  # noqa: E402
from oddio_tpu_torch.utils.scene_profile import FILL, RATE  # noqa: E402

torch.set_num_threads(1)


def mixer_agc(m, voices, seed, kw):
    """``build_mixer_agc`` in package ``m``."""
    rng = np.random.default_rng(seed)
    ns = voices // 8
    mixer = m.Mixer(1, initial_capacity=max(ns, 1), **kw)
    control = m.MixerControl(mixer)
    ctls = []
    for i in range(voices):
        opt = m.AdaptOptions(tau=0.1, max_gain=4.0)
        if i < ns:
            stream = m.Stream(8000, FILL + 128, max_write_per_block=FILL)
            ctls.append(stream.control)
            control.play(m.Adapt(stream, 0.1, opt))
        else:
            control.play(m.Adapt(m.Sine(rng.uniform(0, 6), rng.uniform(50, 2000)), 0.1, opt))
    for c, x in zip(ctls, (rng.standard_normal((len(ctls), FILL)) * 0.1).astype(np.float32)):
        c.write(x)
    return mixer, ctls


def host_pools(m, voices=64, nd=8, ns=64, seed=0):
    """``build_host_pools`` in package ``m``: (scene, stream controls,
    speed controls, rng)."""
    kw = {"device": "cpu"} if m is pt else {}
    rng = np.random.default_rng(seed)
    control, scene = m.SpatialScene.new(initial_capacity=max(nd, 1), **kw)
    ctls, speeds = [], []

    def opts():
        return m.SpatialOptions(position=rng.uniform(-15, 15, 3),
                                velocity=rng.uniform(-0.2, 0.2, 3))

    k = dict(max_distance=50.0, rate=RATE, buffer_duration=0.1)
    for _ in range(voices):
        stream = m.Stream(8000, FILL + 128, max_write_per_block=FILL)
        sc, sp = m.Speed.new(stream)
        sc.set_speed(rng.uniform(0.8, 1.25))
        control.play_buffered(sp, opts(), **k)
        ctls.append(stream.control)
        speeds.append(sc)
    for _ in range(nd):
        stream = m.Stream(8000, FILL + 128, max_write_per_block=FILL)
        control.play_buffered(m.Adapt(stream, 0.1, m.AdaptOptions(tau=0.1, max_gain=4.0)),
                              opts(), **k)
        ctls.append(stream.control)
    for c, x in zip(ctls, (rng.standard_normal((len(ctls), FILL)) * 0.1).astype(np.float32)):
        c.write(x)
    mixer, mctls = mixer_agc(m, ns, seed + 1, kw)
    control.play_buffered(mixer, opts(), **k)
    return scene, ctls + mctls, speeds, rng


def test_host_pool_scene_matches_jax():
    outs = []
    for m in (ot, pt):
        scene, ctls, speeds, rng = host_pools(m)
        r = m.Renderer(scene, RATE)
        a = np.concatenate([np.asarray(r.render_block(512)) for _ in range(4)])
        for c, x in zip(ctls, (rng.standard_normal((len(ctls), 1024)) * 0.1).astype(np.float32)):
            c.write(x)
        speeds[0].set_speed(1.2)
        b = np.concatenate([np.asarray(r.render_block(512)) for _ in range(4)])
        outs.append(np.concatenate([a, b]))
    a, b = outs
    assert np.isfinite(b).all() and np.abs(b).max() > 0.05
    assert np.abs(a - b).max() <= 1e-5, np.abs(a - b).max()
