"""The port's SpatialScene against the exact numpy oracle
(tests/reference_impl.py) on a flyby and on bench.py's buffered scene, and
on a scene whose host plan lists family
sub-pass voices, against the JAX package — both to max |err| <= 1e-5 (the
PARITY.md contract)."""

import numpy as np
import pytest

import reference_impl as ref

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import oddio_tpu as ot  # noqa: E402
import oddio_tpu_torch as pt  # noqa: E402

torch.set_num_threads(1)

F = np.float32
TOL = 1e-5


@pytest.mark.parametrize("buffered", [False, True])
def test_golden_spatial_flyby_sine(buffered):
    """test_golden.py's small-block flyby, shortened, with a Sine source:
    one voice flying past a rotated listener, a motion update and then a
    discontinuous jump; both spatialization paths against the exact
    oracle."""
    RATE, BLOCK, NBLK = 8000, 512, 10
    pos, vel = [-20.0, 5.0, 0.0], [30.0, 0.0, 0.0]
    rot = [np.cos(0.15), 0.0, np.sin(0.15), 0.0]

    control, scene = pt.SpatialScene.new()
    sig = pt.Sine(0.3, 500.0)
    opts = pt.SpatialOptions(position=pos, velocity=vel)
    if buffered:
        h = control.play_buffered(sig, opts, max_distance=60.0, rate=RATE,
                                  buffer_duration=0.1)
    else:
        h = control.play(sig, opts)
    control.set_listener_rotation(rot)
    r = pt.Renderer(scene, RATE)

    oscene = ref.OSpatialScene(exact=True)
    osig = ref.OSine(0.3, 500.0, exact=True)
    if buffered:
        ov = oscene.play_buffered(osig, pos, vel, 0.1, max_distance=60.0,
                                  rate=RATE, buffer_duration=0.1)
    else:
        ov = oscene.play(osig, pos, vel, 0.1)
    oscene.set_listener_rotation(rot)

    t = 0.0
    errs = []
    for i in range(NBLK):
        if i == 3:
            for x in (h, ov):
                x.set_motion([-20.0 + 30.0 * t, 5.0, 0.0], vel, False)
        if i == 6:  # discontinuity jump
            for x in (h, ov):
                x.set_motion([10.0, 2.0, -3.0], [5.0, 0.0, 0.0], True)
        eng = r.render_block(BLOCK)
        buf = np.zeros((BLOCK, 2), F)
        ref.oddio_run(oscene, RATE, buf)
        errs.append(np.abs(eng - buf).max())
        t += BLOCK / RATE
    assert np.abs(buf).max() > 1e-3
    assert max(errs) <= TOL, errs


def test_golden_bench_scene_buffered():
    """bench.py's buffered scene at 64 voices (loud, close, slow movers at
    48 kHz) through render_frames, so the fused multi-block read runs,
    against the exact oracle."""
    from oddio_tpu_torch.utils.scene_profile import build_spatial

    RATE, BLOCK, NBLK, V = 48000, 512, 24, 64
    _, scene = build_spatial(True, V, "cpu")
    r = pt.Renderer(scene, RATE)
    eng = r.render_frames(BLOCK * NBLK)
    assert r.dispatch_counts.get(("multi", 4), 0) > 0, r.dispatch_counts

    rng = np.random.default_rng(0)  # build_spatial's draws, in its order
    oscene = ref.OSpatialScene(exact=True)
    for _ in range(V):
        osig = ref.OSine(rng.uniform(0, 6), rng.uniform(100, 2000), exact=True)
        p, v = rng.uniform(-15, 15, 3), rng.uniform(-0.2, 0.2, 3)
        oscene.play_buffered(osig, p, v, 0.1, max_distance=50.0, rate=RATE,
                             buffer_duration=0.1)
    want = np.zeros((BLOCK * NBLK, 2), F)
    for i in range(NBLK):
        buf = np.zeros((BLOCK, 2), F)
        ref.oddio_run(oscene, RATE, buf)
        want[i * BLOCK : (i + 1) * BLOCK] = buf
    assert np.abs(want).max() > 1e-2
    assert np.abs(eng - want).max() <= TOL, np.abs(eng - want).max()


def _subpass_scene(m):
    """test_golden.py:343's mixed scene with Sine sources: near/slow voices
    on the tight tier, two beyond the clamp (frozen reads), one fast mover
    and one drifting across the clamp boundary."""
    voices = [
        ([5.0, 2.0, 0.0], [2.0, 0.0, 0.0]),
        ([-8.0, 1.0, 3.0], [0.0, 1.5, 0.0]),
        ([0.0, -6.0, 2.0], [0.0, 0.0, 0.0]),
        ([60.0, 5.0, 0.0], [0.0, 0.0, 0.0]),
        ([-70.0, 0.0, 10.0], [0.0, 0.0, 0.0]),
        ([4.0, 0.0, 0.0], [100.0, 0.0, 0.0]),
        ([43.8, 0.0, 0.0], [2.0, 0.0, 0.0]),
    ]
    control, scene = m.SpatialScene.new()
    hs = [
        control.play_buffered(
            m.Sine(0.1 * k, 300.0 + 70.0 * k),
            m.SpatialOptions(position=p, velocity=v),
            max_distance=10.0, rate=8000, buffer_duration=0.1,
        )
        for k, (p, v) in enumerate(voices)
    ]
    return scene, hs


def test_subpass_scene_matches_jax():
    """A scene whose host plan lists family sub-pass voices, so the
    buffered pool's second K2 call (over gathered sub-pass rows) runs;
    membership changes mid-run by motion deltas.  The port's tier plan
    equals the JAX package's block by block, and the audio agrees."""
    runs = []
    for m in (ot, pt):
        scene, hs = _subpass_scene(m)
        r = m.Renderer(scene, 8000)
        pool = next(iter(scene._buffered_pools.values()))
        outs, plans = [], []
        for i in range(10):
            if i == 4:
                hs[3].set_motion([6.0, 1.0, 0.0], [0.0, 0.0, 0.0], True)
            if i == 7:
                hs[0].set_motion([80.0, 0.0, 0.0], [0.0, 0.0, 0.0], True)
            outs.append(r.render_block(512))
            plans.append((pool._read_cfg, pool._sub_cfg, tuple(pool._sub_list)))
        runs.append((np.concatenate(outs), plans))
    (a, plan_j), (b, plan_p) = runs
    assert plan_p == plan_j
    assert any(p[1] is not None for p in plan_p), plan_p  # sub-pass engaged
    assert np.abs(a).max() > 1e-4
    assert np.abs(a - b).max() <= TOL, np.abs(a - b).max()
