"""Sampler voices (FramesSignal, Cycle, Fader) in the port's SpatialScene:
the FramesSignal forms of tests/test_spatial.py:373, :416 and :434 and of
the goldens tests/test_golden.py:297, :431 and :522, on short renders.

* The device-resident seek pool's warped sampler reads (K6's arena form,
  on the CPU its plain version) against the port's host seek pool and
  the JAX package's: within the JAX test's 5e-5 (the host pool shifts
  its cursor in f64, the JAX device pool by split f32 products);
* a finishing FramesSignal seek voice lingers for its propagation delay
  and frees its slot; play/finish churn recycles slots;
* the buffered goldens with a FramesSignal source against the exact
  oracle within 1e-5: a voice beyond ``max_delay*c`` (frozen reads), a
  slow scene on the tight walk tier through a motion transition, and ring
  rates other than the scene's (ratio 0.5, 1.5 and 3.0; the host pool's
  exact branch);
* a Fader voice in the device-resident buffered pool, fading between two
  FramesSignals, against the same voice in the host buffered pool.
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


def _host_seek(cls):
    return type(f"HostSeek{cls.__name__}", (cls,), {"dr_seek_supported": lambda self: False})


def _seek_scene(m, host):
    rng = np.random.default_rng(9)
    snd = m.Frames.from_slice(8000, (np.sin(np.linspace(0, 700, 12000)) * 0.7).astype(F))
    tbl = m.Frames.from_slice(8000, rng.standard_normal(997).astype(F))
    FS = _host_seek(m.FramesSignal) if host else m.FramesSignal
    CY = _host_seek(m.Cycle) if host else m.Cycle
    control, scene = m.SpatialScene.new(**kw(m))
    hs = []
    for i in range(5):
        hs.append(control.play(FS(snd, -0.02 * i), m.SpatialOptions(
            position=rng.uniform(-15, 15, 3), velocity=rng.uniform(-4, 4, 3))))
    for i in range(4):
        c = CY(tbl)
        c.seek(0.01 * i)
        hs.append(control.play(c, m.SpatialOptions(
            position=rng.uniform(-15, 15, 3), velocity=rng.uniform(-4, 4, 3))))
    r = m.Renderer(scene, 8000)
    a = r.render_frames(1024)
    for h in hs[::2]:
        h.set_motion(rng.uniform(-15, 15, 3), rng.uniform(-4, 4, 3), False)
    b = r.render_frames(2048)
    return scene, np.concatenate([a, b])


def test_seek_pool_sampler_voices_dr_host_and_jax():
    outs = {}
    for m, host in ((pt, False), (pt, True), (ot, False)):
        scene, outs[(m, host)] = _seek_scene(m, host)
        if m is pt:
            assert all(p.is_dr != host for p in scene._seek_pools.values())
    dr, host, jx = outs[(pt, False)], outs[(pt, True)], outs[(ot, False)]
    assert np.abs(dr).max() > 0.05
    assert np.abs(dr - host).max() < 5e-5
    assert np.abs(dr - jx).max() < 5e-5


def test_seek_pool_frames_voice_finishes_and_lingers():
    frames = pt.Frames.from_slice(8000, np.ones(400, F))
    control, scene = pt.SpatialScene.new(device="cpu")
    h = control.play(pt.FramesSignal(frames, 0.0), pt.SpatialOptions(position=[3.0, 0.0, 0.0]))
    pool = list(scene._seek_pools.values())[0]
    assert pool.is_dr
    r = pt.Renderer(scene, 8000, sync_every=1)
    for _ in range(6):  # 400 frames of source, the linger, the sync cadence
        r.render_block(256)
    assert h.is_finished()
    assert pool.mask_host.sum() == 0


def test_seek_pool_frames_voice_churn():
    rng = np.random.default_rng(21)
    frames = pt.Frames.from_slice(8000, np.ones(300, F) * 0.1)
    control, scene = pt.SpatialScene.new(initial_capacity=8, device="cpu")
    r = pt.Renderer(scene, 8000, sync_every=2)
    handles = []
    for step in range(30):
        if step % 2 == 0:
            handles.append(control.play(pt.FramesSignal(frames, 0.0),
                                        pt.SpatialOptions(position=rng.uniform(-5, 5, 3))))
        if handles and step % 5 == 0:
            handles[rng.integers(len(handles))].set_motion(
                rng.uniform(-5, 5, 3), [0.0, 0.0, 0.0], False)
        assert np.isfinite(r.render_block(256)).all()
    pool = list(scene._seek_pools.values())[0]
    assert pool.is_dr
    for _ in range(8):
        r.render_block(256)
    scene.sync()
    assert pool.mask_host.sum() == 0
    assert len(pool._free) == pool.capacity
    assert all(h.is_finished() for h in handles)


def _boop(rate, hz):
    tt = np.arange(rate, dtype=F) / F(rate)
    return np.sin(tt * F(hz * 2 * np.pi), dtype=F)


def _run_golden(scene_rate, ring_rate, pos, vel, nblk, moves, dr=True, max_distance=60.0,
                hz=500):
    """Render one buffered FramesSignal voice and the exact oracle block by
    block; ``moves`` maps a block index to (position, velocity). Returns
    (errors per block, the pool, read tiers per block)."""
    boop = _boop(ring_rate, hz)
    control, scene = pt.SpatialScene.new(device="cpu")
    sig = pt.FramesSignal(pt.Frames.from_slice(ring_rate, boop), 0.0)
    if not dr:
        sig.dr_supported = lambda: False  # the host buffered pool
    h = control.play_buffered(sig, pt.SpatialOptions(position=pos, velocity=vel),
                              max_distance=max_distance, rate=ring_rate, buffer_duration=0.1)
    r = pt.Renderer(scene, scene_rate)
    oscene = ref.OSpatialScene(exact=True)
    osig = ref.OFramesSignal(ref.OFrames(ring_rate, boop), 0.0, exact=True)
    ov = oscene.play_buffered(osig, pos, vel, 0.1, max_distance=max_distance,
                              rate=ring_rate, buffer_duration=0.1)
    pool = list(scene._buffered_pools.values())[0]
    errs, tiers, peak = [], [], 0.0
    for i in range(nblk):
        if i in moves:
            for x in (h, ov):
                x.set_motion(*moves[i], False)
        eng = r.render_block(512)
        buf = np.zeros((512, 2), F)
        ref.oddio_run(oscene, scene_rate, buf)
        errs.append(np.abs(eng - buf).max())
        tiers.append(getattr(pool, "_read_cfg", None))
        peak = max(peak, np.abs(buf).max())
    assert peak > 1e-4
    return errs, pool, tiers


@pytest.mark.parametrize("dr", [True, False])
def test_golden_buffered_frames_beyond_max_delay(dr):
    """test_golden.py:297: a voice past max_delay*c reads frozen (ds = 0)."""
    errs, pool, _ = _run_golden(8000, 8000, [60.0, 5.0, 0.0], [0.0, 0.0, 0.0], 8, {},
                                dr=dr, max_distance=10.0)
    assert max(errs) <= TOL, errs
    if dr:
        assert pool._sub_cfg is None and list(pool._sub_list) == []
        assert pool._read_cfg == (512, 32)
    else:
        assert not pool._use_strips


def test_golden_buffered_frames_slow_scene_tight_tier():
    """test_golden.py:431: idle blocks on the tight tier, a motion
    transition re-bounds the walk, and it decays back."""
    errs, _, tiers = _run_golden(8000, 8000, [-8.0, 2.0, 0.0], [4.0, 0.0, 0.0], 16,
                                 {5: ([4.0, 2.0, 0.0], [4.0, 0.0, 0.0])})
    assert tiers[1] == (512, 32) and tiers[5][1] > 32 and tiers[-1] == (512, 32), tiers
    assert max(errs) <= TOL, (errs, tiers)


@pytest.mark.parametrize("rring,dr", [(12000, True), (4000, True), (24000, True),
                                      (12000, False), (24000, False)])
def test_golden_buffered_frames_rate_mismatch(rring, dr):
    """test_golden.py:522: ring rates other than the scene's."""
    errs, pool, _ = _run_golden(8000, rring, [-10.0, 5.0, 0.0], [20.0, 0.0, 0.0], 8,
                                {4: ([0.0, 5.0, 0.0], [20.0, 0.0, 0.0])}, dr=dr, hz=300)
    if dr:
        assert (pool._read_cfg is None) == (rring == 24000), pool._read_cfg
    else:
        assert not pool._use_strips
    assert max(errs) <= TOL, errs


def test_fader_frames_as_buffered_spatial_voice():
    """A Fader(FramesSignal) in the device-resident buffered pool fading to
    another FramesSignal (both banks through K6's arena form) against the
    same scene in the host buffered pool (the pooled two-bank fader)."""
    outs = []
    for dr in (True, False):
        snd = pt.Frames.from_slice(8000, _boop(8000, 300) * F(0.5))
        snd2 = pt.Frames.from_slice(8000, _boop(8000, 600) * F(0.5))
        control, scene = pt.SpatialScene.new(device="cpu")
        fc, f = pt.Fader.new(pt.FramesSignal(snd, 0.0))
        if not dr:
            f.dr_supported = lambda: False
        control.play_buffered(f, pt.SpatialOptions(position=[-2.0, 0.0, 0.0]),
                              max_distance=20.0, rate=8000, buffer_duration=0.05)
        assert [p.is_dr for p in scene._buffered_pools.values()] == [dr]
        r = pt.Renderer(scene, 8000)
        a = r.render_frames(1024)
        fc.fade_to(pt.FramesSignal(snd2, 0.1), 0.05)
        outs.append(np.concatenate([a, r.render_frames(2048)]))
    assert np.abs(outs[0]).max() > 0.01
    assert np.abs(outs[0] - outs[1]).max() <= TOL
    spec = np.abs(np.fft.rfft(outs[0][-1024:, 0]))
    assert abs(np.argmax(spec) * 8000 / 1024 - 600) < 16  # the fade landed
