"""The port's SpatialScene render path against the JAX package.

The scene is ``__graft_entry__.py``'s flagship one: 64 buffered (delay-ring)
and 32 seek (time-warp) Sine voices at 48 kHz in 512-frame blocks, built by
the same control script in both packages.  Bound: max |err| <= 1e-5, the
PARITY.md contract.  The two differ by XLA:CPU's fused multiply-adds in the
JAX package's jitted programs (<= 1 ulp per op; see test_torch_dev.py) and
by the order of the voice sums.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import oddio_tpu as ot  # noqa: E402
import oddio_tpu_torch as pt  # noqa: E402

torch.set_num_threads(1)

RATE, BLOCK = 48000, 512
TOL = 1e-5


def build_entry(m, n_buffered=64, n_seek=32, **scene_kw):
    """The entry() scene (``__graft_entry__._build_scene``) in package ``m``
    (the port's on the CPU)."""
    rng = np.random.default_rng(0)
    if m is pt:
        scene_kw.setdefault("device", "cpu")
    control, scene = m.SpatialScene.new(**scene_kw)
    handles = []
    for _ in range(n_buffered):
        handles.append(control.play_buffered(
            m.Sine(rng.uniform(0, 6), rng.uniform(100, 2000)),
            m.SpatialOptions(
                position=rng.uniform(-30, 30, 3), velocity=rng.uniform(-10, 10, 3)
            ),
            max_distance=50.0, rate=RATE, buffer_duration=0.1,
        ))
    for _ in range(n_seek):
        handles.append(control.play(
            m.Sine(rng.uniform(0, 6), rng.uniform(100, 2000)),
            m.SpatialOptions(position=rng.uniform(-30, 30, 3)),
        ))
    return control, scene, handles


def test_entry_scene_matches_jax():
    """20 blocks through render_frames: one delta block, then an idle run
    that the Renderer fuses into four 4-block groups (K3) plus a 3-block
    run (K1 + K2)."""
    _, sj, _ = build_entry(ot)
    a = ot.Renderer(sj, RATE).render_frames(BLOCK * 20)
    _, sp, _ = build_entry(pt)
    rp = pt.Renderer(sp, RATE)
    b = rp.render_frames(BLOCK * 20)
    assert b.shape == a.shape == (BLOCK * 20, 2) and b.dtype == np.float32
    assert np.abs(a).max() > 1e-3
    assert np.abs(a - b).max() <= TOL, np.abs(a - b).max()
    assert rp.dispatch_counts == {"single": 1, ("multi", 4): 4, "scan": 1}
    pool = sp._buffered_pools[next(iter(sp._buffered_pools))]
    assert pool._read_cfg == (512, 32) and pool._sub_cfg is None


def test_set_motion_and_rotation_mid_run_match_jax():
    """Motion deltas on buffered and seek handles (one discontinuous) and a
    listener rotation mid-run, block by block: the delta program, the
    smoothing transition and the tier changes it causes."""
    outs = []
    for m in (ot, pt):
        control, scene, hs = build_entry(m)
        r = m.Renderer(scene, RATE)
        blocks = [r.render_block(BLOCK) for _ in range(3)]
        hs[0].set_motion([3.0, 1.0, -2.0], [20.0, 0.0, 0.0], False)
        hs[5].set_motion([-12.0, 0.0, 4.0], [0.0, 0.0, 0.0], True)
        hs[64].set_motion([8.0, 2.0, 1.0], [0.0, -15.0, 0.0], False)
        hs[90].set_motion([1.0, 0.0, 1.0], [5.0, 5.0, 0.0], True)
        blocks += [r.render_block(BLOCK) for _ in range(2)]
        control.set_listener_rotation([np.cos(0.2), 0.0, np.sin(0.2), 0.0])
        blocks += [r.render_block(BLOCK) for _ in range(3)]
        outs.append(np.concatenate(blocks))
        assert not hs[0].is_finished()
    a, b = outs
    assert np.abs(a - b).max() <= TOL, np.abs(a - b).max()


def test_grouped_path_matches_per_block_path():
    """The fused multi-block read (K3 over one superwindow) computes the
    same arithmetic as the per-block reads (K2): on the plain versions the
    two renders agree bit for bit (the JAX package's own check is
    test_run_modes.py::test_multiblock_idle_groups_match_per_block)."""
    _, s1, _ = build_entry(pt)
    r1 = pt.Renderer(s1, RATE)
    a = r1.render_frames(BLOCK * 19)
    assert r1.dispatch_counts.get(("multi", 4)) == 4

    _, s2, _ = build_entry(pt)
    for pool in s2._buffered_pools.values():
        pool.MULTI_NB = 0  # instance override disables the fused path
    r2 = pt.Renderer(s2, RATE)
    b = r2.render_frames(BLOCK * 19)
    assert ("multi", 4) not in r2.dispatch_counts
    np.testing.assert_array_equal(a, b)


def test_multiblock_gate_rejects_tight_rings():
    """host_multiblock refuses when the ring lacks slack for a group's
    batched appends (test_run_modes.py:185 in the JAX package)."""
    control, scene = pt.SpatialScene.new(device="cpu")
    control.play_buffered(
        pt.Sine(0.0, 440.0), pt.SpatialOptions(position=[2.0, 1.0, -3.0]),
        max_distance=10.0, rate=8000, buffer_duration=0.1,  # cap 2048
    )
    r = pt.Renderer(scene, 8000)
    a = r.render_frames(512 * 20)
    assert np.isfinite(a).all() and np.abs(a).max() > 0
    assert ("multi", 4) not in r.dispatch_counts


def test_render_frames_device_matches_render_frames():
    _, s1, _ = build_entry(pt, 16, 8)
    a = pt.Renderer(s1, RATE).render_frames(BLOCK * 18)
    _, s2, _ = build_entry(pt, 16, 8)
    outs = pt.Renderer(s2, RATE).render_frames_device(BLOCK * 18)
    assert all(isinstance(o, torch.Tensor) and o.shape[1] == 2 for o in outs)
    b = np.concatenate([
        np.moveaxis(o.numpy(), 1, 2).reshape(-1, 2) for o in outs
    ])
    np.testing.assert_array_equal(a, b)
    s2.sync()  # applies the readback render_frames_device started


def test_specs_needing_host_pools_raise():
    """Specs that are not device-resident capable once raised here; now
    they take the same host pools as in the JAX package: a Sine with its
    own finish rule the host seek and buffered pools, a Speed(Stream) the
    host buffered pool, a Mixer the singleton, an Adapt(Stream) the
    device-resident pool."""
    kinds = []
    for m in (ot, pt):
        class Finite(m.Sine):
            def host_is_finished(self):
                return np.ones(self.batch, bool)

        control, scene = m.SpatialScene.new(**({"device": "cpu"} if m is pt else {}))
        control.play(Finite(0.0, 440.0))
        control.play(m.Sine(0.0, 440.0))
        control.play_buffered(Finite(0.0, 440.0))
        control.play_buffered(m.Speed(m.Stream(8000, 256)))
        control.play_buffered(m.Adapt(m.Stream(8000, 256), 0.1))
        control.play_buffered(m.Mixer(1, **({"device": "cpu"} if m is pt else {})))
        kinds.append(
            [type(p).__name__ for p in scene._seek_pools.values()]
            + [type(p).__name__ for p in scene._buffered_pools.values()]
        )
    assert kinds[0] == kinds[1] == [
        "_SeekPool", "_SeekPoolDR", "_BufferedPool", "_BufferedPool",
        "_BufferedPoolDR", "_BufferedPoolSingleton",
    ]



def test_run_renders_a_bare_sine():
    """``run`` drives a standalone signal through the host protocol."""
    sj, sp = ot.Sine(0.4, 440.0), pt.Sine(0.4, 440.0)
    a = np.concatenate([ot.run(sj, 8000, 256) for _ in range(3)])
    b = np.concatenate([pt.run(sp, 8000, 256, device="cpu") for _ in range(3)])
    assert b.shape == (768, 1)
    assert np.abs(a - b).max() <= 1e-6  # XLA's fused multiply-adds (R7)
