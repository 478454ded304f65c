"""Control paths of the port's SpatialScene against the JAX package, to
max |err| <= 1e-5: the sparse control-delta channel, mid-run plays on the
padded play lanes, motion backpressure, and the ring-write / read paths
that rate mismatches select."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import oddio_tpu as ot  # noqa: E402
import oddio_tpu_torch as pt  # noqa: E402

from test_torch_spatial import BLOCK, RATE, TOL, build_entry  # noqa: E402

torch.set_num_threads(1)


def test_control_deltas_match_jax():
    """A handle write on a controllable field rides the sparse control
    channel (ControlBlock -> push_ctrl -> the delta lanes -> the scatter into
    the pool's inner state) and lands on the voice it targeted."""
    runs = []
    for m in (ot, pt):
        class Tunable(m.Sine):
            _dr_ctrl_fields = ("freq",)

            def __init__(self, phase, hz):
                super().__init__(phase, hz)
                self._cb = m.ControlBlock(self)

        control, scene = m.SpatialScene.new()
        sigs = [Tunable(0.1 * k, 200.0 + 50.0 * k) for k in range(3)]
        for k, s in enumerate(sigs):
            control.play(s, m.SpatialOptions(position=[k + 1.0, 0.0, -2.0]))
        r = m.Renderer(scene, 8000)
        blocks = [r.render_block(256) for _ in range(2)]
        sigs[1]._cb.set("freq", np.float32(2 * np.pi * 330.0))
        blocks += [r.render_block(256) for _ in range(3)]
        freq = np.asarray(scene.device_collect()["s0"]["inner"]["freq"])
        runs.append((np.concatenate(blocks), freq))
    (a, fa), (b, fb) = runs
    np.testing.assert_array_equal(fa, fb)
    assert fb[1] == np.float32(2 * np.pi * 330.0)
    assert np.abs(a - b).max() <= TOL, np.abs(a - b).max()


@pytest.mark.parametrize("scene_rate,ring_rate", [(48000, 44100), (16000, 48000)])
def test_rate_mismatch_paths_match_jax(scene_rate, ring_rate):
    """Ring rate != scene rate: at 48k/44.1k the shared cursor advances by
    a fractional count, so the ring write takes the general unaligned path
    (slice writes instead of K1) and K2 reads at ds != 1; at 16k/48k the
    step is beyond every kernel tier and the exact elementwise read runs."""
    outs = []
    for m in (ot, pt):
        rng = np.random.default_rng(5)
        control, scene = m.SpatialScene.new()
        for _ in range(3):
            control.play_buffered(
                m.Sine(rng.uniform(0, 6), rng.uniform(100, 1500)),
                m.SpatialOptions(position=rng.uniform(-10, 10, 3),
                                 velocity=rng.uniform(-3, 3, 3)),
                max_distance=20.0, rate=ring_rate, buffer_duration=0.1,
            )
        r = m.Renderer(scene, scene_rate)
        outs.append(np.concatenate([r.render_block(BLOCK) for _ in range(6)]))
        pool = next(iter(scene._buffered_pools.values()))
        if ring_rate < scene_rate:
            assert pool._w_aligned == 0 and pool._read_cfg is not None
        else:
            assert pool._read_cfg is None
    a, b = outs
    assert np.abs(a).max() > 1e-3
    assert np.abs(a - b).max() <= TOL, np.abs(a - b).max()


def test_midrun_plays_and_motion_backpressure_match_jax():
    """Plays after the first block ride the padded play lanes (fewer than
    k_play, so no eager apply; the host drops the padding lanes), and 80
    motion updates on one pool overflow its 64 motion lanes, carrying the
    rest to the next block."""
    outs = []
    for m in (ot, pt):
        control, scene, hs = build_entry(m, 80, 8)
        r = m.Renderer(scene, RATE)
        blocks = [r.render_block(BLOCK)]
        rng = np.random.default_rng(9)
        for k in range(3):
            control.play_buffered(
                m.Sine(0.2 * k, 300.0 + 100.0 * k),
                m.SpatialOptions(position=rng.uniform(-10, 10, 3)),
                max_distance=50.0, rate=RATE, buffer_duration=0.1,
            )
        control.play(m.Sine(1.0, 777.0), m.SpatialOptions(position=[2.0, 0.0, -1.0]))
        blocks.append(r.render_block(BLOCK))
        # discontinuous jumps: no smoothing transition, so every walk stays
        # inside the K=64 envelope (a smoothed 20 m move would be a
        # supersonic apparent velocity, where the reference clips reads)
        for h in hs[:80]:
            h.set_motion(rng.uniform(-20, 20, 3), rng.uniform(-5, 5, 3), True)
        pool = next(iter(scene._buffered_pools.values()))
        blocks.append(r.render_block(BLOCK))
        assert len(pool.pending_motion) == 80 - pool.k_motion
        blocks += [r.render_block(BLOCK) for _ in range(3)]
        assert not pool.pending_motion
        outs.append(np.concatenate(blocks))
    a, b = outs
    assert np.abs(a - b).max() <= TOL, np.abs(a - b).max()
