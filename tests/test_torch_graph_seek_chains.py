"""The port's Renderer block step on a SpatialScene's device-resident seek
pools of every built-in seekable chain, on the CPU, against the exact
oracle, the JAX package's Renderer and ``eager()``.

``play()`` voices of ``Cycle``, ``Constant``, ``FixedGain(Sine)``,
``FixedGain(FramesSignal)``, ``Reinhard(Sine)``, ``Tanh(Cycle)`` and
``Tanh(FixedGain(Sine))`` play in ``_SeekPoolDR`` pools (one per chain):
each block samples the chain at both ears' warped times
(``dr_warp_render``; a Cycle or FramesSignal leaf through
``stream_kernels.arena_warp``, on the CPU its plain version, with the
route flags stamped through the wrappers) and seeks it on by the block
(``dr_advance``).  Such a scene declares ``graph_capture``: on a card each
block replays a CUDA graph, here the same step runs uncaptured.

The scene runs ``test_torch_graph_spatial_arena.script``'s calls with
moves (smoothed and discontinuous), plays that grow every pool past its
capacity, writes between two blocks of one call and a new ``Frames``
between two calls; its FramesSignal voices end, linger and are reclaimed.
These tests hold the audio against the JAX Renderer within 1e-5 and,
without its Sine chains (the exact oracle's Sine and the engines' part by
~4e-6 a voice: ROADMAP R11), against the exact oracle within 1e-5 (its
Cycle in float64, ``test_torch_graph_spatial_arena.OCycle``); the step
keys and dispatches, the packed row, ``eager()`` bit for bit, a replay
emulated on a frozen copy, no host read inside a step, the state leaves,
the handles and the state carried from the JAX package, as the buffered
scene's tests do.  Test names avoid the JAX tests'
(``conftest.py`` marks tests slow by name).
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import oddio_tpu as ot  # noqa: E402
import oddio_tpu_torch as pt  # noqa: E402
import test_torch_graph_spatial_arena as SA  # noqa: E402
from oddio_tpu_torch.core import run as prun  # noqa: E402
from oddio_tpu_torch.utils.scene_profile import BUCKETS  # noqa: E402
from oddio_tpu_torch.utils.tree import tree_leaves  # noqa: E402

torch.set_num_threads(1)

RATE, BLOCK = SA.RATE, SA.BLOCK
F = np.float32

#: the seekable chains, each a function of (scene, rng)
CHAINS = {
    "cycle": lambda sc, rng: sc.cycle(float(rng.uniform(0, 0.04))),
    "constant": lambda sc, rng: sc.constant(float(rng.uniform(-0.2, 0.2))),
    "fg_sine": lambda sc, rng: sc.sine(float(rng.uniform(0, 6)), float(rng.uniform(150, 900))),
    "fg_frames": lambda sc, rng: sc.fixed_gain(
        sc.frames(int(rng.integers(SA.SOUNDS)), float(rng.uniform(0.0, 0.3))), -3.0),
    "reinhard_sine": lambda sc, rng: sc.reinhard(
        sc.sine(float(rng.uniform(0, 6)), float(rng.uniform(150, 900)), 0.0)),
    "tanh_cycle": lambda sc, rng: sc.tanh(sc.cycle(float(rng.uniform(0, 0.04)))),
    "tanh_fg_sine": lambda sc, rng: sc.tanh(
        sc.sine(float(rng.uniform(0, 6)), float(rng.uniform(150, 900)), 6.0)),
}


def _seek_voice(sc, chain, rng):
    sig = CHAINS[chain](sc, rng)
    pos, vel = SA._near(rng)
    sc.play(sig, pos, vel)


#: the chains without a Sine: the exact oracle's Sine and the engines'
#: differ by up to ~4e-6 a voice (ROADMAP R11), so Sine chains are held to
#: the JAX package, the others to the oracle too
EXACT = ("cycle", "constant", "fg_frames", "tanh_cycle")


def build_seek(m, seed=0, chains=tuple(CHAINS)):
    """Two voices of each of ``chains``, drawn from ``seed``."""
    sc = SA.Scene(m, seek=True)
    sc.chains = chains
    rng = np.random.default_rng(seed)
    for _ in range(2):
        for chain in chains:
            _seek_voice(sc, chain, rng)
    return sc


def _seek_tick(sc, t):
    """Control tick ``t`` of the seek scene's script."""
    rng = np.random.default_rng(200 + t)
    if t == 0:  # smoothed moves near two voices
        sc.move(0, [2.0, 1.0, 0.5], [1.0, 0.0, 0.0])
        sc.move(5, [-1.0, 3.0, 0.5], [0.0, -1.0, 0.0])
    elif t == 1:  # a discontinuity; a play
        sc.move(1, [-3.0, 2.0, 1.0], [0.0, 2.0, 0.0], True)
        _seek_voice(sc, "fg_frames", rng)
    elif t == 2:  # growth past every pool's capacity
        for _ in range(3):
            for chain in sc.chains:
                _seek_voice(sc, chain, rng)
    elif t == 3:
        sc.move(3, [1.0, -2.0, 0.0], [0.0, 0.0, 2.0])
    elif t == 4:
        sc.move(6, [0.5, 2.0, -1.0], [0.0, 0.0, 0.0], True)
    elif t == 5:
        sc.move(2, [0.5, 0.5, 3.0], [-1.0, 0.0, 0.0], True)


SA.KINDS["seek"] = (build_seek, _seek_tick, False, True)
SA.KINDS["seek_exact"] = (functools.partial(build_seek, chains=EXACT), _seek_tick, True, False)


@pytest.mark.parametrize("unroll,buckets", [(1, None), (8, None), (1, BUCKETS)],
                         ids=["unroll1", "unroll8", "buckets"])
def test_seek_chain_steps_match_oracle_and_jax(unroll, buckets):
    """Every seekable chain within 1e-5 of the JAX Renderer, and the chains
    without a Sine (``EXACT``) within 1e-5 of the exact oracle, through
    block steps; one device-resident seek pool per chain."""
    for kind, chains in (("seek", CHAINS), ("seek_exact", EXACT)):
        _, sc = SA.check_steps(kind, unroll, buckets, multi=False)
        pools = sc.engine._seek_pools.values()
        assert len(pools) == len(chains)
        assert all(type(p).__name__ == "_SeekPoolDR" for p in pools)


def test_seek_chain_step_keys_match_jax():
    SA.check_keys("seek")


def test_seek_chain_step_matches_eager_bit_for_bit():
    """``check_eager``; the FramesSignal voices finished, lingered and were
    reclaimed inside the run."""
    fin = SA.check_eager("seek")
    _, _, _, sc = SA.port("seek")
    assert sum(fin) >= 2 and not all(fin)
    assert sum(p.slot_gen.sum() for p in sc.engine._all_pools()) > 0  # slots reclaimed


def test_seek_chain_block_step_reads_no_host_state(monkeypatch):
    """A replay emulated on a copy of the scene frozen at each step's first
    call: every host value a seek render reads (the block's elapsed time
    that ``dr_advance`` seeks by, the arena route) is in the key."""
    calls = SA.replay_emulation("seek", monkeypatch)
    assert {"single", "scan"} <= set(calls) and len(calls) > 10


def test_seek_chain_steps_read_no_tensor_on_host():
    """``check_host_reads`` over the seek scene: the warped arena reads
    under wrappers, the cursors' advance and the elementwise maps."""
    SA.check_host_reads(("seek",))


def test_seek_chain_state_leaves_stay_put():
    """The step leaves every state leaf in the tensor it was collected in
    through moves (``eager()`` stores what the render returns); a Constant
    voice's output is a tensor of the step's own, not a view of its
    state."""
    sc = build_seek(pt)
    r = pt.Renderer(sc.engine, RATE)
    r.render_block(BLOCK)
    before = tree_leaves(sc.engine.device_collect())
    for t in (0, 3, 4, 5):
        _seek_tick(sc, t)
        r.render_frames(BLOCK * 4)
    after = tree_leaves(sc.engine.device_collect())
    assert len(after) == len(before) and all(a is b for a, b in zip(after, before))
    out = r.render_frames_device(BLOCK * 2, sync=False)[0]
    assert all(out.data_ptr() != x.data_ptr() for x in after)
    with prun.eager():
        r.render_block(BLOCK)
    moved = tree_leaves(sc.engine.device_collect())
    assert any(a is not b for a, b in zip(moved, before))


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_seek_pool_of_each_chain_captures(chain):
    """A scene holding one seek pool of ``chain`` declares
    ``graph_capture``, routes to a device-resident seek pool and steps,
    bit for bit as ``eager()``; the route flags reach the arena leaf
    under the wrappers."""
    outs = []
    for mode in ("step", "eager"):
        with prun.eager() if mode == "eager" else SA.contextlib.nullcontext():
            sc = SA.Scene(pt, seek=True)
            rng = np.random.default_rng(4)
            for _ in range(3):
                _seek_voice(sc, chain, rng)
            r = pt.Renderer(sc.engine, RATE)
            outs.append(r.render_frames(BLOCK * 4))
        (pool,) = sc.engine._seek_pools.values()
        assert sc.engine.graph_capture and type(pool).__name__ == "_SeekPoolDR"
        assert bool(r._steps) is (mode == "step")
        node, leaf = pool.proto, None
        while node is not None:
            assert node._pool_ds_small is True
            leaf = node
            node = node.children().get("inner")
        if chain in ("cycle", "tanh_cycle", "fg_frames"):
            assert getattr(leaf, "arena_kind", None) is not None
    assert np.abs(outs[0]).max() > 0
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("chain", ["fg_frames", "tanh_cycle"])
def test_seek_route_flags_reach_the_leaf_under_wrappers(chain):
    """Sounds at 192 kHz step past ``RESAMPLE_DSMAX`` in a seek pool: the
    pool stamps its gather route on every node of the chain, the arena leaf
    under the wrapper included, and renders it under steps bit for bit as
    ``eager()`` (and the JAX Renderer within 1e-5)."""
    sounds, table = SA._sound_data()
    outs = []
    for m, mode in ((pt, "step"), (pt, "eager"), (ot, "step")):
        with prun.eager() if mode == "eager" else SA.contextlib.nullcontext():
            sc = SA.Scene(m, seek=True)
            sc.sounds = [m.Frames.from_slice(4 * SA.SR, x) for x in sounds]
            sc.table = m.Frames.from_slice(4 * RATE, table)
            rng = np.random.default_rng(8)
            for _ in range(3):
                _seek_voice(sc, chain, rng)
            r = m.Renderer(sc.engine, RATE)
            outs.append(r.render_frames(BLOCK * 6))
        if m is pt:
            (pool,) = sc.engine._seek_pools.values()
            assert pool._ds_small is False and bool(r._steps) is (mode == "step")
            node = pool.proto
            while node is not None:
                assert node._pool_ds_small is False, type(node).__name__
                node = node.children().get("inner")
    assert np.abs(outs[0]).max() > 0.01
    np.testing.assert_array_equal(outs[0], outs[1])
    assert np.abs(outs[0] - outs[2]).max() <= SA.TOL


def test_seek_user_signal_stays_op_by_op():
    """A user signal in a seek chain (a Cycle subclass, which still routes
    to a device-resident seek pool) keeps the scene op by op."""
    sc = SA.Scene(pt, seek=True)
    rng = np.random.default_rng(6)
    _seek_voice(sc, "tanh_fg_sine", rng)
    assert sc.engine.graph_capture

    class UserCycle(pt.Cycle):
        pass

    sc.play(pt.Tanh(UserCycle(sc.table)), [1.0, 0.0, 0.0], [0.0, 0.0, 0.0])
    assert all(p.is_dr for p in sc.engine._all_pools()) and not sc.engine.graph_capture
    r = pt.Renderer(sc.engine, RATE)
    assert np.abs(r.render_frames(BLOCK * 2)).max() > 0 and r._steps == {}


# -- the packed row and the state carried from the JAX package ----------------------------


@functools.lru_cache(maxsize=None)
def _row_params():
    """Each package's params of an idle block, a block of moves and a block
    of plays (float64 FramesSignal cursors among them)."""
    out = []
    for m in (ot, pt):
        sc = build_seek(m)

        def prepare(_sc=sc):
            return _sc.engine.host_prepare(F(1) / F(RATE), BLOCK)

        blocks = [prepare(), prepare()]
        sc.move(0, [1.0, 1.0, 1.0], [0.0, 1.0, 0.0])
        sc.move(3, [-1.0, 2.0, 0.0], [0.0, 0.0, 0.0], True)
        blocks.append(prepare())
        rng = np.random.default_rng(5)
        for chain in ("fg_frames", "cycle", "constant"):
            _seek_voice(sc, chain, rng)
        blocks.append(prepare())
        out.append(blocks[1:])
    return list(zip(*out))


@pytest.mark.parametrize("block", range(3), ids=["idle", "moves", "plays"])
def test_seek_chain_packed_row_matches_jax(block):
    jp, pp = _row_params()[block]
    prow, ppaths = SA.compare_rows(jp, pp)
    if block == 0:
        assert len(prow) == 0
    if block == 2:
        assert any(p[-1] == "t" for p in ppaths)


def test_port_continues_a_jax_seek_scene():
    SA.check_carried("seek")
