"""ScenePacks of the spatial scenes whose device-resident buffered pools
read a sample arena (``test_torch_graph_spatial_arena``: FramesSignal,
Speed, Fader and Cycle voices) or whose seek pools hold the other
built-in seekable chains (``test_torch_graph_seek_chains``), on the CPU.

Such a pack declares ``graph_capture`` (its scenes do) on any mesh: a 1 x
1 pack takes block steps over its stack, a logical 2 x 2 one steps each
cell over its own (on a card, CUDA graphs per cell).  Four scenes drawn
from seeds 0-3 run one script, each tick on every scene: moves, speed
writes (one past the arena step's bound) and fades, plays that grow every
pool in every scene, writes between two blocks of one call and a new
``Frames``.  These tests hold each pack bit for bit against its
``eager()``, and on a shorter script each scene of the buffered packs
within 1e-5 of the exact oracle and of the JAX ScenePack (1 x 1) within
the JAX side's own distance from the oracle + 1e-5.
Test names avoid the JAX tests' (``conftest.py`` marks tests slow by
name).
"""

import contextlib
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import oddio_tpu as ot  # noqa: E402
import oddio_tpu_torch as pt  # noqa: E402
import test_torch_graph_seek_chains  # noqa: E402,F401  (registers the seek kinds)
import test_torch_graph_spatial_arena as SA  # noqa: E402
from oddio_tpu.parallel.mesh import make_mesh as jax_mesh  # noqa: E402
from oddio_tpu.parallel.sharded import ScenePack as JaxPack  # noqa: E402
from oddio_tpu_torch.core import run as prun  # noqa: E402
from oddio_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from oddio_tpu_torch.parallel.sharded import ScenePack  # noqa: E402

torch.set_num_threads(1)

RATE, BLOCK, TOL = SA.RATE, SA.BLOCK, SA.TOL
SCENES = 4


class PackRenderer:
    """A ScenePack (either package's) behind the script's calls: keeps
    every scene's audio in ``outs``."""

    def __init__(self, pack):
        self.pack, self.outs = pack, []

    def render_block(self, n):
        self.outs.append(self.pack.render_block(n))  # (S, n, C)

    def render_frames(self, total):
        nb, rem = divmod(total, BLOCK)
        xs = [np.asarray(t).transpose(1, 0, 3, 2).reshape(t.shape[1], -1, t.shape[2])
              for t in self.pack.render_frames_device(BLOCK * nb)]
        if rem:
            xs.append(self.pack.render_block(rem))
        self.outs.append(np.concatenate(xs, axis=1))

    def schedule(self, actions):
        """``actions[i]()`` before the pack prepares its i-th block of the
        next call (the JAX pack's ``_prepare``, the port's
        ``_block_params``)."""
        hook = "_prepare" if isinstance(self.pack, JaxPack) else "_block_params"
        prepare, count = getattr(self.pack, hook), [0]

        def block(n):
            act = actions.get(count[0])
            count[0] += 1
            if act is not None:
                act()
            if count[0] > max(actions):
                delattr(self.pack, hook)
            return prepare(n)

        setattr(self.pack, hook, block)


def pack_run(m, kind, shape, mode="step", full=True):
    """``SCENES`` scenes of ``kind`` (seeds 0, 1, ...) in a pack on a mesh of
    ``shape`` through the script (``full``: ``SA.script``'s calls, with a
    16-block idle run first; else 2 blocks, tick 0, 6 blocks, tick 2 and
    6 blocks): (S, frames, C), the pack."""
    build, tick = SA.KINDS[kind][:2]
    built = [build(m, seed) for seed in range(SCENES)]
    with prun.eager() if mode == "eager" else contextlib.nullcontext():
        if m is ot:
            pack = JaxPack([sc.engine for sc in built], RATE, jax_mesh(*shape))
        else:
            pack = ScenePack([sc.engine for sc in built], RATE,
                             make_mesh(*shape, ["cpu"] * (shape[0] * shape[1])))
        pr = PackRenderer(pack)

        def ticks(t):
            for sc in built:
                tick(sc, t)

        if not full:
            short_script(pr, ticks)
            return np.concatenate(pr.outs, axis=1), pack
        pr.render_frames(BLOCK * 16)
        ticks(0)
        pr.render_block(BLOCK)
        ticks(1)
        pr.render_frames(BLOCK * 8)
        ticks(2)
        pr.render_frames(BLOCK * 9)
        ticks(3)
        pr.schedule({1: lambda: ticks(4), 2: lambda: ticks(5)})
        pr.render_frames(BLOCK * 10)
        built[0].new_frames()
        pr.render_frames(BLOCK * 8)
    return np.concatenate(pr.outs, axis=1), pack


@functools.lru_cache(maxsize=None)
def _pack(m, kind, shape, mode="step", full=True):
    return pack_run(m, kind, shape, mode, full)


CASES = [(kind, shape) for kind in ("arena", "seek") for shape in ((1, 1), (2, 2))]
IDS = [f"{kind}_{a}x{b}" for kind, (a, b) in CASES]


@pytest.mark.parametrize("kind,shape", CASES, ids=IDS)
def test_spatial_arena_packs_match_eager(kind, shape):
    """The pack declares ``graph_capture`` and takes block steps (on 2 x 2
    every cell its own), bit for bit its ``eager()`` (-0.0 as 0.0); every
    pool grew; a FramesSignal voice's float64 cursors ride the stack."""
    got, p = _pack(pt, kind, shape)
    assert p.graph_capture and p._steps and p.graph_counts["eager"] > 0
    if shape == (2, 2):
        assert {k[-1] for k in p._steps} == set(p._cells)
    want, pe = _pack(pt, kind, shape, mode="eager")
    assert pe._steps == {}
    np.testing.assert_array_equal(SA.zero(got), SA.zero(want))
    assert np.abs(got).max() > 0.02
    assert max(q.capacity for q in p.scenes[0]._all_pools()) > SA.CAPACITY


def short_script(r, ticks):
    """The shorter script through ``r`` (a ``PackRenderer`` or an oracle's
    ``Oracle``): 2 blocks, tick 0, 6 blocks, tick 2 (growth), 6 blocks."""
    r.render_frames(BLOCK * 2)
    ticks(0)
    r.render_frames(BLOCK * 6)
    ticks(2)
    r.render_frames(BLOCK * 6)


@functools.lru_cache(maxsize=None)
def _oracle(kind, seed):
    """The exact oracle's audio of scene ``seed`` of ``kind`` on the shorter
    script, (frames, C)."""
    build, tick = SA.KINDS[kind][:2]
    sc = build(SA.ref, seed)
    outs = []
    r = sc.engine
    render = r.render_frames
    r.render_frames = lambda total: outs.append(render(total))
    short_script(r, functools.partial(tick, sc))
    return np.concatenate(outs)


def test_spatial_arena_pack_matches_jax_pack():
    """On the shorter script, with its growth in every scene, each scene of
    the port's 1 x 1 and 2 x 2 packs of buffered scenes within 1e-5 of the
    exact oracle and within the JAX side's own distance from it + 1e-5 of
    the JAX ScenePack (1 x 1), which keeps float32 FramesSignal cursors
    (ROADMAP Q3.5)."""
    jx, _ = _pack(ot, "arena", (1, 1), full=False)
    assert np.abs(jx).max() > 0.02
    for shape in ((1, 1), (2, 2)):
        got, p = _pack(pt, "arena", shape, full=False)
        assert p._steps
        for s in range(SCENES):
            want = _oracle("arena", s)
            err_jax = float(np.abs(jx[s] - want).max())
            assert np.abs(got[s] - want).max() <= TOL, (shape, s)
            assert np.abs(got[s] - jx[s]).max() <= err_jax + TOL, (shape, s, err_jax)
