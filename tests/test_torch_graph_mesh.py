"""The port's ScenePack block steps on (scene, voice) meshes larger than
1 x 1, on logical CPU meshes (``make_mesh(a, b, ["cpu"] * n)``).

A pack whose scenes all declare ``graph_capture`` takes block steps on any
mesh: each cell runs its own steps over its own stack (on a card, one CUDA
graph per cell and key), a voice-sharded cell's step returns its pools'
partial mixes beside its mix, and the pack sums them after the cells'
calls as op by op.  Here the same steps run uncaptured, so these tests
hold the code that is captured there: config 5 (``config5_mini``) on 2 x
2, the host-pool pack with its submix on 2 x 2, the sampler pack with
fades on 2 x 2 and the spatial case on 2 x 4, through render_block and
render_frames_device at ``scan_unroll`` 1 and 8, bit for bit the same
mesh's ``eager()``; config 5 and the spatial case against the JAX
``ScenePack`` on its mesh of the conftest's virtual 8-device CPU mesh
within PARITY.md's 1e-5, with the runs the JAX scans have; a replay
emulated in every cell; each cell's stack leaves and rings where they
were; ``sync()`` and the handles; a host-pool play and growth between two
blocks of one run; and the read route of a host buffered pool, which must
be the pack's whichever scene group a cell holds.  Test names avoid the
JAX tests' (``conftest.py`` marks tests slow by name).
"""

import contextlib
import copy
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import oddio_tpu as ot  # noqa: E402
import oddio_tpu_torch as pt  # noqa: E402
import test_torch_graph_pack as GP  # noqa: E402
import test_torch_pack_host as TH  # noqa: E402
from oddio_tpu_torch.core import run as prun  # noqa: E402
from oddio_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from oddio_tpu_torch.parallel.sharded import ScenePack  # noqa: E402
from oddio_tpu_torch.utils.scene_profile import (  # noqa: E402
    build_host_pools_pack,
    build_sampler_pack,
    feed,
)
from oddio_tpu_torch.utils.tree import tree_leaves, tree_map  # noqa: E402
from test_torch_graph_step import _bits  # noqa: E402

torch.set_num_threads(1)

BLOCK, TOL = 512, 1e-5


def cpu_mesh(a, b):
    return make_mesh(a, b, ["cpu"] * (a * b))


def _mode(mode):
    return prun.eager() if mode == "eager" else contextlib.nullcontext()


def hostpack_script(unroll):
    """``build_host_pools_pack`` on 2 x 2 (4 scenes of 16 host Speed(Stream)
    voices, 2 device-resident Adapt(Stream) voices and a 64-voice config-5
    submix each): a block, then twice PCM on every stream, a set_speed, a
    block and a run of 6, then an idle run of 9."""
    p, ctls, speeds, rng = build_host_pools_pack(4, 16, "cpu", mesh=cpu_mesh(2, 2))
    p.scan_unroll = unroll
    out = [p.render_block(BLOCK)]
    for k in range(2):
        feed(ctls, rng, 400)
        speeds[5 * k].set_speed(1.15)
        out += [p.render_block(BLOCK), GP._frames(p, 6)]
    out.append(GP._frames(p, 9))
    return np.concatenate(out, axis=1), p, None


def sampler_script(unroll):
    """``build_sampler_pack`` on 2 x 2 (2 scenes of 16 Fader(Speed(
    FramesSignal)) voices, each on its own script of speed writes and
    fades every 8 blocks): 16 blocks through render_frames_device, 8
    through render_block."""
    drv = build_sampler_pack(2, 16, "cpu", sounds=2, seconds=1.0, mesh=cpu_mesh(2, 2))
    drv.pack.scan_unroll = unroll
    x = _frames_of(drv.render(16))
    y = np.concatenate(drv.render(8, device_out=False), axis=1)
    assert min(d.fades for d in drv.drivers) > 0
    return np.concatenate([x, y], axis=1), drv.pack, None


def _frames_of(parts):
    """(B, S, C, n) device tensors as numpy (S, B*n, C)."""
    x = np.concatenate([np.asarray(t) for t in parts])
    B, S, C, n = x.shape
    return x.transpose(1, 0, 3, 2).reshape(S, B * n, C)


#: each case's script and mesh (``config5`` and ``spatial`` the JAX pack runs too)
CASES = {
    "config5": lambda m, unroll: GP.config5_script(m, unroll, shape=(2, 2)),
    "spatial": lambda m, unroll: GP.spatial_script(m, unroll, shape=(2, 4), S=4),
    "hostpack": lambda m, unroll: hostpack_script(unroll),
    "sampler": lambda m, unroll: sampler_script(unroll),
}


@functools.lru_cache(maxsize=None)
def _run(case, m, unroll=1, mode="step"):
    with _mode(mode):
        return CASES[case](m, unroll)


def _cells_stepped(p):
    """The cells that ran steps of their own."""
    return {key[-1] for key in p._steps}


# -- the steps against eager() and the JAX pack -----------------------------------------


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_steps_match_eager_bit_for_bit(case):
    """Every cell steps, at ``scan_unroll`` 1 and 8 (calls of 8 blocks),
    bit for bit the same mesh's ``eager()`` (op by op, numpy params, the
    partial mixes summed per block)."""
    want, pe, _ = _run(case, pt, 1, "eager")
    assert pe._steps == {} and pe.graph_counts["eager"] > 0
    assert np.abs(want).max() > 1e-2 and np.isfinite(want).all()
    for unroll in (1, 8):
        got, p, _ = _run(case, pt, unroll)
        np.testing.assert_array_equal(got, want)
        assert p.graph_capture and p.B > 1 and p.step_partials
        assert _cells_stepped(p) == set(p._cells)
        assert {k[1] for k in p._steps} == {"single", "scan"}
        ks = {k for steps in p._steps.values() for k, _ in steps}
        assert max(ks) == 1 if unroll == 1 else max(ks) > 1  # calls of several blocks


def test_mesh_submix_steps_on_voice_shard_zero_only():
    """The host-pool pack's submix lives on voice shard 0 of each scene
    group: its state and its params ride only in those cells' stacks and
    packed rows, and only they return its partial mix."""
    _, p, _ = _run("hostpack", pt)
    sub = next(q for q in p.scenes[0]._all_pools() if getattr(q, "is_singleton", False))
    for (g, k) in p._cells:
        assert (sub.name in p._dstate[g, k]) is (k == 0)
        names = {name for key in p._steps if key[-1] == (g, k)
                 for name, _ in key[2][0]}
        assert (sub.name in names) is (k == 0)


@pytest.mark.parametrize("case", ["config5", "spatial"])
def test_mesh_steps_match_jax_pack_on_its_mesh(case):
    """Config 5 on 2 x 2 and the spatial case on 2 x 4 within 1e-5 of the
    JAX ScenePack on the same mesh of its virtual CPU devices, and the
    runs render_frames_device dispatches have the lengths, in order, of
    the JAX pack's scan programs."""
    want, _, jax_runs = _run(case, ot)
    assert np.abs(want).max() > 1e-2
    for unroll in (1, 8):
        got, _, runs = _run(case, pt, unroll)
        assert got.shape == want.shape and got.dtype == np.float32
        assert np.abs(got - want).max() <= TOL, np.abs(got - want).max()
        assert runs == jax_runs and len(runs) >= 5 and max(runs) > 2


# -- the replay emulated in every cell ---------------------------------------------------


@pytest.mark.parametrize("case, shape", [("config5_mini", (2, 2)), ("spatial", (2, 4))])
def test_mesh_block_step_reads_no_host_state(case, shape, monkeypatch):
    """A replay emulated in each cell: every call of a cell's step also runs
    on a deep copy of scene 0 frozen at that step's first call, from a
    copy of the cell's stack and rows, under the same cell.  Its outputs
    (the mix and the partial mixes) and stack equal the live call's bit
    for bit, and the live call changes no host attribute of any scene;
    the scenes differ in route flags, and every cell's steps run."""
    frozen, calls, log = {}, [], []
    live_call = prun.BlockSteps._eager_call

    def spy(self, step, d0, dd):
        if id(step) not in frozen:
            frozen[id(step)] = (step, copy.deepcopy(self.scenes[0]))
        before = GP._pack_host(self)
        d_in = tree_map(torch.clone, d0)
        rows = None if step.rows is None else step.rows.clone()
        out = live_call(self, step, d0, dd)
        assert GP._pack_host(self) == before, "the block step changed a host attribute"
        d_f, out_f = prun.step_body(frozen[id(step)][1], step.kind, step.pack, step.n, step.k,
                                    d_in, dd, rows, self.step_partials)
        assert set(out) == {"mix", "parts"} and out["parts"]  # the partial mixes too
        assert len(tree_leaves(out_f)) == len(tree_leaves(out))
        for a, b in zip(tree_leaves(out_f), tree_leaves(out)):
            assert torch.equal(_bits(a), _bits(b))
        for a, b in zip(tree_leaves(d_f), tree_leaves(self._step_get())):
            assert torch.equal(_bits(a), _bits(b))
        calls.append((self._cell, self.scenes[0].archetype()))
        return out

    monkeypatch.setattr(ScenePack, "_eager_call", spy)
    got = GP.FLIPS[case](log, shape)
    monkeypatch.undo()
    with prun.eager():
        want = GP.FLIPS[case]([], shape)
    np.testing.assert_array_equal(got, want)
    assert np.abs(got).max() > 1e-2
    assert {c for c, _ in calls} == set(log[0]._cells)
    assert len({a for _, a in calls}) > 1
    assert log[0].graph_counts["eager"] == len(calls)


# -- the stacks, handles, plays and growth -------------------------------------------------


def test_mesh_stack_leaves_stay_put_in_every_cell():
    """Across runs of steps on a 2 x 2 mesh each cell's stack keeps every
    leaf in its tensor and never moves a ring; growth restacks every
    cell."""
    built = [GP.config5_mini(pt, s) for s in range(2)]
    scenes = [b[0] for b in built]
    flat = [c for b in built for c in b[1]]
    p = GP._pack(pt, scenes, 4, (2, 2))
    p.render_block(BLOCK)
    before = {c: tree_leaves(p._dstate[c]) for c in p._cells}
    rings = {c: [x.data_ptr() for x in GP._rings(p._dstate[c])] for c in p._cells}
    assert all(len(r) == 1 for r in rings.values())
    for j, c in enumerate(flat):
        c.write(GP.PCM[j])
    GP._frames(p, 9)
    h = pt.MixerControl(scenes[0]).play(GP._adapt_sine(pt, 330.0))
    p.render_block(BLOCK)
    h.stop()
    flat[2].close()
    GP._frames(p, 6)
    for c in p._cells:
        after = tree_leaves(p._dstate[c])
        assert len(after) == len(before[c]) and all(a is b for a, b in zip(after, before[c]))
        assert [x.data_ptr() for x in GP._rings(p._dstate[c])] == rings[c]
    control = pt.MixerControl(scenes[1])
    for f in range(10):
        control.play(GP._adapt_sine(pt, 200.0 + 50 * f))
    assert p._dstate is None  # the growth pulled the stacks back into the scenes
    GP._frames(p, 3)
    for c in p._cells:
        assert not any(a is b for a, b in zip(tree_leaves(p._dstate[c]), before[c]))


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_mesh_sync_and_handles_after_steps(shape):
    """Closed streams drain inside the steps of a voice-sharded mesh; after
    each ``pack.sync()`` (which gathers each scene's state from its shards)
    the handles see ``is_stopped()`` on the same blocks as under
    ``eager()``, and the slots are reclaimed."""
    want, end_e, free_e, _ = GP._drain_pack("eager", True, shape)
    got, end_s, free_s, p = GP._drain_pack("step", True, shape)
    assert got == want
    assert end_s == end_e == [True, True]
    assert free_s == free_e == p.scenes[1]._all_pools()[1].capacity
    k = [any(x) for x in want].index(True)
    assert 2 <= k <= 5 and not all(want[k])
    assert _cells_stepped(p) == set(p._cells)


def test_mesh_growth_between_two_blocks_of_a_run():
    """A pool that grows between two blocks of one render_frames_device
    call on a 2 x 2 mesh: the run every cell holds renders first, and the
    rest on the grown stacks; bit for bit ``eager()``."""
    got, p = GP._grow_mid_run("step", (2, 2))
    want, _ = GP._grow_mid_run("eager", (2, 2))
    assert np.abs(want).max() > 1e-2
    np.testing.assert_array_equal(got, want)
    assert [q.capacity for s in p.scenes for q in s._all_pools()] == [2, 16, 2, 16]
    assert p._flush is None and _cells_stepped(p) == set(p._cells)


def _host_play_mid_run(mode):
    """Two host-pool scenes (``test_torch_pack_host.host_scene``) on a 1 x 2
    mesh: 3 blocks, then a run of 6 between whose first two blocks every
    scene plays a Speed(Stream) voice into its host buffered pool (its
    slot reset cannot write through views of a voice-sharded stack: the
    pack flushes the run, writes the state back and restacks), then 4
    blocks.  Returns (audio, pack, stacks' first leaves before the play)."""
    with _mode(mode):
        built = [TH.host_scene(pt, s, n_speed=2) for s in range(2)]
        p = ScenePack([b[0] for b in built], 8000, cpu_mesh(1, 2), scan_unroll=4)
        out = [GP._frames(p, 3)]
        first = {c: tree_leaves(p._dstate[c])[0] for c in p._cells}

        def play():
            for control_scene, _, _ in built:
                st = pt.Stream(8000, 4096)
                sc, sp = pt.Speed.new(st)
                sc.set_speed(1.1)
                st.control.write((np.sin(np.arange(2000) * 0.05) * 0.3).astype(np.float32))
                pt.SpatialSceneControl(control_scene).play_buffered(
                    sp, pt.SpatialOptions(position=[2.0, 1.0, -1.0]), max_distance=40.0,
                    rate=8000, buffer_duration=0.1)

        GP._between_blocks(p, play)
        out += [GP._frames(p, 6), GP._frames(p, 4)]
        return np.concatenate(out, axis=1), p, first


def test_mesh_host_pool_play_between_two_blocks_of_a_run():
    """A host-pool play between two blocks of one run on a voice-sharded
    mesh: the run renders first, the stacks are rebuilt (new leaves: on a
    card each affected step captures again) and the audio equals
    ``eager()``'s bit for bit."""
    got, p, first = _host_play_mid_run("step")
    want, _, _ = _host_play_mid_run("eager")
    assert np.abs(want).max() > 1e-2
    np.testing.assert_array_equal(got, want)
    assert all(tree_leaves(p._dstate[c])[0] is not first[c] for c in p._cells)
    assert _cells_stepped(p) == set(p._cells)


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
@pytest.mark.parametrize("mode", ["eager", "step"])
def test_mesh_scene_groups_take_the_pack_read_route(shape, mode):
    """Scene 1 holds a 60 m/s mover whose walk leaves K5's strip gate, in
    another scene group than scene 0: every cell reads the host buffered
    voices on the exact route that block (scene 0's pool renders every
    cell), as the 1 x 1 pack does, within 2e-6 of it."""
    def run(mesh, mode):
        with _mode(mode):
            scenes = [TH.host_scene(pt, s, n_speed=5 if s == 0 else 4,
                                    fast=[60.0, 0.0, 0.0] if s == 1 else None)[0]
                      for s in range(2)]
            p = ScenePack(scenes, 8000, mesh)
            out = [p.render_block(BLOCK) for _ in range(2)] + [GP._frames(p, 3)]
            return np.concatenate(out, axis=1), p

    want, _ = run(cpu_mesh(1, 1), "eager")
    got, p = run(cpu_mesh(*shape), mode)
    assert not any(next(iter(s._buffered_pools.values()))._use_strips for s in p.scenes)
    assert np.abs(want).max() > 0.01
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
