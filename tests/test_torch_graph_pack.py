"""The port's ScenePack block steps (``parallel/sharded.py`` over
``core/run.BlockSteps``) on the CPU, against the JAX package's ScenePack.

A 1 x 1 pack whose scenes all declare ``graph_capture`` (config-5 Mixers,
Sine-only SpatialScenes) renders through block steps: ``render_block``
through a ``"single"`` key, ``render_frames_device`` through the JAX
pack's runs of equal-archetype blocks, each run as calls of
``scan_unroll`` blocks, every block's merged params one packed row.  On a
card each step is a CUDA graph; here the same step runs uncaptured, so
these tests hold the code that is captured there: the audio against the
JAX ScenePack within PARITY.md's 1e-5 (at ``scan_unroll`` 1 there, 1 and
8 here, the port's two bit-equal), the runs' lengths and boundaries
against the JAX pack's scan programs, the step against ``eager()`` bit for
bit, a replay emulated on a copy of scene 0 frozen at each step's first
call across a route flip in one scene, the stack's leaves and rings where
they were, ``sync()`` and the handles after steps, and the packs that stay
op by op.  Test names avoid the JAX tests' (``conftest.py`` marks tests
slow by name).
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
from oddio_tpu.parallel.mesh import make_mesh as jax_mesh  # noqa: E402
from oddio_tpu.parallel.sharded import ScenePack as JaxPack  # noqa: E402
from oddio_tpu_torch.core import run as prun  # noqa: E402
from oddio_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from oddio_tpu_torch.parallel.sharded import ScenePack  # noqa: E402
from oddio_tpu_torch.utils.tree import tree_leaves, tree_map  # noqa: E402
from test_torch_graph_step import _bits, _host  # noqa: E402
from test_torch_pack import PCM, build_spatial_scene, config5_mini  # noqa: E402

torch.set_num_threads(1)

RATE, BLOCK, TOL = 8000, 512, 1e-5


def _pack(m, scenes, unroll=1, shape=(1, 1)):
    """The JAX pack on its CPU mesh of ``shape``, or the port's on a
    logical CPU mesh of ``shape``."""
    if m is ot:
        return JaxPack(scenes, RATE, jax_mesh(*shape), scan_unroll=unroll)
    return ScenePack(scenes, RATE, make_mesh(*shape, ["cpu"] * (shape[0] * shape[1])),
                     scan_unroll=unroll)


def _frames(p, nblocks):
    """``render_frames_device`` as numpy (S, nblocks*n, C)."""
    x = np.concatenate([np.asarray(t) for t in p.render_frames_device(BLOCK * nblocks)])
    B, S, C, n = x.shape
    return x.transpose(1, 0, 3, 2).reshape(S, B * n, C)


def _adapt_sine(m, f, tau=0.1):
    return m.Adapt(m.Sine(0.3, f), 0.1, m.AdaptOptions(tau=tau, max_gain=4.0))


def _spy_runs(p, m):
    """The run lengths ``p`` dispatches: the JAX pack's scan programs, the
    port's ``"scan"`` dispatches."""
    runs = []
    if m is ot:
        get = p._get_scan_step

        def spy(arch, n, nblocks):
            runs.append(nblocks)
            return get(arch, n, nblocks)

        p._get_scan_step = spy
    else:
        dispatch = p._dispatch_steps

        def spy(arch, kind, pend, n):
            if kind == "scan":
                runs.append(len(pend))
            return dispatch(arch, kind, pend, n)

        p._dispatch_steps = spy
    return runs


def _between_blocks(p, act):
    """Run ``act()`` between the first two blocks of ``p``'s next
    render_frames_device call (a control thread): before the stepped
    pack, or the JAX pack, asks scene 0 for a structure event, or under
    ``eager()``, which renders each block before preparing the next, before
    the second block's prepare."""
    if isinstance(p, ScenePack) and prun.eager_mode():
        prepare = p._block_params

        def block_params(n, _count=[0]):
            _count[0] += 1
            if _count[0] == 2:
                del p._block_params
                act()
            return prepare(n)

        p._block_params = block_params
        return
    scene = p.scenes[0]
    check = scene.host_structure_event

    def once():
        del scene.host_structure_event
        act()
        return check()

    scene.host_structure_event = once


def config5_script(m, unroll=1, grow="all", shape=(1, 1)):
    """Two config-5 mini mixers (``test_torch_pack.config5_mini``) through
    render_block and render_frames_device: stream writes, a play and a
    stop, a stream close, twelve plays (a bulk play, past the Adapt(Sine)
    pool's 8 slots) in scene 1 (``grow`` "one") or in every scene (the JAX
    pack stacks only equal capacities), and a play in scene 0, then nine
    plays in every scene between the first two blocks of the next call (a
    bulk play: a structure event, which flushes the run); on a mesh of
    ``shape``.  Returns (audio (S, N, C), pack, run lengths)."""
    built = [config5_mini(m, s) for s in range(2)]
    scenes = [b[0] for b in built]
    flat = [c for b in built for c in b[1]]
    p = _pack(m, scenes, unroll, shape)
    runs = _spy_runs(p, m)
    controls = [m.MixerControl(s) for s in scenes]
    out = [p.render_block(BLOCK) for _ in range(2)]
    for j, c in enumerate(flat):
        c.write(PCM[j])
    out.append(_frames(p, 6))
    h = controls[0].play(_adapt_sine(m, 440.0))
    out.append(p.render_block(BLOCK))
    h.stop()
    flat[1].close()
    for j, c in enumerate(flat):
        c.write(PCM[j, :300])
    out.append(_frames(p, 5))
    rng = np.random.default_rng(3)
    for control in controls[1:] if grow == "one" else controls:
        for _ in range(12):
            control.play(_adapt_sine(m, rng.uniform(100, 1000)))
    out.append(_frames(p, 7))
    out.append(p.render_block(BLOCK))
    out.append(_frames(p, 12))
    controls[0].play(_adapt_sine(m, 620.0))

    def bulk():
        for control in controls:
            for _ in range(9):
                control.play(_adapt_sine(m, rng.uniform(100, 1000)))

    _between_blocks(p, bulk)
    out.append(_frames(p, 9))
    return np.concatenate(out, axis=1), p, runs


def spatial_script(m, unroll=1, shape=(1, 1), S=3):
    """``S`` spatial scenes (8 buffered and 8 seek Sine voices at 8 kHz)
    through render_block and render_frames_device: a smoothed move near a
    buffered voice and a discontinuous jump of a seek voice in scene 0, a
    listener rotation in scene 1; on a mesh of ``shape``.  Returns (audio,
    pack, run lengths)."""
    built = [build_spatial_scene(m, s) for s in range(S)]
    p = _pack(m, [b[1] for b in built], unroll, shape)
    runs = _spy_runs(p, m)
    out = [p.render_block(BLOCK) for _ in range(2)]
    out.append(_frames(p, 5))
    built[0][2][2].set_motion([4.0, 0.0, -6.0], [0.0, 3.0, 0.0], False)
    built[0][2][9].set_motion([-3.0, 1.0, 2.0], [1.0, 0.0, 0.0], True)
    built[1][0].set_listener_rotation([np.cos(0.3), 0.0, np.sin(0.3), 0.0])
    out.append(_frames(p, 6))
    out.append(p.render_block(BLOCK))
    out.append(_frames(p, 12))
    return np.concatenate(out, axis=1), p, runs


SCRIPTS = {"config5_mini": config5_script, "spatial": spatial_script}


@functools.lru_cache(maxsize=None)
def _run(case, m, unroll=1, mode="step"):
    with prun.eager() if mode == "eager" else contextlib.nullcontext():
        return SCRIPTS[case](m, unroll)


# -- the pack against the JAX ScenePack ------------------------------------------------


@pytest.mark.parametrize("case", sorted(SCRIPTS))
def test_stepped_pack_matches_jax_pack(case):
    """render_block and render_frames_device through the steps within 1e-5
    of the JAX ScenePack (its scans at unroll 1); the port's unroll 1 and 8
    bit-equal, each call of 8 blocks one step."""
    want, _, _ = _run(case, ot)
    got, p1, _ = _run(case, pt, 1)
    got8, p8, _ = _run(case, pt, 8)
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(want).max() > 1e-2
    assert np.abs(got - want).max() <= TOL, np.abs(got - want).max()
    np.testing.assert_array_equal(got8, got)
    for p in (p1, p8):
        assert p.graph_capture and p.graph_counts["eager"] > 0
        assert p.graph_counts["replays"] == 0
        assert {k[1] for k in p._steps} == {"single", "scan"}
    assert all(k == 1 for steps in p1._steps.values() for k, _ in steps)
    assert any(k == 8 for steps in p8._steps.values() for k, _ in steps)


@pytest.mark.parametrize("case", sorted(SCRIPTS))
def test_pack_runs_match_jax_scans(case):
    """The runs render_frames_device dispatches (flushed on structure
    events and archetype changes, idle runs whole) have the lengths, in
    order, of the JAX pack's scan programs; with plays, stops, writes, a
    close and growth in one scene on the config-5 pack."""
    _, _, want = _run(case, ot)
    if case == "config5_mini":
        _, p, got = config5_script(pt, grow="one")
        assert [q.capacity for s in p.scenes for q in s._all_pools()] == [2, 32, 2, 32]
    else:
        _, _, got = _run(case, pt)
    assert got == want and len(want) >= 5
    assert max(want) > 2


@pytest.mark.parametrize("case", sorted(SCRIPTS))
def test_pack_step_matches_eager_bit_for_bit(case):
    """The steps (packed rows, lanes on the device, copy-back into the
    stack) against ``eager()`` (op by op, numpy params, the state stored as
    returned), through control traffic: bit for bit."""
    ref, pe, _ = _run(case, pt, 1, "eager")
    got, _, _ = _run(case, pt, 1)
    assert pe._steps == {} and pe.graph_counts["eager"] > 0
    np.testing.assert_array_equal(got, ref)
    if case == "config5_mini":
        a, _, _ = config5_script(pt, grow="one")
        with prun.eager():
            b, _, _ = config5_script(pt, grow="one")
        np.testing.assert_array_equal(a, b)


# -- the replay emulated --------------------------------------------------------------


def _pack_host(p):
    """A comparable picture of the scenes' and their pools' host state
    (the device state, the upload caches and the count tensors left out)."""
    skip = {"_pools", "_buffered_pools", "_seek_pools", "_rot_dev"}
    return _host([{"scene": {k: v for k, v in vars(s).items() if k not in skip},
                   "pools": [{k: v for k, v in vars(q).items()
                              if k not in ("state", "_count_t", "_unpack_hook")}
                             for q in s._all_pools()]}
                  for s in p.scenes])


def _scheduled(p, actions):
    """Run ``actions[i]()`` just before the pack prepares its i-th block of
    the call (a control thread acting between two blocks of one call)."""
    prepare, count = p._block_params, [0]

    def block_params(n):
        act = actions.get(count[0])
        count[0] += 1
        if act is not None:
            act()
        return prepare(n)

    p._block_params = block_params
    return count


def _flip_config5(log, shape=(1, 1)):
    """Two config-5 mini mixers on K7 (tau 0.1 s everywhere); a tiny-tau
    voice played in scene 1 between two blocks of one call sends the pack
    to the scan.  ``log`` gets the pack (on a mesh of ``shape``)."""
    built = [config5_mini(pt, s) for s in range(2)]
    p = _pack(pt, [b[0] for b in built], shape=shape)
    log.append(p)
    out = [_frames(p, 3)]
    control = pt.MixerControl(built[1][0])
    hs = []
    count = _scheduled(p, {0: lambda: hs.append(control.play(_adapt_sine(pt, 300.0))),
                           1: lambda: hs.append(control.play(_adapt_sine(pt, 500.0, 1e-6))),
                           2: lambda: hs[0].stop()})
    out.append(_frames(p, 8))
    assert count[0] >= 3
    pool = p.scenes[0]._all_pools()[1]
    assert not pool._ema_fast and not pool.proto._pool_ema_fast
    return np.concatenate(out, axis=1)


def _flip_spatial(log, shape=(1, 1)):
    """Two spatial scenes; a fast move in scene 1 between two blocks of one
    call changes the pack's read tier."""
    built = [build_spatial_scene(pt, s) for s in range(2)]
    p = _pack(pt, [b[1] for b in built], shape=shape)
    log.append(p)
    out = [_frames(p, 3)]
    h = built[1][2][1]
    _scheduled(p, {2: lambda: h.set_motion([6.0, 0.0, 1.0], [0.0, 40.0, 0.0], False)})
    out.append(_frames(p, 8))
    return np.concatenate(out, axis=1)


FLIPS = {"config5_mini": _flip_config5, "spatial": _flip_spatial}


@pytest.mark.parametrize("case", sorted(FLIPS))
def test_pack_block_step_reads_no_host_state(case, monkeypatch):
    """A replay emulated: each call of a pack's step also runs on a deep
    copy of scene 0 frozen at that step's first call, from a copy of the
    same stack and rows.  Its audio and stack equal the live call's bit for
    bit, and the live call changes no host attribute of any scene; the
    scenes differ in route flags (a tiny-tau voice in one config-5 scene,
    a fast move in one spatial scene), and the run prepared before the
    flip renders as of its own archetype."""
    frozen, calls, log = {}, [], []
    live_call = prun.BlockSteps._eager_call

    def spy(self, step, d0, dd):
        if id(step) not in frozen:
            # the step is held too, so that its id is not reused
            frozen[id(step)] = (step, copy.deepcopy(self.scenes[0]))
        before = _pack_host(self)
        d_in = tree_map(torch.clone, d0)
        rows = None if step.rows is None else step.rows.clone()
        out = live_call(self, step, d0, dd)
        assert _pack_host(self) == before, "the block step changed a host attribute"
        d_f, out_f = prun.step_body(frozen[id(step)][1], step.kind, step.pack, step.n, step.k,
                                    d_in, dd, rows)
        assert torch.equal(_bits(out_f), _bits(out))
        for a, b in zip(tree_leaves(d_f), tree_leaves(self._step_get())):
            assert torch.equal(_bits(a), _bits(b))
        calls.append(self.scenes[0].archetype())
        return out

    monkeypatch.setattr(ScenePack, "_eager_call", spy)
    got = FLIPS[case](log)
    monkeypatch.undo()
    with prun.eager():
        want = FLIPS[case]([])
    np.testing.assert_array_equal(got, want)
    assert np.abs(got).max() > 1e-2 and len(calls) >= 6
    assert len(set(calls)) > 1
    assert log[0].graph_counts["eager"] == len(calls)


# -- the stack, handles, and packs that stay op by op ----------------------------------


def _rings(tree):
    """The ring leaves of a state tree (the leaves a step writes in place)."""
    return [x for k, v in tree.items()
            for x in (_rings(v) if isinstance(v, dict) else [v] if k == "ring" else [])]


def test_pack_stack_leaves_stay_put():
    """Across runs of steps the stack keeps every leaf in its tensor and
    never moves a ring; growth in one scene restacks (new leaves, one
    capacity); ``eager()`` stores what the render returns."""
    built = [config5_mini(pt, s) for s in range(2)]
    scenes = [b[0] for b in built]
    flat = [c for b in built for c in b[1]]
    p = _pack(pt, scenes, 4)
    p.render_block(BLOCK)
    before = tree_leaves(p._dstate[0, 0])
    rings = [x.data_ptr() for x in _rings(p._dstate[0, 0])]
    assert len(rings) == 1
    for j, c in enumerate(flat):
        c.write(PCM[j])
    _frames(p, 9)
    h = pt.MixerControl(scenes[0]).play(_adapt_sine(pt, 330.0))
    p.render_block(BLOCK)
    h.stop()
    flat[2].close()
    _frames(p, 6)
    after = tree_leaves(p._dstate[0, 0])
    assert len(after) == len(before) and all(a is b for a, b in zip(after, before))
    assert [x.data_ptr() for x in _rings(p._dstate[0, 0])] == rings
    control = pt.MixerControl(scenes[1])
    for f in range(10):
        control.play(_adapt_sine(pt, 200.0 + 50 * f))
    assert p._dstate is None  # the growth pulled the stack back into the scenes
    _frames(p, 3)
    grown = tree_leaves(p._dstate[0, 0])
    assert not any(a is b for a, b in zip(grown, before))
    assert {q.capacity for s in scenes for q in s._all_pools()} == {2, 16}
    with prun.eager():
        p.render_block(BLOCK)
    assert any(a is not b for a, b in zip(tree_leaves(p._dstate[0, 0]), grown))


def _grow_mid_run(mode, shape=(1, 1)):
    """Two config-5 mini mixers: 4 blocks, a play in scene 0, then 10
    blocks in one call, between whose first two blocks three plays grow
    scene 1's Adapt(Sine) pool (8 slots, 6 voices: no bulk play, so no
    structure event).  Returns (audio, pack)."""
    with prun.eager() if mode == "eager" else contextlib.nullcontext():
        scenes = [config5_mini(pt, s)[0] for s in range(2)]
        p = _pack(pt, scenes, 4, shape)
        out = [_frames(p, 4)]
        pt.MixerControl(scenes[0]).play(_adapt_sine(pt, 620.0))
        control = pt.MixerControl(scenes[1])
        _between_blocks(p, lambda: [control.play(_adapt_sine(pt, 200.0 + 90 * k))
                                    for k in range(3)])
        out.append(_frames(p, 10))
        return np.concatenate(out, axis=1), p


def test_pack_growth_between_two_blocks_of_a_run():
    """A pool that grows between two blocks of one render_frames_device
    call pulls the stack back into the scenes (``_unpack``): the run the
    steps hold renders first, on the state it was prepared against, and
    the rest on the grown stack; bit for bit as under ``eager()``, which
    renders each block before preparing the next."""
    got, p = _grow_mid_run("step")
    want, _ = _grow_mid_run("eager")
    assert np.abs(want).max() > 1e-2
    np.testing.assert_array_equal(got, want)
    assert [q.capacity for s in p.scenes for q in s._all_pools()] == [2, 16, 2, 16]
    assert p._flush is None and p._steps


def _drain_pack(mode, per_block_sync, shape=(1, 1)):
    """Two mixers of two Adapt(Sine) voices and a closed Adapt(Stream) of
    1200 and 2000 samples (2.3 and 3.9 blocks): the handles' ``is_stopped()`` after
    each render (with ``per_block_sync``, after ``pack.sync()``), and the
    pool's free slots at the end."""
    hs, mixers = [], []
    for s in range(2):
        control, mixer = pt.Mixer.new(channels=1, device="cpu")
        for f in (220.0, 330.0):
            control.play(_adapt_sine(pt, f + s))
        ctl, st = pt.Stream.new(8000, 2048)
        ctl.write(np.full(1200 + 800 * s, 0.25, np.float32))
        ctl.close()
        hs.append(control.play(pt.Adapt(st, 0.1, pt.AdaptOptions(tau=0.1, max_gain=4.0))))
        mixers.append(mixer)
    p = _pack(pt, mixers, shape=shape)
    seq = []
    with prun.eager() if mode == "eager" else contextlib.nullcontext():
        for k in range(8):
            if k % 2:
                p.render_block(BLOCK)
            else:
                p.render_frames_device(BLOCK)
            if per_block_sync:
                p.sync()
            seq.append([h.is_stopped() for h in hs])
    p.sync()
    pool = hs[1]._pool
    return seq, [h.is_stopped() for h in hs], len(pool._free), p


def test_pack_sync_and_handles_after_steps():
    """Closed streams drain inside the steps; ``sync()`` reclaims their
    slots and the handles see ``is_stopped()`` on the same blocks as under
    ``eager()``; without a sync the handles read the stack the steps left
    (the scenes hold views of it, their store counts bumped), never a
    stale copy."""
    want, end_e, free_e, _ = _drain_pack("eager", True)
    got, end_s, free_s, p = _drain_pack("step", True)
    assert got == want
    assert end_s == end_e == [True, True]
    assert free_s == free_e == p.scenes[1]._all_pools()[1].capacity
    k = [any(x) for x in want].index(True)
    assert 2 <= k <= 5 and not all(want[k])
    assert p.graph_counts["replays"] == 0 and p._steps
    late, end_l, free_l, _ = _drain_pack("step", False)
    assert late == want
    assert end_l == [True, True] and free_l == free_s


def test_other_packs_stay_op_by_op():
    """A pack of scenes with a host seek pool (``_SeekPool``), on a 1 x 1
    and on a 2 x 2 mesh, renders op by op: no step, every block counted as
    an op-by-op call.  The config-5 pack on a 2 x 2 mesh, the host-pool
    pack and the submix pack take block steps, bit for bit ``eager()``'s."""
    from oddio_tpu_torch.utils.scene_profile import build_config5_pack, build_host_pools_pack

    class FiniteSine(pt.Sine):
        def host_is_finished(self):
            return np.asarray(self.phase) > 2.0

    def seek_scene(s):
        control, scene = pt.SpatialScene.new(device="cpu")
        control.play(FiniteSine(0.1 * s, 300.0 + s), pt.SpatialOptions(position=[2.0, 1.0, 0.0]))
        return scene

    def subs():
        out = []
        for s in range(2):
            control, mixer = pt.Mixer.new(channels=1, device="cpu")
            control.play(_adapt_sine(pt, 300.0 + s))
            inner = pt.Mixer(1, device="cpu")
            pt.MixerControl(inner).play(_adapt_sine(pt, 500.0 + s))
            control.play(inner)
            out.append(mixer)
        return ScenePack(out, RATE, make_mesh(1, 1, ["cpu"]))

    mesh = make_mesh(2, 2, ["cpu"] * 4)
    ps = ScenePack([seek_scene(s) for s in range(2)], RATE, make_mesh(1, 1, ["cpu"]))
    ps22 = ScenePack([seek_scene(s) for s in range(2)], RATE, mesh)
    one, _, _ = build_config5_pack(2, "cpu", voices=16)
    assert one.graph_capture
    for p in (ps, ps22):
        assert not p.graph_capture
        p.render_block(BLOCK)
        out = p.render_frames_device(BLOCK * 3)
        assert len(out) == 1 and out[0].shape[0] == 3
        assert p._steps == {} and p.graph_counts["eager"] == 4
    runs = []
    for ctx in (contextlib.nullcontext(), prun.eager()):
        with ctx:
            p22, _, _ = build_config5_pack(2, "cpu", voices=16, mesh=mesh)
            hp, _, _, _ = build_host_pools_pack(2, 16, "cpu")
            sp = subs()
            got = []
            for p in (p22, hp, sp):
                assert p.graph_capture
                got.append(torch.from_numpy(p.render_block(BLOCK)))
                got.extend(p.render_frames_device(BLOCK * 3))
                assert bool(p._steps) is not prun.eager_mode()
            # every cell of the 2 x 2 has steps of its own
            assert {k[-1] for k in p22._steps} == (
                set() if prun.eager_mode() else set(p22._cells))
            runs.append(got)
    for a, b in zip(*runs):
        assert torch.equal(a, b)
