"""The port's Renderer block step on BASELINE config 4's dense mix and the
wavetable, on the CPU, against the JAX package's Renderer.

A wrapper root (``Tanh(Reinhard(mixer))``, config 4's golden
``Downmix(Tanh(Reinhard(stereo mixer)))``) renders its mixer directly and
forwards ``graph_capture``, ``GRAPH_INPLACE`` and ``render_archetype``;
a Mixer whose device-resident pools hold chains of Gain, FixedGain,
Constant, MonoToStereo, Downmix, Reinhard, Tanh, Speed, Cycle, Sine,
Adapt and Stream declares ``graph_capture``.  Their Renderers pack each
block's params into one float32 row and run one block step per
``(archetype, kind, pack spec)`` key; on a card the step is a CUDA graph
(the wavetable's holds K6's arena form, ``arena_step``), here the same
step runs uncaptured.  These tests hold: the audio against the JAX
Renderer within PARITY.md's 1e-5 (bench.py's dense mix at unroll 1 and 4
with its buckets, the golden chain, the wavetable through a set_speed
script that flips its pool between the arena step and the exact gather
and back), the step keys and dispatches against the JAX Renderer's, the
row against the JAX package's ``_pack_row`` bit for bit, the step
against ``eager()`` bit for bit, a replay emulated on a copy of the
root frozen at each step's first call, no tensor read on the host inside
a step, the state leaves where they were, and both scenes carried over
from the JAX package with ``carry_mixer``.  Test names avoid the JAX
tests' (``conftest.py`` marks tests slow by name).
"""

import copy
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import oddio_tpu as ot  # noqa: E402
import oddio_tpu_torch as pt  # noqa: E402
from oddio_tpu.core import run as jrun  # noqa: E402
from oddio_tpu_torch.core import run as prun  # noqa: E402
from oddio_tpu_torch.utils.scene_profile import (BUCKETS, build_densemix,  # noqa: E402
                                                 build_wavetable)
from oddio_tpu_torch.utils.tree import tree_flatten, tree_leaves, tree_map  # noqa: E402
from test_torch_graph_mixer import _mixer_host, _scheduled  # noqa: E402
from test_torch_graph_step import _bits, _offsets, _paths, host_read_guard  # noqa: E402

torch.set_num_threads(1)

RATE, BLOCK, TOL = 48000, 512, 1e-5
VOICES = 32
#: the wavetable's 2048-sample sine table (``bench.py:473``)
TABLE = np.sin(np.linspace(0, 2 * np.pi, 2048, endpoint=False)).astype(np.float32)


def _jax_densemix(voices, seed=0):
    """``build_densemix``'s draws in the JAX package."""
    rng = np.random.default_rng(seed)
    control, mixer = ot.Mixer.new(channels=1)
    gcs = []
    for _ in range(voices):
        gc, g = ot.Gain.new(ot.Sine(rng.uniform(0, 6), rng.uniform(50, 4000)))
        gc.set_gain(rng.uniform(-20, 0))
        gcs.append(gc)
        control.play(g)
    return ot.Tanh(ot.Reinhard(mixer)), mixer, gcs, rng


def _jax_wavetable(voices, seed=0):
    """``build_wavetable``'s draws in the JAX package."""
    rng = np.random.default_rng(seed)
    frames = ot.Frames.from_slice(RATE, TABLE)
    control, mixer = ot.Mixer.new(channels=1)
    scs = []
    for _ in range(voices):
        c = ot.Cycle(frames)
        c.seek(float(rng.uniform(0, 0.04)))
        sc, sp = ot.Speed.new(c)
        scs.append(sc)
        control.play(sp)
    return mixer, scs, rng


def _golden(m, voices, seed=3):
    """Config 4's golden chain (``tests/test_torch_gain.py``'s): voices of
    ``MonoToStereo(FixedGain(Sine))`` in a stereo mixer under
    ``Downmix(Tanh(Reinhard(mixer)))``."""
    rng = np.random.default_rng(seed)
    control, mixer = m.Mixer.new(channels=2, **({"device": "cpu"} if m is pt else {}))
    for _ in range(voices):
        control.play(m.MonoToStereo(m.FixedGain(
            m.Sine(rng.uniform(0, 6), rng.uniform(100, 2000)), rng.uniform(-12, 3))))
    return m.Downmix(m.Tanh(m.Reinhard(mixer))), mixer, rng


def build(m, kind, voices=VOICES):
    """``kind``'s scene in package ``m`` (the same draws): (root, mixer,
    controls, rng, a new voice from rng)."""
    if kind == "dense":
        root, mixer, ctls, rng = (_jax_densemix(voices) if m is ot
                                  else build_densemix(voices, "cpu"))

        def voice():
            gc, g = m.Gain.new(m.Sine(rng.uniform(0, 6), rng.uniform(50, 4000)))
            gc.set_gain(rng.uniform(-20, 0))
            return g
    elif kind == "golden":
        root, mixer, rng = _golden(m, voices)
        ctls = []

        def voice():
            return m.MonoToStereo(m.FixedGain(m.Sine(rng.uniform(0, 6), 440.0), -6.0))
    else:
        mixer, ctls, rng = _jax_wavetable(voices) if m is ot else build_wavetable(voices, "cpu")
        root = mixer

        def voice():
            c = m.Cycle(m.Frames.from_slice(RATE, TABLE[::2].copy()))
            sc, sp = m.Speed.new(c)
            sc.set_speed(0.9)
            return sp
    return root, mixer, ctls, rng, voice


def _tick(kind, ctls, t):
    """Control tick ``t``: set_gain on 8 voices (dense); set_speed on 8
    (wavetable): into the step tier 4 at t = 0, past the arena step's
    bound (the exact gather) on 4 at t = 1, back at t = 2."""
    if kind == "dense":
        for i, gc in enumerate(ctls[8 * t:8 * (t + 1)]):
            gc.set_gain(-3.0 * i - t)
    elif kind == "wave":
        for sc in ctls[8 * t:8 * (t + 1)] if t == 0 else ctls[:4]:
            sc.set_speed({0: 3.0, 1: 5.0, 2: 1.1}[t])


def script(m, kind, unroll=1, buckets=None):
    """``kind``'s scene through one control script: an idle run, control
    ticks, plays (the pool grows), render_block, a tail block, and a play
    and a tick between two blocks of one call.  Returns (audio,
    renderer, JAX dispatches by kind, root)."""
    root, mixer, ctls, rng, voice = build(m, kind)
    r = m.Renderer(root, RATE, scan_unroll=unroll, scan_buckets=buckets)
    kinds = {}
    if m is ot:
        get_step = r._get_step

        def spy(kind_, *a, **kw):
            k = kind_ if isinstance(kind_, str) else tuple(kind_)
            kinds[k] = kinds.get(k, 0) + 1
            return get_step(kind_, *a, **kw)

        r._get_step = spy
    out = [r.render_frames(BLOCK * 20)]
    _tick(kind, ctls, 0)
    out.append(r.render_frames(BLOCK * 6))
    mixer.play(voice())
    mixer.play(voice())
    out += [r.render_block(BLOCK) for _ in range(3)]
    _tick(kind, ctls, 1)
    out.append(r.render_frames(BLOCK * 9 + 100))
    _scheduled(mixer, {1: lambda: mixer.play(voice()), 2: lambda: _tick(kind, ctls, 2)})
    out.append(r.render_frames(BLOCK * 12))
    return np.concatenate(out), r, kinds, root


@functools.lru_cache(maxsize=None)
def _pair(kind, unroll, buckets):
    a, rj, kinds, _ = script(ot, kind, unroll, buckets)
    b, rp, _, root = script(pt, kind, unroll, buckets)
    return a, b, rj, rp, kinds, root


CASES = [("dense", 1, BUCKETS), ("dense", 4, BUCKETS), ("golden", 1, None),
         ("wave", 1, BUCKETS), ("wave", 1, None)]
IDS = ["dense_unroll1", "dense_unroll4", "golden", "wave_buckets", "wave_runs"]


# -- (a), (b) the Renderer against the JAX package -------------------------------------


@pytest.mark.parametrize("kind,unroll,buckets", CASES, ids=IDS)
def test_dense_renderer_matches_jax(kind, unroll, buckets):
    a, b, _, rp, _, root = _pair(kind, unroll, buckets)
    assert b.shape == a.shape and b.dtype == np.float32
    assert np.abs(a).max() > 0.1
    assert np.abs(a - b).max() <= TOL, np.abs(a - b).max()
    assert root.graph_capture and rp._steps
    assert rp.graph_counts["eager"] > 0 and rp.graph_counts["replays"] == 0
    if unroll == 4:  # runs went as calls of 4 blocks and their remainders
        assert any(k == 4 for steps in rp._steps.values() for k, _ in steps)
    if kind == "wave":  # the pool took both routes: the arena step and the gather
        flags = {e[6] for k in rp._steps for e in k[0][2]}
        assert flags == {True, False}


@pytest.mark.parametrize("kind,unroll,buckets", CASES, ids=IDS)
def test_dense_step_keys_match_jax(kind, unroll, buckets):
    """One block step per key the JAX Renderer compiles a program for; the
    dispatches by kind equal the JAX Renderer's (a wrapper root forwards
    no idle-run hook, so its idle blocks go as scans of ``{}`` rows)."""
    _, _, rj, rp, kinds, _ = _pair(kind, unroll, buckets)
    assert len(rp._steps) == len(rj._steps)
    assert sorted(str(k[1]) for k in rp._steps) == sorted(str(k[1]) for k in rj._steps)
    assert rp.dispatch_counts == kinds
    assert any(k[1] == "scan" and k[2][1] == () for k in rp._steps)


# -- (c) the packed row ---------------------------------------------------------------

ROW_BLOCKS = ("idle", "control", "plays")


@functools.lru_cache(maxsize=None)
def _row_params(kind):
    """Each package's root params of an idle block, a block after a
    control tick and a block after two plays."""
    out = []
    for m in (ot, pt):
        root, mixer, ctls, rng, voice = build(m, kind)
        r = m.Renderer(root, RATE)
        blocks = []
        prepare = root.host_prepare

        def spy(*a, _prepare=prepare, _blocks=blocks, **kw):
            _blocks.append(_prepare(*a, **kw))
            return _blocks[-1]

        root.host_prepare = spy
        r.render_block(BLOCK)
        r.render_block(BLOCK)
        _tick("wave" if kind == "wave" else "dense", ctls, 0)
        r.render_block(BLOCK)
        mixer.play(voice())
        mixer.play(voice())
        r.render_block(BLOCK)
        out.append(blocks[1:])
    return list(zip(*out))


@pytest.mark.parametrize("block", range(len(ROW_BLOCKS)), ids=ROW_BLOCKS)
@pytest.mark.parametrize("kind", ["dense", "wave"])
def test_dense_packed_row_matches_jax(kind, block):
    """The port's row holds the JAX package's leaves, and only them, each
    bit for bit; it unpacks to the params.  A wrapper root's row is its
    mixer's, nested under each wrapper's "inner"."""
    jp, pp = _row_params(kind)[block]
    pack = prun._pack_spec(pp)
    assert pack is not None and jrun._pack_spec(jp) is not None
    jrow, prow = jrun._pack_row(jp), prun._pack_row(pp)
    assert prow.dtype == np.float32 and len(prow) == len(jrow)
    jleaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    jpaths = [tuple(k.key for k in path) for path, _ in jleaves]
    joff = _offsets([(p, np.shape(x)) for p, (_, x) in zip(jpaths, jleaves)])
    poff = _offsets([(p, np.shape(x)) for p, x in zip(_paths(pp), tree_flatten(pp)[0])])
    assert joff == poff
    np.testing.assert_array_equal(prow.view(np.uint32), jrow.view(np.uint32))
    got = prun._unpack_row(torch.from_numpy(prow), *pack)
    assert _paths(got) == _paths(pp)
    for x, want in zip(tree_flatten(got)[0], tree_flatten(pp)[0]):
        np.testing.assert_array_equal(x.numpy(), np.asarray(want).astype(x.numpy().dtype))
    pools = pp["inner"]["inner"] if kind == "dense" else pp
    assert list(pools) == ["p0"]
    if ROW_BLOCKS[block] == "idle":
        assert len(prow) == 0
    if ROW_BLOCKS[block] == "control":  # 8 real lanes of the gain or speed field
        (p,) = [p for p in pools.values() if "ctrl_idx0" in p]
        assert int((np.asarray(p["ctrl_idx0"]) < VOICES).sum()) == 8 and "play_idx" in p
    if ROW_BLOCKS[block] == "plays":
        assert any(int((np.asarray(p["play_idx"]) < 64).sum()) == 2
                   for p in pools.values() if "play_idx" in p)


# -- (d)-(g) the step itself -----------------------------------------------------------


@pytest.mark.parametrize("kind", ["dense", "golden", "wave"])
def test_dense_step_matches_eager_bit_for_bit(kind):
    """The step path (packed rows, device lanes, copy-back) against
    ``eager()`` (numpy params, the state stored as returned): bit for bit,
    the same dispatches."""
    with prun.eager():
        ref, r0, _, _ = script(pt, kind)
    assert r0._steps == {} and r0.graph_counts["eager"] > 0
    for unroll, buckets in ((1, None), (4, BUCKETS)):
        got, r, _, _ = script(pt, kind, unroll, buckets)
        np.testing.assert_array_equal(got, ref)
        if buckets is None:
            assert r.dispatch_counts == r0.dispatch_counts


def _mixer_of(sig):
    while not isinstance(sig, pt.Mixer):
        sig = sig.inner
    return sig


def _flip_script(log, wrap=False):
    """A 16-voice wavetable (under ``Reinhard`` with ``wrap``) whose pool
    leaves the arena step when a voice's speed passes its bound between
    two blocks of one call (after a play, so that the first block is no
    idle run); ``log`` gets the call's prepare counter and the pool."""
    mixer, scs, rng = build_wavetable(16, "cpu", seed=4)
    r = pt.Renderer(pt.Reinhard(mixer) if wrap else mixer, RATE)
    out = [r.render_frames(BLOCK * 4)]
    count = _scheduled(mixer, {
        0: lambda: mixer.play(pt.Speed(pt.Cycle(pt.Frames.from_slice(RATE, TABLE)))),
        1: lambda: scs[3].set_speed(6.0),
    })
    pool = next(iter(mixer._pools.values()))
    log.append((count, pool))
    out.append(r.render_frames(BLOCK * 8))
    assert not pool._ds_small
    return np.concatenate(out), r


def test_dense_block_step_reads_no_host_state(monkeypatch):
    """A replay emulated: each call of a step also runs on a deep copy of
    the root frozen at that step's first call, from a copy of the same
    state and rows.  Its audio and state equal the live call's bit for bit
    (every host value the step reads is in the key: the interval, the
    count, the arena route and tier), and the live call changes no host
    attribute.  The run prepared before the speed write renders with the
    arena step, as its key says, though the pool holds the gather's flag
    by then, also under a wrapper root."""
    frozen, calls, log = {}, [], []
    live_call = prun.Renderer._eager_call

    def spy(self, step, d0, dd):
        sig = self.signal
        if id(step) not in frozen:
            # the step is held too, so that its id is not reused
            frozen[id(step)] = (step, copy.deepcopy(sig))
        before = _mixer_host(_mixer_of(sig))
        d_in = tree_map(torch.clone, d0)
        rows = None if step.rows is None else step.rows.clone()
        out = live_call(self, step, d0, dd)
        assert _mixer_host(_mixer_of(sig)) == before, "the block step changed a host attribute"
        d_f, out_f = prun.step_body(frozen[id(step)][1], step.kind, step.pack, step.n, step.k,
                                    d_in, dd, rows)
        assert torch.equal(_bits(out_f), _bits(out))
        for a, b in zip(tree_leaves(d_f), tree_leaves(sig.device_collect())):
            assert torch.equal(_bits(a), _bits(b))
        if log:
            count, pool = log[0]
            calls.append((count[0], pool.proto._pool_ds_small))
        else:
            calls.append(None)
        return out

    monkeypatch.setattr(prun.Renderer, "_eager_call", spy)
    script(pt, "dense", 4, BUCKETS)
    script(pt, "golden")
    assert len(calls) > 20
    for wrap in (False, True):  # a wrapper root forwards render_archetype
        log.clear()
        got, _ = _flip_script(log, wrap)
        with prun.eager():
            want, _ = _flip_script([], wrap)
        np.testing.assert_array_equal(got, want)
        flip = [c for c in calls if c is not None]
        assert np.isfinite(got).all() and len(flip) >= 8
        calls.clear()
        # the run of the block prepared before the write is dispatched
        # after the write's prepare (the second): on the arena step, as
        # its key says
        assert any(prepared >= 2 and small for prepared, small in flip)
        assert any(not small for _, small in flip)


@pytest.mark.parametrize("kind", ["dense", "golden", "wave"])
def test_dense_steps_read_no_tensor_on_host(kind):
    """Inside a block step no tensor is read on the host (``__array__``,
    ``numpy()``, ``item()``, ``tolist()`` raise there): what a CUDA graph
    could not replay.  The script's steps take every key's path."""
    with host_read_guard() as hits:
        got, r, _, _ = script(pt, kind, 4, BUCKETS)
    assert hits == [] and r._steps and r.graph_counts["eager"] > 0
    with prun.eager():
        want, _, _, _ = script(pt, kind, 4, BUCKETS)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["dense", "wave"])
def test_dense_state_leaves_stay_put(kind):
    """The step leaves every state leaf in the tensor it was collected in
    (through control ticks and the wavetable's route flips);
    ``eager()`` stores what the render returns."""
    root, mixer, ctls, rng, _ = build(pt, kind)
    r = pt.Renderer(root, RATE, scan_buckets=BUCKETS)
    r.render_block(BLOCK)
    before = tree_leaves(root.device_collect())
    r.render_frames(BLOCK * 20)
    for t in range(3):
        _tick(kind, ctls, t)
        r.render_frames(BLOCK * 5)
    after = tree_leaves(root.device_collect())
    assert len(after) == len(before) and all(a is b for a, b in zip(after, before))
    with prun.eager():
        r.render_block(BLOCK)
    moved = tree_leaves(root.device_collect())
    assert any(a is not b for a, b in zip(moved, before))


@pytest.mark.parametrize("kind", ["dense", "wave"])
def test_dense_continues_from_jax_under_steps(kind):
    """A JAX dense mix and a JAX wavetable rendered for some blocks (a
    control tick among them), their mixers carried across with
    ``carry_mixer``: the port's stepped Renderer continues within 1e-5 of
    the JAX render, through another tick."""
    from oddio_tpu_torch.utils.convert import carry_mixer

    rootj, mj, cj, _, _ = build(ot, kind)
    rj = ot.Renderer(rootj, RATE, scan_buckets=BUCKETS)
    rj.render_frames(BLOCK * 6)
    _tick(kind, cj, 0)
    rj.render_frames(BLOCK * 5)
    rootp, mp, cp, _, _ = build(pt, kind)
    carry_mixer(mj, mp)
    rp = pt.Renderer(rootp, RATE, scan_buckets=BUCKETS)
    a, b = [], []
    for t in (None, 1):
        if t is not None:
            _tick(kind, cj, t)
            _tick(kind, cp, t)
        a.append(rj.render_frames(BLOCK * 8))
        b.append(rp.render_frames(BLOCK * 8))
    a, b = np.concatenate(a), np.concatenate(b)
    assert np.abs(a).max() > 0.1 and rp._steps and rootp.graph_capture
    assert np.abs(a - b).max() <= TOL, np.abs(a - b).max()


def test_dense_wrapper_paths_unchanged():
    """A wrapper's standalone render (the step's, and a submix's) equals
    its batched ``render_host`` (a pack's) bit for bit: the wrapped
    mixer's block through each map."""
    for make in (lambda m: pt.Tanh(pt.Reinhard(m)), lambda m: pt.MonoToStereo(m),
                 lambda m: pt.Downmix(pt.MonoToStereo(m))):
        outs = []
        for way in ("render", "render_host"):
            root, mixer, _, _, _ = build(pt, "dense", voices=8)
            chain = make(mixer)
            chain._set_device("cpu")
            d, dd = chain.device_collect(), chain.device_data()
            p = chain.host_prepare(np.float32(1 / RATE), BLOCK)
            if way == "render":
                d2, block = chain.render(d, dd, p, BLOCK)
            else:
                d2, block = chain.render_host(tree_map(lambda x: x[None], d), dd,
                                              tree_map(lambda x: np.asarray(x)[None], p), BLOCK)
                block = block[0]
            outs.append(block)
        assert outs[0].shape == (chain.channels, BLOCK)
        assert torch.equal(_bits(outs[0]), _bits(outs[1]))


def test_dense_pack_of_stepped_mixers_matches_eager():
    """A 1 x 1 ScenePack of wavetable mixers now declares ``graph_capture``
    (its scenes do): its steps, through a route flip in one scene, equal
    ``eager()`` bit for bit."""
    from oddio_tpu_torch.parallel.mesh import make_mesh
    from oddio_tpu_torch.parallel.sharded import ScenePack

    outs = []
    for mode in ("step", "eager"):
        scenes, ctls = [], []
        for s in range(3):
            mixer, scs, _ = build_wavetable(8, "cpu", seed=s)
            scenes.append(mixer)
            ctls.append(scs)
        with prun.eager() if mode == "eager" else __import__("contextlib").nullcontext():
            pack = ScenePack(scenes, RATE, make_mesh(1, 1, ["cpu"]))
            assert pack.graph_capture
            x = [pack.render_block(BLOCK).transpose(0, 2, 1)[None]]
            x += [t.cpu().numpy() for t in pack.render_frames_device(BLOCK * 6)]
            ctls[1][0].set_speed(5.0)
            x += [t.cpu().numpy() for t in pack.render_frames_device(BLOCK * 6)]
        outs.append((np.concatenate(x), pack))
    (xs, ps), (xe, pe) = outs
    assert ps._steps and pe._steps == {} and xs.shape == (13, 3, 1, BLOCK)
    assert not next(iter(scenes[1]._pools.values()))._ds_small
    np.testing.assert_array_equal(xs, xe)
