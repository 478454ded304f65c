"""The port's Renderer block step on the samplers, on the CPU, against the
exact oracle and the JAX package's Renderer.

BASELINE config 2's Mixer of ``Fader(Speed(FramesSignal))`` voices
(``scene_profile.build_sampler`` at a small width), a Mixer of
``Fader(FixedGain(Sine))`` voices (the Fader's non-arena route,
``fade_mix_plain``),
the seek sampler (mono FramesSignal voices in a SpatialScene's
device-resident seek pool, K6's ``arena_warp``) and a 1 x 1 ScenePack of
sampler Mixers declare ``graph_capture``.  Their params pack into one
float32 row, a FramesSignal's float64 time cursor ``t`` as two words of
its bit pattern, and the fade lanes apply on the device with drop
semantics; on a card each step is a CUDA graph (``arena_step`` or
``fader_step`` inside), here the same step runs uncaptured.

Each scene runs one control script: speed writes (one past the arena
step's bound, so its pool takes the exact gather and comes back), fades,
a fade given during a fade (it waits; a second one replaces it), a play
during the fades, growth past the pools' capacity, a tail block and
writes between two blocks of one call (the seek sampler: motion writes in
place of speed writes and fades).  These tests hold: the audio against
the exact oracle (``reference_impl``, with a Fader after fader.rs here)
within PARITY.md's 1e-5 and against the JAX Renderer within the JAX
side's own distance from the oracle + 1e-5 (its FramesSignal cursor is
float32, ROADMAP Q3.5), at ``scan_unroll`` 1 and 8 and with bench.py's
buckets; the step keys and dispatches against the JAX Renderer's; the row
against the JAX package's ``_pack_row`` with the ``t`` words taken out;
the step against ``eager()`` bit for bit; a replay emulated on a frozen
copy of the engine; and no tensor read on the host inside a step.  Test
names avoid the JAX tests' (``conftest.py`` marks tests slow by name).
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
import reference_impl as ref  # noqa: E402
from oddio_tpu.core import run as jrun  # noqa: E402
from oddio_tpu_torch.core import run as prun  # noqa: E402
from oddio_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from oddio_tpu_torch.parallel.sharded import ScenePack  # noqa: E402
from oddio_tpu_torch.utils.scene_profile import (BUCKETS, SAMPLER_RATE,  # noqa: E402
                                                 _sampler_sounds, build_sampler)
from oddio_tpu_torch.utils.tree import tree_flatten, tree_leaves, tree_map  # noqa: E402
from test_torch_graph_mixer import _scheduled as _mixer_scheduled  # noqa: E402
from test_torch_graph_step import _bits, _host, _paths, host_read_guard  # noqa: E402

torch.set_num_threads(1)

RATE, BLOCK, TOL = 48000, 512, 1e-5
F = np.float32
VOICES, SOUNDS, SECONDS = 8, 2, 1.0


class OFader(ref.OSignal):
    """fader.rs:38-77 for the oracle: a fade starts at a block boundary once
    the previous one has completed (a newer waiting command replaces the
    older); while fading, ``sqrt(1 - p)*old + sqrt(p)*new`` with ``p`` the
    float32 ramp ``min(p0 + j*inc, 1)``; on completion the new signal
    replaces the old at the next block."""

    def __init__(self, inner):
        self.inner, self.next, self.pending = inner, None, None
        self.progress, self.duration = F(1.0), F(1.0)

    def fade_to(self, sig, duration):
        self.pending = (sig, F(duration))

    def sample(self, interval, out):
        interval = F(interval)
        if self.next is not None and self.progress >= 1.0:
            self.inner, self.next = self.next, None
        if self.next is None and self.pending is not None:
            (self.next, self.duration), self.pending = self.pending, None
            self.progress = F(0.0)
        if self.next is None:
            self.inner.sample(interval, out)
            return
        inc = F(interval / max(self.duration, interval))
        a, b = np.zeros_like(out), np.zeros_like(out)
        self.inner.sample(interval, a)
        self.next.sample(interval, b)
        p = np.minimum(self.progress + np.arange(len(out), dtype=F) * inc, F(1.0))
        if out.ndim == 2:
            p = p[:, None]
        out[:] = (a * np.sqrt(F(1.0) - p) + b * np.sqrt(p)).astype(F)
        self.progress = min(F(self.progress + F(len(out)) * inc), F(1.0))


class Oracle:
    """An oracle engine behind a Renderer's calls (the same block
    boundaries): ``render_frames`` in 512-frame blocks and a remainder,
    ``render_block``, and ``actions`` run before the i-th block of the
    next call (``_scheduled``'s)."""

    def __init__(self, sig, channels):
        self.sig, self.channels, self.actions = sig, channels, {}

    def render_block(self, n):
        act = self.actions.pop(0, None)
        self.actions = {k - 1: v for k, v in self.actions.items()}
        if act is not None:
            act()
        buf = np.zeros((n, self.channels), F)
        ref.oddio_run(self.sig, RATE, buf if self.channels > 1 else buf[:, 0])
        return buf

    def render_frames(self, total, block_size=BLOCK):
        nb, rem = divmod(total, block_size)
        out = [self.render_block(block_size) for _ in range(nb)]
        if rem:
            out.append(self.render_block(rem))
        return np.concatenate(out)


def _scheduled(engine, actions):
    """Run ``actions[i]()`` just before the engine's i-th ``host_prepare`` of
    the next call (``test_torch_graph_mixer._scheduled``: a control thread
    acting between two blocks); the oracle's blocks take them the same
    way."""
    if isinstance(engine, Oracle):
        engine.actions = dict(actions)
    else:
        _mixer_scheduled(engine, actions)


# -- the scenes, in each package (the same draws) --------------------------------------


class Scene:
    """One engine in package ``m`` (``ot``, ``pt`` or ``ref``, the oracle:
    then ``engine`` is its ``Oracle``) with what plays into it
    (``root``), its sounds (``data``) and its voices' handles:
    ``speed[i]``, ``fader[i]`` (the samplers) or ``voice[i]`` (the seek
    sampler, motion handles)."""

    def __init__(self, m, engine, root, data):
        self.m, self.engine, self.root, self.data = m, engine, root, data
        self.speed, self.fader, self.voice = [], [], []

    def frames(self, i):
        m = self.m
        rate = self.data[1]
        if m is ref:
            return ref.OFrames(rate, self.data[0][i])
        return m.Frames.from_slice(rate, self.data[0][i])

    def source(self, i, t0, speed):
        """(speed handle, ``Speed(FramesSignal)``) over sound ``i``."""
        m = self.m
        if m is ref:
            s = ref.OSpeed(ref.OFramesSignal(self.frames(i), t0, exact=True), F(speed))
            return s, s
        sc, sp = m.Speed.new(m.FramesSignal(self.frames(i), t0))
        sc.set_speed(speed)
        return sc, sp


def set_speed(m, h, x):
    if m is ref:
        h.speed = F(x)
    else:
        h.set_speed(x)


def _fader_voice(sc, sig):
    m = sc.m
    if m is ref:
        fc = f = OFader(sig)
    else:
        fc, f = m.Fader.new(sig)
    sc.fader.append(fc)
    sc.root.play(f)


def build_config2(m, seed=0, voices=VOICES):
    """Config 2 at a small width: ``build_sampler``'s draws (its sounds and
    voices, from ``seed``) in package ``m``."""
    if m is pt:
        drv = build_sampler(voices, "cpu", seed, sounds=SOUNDS, seconds=SECONDS)
        data = [f.data for f in drv.frames]
        sc = Scene(pt, drv.mixer, drv.mixer, (data, SAMPLER_RATE))
        sc.speed, sc.fader = list(drv.speeds), list(drv.faders)
        return sc
    rng = np.random.default_rng(seed)
    data = [f.data for f in _sampler_sounds(rng, SOUNDS, SECONDS)]
    if m is ref:
        engine = ref.OMixer(channels=2)
        root = Oracle(engine, 2)
        engine_play = engine
    else:
        _, engine = m.Mixer.new(channels=2)
        root = engine_play = engine
    sc = Scene(m, root, engine_play, (data, SAMPLER_RATE))
    for _ in range(voices):
        i = int(rng.integers(SOUNDS))
        t0 = float(rng.uniform(0, SECONDS / 2))
        h, sp = sc.source(i, t0, float(rng.uniform(0.8, 1.25)))
        sc.speed.append(h)
        _fader_voice(sc, sp)
    return sc


SINE = [(0.3 * k, 180.0 + 70.0 * k) for k in range(40)]


def _sine(m, k):
    """Sine ``k`` at -20 dB (``FixedGain``: the mix stays near unit level,
    where the oracle's float32 voice sum keeps well inside 1e-5)."""
    phase, hz = SINE[k]
    if m is ref:
        return ref.OFixedGain(ref.OSine(phase, hz, exact=True), -20.0)
    return m.FixedGain(m.Sine(phase, hz), -20.0)


def build_fader_sine(m, voices=VOICES):
    """A mono Mixer of ``Fader(FixedGain(Sine))`` voices (the Fader's
    non-arena route)."""
    if m is ref:
        engine = ref.OMixer(channels=1)
        sc = Scene(m, Oracle(engine, 1), engine, None)
    else:
        _, engine = m.Mixer.new(channels=1, **({"device": "cpu"} if m is pt else {}))
        sc = Scene(m, engine, engine, None)
    for k in range(voices):
        _fader_voice(sc, _sine(m, k))
    return sc


def _seek_data(seed=5):
    rng = np.random.default_rng(seed)
    n = int(SECONDS * SAMPLER_RATE)
    t = np.arange(n) / SAMPLER_RATE
    return [(0.5 * np.sin(2 * np.pi * rng.uniform(100, 900) * t)
             + 0.05 * rng.standard_normal(n)).astype(F) for _ in range(SOUNDS)], rng


def build_seek(m, voices=VOICES):
    """The seek sampler at a small width: mono FramesSignal voices at
    positions within 4 m and velocities up to 5 m/s in a SpatialScene's
    device-resident seek pool (``scene_profile.build_seek_sampler``'s
    layout at a small width, from draws of its own)."""
    data, rng = _seek_data()
    if m is ref:
        engine = ref.OSpatialScene(exact=True)
        sc = Scene(m, Oracle(engine, 2), engine, (data, SAMPLER_RATE))
    else:
        control, engine = m.SpatialScene.new(**({"device": "cpu"} if m is pt else {}))
        sc = Scene(m, engine, control, (data, SAMPLER_RATE))
    for _ in range(voices):
        seek_play(sc, int(rng.integers(SOUNDS)), float(rng.uniform(-0.05, 0.3)),
                  rng.uniform(-4, 4, 3), rng.uniform(-5, 5, 3))
    return sc


def seek_play(sc, i, t0, pos, vel):
    m = sc.m
    if m is ref:
        sc.voice.append(sc.root.play(ref.OFramesSignal(sc.frames(i), t0, exact=True),
                                     np.asarray(pos, F), np.asarray(vel, F)))
    else:
        sc.voice.append(sc.root.play(m.FramesSignal(sc.frames(i), t0),
                                     m.SpatialOptions(position=pos, velocity=vel)))


def set_motion(m, h, pos, vel):
    h.set_motion(np.asarray(pos, F) if m is ref else pos,
                 np.asarray(vel, F) if m is ref else vel, False)


# -- the control script -----------------------------------------------------------------


def _fade(sc, v, k, dur):
    """Voice ``v`` fades to target ``k`` over ``dur`` seconds."""
    m = sc.m
    if sc.data is None:
        target = _sine(m, 20 + k)
    else:
        h, target = sc.source(k % SOUNDS, 0.05 * k, 0.9 + 0.05 * k)
    sc.fader[v].fade_to(target, dur)


def _new_voice(sc, k):
    if sc.data is None:
        _fader_voice(sc, _sine(sc.m, 10 + k))
    else:
        h, sp = sc.source(k % SOUNDS, 0.02 * k, 1.0 + 0.01 * k)
        sc.speed.append(h)
        _fader_voice(sc, sp)


def _tick(sc, t):
    """Control tick ``t`` of the samplers' script."""
    m = sc.m
    if t == 0:  # speed writes and two fades
        if sc.data is not None:
            set_speed(m, sc.speed[0], 0.9)
            set_speed(m, sc.speed[1], 1.2)
        _fade(sc, 2, 0, 0.02)
        _fade(sc, 3, 1, 0.05)
    elif t == 1:  # a fade during a fade waits; a second one replaces it; a play
        _fade(sc, 3, 2, 0.02)
        _fade(sc, 3, 3, 0.01)
        _new_voice(sc, 0)
    elif t == 2:  # growth past the capacity; a speed past the arena step's bound
        for k in range(9):
            _new_voice(sc, 1 + k)
        if sc.data is not None:
            set_speed(m, sc.speed[4], 5.0)
        _fade(sc, 5, 4, 0.03)
    elif t == 3:  # before the last call: its first block is no idle block
        _fade(sc, 7, 6, 0.02)
    elif t == 4:
        if sc.data is not None:
            set_speed(m, sc.speed[4], 1.0)
    elif t == 5:
        _fade(sc, 6, 5, 0.02)


def _seek_tick(sc, t, rng):
    m = sc.m
    if t == 0:
        for h in sc.voice[:3]:
            set_motion(m, h, rng.uniform(-4, 4, 3), rng.uniform(-5, 5, 3))
    elif t == 1:
        seek_play(sc, 0, 0.1, [2.0, 1.0, 0.5], [1.0, 0.0, 0.0])
    elif t == 2:
        for k in range(9):
            seek_play(sc, k % SOUNDS, 0.01 * k, rng.uniform(-4, 4, 3), rng.uniform(-5, 5, 3))
    elif t == 3:
        set_motion(m, sc.voice[1], [-6.0, 1.0, 2.0], [1.0, 1.0, 0.0])
    elif t == 4:
        set_motion(m, sc.voice[0], [3.0, 0.0, 1.0], [0.0, 2.0, 0.0])
    elif t == 5:
        seek_play(sc, 1, 0.0, [-4.0, 2.0, 0.0], [0.0, 0.0, 1.0])


def script(sc, r):
    """The script through ``r`` (a Renderer, or the oracle's ``Oracle``):
    6 blocks, tick 0, a single block, tick 1, 8 blocks, tick 2, 9 blocks
    and a 100-frame tail, tick 3, then 10 blocks with ticks 4 and 5 before
    the second and third.  Returns the audio, (frames, C)."""
    if sc.fader or sc.data is None:
        tick = functools.partial(_tick, sc)
    else:
        rng = np.random.default_rng(7)
        tick = functools.partial(_seek_tick, sc, rng=rng)
    out = [r.render_frames(BLOCK * 6)]
    tick(0)
    out.append(r.render_block(BLOCK))
    tick(1)
    out.append(r.render_frames(BLOCK * 8))
    tick(2)
    out.append(r.render_frames(BLOCK * 9 + 100))
    tick(3)
    _scheduled(sc.engine, {1: lambda: tick(4), 2: lambda: tick(5)})
    out.append(r.render_frames(BLOCK * 10))
    return np.concatenate(out)


BUILD = {"sampler": build_config2, "fader_sine": build_fader_sine, "seek": build_seek}


def run(kind, m, unroll=1, buckets=None):
    """``kind``'s scene through the script in package ``m``: (audio,
    renderer, JAX dispatches by kind, scene)."""
    sc = BUILD[kind](m)
    if m is ref:
        return script(sc, sc.engine), None, None, sc
    r = m.Renderer(sc.engine, RATE, scan_unroll=unroll, scan_buckets=buckets)
    kinds = {}
    if m is ot:
        get_step = r._get_step

        def spy(kind_, *a, **kw):
            k = kind_ if isinstance(kind_, str) else tuple(kind_)
            kinds[k] = kinds.get(k, 0) + 1
            return get_step(kind_, *a, **kw)

        r._get_step = spy
    return script(sc, r), r, kinds, sc


@functools.lru_cache(maxsize=None)
def _reference(kind):
    """The oracle's and the JAX Renderer's audio of ``kind``'s script, the
    JAX step keys and dispatches."""
    want = run(kind, ref)[0]
    a, rj, kinds, _ = run(kind, ot)
    return want, a, rj, kinds


CASES = [("sampler", 1, None), ("sampler", 8, None), ("sampler", 1, BUCKETS),
         ("fader_sine", 1, None), ("fader_sine", 8, None),
         ("seek", 1, BUCKETS), ("seek", 8, None)]
IDS = ["sampler_unroll1", "sampler_unroll8", "sampler_buckets", "fader_sine_unroll1",
       "fader_sine_unroll8", "seek_buckets", "seek_unroll8"]


@functools.lru_cache(maxsize=None)
def _port(kind, unroll, buckets):
    return run(kind, pt, unroll, buckets)


@pytest.mark.parametrize("kind,unroll,buckets", CASES, ids=IDS)
def test_sampler_steps_match_oracle_and_jax(kind, unroll, buckets):
    """Within 1e-5 of the exact oracle, and of the JAX Renderer within the
    JAX side's own distance from the oracle + 1e-5; the engine declares
    ``graph_capture`` and went through block steps."""
    want, a, _, _ = _reference(kind)
    b, rp, _, sc = _port(kind, unroll, buckets)
    assert b.shape == want.shape == a.shape and b.dtype == np.float32
    assert np.abs(want).max() > 0.05
    err, err_jax = np.abs(b - want).max(), np.abs(a - want).max()
    assert err <= TOL, (err, err_jax)
    assert np.abs(b - a).max() <= err_jax + TOL, (np.abs(b - a).max(), err_jax)
    assert sc.engine.graph_capture and rp._steps
    assert rp.graph_counts["eager"] > 0 and rp.graph_counts["replays"] == 0
    if unroll == 8:
        assert any(k == 8 for steps in rp._steps.values() for k, _ in steps)
    pools = list(sc.engine._all_pools())
    assert all(p.is_dr for p in pools) and max(p.capacity for p in pools) >= 32  # grew
    if kind == "sampler":  # the pool took both routes: the arena step and the gather
        flags = {e[6] for k in rp._steps for e in k[0][2]}
        assert flags == {True, False}


@pytest.mark.parametrize("kind", ["sampler", "fader_sine", "seek"])
def test_sampler_step_keys_match_jax(kind):
    """One block step per key the JAX Renderer compiles a program for, of
    the same kinds; the dispatches by kind equal the JAX Renderer's."""
    _, _, rj, kinds = _reference(kind)
    _, rp, _, _ = _port(kind, 1, None)
    assert len(rp._steps) == len(rj._steps)
    assert sorted(str(k[1]) for k in rp._steps) == sorted(str(k[1]) for k in rj._steps)
    assert rp.dispatch_counts == kinds


# -- the packed row ---------------------------------------------------------------------


@pytest.mark.parametrize("pre", [0, 1, 2, 5])
def test_float64_leaf_round_trips_at_any_offset(pre):
    """A float64 leaf (NaN payloads, signed zeros, infinities, subnormals
    and large cursors among its values) after ``pre`` float32 words packs
    as two words a value and unpacks bit for bit to a float64 tensor; the
    other leaves keep their words."""
    rng = np.random.default_rng(pre)
    t = rng.standard_normal(7) * 1e7
    t[:4] = [np.nan, -0.0, np.inf, 5e-324]
    t.view(np.uint64)[4] = 0x7FF8_0000_DEAD_BEEF
    params = {"a": rng.standard_normal(pre).astype(F), "b": np.int32(-3),
              "t": t, "u": np.float64(1234.5678), "z": np.array([True, False])}
    pack = prun._pack_spec(params)
    row = prun._pack_row(params)
    assert pack is not None and len(row) == prun._row_len(pack[1]) == pre + 1 + 14 + 2 + 2
    np.testing.assert_array_equal(row[pre + 1:pre + 15].view(np.uint64), t.view(np.uint64))
    got = prun._unpack_row(torch.from_numpy(row), *pack)
    assert got["t"].dtype == torch.float64 and got["u"].shape == ()
    np.testing.assert_array_equal(got["t"].numpy().view(np.uint64), t.view(np.uint64))
    assert got["u"].item() == 1234.5678 and got["b"].item() == -3
    np.testing.assert_array_equal(got["a"].numpy(), params["a"])
    np.testing.assert_array_equal(got["z"].numpy(), params["z"])
    # the same words through a run's staging rows, a row at an odd offset
    rows = np.zeros((3, len(row)), F)
    for k in range(3):
        prun._pack_into(params, rows[k])
    flat = torch.from_numpy(np.concatenate([np.zeros(1, F), rows.reshape(-1)]))[1:]
    got2 = prun._unpack_row(flat.view(3, -1)[1], *pack)
    np.testing.assert_array_equal(got2["t"].numpy().view(np.uint64), t.view(np.uint64))


ROW_BLOCKS = ("idle", "speed", "plays", "fades")


@functools.lru_cache(maxsize=None)
def _row_params():
    """Each package's params of an idle block, a block of speed writes, a
    block of two plays and a block that releases two fades."""
    out = []
    for m in (ot, pt):
        sc = build_config2(m)

        def prepare(_sc=sc):
            # the host side alone: the params need no render
            return _sc.engine.host_prepare(F(1) / F(RATE), BLOCK)

        blocks = [prepare(), prepare()]
        set_speed(m, sc.speed[0], 0.9)
        set_speed(m, sc.speed[1], 1.1)
        blocks.append(prepare())
        _new_voice(sc, 0)
        _new_voice(sc, 1)
        blocks.append(prepare())
        _fade(sc, 2, 0, 0.02)
        _fade(sc, 3, 1, 0.02)
        blocks.append(prepare())
        out.append(blocks[1:])
    return list(zip(*out))


@pytest.mark.parametrize("block", range(len(ROW_BLOCKS)), ids=ROW_BLOCKS)
def test_sampler_packed_row_matches_jax(block):
    """The port's row is the JAX package's with the words of each
    FramesSignal ``t`` (a float64, two words) taken out, every other leaf
    at its place bit for bit but the arena offsets ``off``/``goff`` (where
    each package's process-wide sample arena placed the sounds, which
    depends on what the process loaded before); it unpacks to the params,
    ``t`` included."""
    jp, pp = _row_params()[block]
    pack = prun._pack_spec(pp)
    assert pack is not None and jrun._pack_spec(jp) is not None
    jrow, prow = jrun._pack_row(jp), prun._pack_row(pp)
    pleaves = tree_flatten(pp)[0]
    ppaths = _paths(pp)
    words = [(p, np.size(x) * (2 if np.asarray(x).dtype == np.float64 else 1))
             for p, x in zip(ppaths, pleaves)]
    keep = np.concatenate([np.full(w, p[-1] != "t") for p, w in words] or [np.zeros(0, bool)])
    same = np.concatenate([np.full(w, p[-1] not in ("off", "goff")) for p, w in words
                           if p[-1] != "t"] or [np.zeros(0, bool)])
    assert keep.size == len(prow) and same.size == len(jrow)
    t64 = [x for p, x in zip(ppaths, pleaves) if p[-1] == "t"]
    assert all(np.asarray(x).dtype == np.float64 for x in t64)
    np.testing.assert_array_equal(prow[keep][same].view(np.uint32), jrow[same].view(np.uint32))
    jleaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    jpaths = [tuple(k.key for k in path) for path, _ in jleaves]
    assert jpaths == [p for p in ppaths if p[-1] != "t"]
    got = prun._unpack_row(torch.from_numpy(prow), *pack)
    assert _paths(got) == ppaths
    for x, want in zip(tree_flatten(got)[0], pleaves):
        want = np.asarray(want)
        if want.dtype == np.float64:
            assert x.dtype == torch.float64
            np.testing.assert_array_equal(x.numpy().view(np.uint64), want.view(np.uint64))
        else:
            np.testing.assert_array_equal(x.numpy(), want.astype(x.numpy().dtype))
    pool = pp["p0"]
    name = ROW_BLOCKS[block]
    if name == "idle":
        assert len(prow) == 0
    if name == "speed":
        assert int((np.asarray(pool["ctrl_idx0"]) < VOICES).sum()) == 2
    if name == "plays":
        assert int((np.asarray(pool["play_idx"]) < 16).sum()) == 2 and t64
    if name == "fades":
        assert int((np.asarray(pool["fade_idx0"]) < 16).sum()) == 2 and len(t64) >= 2


# -- the step itself --------------------------------------------------------------------


class PackRenderer:
    """A 1 x 1 ScenePack behind the script's Renderer calls: returns
    scene ``s``'s audio; ``outs`` keeps every scene's."""

    def __init__(self, pack):
        self.pack, self.outs = pack, []

    def _keep(self, x):  # (S, n, C)
        self.outs.append(x)
        return x[0]

    def render_block(self, n):
        return self._keep(self.pack.render_block(n))

    def render_frames(self, total):
        nb, rem = divmod(total, BLOCK)
        xs = [t.permute(1, 0, 3, 2).reshape(t.shape[1], -1, t.shape[2]).numpy()
              for t in self.pack.render_frames_device(BLOCK * nb)]
        if rem:
            xs.append(self.pack.render_block(rem))
        return self._keep(np.concatenate(xs, axis=1))


def pack_run(unroll, mode="step"):
    """Two config-2 scenes (seeds 0 and 1) in a 1 x 1 pack through the
    script, scene by scene (each tick on every scene): (S, frames, C)."""
    scenes = [build_config2(pt, seed) for seed in (0, 1)]
    with prun.eager() if mode == "eager" else contextlib.nullcontext():
        pack = ScenePack([sc.engine for sc in scenes], RATE, make_mesh(1, 1, ["cpu"]),
                         scan_unroll=unroll)
        pr = PackRenderer(pack)

        def tick(t):
            for sc in scenes:
                _tick(sc, t)

        pr.render_frames(BLOCK * 6)
        tick(0)
        pr.render_block(BLOCK)
        tick(1)
        pr.render_frames(BLOCK * 8)
        tick(2)
        pr.render_frames(BLOCK * 9 + 100)
        tick(3)
        _scheduled(scenes[0].engine, {1: lambda: tick(4), 2: lambda: tick(5)})
        pr.render_frames(BLOCK * 10)
    return np.concatenate(pr.outs, axis=1), pack


@functools.lru_cache(maxsize=None)
def _oracle_seed1():
    """The oracle's audio of the config-2 scene of seed 1."""
    sc = build_config2(ref, 1)
    return script(sc, sc.engine)


@pytest.mark.parametrize("unroll", [1, 8])
def test_sampler_pack_matches_oracle_and_jax(unroll):
    """A 1 x 1 pack of two config-2 scenes takes block steps (its scenes
    declare ``graph_capture``): each scene within 1e-5 of its own oracle
    run, scene 0 within the JAX side's error + 1e-5 of the JAX Renderer;
    ``eager()`` bit for bit."""
    got, pack = pack_run(unroll)
    assert pack.graph_capture and pack._steps and pack.graph_counts["eager"] > 0
    want0, a0, _, _ = _reference("sampler")
    want1 = _oracle_seed1()
    for s, want in ((0, want0), (1, want1)):
        assert np.abs(got[s] - want).max() <= TOL, (s, np.abs(got[s] - want).max())
    err_jax = np.abs(a0 - want0).max()
    assert np.abs(got[0] - a0).max() <= err_jax + TOL
    if unroll == 8:
        ref_eager, pe = pack_run(unroll, "eager")
        assert pe._steps == {}
        np.testing.assert_array_equal(got, ref_eager)


@pytest.mark.parametrize("kind", ["sampler", "fader_sine", "seek"])
def test_sampler_step_matches_eager_bit_for_bit(kind):
    """The step path (packed rows with the float64 cursors, the fade lanes
    on the device, copy-back) against ``eager()`` (numpy params, the same
    device lanes, the state stored as returned): bit for bit, with the
    same dispatches."""
    with prun.eager():
        want, r0, _, _ = run(kind, pt)
    assert r0._steps == {} and r0.graph_counts["eager"] > 0
    for unroll, buckets in ((1, None), (8, BUCKETS)):
        got, r, _, _ = _port(kind, unroll, buckets)
        np.testing.assert_array_equal(got, want)
        if buckets is None:
            assert r.dispatch_counts == r0.dispatch_counts


def _engine_host(engine):
    """A comparable picture of the engine's and its pools' host state (the
    device state and the count-tensor cache left out)."""
    return _host({"engine": {k: v for k, v in vars(engine).items()
                             if k not in ("_pools", "_seek_pools", "_buffered_pools",
                                          "_rot_dev")},
                  "pools": [{k: v for k, v in vars(p).items() if k not in ("state", "_count_t")}
                            for p in engine._all_pools()]})


@pytest.mark.parametrize("kind", ["sampler", "fader_sine", "seek"])
def test_sampler_block_step_reads_no_host_state(kind, monkeypatch):
    """A replay emulated: each call of a step also runs on a deep copy of
    the engine frozen at that step's first call, from a copy of the same
    state and rows.  Its audio and state equal the live call's bit for bit
    (every host value the step reads is in the key: the interval, the
    count, the arena route), and the live call changes no host attribute.
    The script's speed past the arena bound is written between runs, so a
    run prepared before it renders as its key says."""
    frozen, calls = {}, []
    live_call = prun.Renderer._eager_call

    def spy(self, step, d0, dd):
        sig = self.signal
        if id(step) not in frozen:
            # the step is held too, so that its id is not reused
            frozen[id(step)] = (step, copy.deepcopy(sig))
        before = _engine_host(sig)
        d_in = tree_map(torch.clone, d0)
        rows = None if step.rows is None else step.rows.clone()
        out = live_call(self, step, d0, dd)
        assert _engine_host(sig) == before, "the block step changed a host attribute"
        d_f, out_f = prun.step_body(frozen[id(step)][1], step.kind, step.pack, step.n, step.k,
                                    d_in, dd, rows)
        assert torch.equal(_bits(out_f), _bits(out))
        for a, b in zip(tree_leaves(d_f), tree_leaves(sig.device_collect())):
            assert torch.equal(_bits(a), _bits(b))
        calls.append(step.kind)
        return out

    monkeypatch.setattr(prun.Renderer, "_eager_call", spy)
    got, _, _, _ = run(kind, pt, 8, BUCKETS)
    want, _, _, _ = _port(kind, 8, BUCKETS)
    np.testing.assert_array_equal(got, want)
    assert len(calls) > 10


def test_sampler_steps_read_no_tensor_on_host():
    """Inside a block step no tensor is read on the host (``__array__``,
    ``numpy()``, ``item()``, ``tolist()`` raise there), over the sampler's,
    the Fader(Sine) mixer's, the seek sampler's and the pack's scripts:
    the fade lanes, the float64 rows and the arena steps included."""
    with host_read_guard() as hits:
        outs = [run(kind, pt, 8, BUCKETS)[0] for kind in ("sampler", "fader_sine", "seek")]
        packed, pack = pack_run(8)
    assert hits == [] and pack._steps
    for kind, got in zip(("sampler", "fader_sine", "seek"), outs):
        np.testing.assert_array_equal(got, _port(kind, 8, BUCKETS)[0])


def test_sampler_state_leaves_stay_put():
    """The step leaves every state leaf in the tensor it was collected in
    through speed writes, fades and route flips (``eager()`` stores what
    the render returns); the float64 cursors stay float64."""
    sc = build_config2(pt)
    r = pt.Renderer(sc.engine, RATE)
    r.render_block(BLOCK)
    before = tree_leaves(sc.engine.device_collect())
    for t in (0, 1, 3, 4, 5):
        _tick(sc, t)
        r.render_frames(BLOCK * 5)
    after = tree_leaves(sc.engine.device_collect())
    assert len(after) == len(before) and all(a is b for a, b in zip(after, before))
    assert sum(x.dtype == torch.float64 for x in after) == 2  # both banks' t
    with prun.eager():
        r.render_block(BLOCK)
    moved = tree_leaves(sc.engine.device_collect())
    assert any(a is not b for a, b in zip(moved, before))
