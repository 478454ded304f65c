"""The port's Renderer block step on a SpatialScene's device-resident
buffered pools of arena readers, on the CPU, against the exact oracle, the
JAX package's Renderer and ``eager()``.

``play_buffered`` voices of ``FramesSignal``, ``Speed(FramesSignal)``,
``Fader(Speed(FramesSignal))`` and ``Cycle`` play in ``_BufferedPoolDR``
pools (one per chain), whose block renders each inner chain into its
voices' delay rings: ``stream_kernels.arena_step`` or ``fader_step`` (on
the CPU their plain versions) writes the samples K1 appends and K2/K3
read.  Such a scene declares ``graph_capture``: on a card each block (or
idle group) replays a CUDA graph, here the same step runs uncaptured.

Each scene runs one control script: smoothed and discontinuous moves,
speed writes (one past ``RESAMPLE_DSMAX``, so the pool takes the exact
whole-arena gather and comes back), fades (one given during a fade),
plays that grow every pool past its capacity, writes between two blocks
of one call, a new ``Frames`` between two calls (the global arena is
replaced: a step must see a new leaf) and an idle run long enough for
fused groups.  The FramesSignal voices start late in short sounds, so
they end, linger for their propagation delay and are reclaimed inside the
run.  These tests hold the audio against the exact oracle
(``reference_impl``) within 1e-5 and against the JAX Renderer within the
JAX side's own distance from the oracle + 1e-5 (its FramesSignal cursor
is float32, ROADMAP Q3.5), the oracle's Cycle computing its positions in
float64 as the engines do (ROADMAP R11); the step keys and dispatches
against the JAX Renderer's; the packed row against the JAX package's
``_pack_row`` with the port's own leaves taken out; the step against
``eager()`` bit for bit; a replay emulated on a frozen copy; no tensor
read on the host inside a step; the state leaves where they were; the
handles' ``is_finished``; and the state carried from the JAX package
(``utils/convert.carry_scene``).  ``test_torch_graph_seek_chains`` and
``test_torch_graph_spatial_pack`` (packs of such scenes) use this file's
scenes and checks.  Test names avoid the JAX tests' (``conftest.py``
marks tests slow by name).
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
from oddio_tpu_torch.utils.scene_profile import BUCKETS  # noqa: E402
from oddio_tpu_torch.utils.tree import tree_flatten, tree_leaves, tree_map  # noqa: E402
from test_torch_graph_sampler import OFader, Oracle, _scheduled  # noqa: E402
from test_torch_graph_step import _bits, _host, _paths, host_read_guard  # noqa: E402

torch.set_num_threads(1)

RATE, BLOCK, TOL = 48000, 512, 1e-5
F = np.float32
#: the sounds' rate, length and count; the wavetable's length
SR, SECONDS, SOUNDS, TABLE = 44100, 0.5, 2, 2048
#: the buffered voices' ring: max_distance and buffer_duration
MAXD, BUFD = 100.0, 0.1
CAPACITY = 4


def _sound_data(seed=11):
    """``SOUNDS`` mono sounds of ``SECONDS`` at ``SR`` (two partials and
    noise) and the wavetable (one sine cycle in ``TABLE`` samples plus a
    partial), as numpy."""
    rng = np.random.default_rng(seed)
    n = int(SECONDS * SR)
    t = np.arange(n) / SR
    sounds = []
    for _ in range(SOUNDS):
        f = rng.uniform(150, 900, 2)
        x = 0.3 * np.sin(2 * np.pi * f[0] * t) + 0.2 * np.sin(2 * np.pi * f[1] * t + 1.0)
        sounds.append((x + 0.03 * rng.standard_normal(n)).astype(F))
    ph = np.arange(TABLE) * (2 * np.pi / TABLE)
    table = (0.5 * np.sin(ph) + 0.1 * np.sin(3 * ph)).astype(F)
    return sounds, table


class OSeekWrap:
    """Seek forwarding for the oracle's Reinhard and Tanh (reinhard.rs and
    tanh.rs forward ``Seek`` to the inner signal)."""

    def seek(self, seconds):
        self.inner.seek(seconds)


class OReinhard(OSeekWrap, ref.OReinhard):
    pass


class OTanh(OSeekWrap, ref.OTanh):
    pass


class OCycle(ref.OCycle):
    """cycle.rs with each frame's position in float64, ``cursor + i*ds``
    wrapped modulo the length, and the end state the last position so
    wrapped plus one step: the exact variant the engines compute, as
    ``reference_impl``'s exact FramesSignal (its own Cycle accumulates the
    offset in float32, which moves a warped seek read by ~1.5e-5 here:
    ROADMAP R11)."""

    def sample(self, interval, out):
        data = self.frames.data
        n = len(data)
        ds = np.float64(F(F(interval) * F(int(self.frames.rate))))
        pos = np.remainder(self.cursor + np.arange(len(out)) * ds, np.float64(n))
        x = pos.astype(np.int64)
        fract = (pos - x).astype(F)
        a, b = data[x], data[(x + 1) % n]
        out[:] = (a + fract * (b - a)).astype(F)
        self.cursor = np.remainder(self.cursor + (len(out) - 1) * ds, np.float64(n)) + ds


class Scene:
    """One SpatialScene in package ``m`` (``ot``, ``pt`` or ``ref``, the
    oracle: then ``engine`` is its ``Oracle``), ``root`` what plays into it
    (the control, or the oracle scene); its sounds and table as ``Frames``
    made once; the voices' motion handles ``voice``, Speed handles
    ``speed`` and Fader handles ``fader``."""

    def __init__(self, m, seek=False):
        self.m, self.seek = m, seek
        sounds, table = _sound_data()
        if m is ref:
            self.sounds = [ref.OFrames(SR, x) for x in sounds]
            self.table = table
            oscene = ref.OSpatialScene(exact=True)
            self.engine, self.root = Oracle(oscene, 2), oscene
        else:
            self.sounds = [m.Frames.from_slice(SR, x) for x in sounds]
            self.table = m.Frames.from_slice(RATE, table)
            kw = {"device": "cpu"} if m is pt else {}
            self.root, self.engine = m.SpatialScene.new(initial_capacity=CAPACITY, **kw)
        self.voice, self.speed, self.fader = [], [], []

    # -- the chains ----------------------------------------------------------------------

    def frames(self, i, t0):
        if self.m is ref:
            return ref.OFramesSignal(self.sounds[i], t0, exact=True)
        return self.m.FramesSignal(self.sounds[i], t0)

    def speed_frames(self, i, t0, speed):
        m = self.m
        if m is ref:
            s = ref.OSpeed(self.frames(i, t0), F(speed))
            self.speed.append(s)
            return s
        sc, sp = m.Speed.new(self.frames(i, t0))
        sc.set_speed(speed)
        self.speed.append(sc)
        return sp

    def fader_voice(self, i, t0, speed):
        m = self.m
        sig = self.speed_frames(i, t0, speed)
        if m is ref:
            fc = f = OFader(sig)
        else:
            fc, f = m.Fader.new(sig)
        self.fader.append(fc)
        return f

    def cycle(self, t0):
        if self.m is ref:
            c = OCycle(ref.OFrames(RATE, self.table))
        else:
            c = self.m.Cycle(self.table)
        c.seek(t0)
        return c

    def sine(self, phase, hz, db=-12.0):
        m = self.m
        if m is ref:
            return ref.OFixedGain(ref.OSine(phase, hz, exact=True), db)
        return m.FixedGain(m.Sine(phase, hz), db)

    def constant(self, v):
        return ref.OConstant(F(v)) if self.m is ref else self.m.Constant(v)

    def fixed_gain(self, sig, db):
        return ref.OFixedGain(sig, db) if self.m is ref else self.m.FixedGain(sig, db)

    def reinhard(self, sig):
        return OReinhard(sig) if self.m is ref else self.m.Reinhard(sig)

    def tanh(self, sig):
        return OTanh(sig) if self.m is ref else self.m.Tanh(sig)

    # -- plays and control ---------------------------------------------------------------

    def play(self, sig, pos, vel):
        pos, vel = np.asarray(pos, F), np.asarray(vel, F)
        if self.m is ref:
            h = (self.root.play(sig, pos, vel, 0.1) if self.seek else
                 self.root.play_buffered(sig, pos, vel, 0.1, max_distance=MAXD, rate=RATE,
                                         buffer_duration=BUFD))
        else:
            opts = self.m.SpatialOptions(position=pos, velocity=vel)
            h = (self.root.play(sig, opts) if self.seek else
                 self.root.play_buffered(sig, opts, max_distance=MAXD, rate=RATE,
                                         buffer_duration=BUFD))
        self.voice.append(h)
        return h

    def move(self, k, pos, vel, disc=False):
        self.voice[k].set_motion(np.asarray(pos, F), np.asarray(vel, F), disc)

    def set_speed(self, k, x):
        if self.m is ref:
            self.speed[k].speed = F(x)
        else:
            self.speed[k].set_speed(x)

    def fade(self, k, i, t0, speed, dur):
        """Fader ``k`` fades to a fresh ``Speed(FramesSignal)`` over
        ``dur`` seconds (its Speed handle is not kept)."""
        if self.m is ref:
            target = ref.OSpeed(self.frames(i, t0), F(speed))
        else:
            sc, target = self.m.Speed.new(self.frames(i, t0))
            sc.set_speed(speed)
        self.fader[k].fade_to(target, dur)

    def new_frames(self):
        """A new sound, and a FramesSignal over it (its guarded region), in
        the package's global sample arena (the oracle has none)."""
        if self.m is not ref:
            self.m.FramesSignal(self.m.Frames.from_slice(SR, np.linspace(-0.1, 0.1, 3000,
                                                                          dtype=F)))


# -- the scenes (the same draws in every package) ---------------------------------------


def _near(rng):
    return rng.uniform(-4, 4, 3), rng.uniform(-3, 3, 3)


def _arena_voice(sc, kind, rng):
    """A buffered voice of ``kind`` from ``rng`` (every package draws the
    same numbers whatever it builds)."""
    i = int(rng.integers(SOUNDS))
    t0 = float(rng.uniform(0.0, 0.3))
    speed = float(rng.uniform(0.85, 1.2))
    pos, vel = _near(rng)
    sig = {"frames": lambda: sc.frames(i, t0),
           "speed": lambda: sc.speed_frames(i, t0, speed),
           "fader": lambda: sc.fader_voice(i, t0, speed),
           "cycle": lambda: sc.cycle(t0 / 10)}[kind]()
    sc.play(sig, pos, vel)


#: the buffered chains of each scene kind
ARENA_KINDS = ("frames", "speed", "fader", "cycle")


def build_arena(m, seed=0):
    """Three voices of each of the buffered chains, drawn from ``seed``."""
    sc = Scene(m)
    rng = np.random.default_rng(seed)
    for _ in range(3):
        for k in ARENA_KINDS:
            _arena_voice(sc, k, rng)
    return sc


def _arena_tick(sc, t):
    """Control tick ``t`` of the buffered scenes' script."""
    rng = np.random.default_rng(100 + t)
    if t == 0:  # a smoothed move near a voice, speed writes, two fades
        sc.move(0, [2.0, 1.0, 0.5], [1.0, 0.0, 0.0])
        sc.set_speed(0, 0.9)
        sc.set_speed(1, 1.2)
        sc.fade(0, 1, 0.05, 1.1, 0.02)
        sc.fade(1, 0, 0.1, 0.95, 0.05)
    elif t == 1:  # a discontinuity; a fade during a fade waits; a play
        sc.move(1, [-3.0, 2.0, 1.0], [0.0, 2.0, 0.0], True)
        sc.fade(1, 1, 0.0, 1.0, 0.02)
        _arena_voice(sc, "frames", rng)
    elif t == 2:  # growth past every pool's capacity; a speed past the arena step's bound
        for _ in range(2):
            for k in ARENA_KINDS:
                _arena_voice(sc, k, rng)
        sc.set_speed(2, 5.0)
    elif t == 3:  # before the call with writes inside it
        sc.fade(2, 0, 0.2, 1.05, 0.03)
        sc.move(3, [1.0, -2.0, 0.0], [0.0, 0.0, 2.0])
    elif t == 4:
        sc.set_speed(2, 1.0)
    elif t == 5:
        sc.move(2, [0.5, 0.5, 3.0], [-1.0, 0.0, 0.0], True)


def script(sc, r, tick, first=0, between=None):
    """The script through ``r`` (a Renderer or the oracle's ``Oracle``) from
    call ``first`` on: 20 blocks (idle after the first: fused groups), tick
    0, a single block, (``between()``,) tick 1, 8 blocks, tick 2, 8
    blocks, tick 3, 8 blocks with ticks 4 and 5 before the second and
    third, a new ``Frames``, then 8 blocks (calls of one length: the JAX
    Renderer compiles a program per run length).  Returns the audio,
    (frames, 2)."""
    out = []
    if first == 0:
        out.append(r.render_frames(BLOCK * 20))
        tick(0)
        out.append(r.render_block(BLOCK))
    if between is not None:
        between()
    tick(1)
    out.append(r.render_frames(BLOCK * 8))
    tick(2)
    out.append(r.render_frames(BLOCK * 8))
    tick(3)
    _scheduled(sc.engine, {1: lambda: tick(4), 2: lambda: tick(5)})
    out.append(r.render_frames(BLOCK * 8))
    sc.new_frames()
    out.append(r.render_frames(BLOCK * 8))
    return np.concatenate(out)


#: each scene kind: (its constructor ``build(m, seed)``, its control tick
#: ``tick(scene, t)``, whether the exact oracle holds it, whether the JAX
#: Renderer holds it).  The seek-chain tests register their kinds here too.
KINDS = {"arena": (build_arena, _arena_tick, True, True)}


def run(kind, m, unroll=1, buckets=None, between=None):
    """``kind``'s scene through the script in package ``m`` (``between(scene)``
    after its first two calls): (audio, renderer, JAX dispatches by kind,
    scene)."""
    build, tick = KINDS[kind][:2]
    sc = build(m)
    tick = functools.partial(tick, sc)
    if between is not None:
        between = functools.partial(between, sc)
    if m is ref:
        return script(sc, sc.engine, tick), None, None, sc
    r = m.Renderer(sc.engine, RATE, scan_unroll=unroll, scan_buckets=buckets)
    kinds = {}
    if m is ot:
        get_step = r._get_step

        def spy(kind_, *a, **kw):
            k = kind_ if isinstance(kind_, str) else tuple(kind_)
            kinds[k] = kinds.get(k, 0) + 1
            return get_step(kind_, *a, **kw)

        r._get_step = spy
    return script(sc, r, tick, between=between), r, kinds, sc


def _carry(out, kind, sj):
    """The state carried from the JAX package: after ``sj``'s (a JAX
    scene's) first two calls of the script, a port scene of ``kind``
    prepares the same 21 blocks on the host, takes ``sj``'s state
    (``carry_scene``, fades in flight) and renders the rest of the script
    through its block steps into ``out["carried"]``."""
    from oddio_tpu_torch.utils.convert import carry_scene

    build, tick = KINDS[kind][:2]
    sp = build(pt)
    rp = pt.Renderer(sp.engine, RATE)
    for t in range(21):
        if t == 20:
            tick(sp, 0)
        sp.engine.host_prepare(rp.interval, BLOCK)
    carry_scene(sj.engine, sp.engine)
    out["carried"] = script(sp, rp, functools.partial(tick, sp), first=1)
    out["steps"] = rp._steps


@functools.lru_cache(maxsize=None)
def reference(kind):
    """The oracle's audio of ``kind``'s script, the JAX Renderer's audio,
    the JAX Renderer and its dispatches by kind (None where not held), and
    ``_carry``'s port run from the JAX run's state."""
    want = run(kind, ref)[0] if KINDS[kind][2] else None
    carried = {}
    a, rj, kinds, _ = (run(kind, ot, between=functools.partial(_carry, carried, kind))
                       if KINDS[kind][3] else (None,) * 4)
    return want, a, rj, kinds, carried


@functools.lru_cache(maxsize=None)
def port(kind, unroll=1, buckets=None, mode="step"):
    with prun.eager() if mode == "eager" else contextlib.nullcontext():
        return run(kind, pt, unroll, buckets)


def zero(x):
    """``x`` with -0.0 taken as 0.0 (ROADMAP Q3.7)."""
    return x + np.float32(0.0)


def err_jax(kind):
    """The JAX Renderer's own distance from the oracle on ``kind``'s
    script (0 where the oracle is not held)."""
    want, a = reference(kind)[:2]
    return 0.0 if want is None else float(np.abs(a - want).max())


def check_audio(kind, b):
    """``b`` (``kind``'s script) within 1e-5 of the oracle and within the
    JAX side's own oracle error + 1e-5 of the JAX Renderer (each where
    held)."""
    want, a = reference(kind)[:2]
    assert b.dtype == np.float32 and np.abs(b).max() > 0.02
    if want is not None:
        assert want.shape == b.shape
        assert np.abs(b - want).max() <= TOL, np.abs(b - want).max()
    if a is not None:
        assert a.shape == b.shape
        assert np.abs(b - a).max() <= err_jax(kind) + TOL, (np.abs(b - a).max(), err_jax(kind))


def check_steps(kind, unroll, buckets, multi=True):
    """The port's run of ``kind`` at ``unroll``/``buckets``: its audio
    (``check_audio``), the scene declares ``graph_capture`` and went
    through block steps (fused groups where ``multi``), every pool grew.
    Returns (renderer, scene)."""
    b, rp, _, sc = port(kind, unroll, buckets)
    check_audio(kind, b)
    assert sc.engine.graph_capture and rp._steps
    assert rp.graph_counts["eager"] > 0 and rp.graph_counts["replays"] == 0
    if multi and buckets is None:
        assert ("multi", 4) in {k[1] for k in rp._steps}
    if unroll == 8:
        assert any(k == 8 for steps in rp._steps.values() for k, _ in steps)
    pools = sc.engine._all_pools()
    assert all(p.is_dr for p in pools) and max(p.capacity for p in pools) > CAPACITY
    return rp, sc


def check_keys(kind):
    """One block step per key the JAX Renderer compiles a program for, of
    the same kinds; the dispatches by kind equal the JAX Renderer's (which
    fetches its fused-group program once a run, where the port counts the
    groups)."""
    rj, kinds = reference(kind)[2:4]
    _, rp, _, _ = port(kind)
    assert len(rp._steps) == len(rj._steps)
    assert sorted(str(k[1]) for k in rp._steps) == sorted(str(k[1]) for k in rj._steps)
    multi = ("multi", 4)
    assert {k: v for k, v in rp.dispatch_counts.items() if k != multi} == {
        k: v for k, v in kinds.items() if k != multi}
    assert rp.dispatch_counts.get(multi, 0) >= kinds.get(multi, 0)


def check_eager(kind):
    """The step path (packed rows, lanes on the device, copy-back) against
    ``eager()`` (numpy params, the state stored as returned): bit for bit
    (-0.0 as 0.0), with the same dispatches, at unroll 1 and at 8 with
    bench.py's buckets; the handles' ``is_finished`` equal at the end.
    Returns the handles' flags."""
    want, r0, _, s0 = port(kind, mode="eager")
    assert r0._steps == {} and r0.graph_counts["eager"] > 0
    fin = [h.is_finished() for h in s0.voice]
    for unroll, buckets in ((1, None), (8, BUCKETS)):
        got, r, _, sc = port(kind, unroll, buckets)
        np.testing.assert_array_equal(zero(got), zero(want))
        if buckets is None:
            assert r.dispatch_counts == r0.dispatch_counts
        assert [h.is_finished() for h in sc.voice] == fin
    return fin


def _engine_host(engine):
    """A comparable picture of the scene's and its pools' host state (the
    device state and the count-tensor cache left out)."""
    return _host({"engine": {k: v for k, v in vars(engine).items()
                             if k not in ("_seek_pools", "_buffered_pools", "_rot_dev")},
                  "pools": [{k: v for k, v in vars(p).items() if k not in ("state", "_count_t")}
                            for p in engine._all_pools()]})


def replay_emulation(kind, monkeypatch):
    """``kind``'s script at unroll 8, each call of a
    step also run on a deep copy of the engine frozen at that step's first
    call, from a copy of the same state and rows: its audio and state
    equal the live call's bit for bit, and the live call changes no host
    attribute.  Returns the step kinds called."""
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
    got = run(kind, pt, 8)[0]
    monkeypatch.undo()
    np.testing.assert_array_equal(got, port(kind, 8)[0])
    return calls


def check_host_reads(kinds):
    """Inside a block step no tensor is read on the host (``__array__``,
    ``numpy()``, ``item()``, ``tolist()`` raise there) over ``kinds``'
    scripts; the audio equals the unguarded runs'."""
    with host_read_guard() as hits:
        outs = [run(kind, pt, 8)[0] for kind in kinds]
    assert hits == []
    for kind, got in zip(kinds, outs):
        np.testing.assert_array_equal(got, port(kind, 8)[0])


@pytest.mark.parametrize("unroll,buckets", [(1, None), (8, None), (1, BUCKETS)],
                         ids=["unroll1", "unroll8", "buckets"])
def test_buffered_arena_steps_match_oracle_and_jax(unroll, buckets):
    """The buffered scene (FramesSignal, Speed, Fader and Cycle voices)
    within 1e-5 of the exact oracle and of the JAX Renderer within the JAX
    side's own distance from the oracle + 1e-5, through block steps and
    fused groups; the Speed pool took both routes, the arena step and the
    whole-arena gather."""
    rp, _ = check_steps("arena", unroll, buckets)
    field = 2 + [a for a, _ in pt.SpatialScene.POOL_ARCH].index("_ds_small")
    assert {e[field] for k in rp._steps for e in k[0][2]} == {True, False}


def test_buffered_arena_step_keys_match_jax():
    check_keys("arena")


def test_buffered_arena_step_matches_eager_bit_for_bit():
    """``check_eager``; FramesSignal voices finished, lingered and were
    reclaimed inside the run."""
    fin = check_eager("arena")
    _, _, _, sc = port("arena")
    assert sum(fin) >= 4 and not all(fin)
    assert sum(p.slot_gen.sum() for p in sc.engine._all_pools()) > 0  # slots reclaimed


def test_buffered_arena_block_step_reads_no_host_state(monkeypatch):
    """A replay emulated on a copy of the scene frozen at each step's first
    call (every host value the step reads is in the key: the interval, the
    read tier, the arena route, the inner frame count); through the speed
    write past the arena bound, the fades, growth and fused groups."""
    calls = replay_emulation("arena", monkeypatch)
    assert {"single", "scan", ("multi", 4)} <= set(calls) and len(calls) > 10


def test_buffered_arena_steps_read_no_tensor_on_host():
    """``check_host_reads`` over the buffered scene: the arena steps, the
    Fader step, the gather route, the fade lanes and the float64 play rows
    included."""
    check_host_reads(("arena",))


def test_buffered_arena_state_leaves_stay_put():
    """The step leaves every state leaf in the tensor it was collected in,
    the rings included, through moves, speed writes (one past the arena
    bound) and fades (``eager()`` stores what the render returns); the
    float64 cursors stay float64."""
    sc = build_arena(pt)
    r = pt.Renderer(sc.engine, RATE)
    r.render_block(BLOCK)
    before = tree_leaves(sc.engine.device_collect())
    for t in (0, 3, 4, 5):
        _arena_tick(sc, t)
        if t == 0:
            sc.set_speed(2, 5.0)
        r.render_frames(BLOCK * 5)
    after = tree_leaves(sc.engine.device_collect())
    assert len(after) == len(before) and all(a is b for a, b in zip(after, before))
    assert sum(x.dtype == torch.float64 for x in after) == 4  # FS, Speed, both Fader banks
    with prun.eager():
        r.render_block(BLOCK)
    moved = tree_leaves(sc.engine.device_collect())
    assert any(a is not b for a, b in zip(moved, before))


def test_new_frames_replaces_the_arena_leaf():
    """A new ``Frames`` (in any engine) replaces the global arena's device
    tensors: the data leaves the step checks before a replay are new
    tensors (so a card's graph captures again, never reading a stale
    address), and every state leaf is where it was; the steps after it
    equal ``eager()``."""
    outs = []
    for mode in ("step", "eager"):
        with prun.eager() if mode == "eager" else contextlib.nullcontext():
            sc = build_arena(pt)
            r = pt.Renderer(sc.engine, RATE)
            a = r.render_frames(BLOCK * 3)
            d0 = tree_leaves(sc.engine.device_collect())
            dd0 = tree_leaves(sc.engine.device_data())
            # the same tensors while nothing is added
            assert all(x is y for x, y in zip(dd0, tree_leaves(sc.engine.device_data())))
            sc.new_frames()
            dd2 = tree_leaves(sc.engine.device_data())
            assert len(dd2) == len(dd0) and all(x is not y for x, y in zip(dd0, dd2))
            assert all(x is y for x, y in zip(d0, tree_leaves(sc.engine.device_collect())))
            outs.append(np.concatenate([a, r.render_frames(BLOCK * 3)]))
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("chain", ARENA_KINDS)
def test_buffered_pool_of_each_arena_chain_captures(chain):
    """A scene holding one buffered pool of ``chain`` declares
    ``graph_capture`` and steps; the same chain around a user signal (a
    FramesSignal subclass) keeps op-by-op dispatch."""
    sc = Scene(pt)
    rng = np.random.default_rng(3)
    for _ in range(2):
        _arena_voice(sc, chain, rng)
    assert sc.engine.graph_capture
    r = pt.Renderer(sc.engine, RATE)
    assert np.abs(r.render_frames(BLOCK * 4)).max() > 0
    assert r._steps

    class UserFrames(pt.FramesSignal):
        pass

    class UserCycle(pt.Cycle):
        pass

    sc.frames = lambda i, t0: UserFrames(sc.sounds[i], t0)
    sc.cycle = lambda t0: UserCycle(sc.table)
    _arena_voice(sc, chain, rng)
    assert not sc.engine.graph_capture
    r = pt.Renderer(sc.engine, RATE)
    r.render_frames(BLOCK * 2)
    assert r._steps == {}


# -- the packed row ---------------------------------------------------------------------


ROW_BLOCKS = ("idle", "moves", "speeds", "plays", "fades")


@functools.lru_cache(maxsize=None)
def _row_params():
    """Each package's params of an idle block, a block of moves, of speed
    writes, of plays and of two released fades."""
    out = []
    for m in (ot, pt):
        sc = build_arena(m)

        def prepare(_sc=sc):
            # the host side alone: the params need no render
            return _sc.engine.host_prepare(F(1) / F(RATE), BLOCK)

        blocks = [prepare(), prepare()]
        sc.move(0, [1.0, 1.0, 1.0], [0.0, 1.0, 0.0])
        sc.move(4, [-1.0, 2.0, 0.0], [0.0, 0.0, 0.0], True)
        blocks.append(prepare())
        sc.set_speed(0, 0.9)
        sc.set_speed(1, 1.1)
        blocks.append(prepare())
        rng = np.random.default_rng(5)
        for k in ("frames", "fader", "cycle"):
            _arena_voice(sc, k, rng)
        blocks.append(prepare())
        sc.fade(0, 1, 0.0, 1.0, 0.02)
        sc.fade(2, 0, 0.1, 1.0, 0.02)
        blocks.append(prepare())
        out.append(blocks[1:])
    return list(zip(*out))


#: the leaves of a port's row the JAX package does not keep: a FramesSignal's
#: float64 time cursor and a buffered voice's own ring cursor
PORT_ONLY = ("t", "vcur", "vbase")


def compare_rows(jp, pp):
    """The port's row is the JAX package's with the words of ``PORT_ONLY``
    leaves (each float64 ``t`` two words) taken out, every other leaf at its place bit for bit but the
    arena offsets (where each package's process-wide sample arena placed
    the sounds); it unpacks to the params, ``t`` included.  Returns (the
    port's row, its leaves' paths)."""
    pack = prun._pack_spec(pp)
    assert pack is not None and jrun._pack_spec(jp) is not None
    jrow, prow = jrun._pack_row(jp), prun._pack_row(pp)
    pleaves = tree_flatten(pp)[0]
    ppaths = _paths(pp)
    words = [(p, np.size(x) * (2 if np.asarray(x).dtype == np.float64 else 1))
             for p, x in zip(ppaths, pleaves)]
    keep = np.concatenate([np.full(w, p[-1] not in PORT_ONLY) for p, w in words]
                          or [np.zeros(0, bool)])
    same = np.concatenate([np.full(w, p[-1] not in ("off", "goff", "loff")) for p, w in words
                           if p[-1] not in PORT_ONLY] or [np.zeros(0, bool)])
    assert keep.size == len(prow) and same.size == len(jrow)
    np.testing.assert_array_equal(prow[keep][same].view(np.uint32), jrow[same].view(np.uint32))
    jleaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert [tuple(k.key for k in path) for path, _ in jleaves] == [
        p for p in ppaths if p[-1] not in PORT_ONLY]
    got = prun._unpack_row(torch.from_numpy(prow), *pack)
    assert _paths(got) == ppaths
    for x, want in zip(tree_flatten(got)[0], pleaves):
        want = np.asarray(want)
        if want.dtype == np.float64:
            assert x.dtype == torch.float64
            np.testing.assert_array_equal(x.numpy().view(np.uint64), want.view(np.uint64))
        else:
            np.testing.assert_array_equal(x.numpy(), want.astype(x.numpy().dtype))
    return prow, ppaths


@pytest.mark.parametrize("block", range(len(ROW_BLOCKS)), ids=ROW_BLOCKS)
def test_buffered_arena_packed_row_matches_jax(block):
    """Each block's row against the JAX package's (``compare_rows``); an
    idle block ships no row, the plays and the fades ship float64
    cursors."""
    jp, pp = _row_params()[block]
    prow, ppaths = compare_rows(jp, pp)
    name = ROW_BLOCKS[block]
    if name == "idle":
        assert len(prow) == 0
    if name in ("plays", "fades"):
        assert any(p[-1] == "t" for p in ppaths)


# -- the state carried from the JAX package ---------------------------------------------


def check_carried(kind):
    """After ``carry_scene`` (``_carry``) the port's block steps render the
    rest of the script within the JAX side's own distance from the oracle
    + 1e-5 of the JAX Renderer's same blocks (the carried cursors are the
    JAX package's float32 ones)."""
    _, a, _, _, carried = reference(kind)
    b = carried["carried"]
    a = a[len(a) - len(b):]
    assert np.abs(a).max() > 0.02 and carried["steps"]
    assert np.abs(b - a).max() <= err_jax(kind) + TOL, (np.abs(b - a).max(), err_jax(kind))


def test_port_continues_a_jax_arena_scene():
    check_carried("arena")
