"""The port's block steps on the host pools, on the CPU, against the JAX
package's Renderer and ScenePack and the exact numpy oracle.

A SpatialScene of host buffered pools (Speed(Stream) voices: K4/K5's
operand record in the packed row), device-resident buffered pools of
stream chains (Adapt(Stream): the ingest chunk in the row) and submixes
(a config-5 Mixer played as one voice), a Mixer of a host ``Pool`` and a
submix, and a 1 x 1 ScenePack of such scenes declare ``graph_capture``.
On a card each step is a CUDA graph; here the same step runs uncaptured,
so these tests hold the code that is captured there, through one script
of ``set_speed`` writes, ``set_motion`` (a jump and a small smoothed
move), PCM ingest, a stream closed mid-run, pool growth and writes
between two blocks of one call: the audio within PARITY.md's 1e-5 of the
JAX Renderer (or ScenePack) and of the oracle (``reference_impl.py``
with ``OStream``, stream.rs written here), the step against ``eager()`` bit
for bit at ``scan_unroll`` 1 and 8, a replay emulated by running each
call on a copy of the engine frozen at its step's first call, and the
host-read guard of ``test_torch_graph_step.py``.

First, the repair this slice needs (ROADMAP Q3.10): a Renderer prepares
the next block before it dispatches a run, so a host pool whose strip
gate flips inside one call rendered the run with the next block's gate
and failed on the missing record.  Every engine now renders a run as of
its own archetype (``render_archetype``); the JAX package still fails
there (ROADMAP R14), so it is held block by block.  Test names avoid the
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
import reference_impl as ref  # noqa: E402
from oddio_tpu.parallel.mesh import make_mesh as jax_mesh  # noqa: E402
from oddio_tpu.parallel.sharded import ScenePack as JaxPack  # noqa: E402
from oddio_tpu_torch.core import run as prun  # noqa: E402
from oddio_tpu_torch.ops.ring_kernels import record_fields  # noqa: E402
from oddio_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from oddio_tpu_torch.parallel.sharded import ScenePack  # noqa: E402
from oddio_tpu_torch.utils.tree import tree_leaves, tree_map  # noqa: E402
from test_torch_graph_step import _bits, _host, host_read_guard  # noqa: E402

torch.set_num_threads(1)

RATE, BLOCK, TOL = 48000, 512, 1e-5
F = np.float32
SQ2 = np.sqrt(F(2.0), dtype=F)


def kw(m):
    return {"device": "cpu"} if m is pt else {}


# -- Q3.10: a fly-by flips the strip gate inside one call ---------------------------

FLY_POS, FLY_VEL, FLY_BLOCKS = [-10.0, 5.0, 0.0], [60.0, 0.0, 0.0], 32


def _fly_data():
    return (np.random.default_rng(19).standard_normal(FLY_BLOCKS * BLOCK + 4000) * 0.3
            ).astype(F)


def flyby(m):
    """One Speed(Stream) voice at 48 kHz played buffered 10 m left of the
    listener moving right at 60 m/s: its walk leaves K5's strip gate, takes
    it near the listener and leaves it again (max_distance 200 m, a 0.1 s
    buffer)."""
    data = _fly_data()
    control, scene = m.SpatialScene.new(**kw(m))
    ctl, st = m.Stream.new(RATE, len(data) + BLOCK)
    ctl.write(data)
    control.play_buffered(m.Speed(st), m.SpatialOptions(position=FLY_POS, velocity=FLY_VEL),
                          max_distance=200.0, rate=RATE, buffer_duration=0.1)
    return scene


@functools.lru_cache(maxsize=None)
def _fly_reference():
    """(the JAX package block by block, the exact oracle), each (n, 2)."""
    rj = ot.Renderer(flyby(ot), RATE)
    a = np.concatenate([np.asarray(rj.render_block(BLOCK)) for _ in range(FLY_BLOCKS)])
    oscene = ref.OSpatialScene(exact=True)
    oscene.play_buffered(ref.OFramesSignal(ref.OFrames(RATE, _fly_data()), 0.0, exact=True),
                         FLY_POS, FLY_VEL, max_distance=200.0, rate=RATE, buffer_duration=0.1)
    want = np.zeros((FLY_BLOCKS * BLOCK, 2), F)
    for k in range(FLY_BLOCKS):
        ref.oddio_run(oscene, RATE, want[BLOCK * k:BLOCK * (k + 1)])
    return a, want


@pytest.mark.parametrize("mode", ["step", "eager"])
def test_flyby_gate_flip_in_one_call(mode):
    """ROADMAP Q3.10: one ``render_frames`` call across both flips of the
    gate runs, in ``eager()`` and through steps, within 1e-5 of the exact
    oracle and of the JAX package rendered block by block."""
    scene = flyby(pt)
    gates = []
    prepare = scene.host_prepare

    def spy(*a, **k):
        out = prepare(*a, **k)
        gates.append(next(iter(scene._buffered_pools.values()))._use_strips)
        return out

    scene.host_prepare = spy
    assert scene.graph_capture
    r = pt.Renderer(scene, RATE)
    with prun.eager() if mode == "eager" else contextlib.nullcontext():
        got = r.render_frames(BLOCK * FLY_BLOCKS)
    flips = sum(a != b for a, b in zip(gates, gates[1:]))
    assert not gates[0] and any(gates) and flips == 2, gates
    assert r.dispatch_counts["scan"] == 3
    jx, want = _fly_reference()
    assert np.abs(want).max() > 0.005
    assert np.abs(got - want).max() <= TOL, np.abs(got - want).max()
    assert np.abs(got - jx).max() <= TOL, np.abs(got - jx).max()


def test_flyby_jax_render_frames_keeps_its_fault():
    """ROADMAP R14: the JAX package traces a run with the next block's
    gate and fails on the missing strip record (its own reference effect,
    not fixed in ``oddio_tpu/``)."""
    with pytest.raises(KeyError):
        ot.Renderer(flyby(ot), RATE).render_frames(BLOCK * FLY_BLOCKS)


# -- the host-pool engines, their script and its oracle --------------------------------


class OStream(ref.OSignal):
    """stream.rs as the oracle of a Stream and its control: the written
    samples join the buffer at the next block (Receiver::update); each
    frame lerps at ``t + i*ds`` (f32, ``ds = interval*rate``) with zeros
    past the buffered length (stream.rs:37-61); a block advances the f32
    cursor by ``interval*len(out)*rate``, clamped at the buffered length,
    and releases the whole samples it passed (stream.rs:63-69); it
    finishes once closed and drained (stream.rs:76-78, 88-91)."""

    def __init__(self, rate, data):
        self.rate = F(rate)
        self.buf = np.asarray(data, F)
        self.queued = []
        self.t = F(0.0)
        self.closed = self.stopping = False

    def write(self, x):
        self.queued.append(np.asarray(x, F))
        return len(x)

    def close(self):
        self.closed = True

    def sample(self, interval, out):
        if self.queued:
            self.buf = np.concatenate([self.buf] + self.queued)
            self.queued = []
        self.stopping = self.stopping or self.closed
        interval = F(interval)
        ds = F(interval * self.rate)
        n, size = len(out), len(self.buf)
        # every frame's f32 arithmetic elementwise, as one frame's
        pos = self.t + ds * np.arange(n, dtype=F)
        x0 = np.trunc(pos).astype(np.int64)
        padded = np.concatenate([self.buf, np.zeros(2, F)])

        def get(k):
            return np.where((k >= 0) & (k < size), padded[np.clip(k, 0, size + 1)], F(0.0))

        out[:] = ref.lerp(get(x0), get(x0 + 1), pos - x0.astype(F))
        nxt = F(self.t + F(F(interval * F(n)) * self.rate))
        tc = min(nxt, F(size))
        released = int(np.trunc(tc))
        self.t = F(tc - F(released))
        self.buf = self.buf[released:]

    def is_finished(self):
        return self.stopping and self.t == F(len(self.buf))


class _OSpeedCtl:
    def __init__(self, sig):
        self.sig = sig

    def set_speed(self, x):
        self.sig.speed = F(x)


class Rig:
    """One engine of package ``m`` (``ot``, ``pt``, or None for the
    oracle) built from seeded draws: "scene" (a SpatialScene of host
    Speed(Stream) voices, device-resident Adapt(Stream) voices and a
    config-5 submix of an Adapt(Stream) and an Adapt(Sine)) or "mixer" (a
    Mixer of host Speed(Stream) voices and the same submix); the handles
    the script drives."""

    def __init__(self, m, kind, seed):
        self.m, self.kind = m, kind
        self.rng = np.random.default_rng(seed)
        self.turn = 0  # the script's speed writes take the voices in turn
        self.speeds, self.streams, self.hs = [], [], []
        if m is None:
            self.engine = ref.OSpatialScene(exact=True) if kind == "scene" else ref.OMixer()
        elif kind == "scene":
            self.control, self.engine = m.SpatialScene.new(initial_capacity=8, **kw(m))
        else:
            self.engine = m.Mixer(1, initial_capacity=8, **kw(m))
            self.control = m.MixerControl(self.engine)
        if m is not None:  # each block's params, as host_prepare returned them
            self.params = []
            prepare = self.engine.host_prepare

            def spy(*a, **k):
                self.params.append(prepare(*a, **k))
                return self.params[-1]

            self.engine.host_prepare = spy
        for _ in range(5):
            self.speed_voice()
        # a stream closed mid-run: its PCM, 800 samples then silence,
        # written once
        self.closer = self.speed_voice(data=np.concatenate(
            [self._pcm(800), np.zeros(400, F)]), fed=False)
        if kind == "scene":
            for _ in range(2):
                self.voice(self._adapt(self._stream(self._pcm(2400))), True)
        sub_streams = []
        if m is None:
            sub = ref.OMixer()
            play = sub.play
        else:
            sub = m.Mixer(1, **kw(m))
            play = m.MixerControl(sub).play
        st = self._stream(self._pcm(2400), into=sub_streams)
        play(self._adapt(st))
        phase, freq = self.rng.uniform(0, 6), self.rng.uniform(100, 900)
        play(self._adapt(ref.OSine(phase, freq, exact=True) if m is None
                         else m.Sine(phase, freq)))
        self.voice(sub, False)
        self.streams += sub_streams

    def _pcm(self, k):
        return (self.rng.standard_normal(k) * 0.1).astype(F)

    def _stream(self, data, into=None):
        """A stream of 8 kHz PCM ``data`` (or its oracle FramesSignal);
        its control joins ``into`` (default the rig's streams)."""
        into = self.streams if into is None else into
        if self.m is None:
            sig = OStream(8000, data)
            into.append(sig)
            return sig
        st = self.m.Stream(8000, 8192, max_write_per_block=2400)
        assert st.control.write(data) == len(data)
        into.append(st.control)
        return st

    def _adapt(self, inner):
        if self.m is None:
            return ref.OAdapt(inner, 0.1, 0.1, 4.0, F(0.1) / SQ2, F(0.5) / SQ2)
        return self.m.Adapt(inner, 0.1, self.m.AdaptOptions(tau=0.1, max_gain=4.0))

    def speed_voice(self, data=None, fed=True):
        """A Speed(Stream) voice at a speed in [0.8, 1.25] (the host
        pool); returns its stream control."""
        data = self._pcm(2400) if data is None else data
        speed = F(self.rng.uniform(0.8, 1.25))
        into = self.streams if fed else []
        st = self._stream(data, into)
        if self.m is None:
            sig = ref.OSpeed(st, speed)
            self.speeds.append(_OSpeedCtl(sig))
        else:
            sc, sig = self.m.Speed.new(st)
            sc.set_speed(speed)
            self.speeds.append(sc)
        self.voice(sig, True)
        return into[-1]

    def voice(self, sig, moving):
        if self.kind == "mixer":
            if self.m is None:
                self.engine.play(sig)
            else:
                self.hs.append((self.control.play(sig), None))
            return
        pos = self.rng.uniform(-6, 6, 3)
        vel = self.rng.uniform(-0.2, 0.2, 3) if moving else np.zeros(3)
        opts = dict(max_distance=50.0, rate=RATE, buffer_duration=0.1)
        if self.m is None:
            h = self.engine.play_buffered(sig, pos, vel, **opts)
        else:
            h = self.control.play_buffered(sig, self.m.SpatialOptions(position=pos, velocity=vel),
                                           **opts)
        self.hs.append((h, pos.astype(F)))

    # the script's actions
    def feed(self, k, streams=None):
        for c in self.streams if streams is None else streams:
            x = self._pcm(k)
            assert c.write(x) == k

    def move(self):
        """A jump of voice 1 and a small smoothed move of voice 6 (a
        device-resident one in a scene)."""
        for (h, pos), disc in ((self.hs[1], True), (self.hs[6], False)):
            target = pos + self.rng.uniform(-1, 1, 3).astype(F)
            h.set_motion(target, self.rng.uniform(-0.3, 0.3, 3), disc)

    def grow(self):
        for _ in range(5):  # 11 Speed(Stream) voices: the host pool doubles to 16
            self.speed_voice()


#: the script: (blocks of each call, call kind, {block of the call: actions})
SCRIPT = (
    (6, "frames", {}),
    (8, "frames", {3: ("speed", "feed_some"), 6: ("close",)}),
    (8, "frames", {0: ("grow",)}),
    (4, "block", {1: ("speed",)}),
    (12, "frames", {2: ("move", "feed_some")}),
)
#: actions before each call
BEFORE = {1: ("speed", "move", "feed"), 2: ("feed",), 4: ("speed",)}
NBLOCKS = sum(n for n, _, _ in SCRIPT)


def _act(rig, name):
    if name == "speed":
        rig.speeds[rig.turn % 5].set_speed(F(rig.rng.uniform(0.8, 1.25)))
        rig.turn += 1
    elif name == "feed":
        rig.feed(1000)
    elif name == "feed_some":
        rig.feed(500, rig.streams[:2])
    elif name == "close":
        rig.closer.close()
    elif name == "move" and rig.kind == "scene":
        rig.move()
    elif name == "grow":
        rig.grow()


def _scheduled(engine, hook):
    """Call ``hook(i)`` just before the engine's i-th ``host_prepare`` (a
    control thread acting between two blocks of one render call)."""
    prepare, count = engine.host_prepare, [0]

    def host_prepare(*a, **kwargs):
        hook(count[0])
        count[0] += 1
        return prepare(*a, **kwargs)

    engine.host_prepare = host_prepare


def run_script(rigs, render, calls=len(SCRIPT)):
    """Drive ``rigs`` (one per scene) through the first ``calls`` calls of
    SCRIPT; ``render(n, kind, state)`` renders a call of n blocks,
    returning (S, n*BLOCK, C).  Returns the audio, (S, blocks*BLOCK, C)."""
    state = {"pending": {}, "base": 0}

    def hook(i, s):
        for name in state["pending"].get((s, i), ()):
            _act(rigs[s], name)

    for s, rig in enumerate(rigs):
        if rig.m is not None:
            _scheduled(rig.engine, lambda i, s=s: hook(i - state["base"], s))
    out = []
    prepared = [0]
    for c, (n, kind, inside) in enumerate(SCRIPT[:calls]):
        for name in BEFORE.get(c, ()):
            for rig in rigs:
                _act(rig, name)
        state["pending"] = {(s, i): acts for i, acts in inside.items()
                            for s in range(len(rigs))}
        state["base"] = prepared[0]
        out.append(render(n, kind, state))
        prepared[0] += n
    return np.concatenate(out, axis=1)


def _port_render(engine, renderer):
    def render(n, kind, _state):
        # the JAX Renderer block by block: one program per archetype
        if kind == "block" or isinstance(renderer, ot.Renderer):
            return np.concatenate([renderer.render_block(BLOCK) for _ in range(n)])[None]
        return renderer.render_frames(BLOCK * n)[None]

    return render


def _pack_render(pack):
    def render(n, kind, _state):
        if kind == "block":
            return np.concatenate([pack.render_block(BLOCK) for _ in range(n)], axis=1)
        if isinstance(pack, JaxPack):
            return np.concatenate([pack.render_block(BLOCK) for _ in range(n)], axis=1)
        got = torch.cat(pack.render_frames_device(BLOCK * n))  # (n, S, C, BLOCK)
        return got.permute(1, 0, 3, 2).reshape(got.shape[1], -1, got.shape[2]).numpy()

    return render


def _oracle_render(rigs):
    def render(n, kind, state):
        outs = []
        for s, rig in enumerate(rigs):
            # the oracle mixer renders mono blocks as 1-d arrays
            x = np.zeros((n * BLOCK, 2) if rig.kind == "scene" else n * BLOCK, F)
            for i in range(n):
                for name in state["pending"].get((s, i), ()):
                    _act(rig, name)
                ref.oddio_run(rig.engine, RATE, x[BLOCK * i:BLOCK * (i + 1)])
            outs.append(x.reshape(n * BLOCK, -1))
        return np.stack(outs)

    return render


SEEDS = {"scene": (3,), "mixer": (4,), "pack": (5, 6)}


def render_case(case, m, unroll=1, mode="step", calls=len(SCRIPT)):
    """The script's first ``calls`` calls on ``case`` ("scene", "mixer" or
    "pack") in package ``m`` (None: the oracle); returns (audio (S, n,
    C), renderer or pack, rigs)."""
    kind = "mixer" if case == "mixer" else "scene"
    with prun.eager() if mode == "eager" else contextlib.nullcontext():
        rigs = [Rig(m, kind, seed) for seed in SEEDS[case]]
        if m is None:
            return run_script(rigs, _oracle_render(rigs), calls), None, rigs
        if case == "pack":
            if m is pt:
                r = ScenePack([g.engine for g in rigs], RATE, make_mesh(1, 1, ["cpu"]),
                              scan_unroll=unroll)
            else:
                r = JaxPack([g.engine for g in rigs], RATE, jax_mesh(1, 1))
            return run_script(rigs, _pack_render(r), calls), r, rigs
        r = m.Renderer(rigs[0].engine, RATE, **({"scan_unroll": unroll} if m is pt else {}))
        return run_script(rigs, _port_render(rigs[0].engine, r), calls), r, rigs


#: calls of the script the JAX package renders (each of its programs
#: compiles for seconds on the CPU): plays, idle blocks, a control block,
#: PCM, and writes and a close between two blocks of one call
JAX_CALLS = 2


@functools.lru_cache(maxsize=None)
def _jax(case):
    """The JAX package's audio of the script's first JAX_CALLS calls, and
    its rigs."""
    x, _, rigs = render_case(case, ot, calls=JAX_CALLS)
    return x, rigs


@functools.lru_cache(maxsize=None)
def _oracle(case):
    return render_case(case, None)[0]


@functools.lru_cache(maxsize=None)
def _eager(case):
    return render_case(case, pt, mode="eager")


@pytest.mark.parametrize("unroll", [1, 8])
@pytest.mark.parametrize("case", ["scene", "mixer", "pack"])
def test_host_pools_match_jax_and_oracle(case, unroll):
    """The script through steps: within 1e-5 of the exact oracle and, over
    its first calls, of the JAX Renderer (the pack's against the JAX
    ScenePack: ``test_torch_graph_host_pack.py``), bit for bit
    ``eager()``'s; the stream closed mid-run finished and its slot was
    reclaimed."""
    got, r, rigs = render_case(case, pt, unroll)
    want = _oracle(case)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(want).max() > 0.01
    assert np.abs(got - want).max() <= TOL, np.abs(got - want).max()
    if case != "pack":
        jx = _jax(case)[0]
        head = got[:, :jx.shape[1]]
        assert np.abs(head - jx).max() <= TOL, np.abs(head - jx).max()
    np.testing.assert_array_equal(got, _eager(case)[0])
    engine = rigs[0].engine if case != "pack" else r.scenes[0]
    assert engine.graph_capture and r._steps
    assert r.graph_counts["eager"] > 0 and r.graph_counts["replays"] == 0
    if unroll == 8:
        assert any(k == 8 for steps in r._steps.values() for k, _ in steps)
    pools = engine._buffered_pools if case != "mixer" else engine._pools
    host = [p for p in pools.values() if type(p).__name__ in ("_BufferedPool", "Pool")]
    assert len(host) == 1 and host[0].capacity == 16
    closer = rigs[0].hs[5][0]  # the closed stream's voice finished and was reclaimed
    assert closer.is_stopped() if case == "mixer" else closer.is_finished()


def test_host_pool_dispatches_match_eager():
    """The steps dispatch as ``eager()`` does (one dispatch per run, the
    same kinds) and the engines' host state ends the same."""
    for case in ("scene", "mixer", "pack"):
        _, r, rigs = render_case(case, pt)
        _, r0, rigs0 = _eager(case)
        if case != "pack":
            assert r.dispatch_counts == r0.dispatch_counts
        for g, g0 in zip(rigs, rigs0):
            assert [c.free() for c in g.streams] == [c.free() for c in g0.streams]


# -- the record in the row -----------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _record_params():
    """Each package's host-pool params of two blocks of the scene's
    script, as ``host_prepare`` returned them: the first, and the first
    after a speed write, a move and PCM (block 6)."""
    out = []
    for m in (ot, pt):
        rig = _jax("scene")[1][0] if m is ot else render_case("scene", pt, calls=JAX_CALLS)[2][0]
        host = next(p.name for p in rig.engine._buffered_pools.values()
                    if type(p).__name__ == "_BufferedPool")
        out.append([rig.params[b][host] for b in (0, 6)])
    return list(zip(*out))


@pytest.mark.parametrize("block", [0, 1], ids=["first", "control"])
def test_row_record_matches_jax_host_pool(block):
    """The record the step reads from its row (a float32 view, its int32
    fields as their bits) equals the JAX host pool's ``wrow``,
    ``extra_w``, ``rrow``, ``extra_r``, ``scal``, ``gain0``, ``d_gain``,
    ``n_write`` and ``mask`` bit for bit."""
    jp, pp = _record_params()[block]
    pack = prun._pack_spec(pp)
    got = prun._unpack_row(torch.from_numpy(prun._pack_row(pp)), *pack)
    rec = got["rec"]
    assert rec.dtype == torch.float32 and rec.is_contiguous()
    f = record_fields(rec)
    for name in ("wrow", "extra_w", "rrow", "extra_r", "n_write"):
        want = np.asarray(jp[name]).astype(np.int32)
        np.testing.assert_array_equal(f[name].numpy(), want, err_msg=name)
    for name in ("scal", "gain0", "d_gain"):
        want = np.asarray(jp[name], F)
        np.testing.assert_array_equal(f[name].numpy().view(np.uint32), want.view(np.uint32),
                                      err_msg=name)
    np.testing.assert_array_equal(f["mask"].numpy(), np.asarray(jp["mask"]).astype(F))
    assert np.asarray(jp["mask"]).sum() == 6


# -- the step itself: no host state, no host reads ---------------------------------------


def _engine_host(sig):
    return _host({k: v for k, v in vars(sig).items() if k not in ("_rot_dev",)})


def test_host_pool_steps_read_no_host_state(monkeypatch):
    """A replay emulated: each call of a step also runs on a deep copy of
    the engine frozen at that step's first call, from a copy of the same
    state and rows; its audio and state equal the live call's bit for bit
    (every host value the step reads is in the key), and the live call
    changes no host attribute."""
    frozen, calls = {}, []
    live_call = prun.BlockSteps._eager_call

    def spy(self, step, d0, dd):
        sig = self._step_sig
        if id(step) not in frozen:
            hook = [(p, p._unpack_hook) for p in _all_pools(sig)]
            for p, _ in hook:  # a pack's hook would copy the pack
                p._unpack_hook = None
            frozen[id(step)] = (step, copy.deepcopy(sig))
            for p, h in hook:
                p._unpack_hook = h
        before = _engine_host(sig)
        d_in = tree_map(torch.clone, d0)
        rows = None if step.rows is None else step.rows.clone()
        out = live_call(self, step, d0, dd)
        assert _engine_host(sig) == before, "the block step changed a host attribute"
        d_f, out_f = prun.step_body(frozen[id(step)][1], step.kind, step.pack, step.n, step.k,
                                    d_in, dd, rows)
        assert torch.equal(_bits(out_f), _bits(out))
        live = self._step_get()

        def same(a, b, path=()):
            if isinstance(a, dict):
                assert set(a) <= set(b), path
                for k in a:
                    same(a[k], b[k], path + (k,))
            else:
                assert torch.equal(_bits(a), _bits(b)), path

        same(d_f, live)
        calls.append(step.kind)
        return out

    monkeypatch.setattr(prun.BlockSteps, "_eager_call", spy)
    for case in ("scene", "mixer", "pack"):
        render_case(case, pt, 8)
    assert len(calls) > 40


def _all_pools(engine):
    out = []
    for p in engine._all_pools():
        out.append(p)
        if getattr(p, "is_singleton", False) and hasattr(p.sig, "_all_pools"):
            out.extend(_all_pools(p.sig))
    return out


def test_host_pool_steps_read_no_tensor_on_host():
    """Every script under ``host_read_guard``: no step reads a tensor on
    the host, and the audio equals ``eager()``'s."""
    got = {}
    with host_read_guard() as hits:
        for case in ("scene", "mixer", "pack"):
            got[case] = render_case(case, pt, 8)[0]
        fly = pt.Renderer(flyby(pt), RATE).render_frames(BLOCK * FLY_BLOCKS)
    assert hits == []
    for case, x in got.items():
        np.testing.assert_array_equal(x, _eager(case)[0])
    with prun.eager():
        np.testing.assert_array_equal(fly, pt.Renderer(flyby(pt), RATE).render_frames(
            BLOCK * FLY_BLOCKS))


def test_host_pool_state_leaves_stay_put():
    """The steps leave every state leaf of the host-pool scene where it was
    collected (the host ring, the stream rings, the submix's rings), but
    for growth, which replaces the grown pool's leaves."""
    rig = Rig(pt, "scene", 9)
    scene = rig.engine
    r = pt.Renderer(scene, RATE)
    r.render_block(BLOCK)
    before = tree_leaves(scene.device_collect())
    rig.feed(700)
    rig.speeds[0].set_speed(1.1)
    rig.move()
    r.render_frames(BLOCK * 6)
    after = tree_leaves(scene.device_collect())
    assert len(after) == len(before) and all(a is b for a, b in zip(after, before))
