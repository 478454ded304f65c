"""The spatial sampler's plain reference (the benchmark's
``benchmark/reference/spatial_sampler.py``, loaded by path) against the
port and against the exact oracle, on the CPU, at a small size: a
SpatialScene of ``FramesSignal``, ``Speed(FramesSignal)``,
``Fader(Speed(FramesSignal))`` and ``Cycle`` voices in delay-ring pools,
driven as a game drives it (one-shots replayed as their handles show
them finished, walking-size motion reports, speed writes, fades), and
voices whose float32 ring cursor writes one block a sample short, where a
later speed write or fade lands a sample earlier in the source.

The tolerance is PARITY.md's 1e-5 (absolute, the engine against an exact
oracle): the reference computes every per-frame value in float64 from
the same float32 per-voice scalars the port rounds, so what is left is the
port's float32 samples, ramps and sums.  Each planted fault (a linear
crossfade, a speed write ignored, a replay dropped) moves the PCM by far
more.  Needs no JAX.
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import oddio_tpu_torch as pt
import reference_impl as oracle

torch.set_num_threads(1)

#: the benchmark's plain references (``benchmark/`` is not a package)
REFERENCE = Path(__file__).resolve().parents[1] / "benchmark" / "reference"


def _load(name):
    """``benchmark/reference/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(f"_benchmark_reference_{name}",
                                                  REFERENCE / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


R = _load("spatial_sampler")

F = np.float32
RATE, BLOCK, SR = 48000, 512, 44100
TOL = 1e-5
KINDS = ("frames", "speed", "fader", "cycle")
MAXD, BUFD = 100.0, 0.1


def sounds(rng, k=3, seconds=(0.15, 0.4)):
    """``k`` mono sounds at 44.1 kHz of lengths in ``seconds``: three
    partials and noise."""
    out = []
    for _ in range(k):
        n = int(rng.uniform(*seconds) * SR)
        t = np.arange(n) / SR
        f = rng.uniform(80, 2000, 3)
        x = sum(np.sin(2 * np.pi * fk * t + rng.uniform(0, 6)) for fk in f) / 3
        out.append((0.4 * x + 0.05 * rng.standard_normal(n)).astype(F))
    return out


class Game:
    """A small game on the port's SpatialScene (on the CPU), every call of
    it kept as the reference's inputs: ``per`` blocks a call; before each
    call ``control`` syncs, replays the one-shots shown finished,
    re-reports ``moves`` voices' motion 1 m off their line, writes speeds
    and fades on a share of the Speed and Fader voices, and (``prefetch``)
    prefetches the digest the next call's sync reads."""

    def __init__(self, seed, voices=8, capacity=8, per=4, prefetch=True, moves=4, share=0.3):
        self.rng = np.random.default_rng(seed)
        self.sounds = sounds(self.rng)
        self.frames = [pt.Frames.from_slice(SR, s) for s in self.sounds]
        self.inp = R.SamplerInputs(self.sounds, SR, RATE, BLOCK, MAXD, BUFD, 0.1)
        self.control_half, self.scene = pt.SpatialScene.new(initial_capacity=capacity,
                                                            device="cpu")
        self.renderer = pt.Renderer(self.scene, RATE, scan_buckets=(8, 4, 1))
        self.per, self.prefetch, self.moves, self.share = per, prefetch, moves, share
        self.block = 0
        self.voices = [self.play(k) for k in KINDS for _ in range(voices)]
        self.finished_at = {}  # life -> the block its handle first showed it finished
        self.out = []

    def play(self, kind):
        rng = self.rng
        pos = rng.uniform(-20, 20, 3).astype(F)
        vel = rng.uniform(-1.5, 1.5, 3).astype(F)
        snd = int(rng.integers(len(self.sounds)))
        spd, off = F(rng.uniform(0.8, 1.25)), float(rng.uniform(0, 0.1))
        sc = fc = None
        if kind == "cycle":
            sig = pt.Cycle(self.frames[snd])
            sig.seek(off)
        else:
            off = 0.0
            sig = pt.FramesSignal(self.frames[snd], 0.0)
            if kind != "frames":
                sc, sig = pt.Speed.new(sig)
                sc.set_speed(float(spd))
            if kind == "fader":
                fc, sig = pt.Fader.new(sig)
        h = self.control_half.play_buffered(sig, pt.SpatialOptions(position=pos, velocity=vel),
                                            max_distance=MAXD, rate=RATE, buffer_duration=BUFD)
        life = self.inp.play(self.block, kind, pos, vel, snd, speed=spd, offset=off)
        return {"kind": kind, "h": h, "life": life, "speed": sc, "fader": fc, "pos": pos,
                "vel": vel, "at": self.block}

    def control(self):
        rng, b, inp = self.rng, self.block, self.inp
        self.scene.sync()
        for i, v in enumerate(self.voices):
            if v["kind"] in ("frames", "speed") and v["h"].is_finished():
                self.finished_at[v["life"]] = b
                self.voices[i] = self.play(v["kind"])
        for v in self.voices[:: max(1, len(self.voices) // self.moves)]:
            p = (v["pos"] + v["vel"] * F((b - v["at"]) * BLOCK / RATE)
                 + rng.uniform(-1, 1, 3)).astype(F)
            vel = rng.uniform(-1.5, 1.5, 3).astype(F)
            v["h"].set_motion(p, vel, False)
            inp.move(b, [v["life"]], p, vel)
            v["pos"], v["vel"], v["at"] = p, vel, b
        for v in self.voices:
            if v["kind"] == "speed" and rng.uniform() < self.share:
                s = F(rng.uniform(0.8, 1.25))
                v["speed"].set_speed(float(s))
                inp.set_speed(b, v["life"], s)
            if v["kind"] == "fader" and rng.uniform() < self.share:
                snd, s = int(rng.integers(len(self.sounds))), F(rng.uniform(0.8, 1.25))
                sc, sp = pt.Speed.new(pt.FramesSignal(self.frames[snd], 0.0))
                sc.set_speed(float(s))
                v["fader"].fade_to(sp, 0.02)
                inp.fade(b, v["life"], snd, s, 0.02)
        if self.prefetch:
            self.scene.sync_prefetch()

    def run(self, blocks):
        while self.block < blocks:
            if self.block:
                self.control()
            for x in self.renderer.render_frames_device(self.per * BLOCK, sync=False):
                B, C, L = x.shape
                self.out.append(x.reshape(B, C, L // BLOCK, BLOCK).permute(0, 2, 1, 3)
                                .reshape(-1, C, BLOCK))
            self.block += self.per
        return torch.cat(self.out).double()


@pytest.fixture(scope="module")
def game():
    g = Game(7)
    return g, g.run(40)


def _err(have, inp, blocks=40):
    return float((have - R.render(inp, list(range(blocks)))).abs().max())


@pytest.mark.parametrize("name", ["spatial", "mixer_agc", "spatial_sampler"])
def test_reference_imports_neither_jax_nor_the_program(name):
    """Each of the benchmark's plain references imports only the standard
    library's math, numpy and torch, and loading it leaves TF32 off."""
    _load(name)
    src = (REFERENCE / f"{name}.py").read_text()
    imports = [ln.split()[1].split(".")[0] for ln in src.splitlines()
               if ln.startswith(("import ", "from "))]
    assert set(imports) <= {"__future__", "math", "numpy", "torch"}
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32


def test_port_matches_reference(game):
    g, have = game
    kinds = {R.KINDS[k] for k in g.inp.kind}
    assert kinds == set(KINDS)
    # the run holds replays, reclaims, speed writes, fades and motion
    assert len(g.inp.kind) > 4 * 8 and g.inp.speeds and g.inp.fades and g.inp.motion
    assert g.finished_at
    err = _err(have, g.inp)
    assert err <= TOL, err
    assert float(have.abs().max()) > 1e-3


@pytest.mark.parametrize("seed", [11, 12])
def test_port_matches_reference_waiting_sync(seed):
    """A sync with no digest prefetched (the current state, waited for)
    and a game that replays voices in 2-block calls: the same
    agreement."""
    g = Game(seed, voices=6, per=2, prefetch=False, share=0.5)
    have = g.run(24)
    assert len(g.inp.kind) > 4 * 6
    assert _err(have, g.inp, 24) <= TOL


def test_handles_never_report_a_finish_before_the_reference_stops_it(game):
    g, _ = game
    stops = g.inp.stops(40)
    for life, b in g.finished_at.items():
        assert life in stops and stops[life] <= b, (life, b, stops.get(life))


def _linear_fade(tab_cls):
    fader = tab_cls.fader

    def linear(self, life, m, rnd):
        sqrt = torch.sqrt
        try:
            torch.sqrt = lambda x: x
            return fader(self, life, m, rnd)
        finally:
            torch.sqrt = sqrt
    return linear


@pytest.mark.parametrize("fault", ["linear_fade", "speed_ignored", "replay_dropped"])
def test_planted_fault_fails_the_comparison(game, fault, monkeypatch):
    import copy

    g, have = game
    inp = copy.deepcopy(g.inp)
    if fault == "linear_fade":
        monkeypatch.setattr(R._Tables, "fader", _linear_fade(R._Tables))
    elif fault == "speed_ignored":
        inp.speeds = inp.speeds[1:]
    else:
        # the first replay never plays: its play and its calls go
        li = min(i for i, b in enumerate(inp.pblock) if b > 0)
        inp.pblock[li] = 10 ** 6
        inp.motion = [(b, i, p, v) for b, i, p, v in inp.motion if li not in i]
        inp.speeds = [e for e in inp.speeds if e[1] != li]
        inp.fades = [e for e in inp.fades if e[1] != li]
    assert _err(have, inp) > 10 * TOL


def test_reference_matches_the_exact_oracle():
    """FramesSignal and Speed(FramesSignal) voices (the oracle's Cycle has
    no exact form, R11), with a speed write, against ``reference_impl``'s
    exact spatial scene, block by block."""
    rng = np.random.default_rng(3)
    snd = sounds(rng, 2, (0.2, 0.3))
    inp = R.SamplerInputs(snd, SR, RATE, BLOCK, MAXD, BUFD, 0.1)
    scene = oracle.OSpatialScene(exact=True)
    frames = [oracle.OFrames(SR, s) for s in snd]
    speeds = []
    for k in range(4):
        pos = rng.uniform(-10, 10, 3).astype(F)
        vel = rng.uniform(-1.5, 1.5, 3).astype(F)
        spd = F(1.0) if k < 2 else F(rng.uniform(0.8, 1.25))
        sig = oracle.OFramesSignal(frames[k % 2], 0.0, exact=True)
        if k >= 2:
            sig = oracle.OSpeed(sig, spd)
            speeds.append((sig, inp.play(0, "speed", pos, vel, k % 2, speed=spd)))
        else:
            inp.play(0, "frames", pos, vel, k % 2)
        scene.play_buffered(sig, pos, vel, 0.1, MAXD, RATE, BUFD)
    blocks = 30
    want = np.zeros((blocks, 2, BLOCK))
    for b in range(blocks):
        if b == 9:
            sig, life = speeds[0]
            sig.speed = F(1.2)
            inp.set_speed(9, life, F(1.2))
        buf = np.zeros((BLOCK, 2), F)
        oracle.oddio_run(scene, RATE, buf)
        want[b] = buf.T
    got = R.render(inp, list(range(blocks))).numpy()
    assert np.abs(want).max() > 1e-3
    assert np.abs(got - want).max() <= TOL



def _short_positions(count, lo, hi):
    """``count`` distances on an axis at which a voice's first-lap ring
    cursor (ring.rs:18-41, float32) rounds to a whole sample in block
    ``lo`` to ``hi - 1`` after its play, so that block writes 511 samples:
    the first of 20000 consecutive float32 values from 10.7 m that do."""
    xs = (np.array([10.7], F).view(np.int32) + np.arange(20000, dtype=np.int32)).view(F)
    probe = R.SamplerInputs([np.zeros(8, F)], SR, RATE, BLOCK, MAXD, BUFD, 0.1)
    for x in xs:
        probe.play(0, "frames", (x, 0.0, 0.0), (0.0, 0.0, 0.0), 0)
    short = probe._short_writes()
    hit = np.nonzero((short >= lo) & (short < hi))[0]
    assert len(hit) >= count
    return [F(xs[i]) for i in hit[:count]]


def _whole_blocks(inp):
    """``inp`` as if every block wrote 512 samples: the form that misses a
    short write."""
    whole = R.SamplerInputs.__new__(R.SamplerInputs)
    whole.__dict__.update(inp.__dict__)
    whole._short_writes = lambda: np.full(len(inp.kind), -1, np.int64)
    return whole


def test_reference_matches_the_exact_oracle_on_a_short_write():
    """A Speed(FramesSignal) voice whose ring cursor writes one sample short
    in its first blocks, then a speed write: the oracle's source starts
    each later block a sample earlier, and so does the reference's.  The
    same inputs with every block taken as 512 samples miss it by far more
    than the tolerance."""
    rng = np.random.default_rng(5)
    snd = sounds(rng, 1, (0.5, 0.6))
    (x,) = _short_positions(1, 1, 3)
    inp = R.SamplerInputs(snd, SR, RATE, BLOCK, MAXD, BUFD, 0.1)
    scene = oracle.OSpatialScene(exact=True)
    frames = oracle.OFrames(SR, snd[0])
    pos, vel = np.array([x, 0.0, 0.0], F), np.zeros(3, F)
    sig = oracle.OSpeed(oracle.OFramesSignal(frames, 0.0, exact=True), F(0.9))
    life = inp.play(0, "speed", pos, vel, 0, speed=F(0.9))
    scene.play_buffered(sig, pos, vel, 0.1, MAXD, RATE, BUFD)
    assert inp._short_writes()[life] >= 1
    blocks = 20
    want = np.zeros((blocks, 2, BLOCK))
    for b in range(blocks):
        if b == 6:
            sig.speed = F(1.25)
            inp.set_speed(6, life, F(1.25))
        buf = np.zeros((BLOCK, 2), F)
        oracle.oddio_run(scene, RATE, buf)
        want[b] = buf.T
    got = R.render(inp, list(range(blocks))).numpy()
    assert np.abs(want).max() > 1e-3
    assert np.abs(got - want).max() <= TOL
    missed = R.render(_whole_blocks(inp), list(range(blocks))).numpy()
    assert np.abs(missed - want).max() > 10 * TOL


class _Script:
    """Voices played at block 0 on the port and in the reference's inputs,
    then ``at(block, fn)`` calls made before that block, rendered in calls
    of ``per`` blocks."""

    def __init__(self, snd):
        self.frames = [pt.Frames.from_slice(SR, s) for s in snd]
        self.inp = R.SamplerInputs(snd, SR, RATE, BLOCK, MAXD, BUFD, 0.1)
        self.control, self.scene = pt.SpatialScene.new(initial_capacity=4, device="cpu")
        self.renderer = pt.Renderer(self.scene, RATE, scan_buckets=(8, 4, 1))
        self.events = {}

    def speed(self, snd, spd):
        sc, sig = pt.Speed.new(pt.FramesSignal(self.frames[snd], 0.0))
        sc.set_speed(float(spd))
        return sc, sig

    def play(self, kind, pos, snd, spd=1.0):
        pos, spd = np.array(pos, F), F(spd)
        ctl = None
        if kind == "frames":
            sig = pt.FramesSignal(self.frames[snd], 0.0)
        else:
            ctl, sig = self.speed(snd, spd)
            if kind == "fader":
                ctl, sig = pt.Fader.new(sig)
        self.control.play_buffered(sig, pt.SpatialOptions(position=pos), max_distance=MAXD,
                                   rate=RATE, buffer_duration=BUFD)
        return ctl, self.inp.play(0, kind, pos, np.zeros(3, F), snd, speed=spd)

    def set_speed(self, block, ctl, life, spd):
        def go():
            ctl.set_speed(float(spd))
            self.inp.set_speed(block, life, F(spd))
        self.events.setdefault(block, []).append(go)

    def fade(self, block, ctl, life, snd, spd, seconds):
        def go():
            ctl.fade_to(self.speed(snd, spd)[1], seconds)
            self.inp.fade(block, life, snd, F(spd), seconds)
        self.events.setdefault(block, []).append(go)

    def run(self, blocks, per=2):
        out = []
        for b in range(0, blocks, per):
            for k in range(b, b + per):
                for go in self.events.get(k, ()):
                    if k != b:
                        raise ValueError("calls land at a call's first block")
                    go()
            for x in self.renderer.render_frames_device(per * BLOCK, sync=False):
                out.append(x.reshape(x.shape[0], 2, -1, BLOCK).permute(0, 2, 1, 3)
                           .reshape(-1, 2, BLOCK))
        return torch.cat(out).double()


def test_port_matches_reference_on_short_writes():
    """A Speed and a Fader voice whose ring cursors each write one sample
    short in their first blocks, beside two plain voices; then a speed
    write on the one and a fade on the other, both landing where oddio
    starts the block a sample earlier in the source."""
    rng = np.random.default_rng(9)
    sc = _Script(sounds(rng, 2, (0.5, 0.6)))
    xs = _short_positions(2, 1, 3)
    spd, l_speed = sc.play("speed", (xs[0], 0.0, 0.0), 0, 0.9)
    fad, l_fader = sc.play("fader", (0.0, xs[1], 0.0), 1, 1.1)
    sc.play("frames", (3.0, 1.0, 0.0), 0)
    sc.play("speed", (-6.0, 0.0, 2.0), 1)
    short = sc.inp._short_writes()
    assert short[l_speed] >= 1 and short[l_fader] >= 1
    sc.set_speed(6, spd, l_speed, 1.25)
    sc.fade(6, fad, l_fader, 0, 0.8, 0.02)
    have = sc.run(16)
    assert float(have.abs().max()) > 1e-3
    assert _err(have, sc.inp, 16) <= TOL
    assert _err(have, _whole_blocks(sc.inp), 16) > 10 * TOL


def test_port_matches_reference_on_a_short_write_inside_a_fade():
    """A Fader voice whose ring cursor writes one sample short while a fade
    of exactly five blocks runs: that fade completes a block later than
    512-sample blocks would finish it, and the fade queued behind it
    starts a block later, on the port's host mirrors as on the device."""
    rng = np.random.default_rng(4)
    sc = _Script(sounds(rng, 2, (0.5, 0.6)))
    (x,) = _short_positions(1, 5, 8)
    fad, life = sc.play("fader", (x, 0.0, 0.0), 0, 1.0)
    sc.play("frames", (2.0, -1.0, 0.5), 1)
    # inc a hair over 1/2560: 2560 samples reach 1, 2559 do not
    sc.fade(2, fad, life, 1, 0.9, (5 * BLOCK - 0.5) / RATE)
    sc.fade(4, fad, life, 0, 1.2, 0.01)
    have = sc.run(16)
    assert float(have.abs().max()) > 1e-3
    assert _err(have, sc.inp, 16) <= TOL
    assert _err(have, _whole_blocks(sc.inp), 16) > 10 * TOL
