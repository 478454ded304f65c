"""K6's arena form as whole steps (``stream_kernels.arena_step``,
``arena_warp``, ``fader_step``): each mode's plain version against the
torch chains it replaces, kept here verbatim as the reference (the
device-resident FramesSignal, Cycle, Speed and Fader renders and the seek
pool's warped reads of the port before the whole-step kernel), bit for bit;
the Fader's fused two-bank route against two bank renders and the torch
crossfade; the routes in scenes against the JAX package.

Cases, at small sizes (``test_torch_cuda.py`` runs them at the paths'
widths on the card): mono and stereo FramesSignal, Cycle, seek reads with E = 2, the
Fader with fading, done, flipped and idle voices mixed; n = 512, 513, 128
and 100; a static interval (the slot rows' split) and a per-voice one with
speeds across the step tiers 1, 2 and 4; negative fractions, cursors
before and past a region, ``count < n`` and ``count = 0``; the bank a
fader keeps at the ``dr_state_init`` row.

Scenes (tolerances as tests/test_torch_frames.py and test_torch_fader.py
state them): a Fader(Speed(FramesSignal)) sampler and a Speed(Cycle)
wavetable in device-resident mixers within 1e-5 of the JAX package (the
sampler's rates and speeds make every step dyadic, so the JAX package's
f32 cursor does not drift, ROADMAP Q3.5), a 2 s sampler render within
1e-5 of the exact oracle, and a seek pool's sampler voices within 5e-5 of
the JAX package.  The CUDA kernel is held to the plain versions in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import oddio_tpu as ot  # noqa: E402
import oddio_tpu_torch as pt  # noqa: E402
import reference_impl as ref  # noqa: E402
from oddio_tpu_torch.core import frames as PF  # noqa: E402
from oddio_tpu_torch.core.hostmath import EPS32  # noqa: E402
from oddio_tpu_torch.ops import stream_kernels as SK  # noqa: E402
from oddio_tpu_torch.ops._dev import (  # noqa: E402
    chunked_frames, device_advance, device_split_ds, split_ds, top12, warp_shift,
)
from oddio_tpu_torch.utils import kernel_bench as KB  # noqa: E402

torch.set_num_threads(1)

F = np.float32
V = 24
L1, LS, LT = 5000, 3300, 700  # mono sound, stereo sound, looped table
IV = float(F(1.0 / 48000.0))
RATE = 44100.0


# --- the chains before the whole-step kernel, verbatim -----------------------------


def _split_t(t, rate):
    s0 = t * rate.to(torch.float64)
    b = torch.trunc(s0)
    return torch.clamp(b, -(2**30), 2**30).to(torch.int32), (s0 - b).to(torch.float32)


def _floor_advance(cur, n_c, ds_int, f_hi, f_lo):
    b, o = cur
    neg = o < 0
    return device_advance(
        b - neg.to(torch.int32), torch.where(neg, o + 1.0, o), n_c, ds_int, f_hi, f_lo,
    )


def _frames_dr_step(state, interval):
    if not isinstance(interval, torch.Tensor):
        return state["ds_int"], state["f_hi"], state["f_lo"]
    ds = state["rate"] * interval
    ds = torch.where(torch.abs(ds - 1.0) <= float(EPS32), 1.0, ds)
    return device_split_ds(ds)


def _frames_at_t(state, t):
    out = dict(state)
    out["t"] = t
    out["base"], out["frac"] = _split_t(t, state["rate"])
    return out


def frames_dr_render(C, state, ddata, interval, n, count):
    ds_int, f_hi, f_lo = _frames_dr_step(state, interval)
    if C == 1:
        goff, length = state["goff"], state["length"]

        def rep(x):
            return x
    else:
        stride = (2 * PF.ARENA_GUARD + state["length"]
                  + torch.remainder(-state["length"], PF.ARENA_ROW))
        goff = (state["goff"][:, None]
                + torch.arange(C, dtype=torch.int32, device=stride.device)
                * stride[:, None]).reshape(-1)

        def rep(x):
            return x.repeat_interleave(C)

        length = rep(state["length"])
    lo = goff - PF.ARENA_GUARD
    hi = goff + length
    dsf = (rep(ds_int), rep(f_hi), rep(f_lo))

    def ev(cur, n_c):
        b, o = cur
        out = SK.arena_resample(ddata["garena"], goff + rep(b), lo, hi, rep(o), *dsf, n_c)
        return out if C == 1 else out.reshape(-1, C, n_c)

    def adv(cur, n_c):
        return _floor_advance(cur, n_c, ds_int, f_hi, f_lo)

    samples = chunked_frames(ev, adv, (state["base"], state["frac"]), n)
    if isinstance(interval, torch.Tensor):
        iv = interval.to(torch.float64)
    else:
        iv = float(np.float32(interval))
    return _frames_at_t(state, state["t"] + iv * count.to(torch.float64)), samples


def frames_dr_warp_render(state, ddata, t0, dt, n):
    V, E = t0.shape
    base2, o0 = _split_t(state["t"][:, None] + t0.to(torch.float64), state["rate"][:, None])
    ds = dt * state["rate"][:, None]
    ds = torch.where(torch.abs(ds - 1.0) <= float(EPS32), 1.0, ds)
    ds_int, f_hi, f_lo = device_split_ds(ds)
    dsf = (ds_int.reshape(-1), f_hi.reshape(-1), f_lo.reshape(-1))
    goff = state["goff"].repeat_interleave(E)
    lo = goff - PF.ARENA_GUARD
    hi = goff + state["length"].repeat_interleave(E)

    def ev(cur, n_c):
        b, o = cur
        return SK.arena_resample(ddata["garena"], goff + b, lo, hi, o, *dsf, n_c)

    def adv(cur, n_c):
        return _floor_advance(cur, n_c, *dsf)

    samples = chunked_frames(ev, adv, (base2.reshape(-1), o0.reshape(-1)), n)
    return samples.reshape(V, E, n)


def _cycle_dr_step(state, interval):
    if not isinstance(interval, torch.Tensor):
        return state["ds_int"], state["f_hi"], state["f_lo"]
    return device_split_ds(state["rate"] * interval)


def cycle_dr_render(state, ddata, interval, n, count):
    ds_int, f_hi, f_lo = _cycle_dr_step(state, interval)
    lo = state["loff"] - 1
    hi = state["loff"] + state["length"] - 1

    def ev(cur, n_c):
        b, o = cur
        return SK.arena_resample(ddata["garena"], state["loff"] + b, lo, hi, o,
                                 ds_int, f_hi, f_lo, n_c)

    def adv(cur, n_c):
        b, o = cur
        b2, o2 = device_advance(b, o, n_c, ds_int, f_hi, f_lo)
        return torch.remainder(b2, state["length"]), o2

    samples = chunked_frames(ev, adv, (state["base"], state["frac"]), n)
    cm1 = torch.clamp_min(count - 1, 0)
    b1, f1 = device_advance(state["base"], state["frac"], cm1, ds_int, f_hi, f_lo)
    b1 = torch.remainder(b1, state["length"])
    b2, f2 = device_advance(b1, f1, torch.ones_like(count), ds_int, f_hi, f_lo)
    keep = count <= 0
    out = dict(state)
    out["base"] = torch.where(keep, state["base"], b2)
    out["frac"] = torch.where(keep, state["frac"], f2)
    return out, samples


def _cycle_dr_warp_cursor(state, t0):
    si, sf = warp_shift(state["rate"], state["r_hi"], t0)
    u = state["frac"][:, None] + sf
    uf = torch.floor(u)
    base2 = state["base"][:, None] + si + uf.to(torch.int32)
    return torch.remainder(base2, state["length"][:, None]), u - uf


def cycle_dr_warp_render(state, ddata, t0, dt, n):
    V, E = t0.shape
    base2, o0 = _cycle_dr_warp_cursor(state, t0)
    ds_int, f_hi, f_lo = device_split_ds(dt * state["rate"][:, None])
    dsf = (ds_int.reshape(-1), f_hi.reshape(-1), f_lo.reshape(-1))
    loff = state["loff"].repeat_interleave(E)
    length = state["length"].repeat_interleave(E)
    lo = loff - 1
    hi = loff + length - 1

    def ev(cur, n_c):
        b, o = cur
        return SK.arena_resample(ddata["garena"], loff + b, lo, hi, o, *dsf, n_c)

    def adv(cur, n_c):
        b, o = cur
        b2, o2 = device_advance(b, o, n_c, *dsf)
        return torch.remainder(b2, length), o2

    samples = chunked_frames(ev, adv, (base2.reshape(-1), o0.reshape(-1)), n)
    return samples.reshape(V, E, n)


def speed_dr_render(inner, state, ddata, interval, n, count):
    if isinstance(interval, torch.Tensor):
        warped = interval * state["speed"]
    else:
        warped = state["speed"] * float(np.float32(interval))
    d2, samples = inner(state["inner"], ddata.get("inner", {}), warped, n, count)
    return {"speed": state["speed"], "inner": d2}, samples


def _ramp(progress0, inc, n):
    j = torch.arange(n, dtype=torch.float32, device=progress0.device)
    return torch.clamp_max(progress0[:, None] + j * inc[:, None], 1.0)


def _voice_mask(m, like):
    return m.reshape(m.shape + (1,) * (like.dim() - 1))


def fader_dr_render(inner, state, ddata, interval, n, count):
    done = state["fading"] & (state["prog"] >= 1.0)
    flip = torch.logical_xor(state["flip"], done)
    fading = state["fading"] & ~done
    dda = ddata.get("a", {})
    a2, sa = inner(state["a"], dda, interval, n, count)
    b2, sb = inner(state["b"], dda, interval, n, count)
    fl = _voice_mask(flip, sa)
    old = torch.where(fl, sb, sa)
    new = torch.where(fl, sa, sb)
    p = _ramp(state["prog"], state["inc"], n)
    if sa.dim() == 3:
        p = p[:, None, :]
    f2 = _voice_mask(fading, sa)
    wa = torch.where(f2, torch.sqrt(1.0 - p), 1.0)
    wb = torch.where(f2, torch.sqrt(p), 0.0)
    prog2 = torch.clamp_max(state["prog"] + count.to(torch.float32) * state["inc"], 1.0)
    out_state = {
        "prog": prog2, "inc": state["inc"], "fading": fading,
        "flip": flip, "a": a2, "b": b2,
    }
    return out_state, old * wa + new * wb


# --- operands -------------------------------------------------------------------------


def _arena(rng):
    """A guarded arena laid out as core/frames.py lays it: a mono sound, a
    two-channel sound (one guarded region per channel), a looped table."""
    A = PF._Arena(1)
    g1 = A.add_guarded((rng.standard_normal(L1) * 0.5).astype(F))
    st = (rng.standard_normal((LS, 2)) * 0.5).astype(F)
    g2 = A.add_guarded(np.ascontiguousarray(st[:, 0]))
    A.add_guarded(np.ascontiguousarray(st[:, 1]))
    loff, _ = A.add_looped((rng.standard_normal(LT) * 0.5).astype(F))
    garena = torch.tensor(np.concatenate(A._gchunks).reshape(-1, PF.ARENA_ROW))
    return garena, g1, g2, loff


TIERS = {1: (0.3, 1.05), 2: (1.1, 2.1), 4: (2.2, 4.3)}


def _speeds(rng, tier):
    s = rng.uniform(*TIERS[tier], V).astype(F)
    s[0] = F(48000.0 / RATE)  # a unit step: FramesSignal's snap
    return torch.tensor(s)


def _split_cols(ds):
    di, fh, fl = split_ds(ds)
    return {"ds_int": torch.tensor(di), "f_hi": torch.tensor(fh), "f_lo": torch.tensor(fl)}


def frames_state(rng, arena, C):
    """FramesSignal leaf rows: cursors inside, before and past the sound,
    far outside it (the clamp) and negative fractions; two voices at the
    ``dr_state_init`` row; the static split of the pool's interval."""
    _, g1, g2, _ = arena
    goff, length = (g1, L1) if C == 1 else (g2, LS)
    rate = np.full(V, F(RATE))
    t = rng.uniform(-0.05, length / RATE + 0.05, V)
    t[:3] = (-30.0, length / RATE + 40.0, -1e-4)
    go = np.full(V, goff, np.int32)
    ln = np.full(V, length, np.int32)
    go[-2:], ln[-2:], rate[-2:], t[-2:] = PF.ARENA_GUARD, 1, F(1.0), 0.0
    ds = (F(IV) * rate).astype(F)
    ds = np.where(np.abs(ds - F(1.0)) <= EPS32, F(1.0), ds)
    st = {"t": torch.tensor(t), "goff": torch.tensor(go), "length": torch.tensor(ln),
          "rate": torch.tensor(rate), "r_hi": torch.tensor(top12(rate)),
          "off": torch.zeros(V, dtype=torch.int32), **_split_cols(ds)}
    st["base"], st["frac"] = _split_t(st["t"], st["rate"])
    return st


def cycle_state(rng, arena):
    """Cycle leaf rows on the looped table (cursors anywhere in it)."""
    loff = arena[3]
    rate = np.full(V, F(RATE))
    rate[:4] = F(48000.0)
    st = {"base": torch.tensor(rng.integers(0, LT, V).astype(np.int32)),
          "frac": torch.tensor(rng.uniform(0.0, 0.999, V).astype(F)),
          "off": torch.zeros(V, dtype=torch.int32),
          "loff": torch.full((V,), loff, dtype=torch.int32),
          "length": torch.full((V,), LT, dtype=torch.int32),
          "rate": torch.tensor(rate), "r_hi": torch.tensor(top12(rate)),
          **_split_cols((F(IV) * rate).astype(F))}
    return st


def _count(rng, n):
    c = np.full(V, n, np.int32)
    c[1::5] = rng.integers(1, n, c[1::5].shape)  # count < n (a buffered pool's n_write)
    c[3::7] = 0
    return torch.tensor(c)


def _interval(rng, mode, tier):
    """The interval the leaf sees: the pool's host number, or a Speed chain's
    per-voice (V,) column."""
    return IV if mode == "static" else torch.tensor(F(IV)) * _speeds(rng, tier)


def _assert_trees_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k])
        else:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


MODES = [("static", 1), ("voice", 1), ("voice", 2), ("voice", 4)]


# --- each mode's plain version against its chain ------------------------------------


@pytest.mark.parametrize("mode,tier", MODES)
@pytest.mark.parametrize("n", [512, 513, 128, 100])
@pytest.mark.parametrize("kind,C", [("frames", 1), ("frames", 2), ("cycle", 1)])
def test_arena_step_plain_equals_the_leaf_chain(kind, C, n, mode, tier):
    rng = np.random.default_rng(n + 10 * C + 100 * tier + (kind == "cycle"))
    arena = _arena(rng)
    st = frames_state(rng, arena, C) if kind == "frames" else cycle_state(rng, arena)
    iv, count = _interval(rng, mode, tier), _count(rng, n)
    dd = {"garena": arena[0]}
    got_st, got = SK.arena_step(arena[0], kind, st, iv, n, count, channels=C)
    if kind == "frames":
        ref_st, want = frames_dr_render(C, st, dd, iv, n, count)
    else:
        ref_st, want = cycle_dr_render(st, dd, iv, n, count)
    assert torch.equal(got, want) and got.shape == ((V, n) if C == 1 else (V, C, n))
    _assert_trees_equal(got_st, ref_st)
    assert float(got.abs().max()) > 0.1
    assert SK.LAUNCHES["arena_step"] == 0  # the plain version launches nothing


@pytest.mark.parametrize("tier", [1, 2, 4])
@pytest.mark.parametrize("n", [512, 513, 100])
@pytest.mark.parametrize("kind", ["frames", "cycle"])
def test_speed_chain_step_plain_equals_speed_over_the_leaf(kind, n, tier):
    """A Speed's factor multiplied in the step (``speed=``), one and two
    Speeds deep, against Speed.dr_render over the leaf's chain."""
    rng = np.random.default_rng(7 * n + tier)
    arena = _arena(rng)
    st = frames_state(rng, arena, 1) if kind == "frames" else cycle_state(rng, arena)
    leaf = ((lambda *a: frames_dr_render(1, *a)) if kind == "frames" else cycle_dr_render)
    dd = {"garena": arena[0]}
    count = _count(rng, n)
    s1, s2 = _speeds(rng, tier), torch.tensor(rng.uniform(0.9, 1.1, V).astype(F))
    one = {"speed": s1, "inner": st}
    ref_st, want = speed_dr_render(leaf, one, {"inner": dd}, IV, n, count)
    got_st, got = SK.arena_step(arena[0], kind, st, IV, n, count, speed=s1)
    assert torch.equal(got, want)
    _assert_trees_equal(got_st, ref_st["inner"])
    two = {"speed": s2, "inner": one}
    ref_st, want = speed_dr_render(lambda *a: speed_dr_render(leaf, *a), two,
                                   {"inner": {"inner": dd}}, IV, n, count)
    got_st, got = SK.arena_step(arena[0], kind, st, SK.warped_interval(IV, s2), n, count,
                                speed=s1)
    assert torch.equal(got, want)
    _assert_trees_equal(got_st, ref_st["inner"]["inner"])


@pytest.mark.parametrize("n", [512, 513, 128, 100])
@pytest.mark.parametrize("kind", ["frames", "cycle"])
def test_arena_warp_plain_equals_the_seek_chain(kind, n):
    """The seek pool's warped read, E = 2 ears a voice, doppler-warped steps
    near the unit step (FramesSignal's snap on some) and far from it."""
    rng = np.random.default_rng(31 * n + (kind == "cycle"))
    arena = _arena(rng)
    st = frames_state(rng, arena, 1) if kind == "frames" else cycle_state(rng, arena)
    t0 = torch.tensor(rng.uniform(-0.06, 0.002, (V, 2)).astype(F))
    dt = torch.tensor((F(IV) * rng.uniform(0.8, 1.25, (V, 2))).astype(F))
    dt[0] = float(F(1.0 / RATE))  # a unit step
    dd = {"garena": arena[0]}
    got = SK.arena_warp(arena[0], kind, st, t0, dt, n)
    want = (frames_dr_warp_render if kind == "frames" else cycle_dr_warp_render)(
        st, dd, t0, dt, n)
    assert got.shape == (V, 2, n) and torch.equal(got, want)
    assert float(got.abs().max()) > 0.1


def _fader_state(rng, n):
    """The Fader's own columns with fading, done (prog 1), flipped and idle
    voices mixed."""
    fading = rng.random(V) < 0.5
    prog = rng.uniform(0.0, 1.0, V).astype(F)
    prog[::4] = 1.0  # done at block start where fading
    prog[1::6] = 0.0  # a fade that starts now
    inc = np.where(fading, F(IV) / rng.uniform(IV, 0.02, V).astype(F), 0.0).astype(F)
    inc[2] = F(1.0)  # a duration of one interval
    return {"prog": torch.tensor(prog), "inc": torch.tensor(inc),
            "fading": torch.tensor(fading), "flip": torch.tensor(rng.random(V) < 0.5)}


def _bank_b(st, rng):
    """The second bank: other cursors on the same sound, and the
    ``dr_state_init`` row for a few voices (their fade never started)."""
    b = {k: v.clone() for k, v in st.items()}
    if "t" in b:
        b["t"] = b["t"] + torch.tensor(rng.uniform(-0.02, 0.02, V))
        b["base"], b["frac"] = _split_t(b["t"], b["rate"])
        for k, v in (("goff", PF.ARENA_GUARD), ("length", 1), ("rate", 1.0), ("t", 0.0)):
            b[k][4:7] = v
        b["base"], b["frac"] = _split_t(b["t"], b["rate"])
    else:
        b["base"] = torch.remainder(b["base"] + 37, b["length"])
    return b


@pytest.mark.parametrize("mode,tier", MODES)
@pytest.mark.parametrize("n", [512, 513, 128, 100])
@pytest.mark.parametrize("kind,C", [("frames", 1), ("frames", 2), ("cycle", 1)])
def test_fader_step_plain_equals_the_fader_chain(kind, C, n, mode, tier):
    """Both banks (each its own speeds) and the crossfade against the
    Fader's render of two Speed chains."""
    rng = np.random.default_rng(3 * n + 17 * C + tier + 1000 * (kind == "cycle"))
    arena = _arena(rng)
    st = frames_state(rng, arena, C) if kind == "frames" else cycle_state(rng, arena)
    banks = (st, _bank_b(st, rng))
    fs = _fader_state(rng, n)
    count = _count(rng, n)
    dd = {"garena": arena[0]}
    leaf = ((lambda *a: frames_dr_render(C, *a)) if kind == "frames" else cycle_dr_render)
    if mode == "static":
        state = dict(fs, a=banks[0], b=banks[1])
        ref_st, want = fader_dr_render(leaf, state, {"a": dd}, IV, n, count)
        core, a2, b2, got = SK.fader_step(arena[0], kind, fs, banks, (IV, IV), n, count,
                                          channels=C)
        refs = (ref_st["a"], ref_st["b"])
    else:
        sp = (_speeds(rng, tier), _speeds(rng, tier))
        state = dict(fs, a={"speed": sp[0], "inner": banks[0]},
                     b={"speed": sp[1], "inner": banks[1]})
        ref_st, want = fader_dr_render(lambda *a: speed_dr_render(leaf, *a), state,
                                       {"a": {"inner": dd}}, IV, n, count)
        core, a2, b2, got = SK.fader_step(arena[0], kind, fs, banks, (IV, IV), n, count,
                                          channels=C, speeds=sp)
        refs = (ref_st["a"]["inner"], ref_st["b"]["inner"])
    assert torch.equal(got, want)
    _assert_trees_equal(a2, refs[0])
    _assert_trees_equal(b2, refs[1])
    _assert_trees_equal(core, {k: ref_st[k] for k in ("prog", "inc", "fading", "flip")})
    assert bool(core["fading"].any()) and bool((~core["fading"]).any())


# --- the routes ------------------------------------------------------------------------


def _capture_pool(build, blocks, n=512):
    """A device-resident mixer pool's proto and the (state, ddata, interval,
    n, count) of each block's render."""
    mixer, script = build()
    pools = KB.dr_pools(mixer)
    assert len(pools) == 1 and pools[0].is_dr
    r = pt.Renderer(mixer, 48000)

    def run():
        for b in range(blocks):
            script(b)
            r.render_block(n)

    return pools[0].proto, KB.capture_steps(pools, run)[pools[0]]


def _sampler_mixer(m, voices, seed, kind="frames", channels=2, fades=True):
    """``voices`` Fader(Speed(FramesSignal)) (or Fader(Speed(Cycle))) voices
    over 16384 Hz sounds at dyadic speeds (rendered at 32768 Hz, every step
    is exact in f32), and a script of fades and speed writes."""
    rng = np.random.default_rng(seed)
    if kind == "frames":
        snd = [(rng.standard_normal((6000, channels) if channels > 1 else 6000) * 0.3)
               .astype(F) for _ in range(2)]
    else:
        snd = [np.sin(np.arange(512) * 2 * np.pi / 512 * (k + 1)).astype(F) for k in range(2)]
    frames = [m.Frames.from_slice(16384, s) for s in snd]
    mc, mixer = m.Mixer.new(channels=channels, **({"device": "cpu"} if m is pt else {}))
    speeds = (0.75, 1.0, 1.25, 1.5, 2.0, 3.0, 5.0)

    def voice(i):
        src = (m.FramesSignal(frames[i % 2], float(rng.uniform(-0.01, 0.1)))
               if kind == "frames" else m.Cycle(frames[i % 2]))
        sc, sp = m.Speed.new(src)
        sc.set_speed(speeds[i % len(speeds)])
        return sc, sp

    fcs, scs = [], []
    for i in range(voices):
        sc, sp = voice(i)
        fc, f = m.Fader.new(sp)
        mc.play(f)
        fcs.append(fc)
        scs.append(sc)

    def script(b):
        if fades and b % 3 == 1:
            for j in range(b % 2, voices, 3):
                fcs[j].fade_to(voice(j + b)[1], 0.01 * (1 + j % 2))
        if b % 4 == 2:
            scs[b % voices].set_speed(speeds[(b + 3) % len(speeds)])

    return mixer, script


def test_fader_fused_route_equals_two_bank_renders_and_the_crossfade():
    """The Fader's one-launch route on captured pool states (fades starting,
    running, completing; speed writes) against its two banks' own renders
    and the torch crossfade, and against the Fader's render before the
    fused route."""
    proto, calls = _capture_pool(lambda: _sampler_mixer(pt, 12, 3), 12)
    assert type(proto).__name__ == "Fader"
    fading = 0
    for state, ddata, interval, n, count in calls:
        got_st, got = proto.dr_render(state, ddata, interval, n, count)
        dda = ddata["a"]
        a2, sa = proto.a.dr_render(state["a"], dda, interval, n, count)
        b2, sb = proto.a.dr_render(state["b"], dda, interval, n, count)
        core, want = SK.fade_mix_plain(state, sa, sb, n, count)
        assert torch.equal(got, want)
        _assert_trees_equal(got_st, dict(core, a=a2, b=b2))

        def leaf(*a):
            return frames_dr_render(2, *a)

        ref_st, ref = fader_dr_render(lambda *a: speed_dr_render(leaf, *a), state, ddata,
                                      interval, n, count)
        assert torch.equal(got, ref)
        _assert_trees_equal(got_st, ref_st)
        fading += int(state["fading"].sum())
    assert fading > 0


def test_fader_route_is_chosen_from_the_archetype(monkeypatch):
    """Speeds over a FramesSignal or a Cycle take the fused launch; any other
    inner (Gain(Sine)), or a pool past the step bound (the exact gather),
    keeps the two bank renders."""
    calls = []
    fused = SK.fader_step
    monkeypatch.setattr(SK, "fader_step", lambda *a, **k: calls.append(1) or fused(*a, **k))
    for kind, channels in (("frames", 2), ("cycle", 1)):
        mixer, script = _sampler_mixer(pt, 4, 5, kind=kind, channels=channels)
        r = pt.Renderer(mixer, 48000)
        for b in range(4):
            script(b)
            r.render_block(256)
        assert len(calls) == 4
        calls.clear()
    mc, mixer = pt.Mixer.new(channels=1, device="cpu")
    fc, f = pt.Fader.new(pt.Gain.new(pt.Sine(0.0, 300.0))[1])
    mc.play(f)
    r = pt.Renderer(mixer, 8000)
    r.render_block(256)
    fc.fade_to(pt.Gain.new(pt.Sine(0.0, 500.0))[1], 0.02)
    r.render_frames(1024)
    assert calls == []
    mc, mixer = pt.Mixer.new(channels=1, device="cpu")
    sc, sp = pt.Speed.new(pt.FramesSignal(pt.Frames.from_slice(8000, np.ones(9000, F)), 0.0))
    sc.set_speed(8.0)  # ds = 8 > RESAMPLE_DSMAX
    mc.play(pt.Fader.new(sp)[1])
    r = pt.Renderer(mixer, 8000)
    r.render_frames(512)
    assert calls == [] and next(iter(mixer._pools.values()))._ds_small is False


# --- scenes against the JAX package and the oracle --------------------------------------


def test_sampler_fader_scene_matches_jax():
    """A stereo Fader(Speed(FramesSignal)) mixer through fades and speed
    writes (the fused route) within 1e-5 of the JAX package."""
    outs = []
    for m in (pt, ot):
        mixer, script = _sampler_mixer(m, 10, 8)
        r = m.Renderer(mixer, 32768)
        chunks = []
        for b in range(14):
            script(b)
            chunks.append(r.render_frames(512 if b % 2 else 513, block_size=512))
        outs.append(np.concatenate(chunks))
    assert np.abs(outs[0]).max() > 0.1
    assert np.abs(outs[0] - outs[1]).max() <= 1e-5


def test_wavetable_scene_matches_jax():
    """Speed(Cycle) voices (one launch a step) and Fader(Speed(Cycle))
    voices within 1e-5 of the JAX package."""
    outs = []
    for m in (pt, ot):
        rng = np.random.default_rng(4)
        tab = np.sin(np.arange(2048) * 2 * np.pi / 2048).astype(F)
        mc, mixer = m.Mixer.new(channels=1, **({"device": "cpu"} if m is pt else {}))
        scs = []
        for i in range(8):
            c = m.Cycle(m.Frames.from_slice(48000, tab))
            c.seek(float(rng.uniform(0, 0.04)))
            sc, sp = m.Speed.new(c)
            sc.set_speed((0.5, 1.0, 1.5, 2.0)[i % 4])
            scs.append(sc)
            mc.play(sp)
        fmix, script = _sampler_mixer(m, 4, 9, kind="cycle", channels=1)
        mc.play(fmix)
        r = m.Renderer(mixer, 48000)
        a = r.render_frames(512 * 6)
        for sc in scs[::2]:
            sc.set_speed(1.25)
        for b in range(6):
            script(b)
        outs.append(np.concatenate([a, r.render_frames(513 * 6, block_size=513)]))
    assert np.abs(outs[0]).max() > 0.5
    assert np.abs(outs[0] - outs[1]).max() <= 1e-5


def test_sampler_chain_two_seconds_against_oracle():
    """188 blocks (2 s) of Speed(FramesSignal) voices on the one-launch
    step: the f64 cursor released in the step stays within 1e-5 of the
    exact oracle to the end (a one-ulp slip in the release would grow)."""
    rng = np.random.default_rng(12)
    data = (np.sin(np.arange(200000) * 0.0123) * 0.5).astype(F)
    speeds = rng.uniform(0.8, 1.25, 6)
    starts = rng.uniform(-0.01, 0.2, 6)
    mc, mixer = pt.Mixer.new(channels=1, device="cpu")
    om = ref.OMixer(channels=1)
    frames, oframes = pt.Frames.from_slice(44100, data), ref.OFrames(44100, data)
    for s, t in zip(speeds, starts):
        sc, sp = pt.Speed.new(pt.FramesSignal(frames, float(t)))
        sc.set_speed(float(s))
        mc.play(sp)
        om.play(ref.OSpeed(ref.OFramesSignal(oframes, float(t), exact=True), F(s)))
    r = pt.Renderer(mixer, 48000)
    got = r.render_frames(512 * 188)
    want = []
    for _ in range(188):
        buf = np.zeros(512, F)
        ref.oddio_run(om, 48000, buf)
        want.append(buf)
    want = np.concatenate(want)
    assert np.abs(got[:, 0]).max() > 0.5
    err = np.abs(got[:, 0] - want)
    assert err.max() <= 1e-5 and err[-512:].max() <= 1e-5


def test_seek_pool_sampler_voices_match_jax():
    """FramesSignal and Cycle voices in a seek pool (the warped read, E = 2
    ears, one launch a block) within the seek tests' 5e-5 of the JAX
    package."""
    outs = []
    for m in (pt, ot):
        rng = np.random.default_rng(21)
        snd = m.Frames.from_slice(24000, (np.sin(np.linspace(0, 900, 20000)) * 0.6).astype(F))
        tbl = m.Frames.from_slice(24000, rng.standard_normal(500).astype(F))
        control, scene = m.SpatialScene.new(**({"device": "cpu"} if m is pt else {}))
        hs = []
        for i in range(6):
            sig = m.FramesSignal(snd, -0.01 * i) if i % 2 else m.Cycle(tbl)
            hs.append(control.play(sig, m.SpatialOptions(
                position=rng.uniform(-4, 4, 3), velocity=rng.uniform(-5, 5, 3))))
        r = m.Renderer(scene, 48000)
        a = r.render_frames(512 * 4)
        for h in hs[::2]:
            h.set_motion(rng.uniform(-4, 4, 3), rng.uniform(-5, 5, 3), False)
        outs.append(np.concatenate([a, r.render_frames(512 * 4)]))
        if m is pt:
            assert all(p.is_dr for p in scene._seek_pools.values())
    assert np.abs(outs[0]).max() > 0.05
    assert np.abs(outs[0] - outs[1]).max() < 5e-5


# --- operand checks ---------------------------------------------------------------------


def test_arena_step_rejects_bad_operands():
    rng = np.random.default_rng(0)
    arena = _arena(rng)
    st = frames_state(rng, arena, 1)
    cnt = torch.full((V,), 64, dtype=torch.int32)
    with pytest.raises(ValueError):
        SK.arena_step(arena[0], "sine", st, IV, 64, cnt)
    with pytest.raises(TypeError):
        SK.arena_step(arena[0], "frames", st, IV, 64, cnt.long())
    with pytest.raises(TypeError):
        SK.arena_step(arena[0], "frames", dict(st, t=st["t"].float()), IV, 64, cnt)
    with pytest.raises(ValueError):
        SK.arena_step(arena[0], "frames", st, torch.zeros(V - 1), 64, cnt)
    with pytest.raises(ValueError):
        SK.arena_step(arena[0], "cycle", cycle_state(rng, arena), IV, 64, cnt, channels=2)
    with pytest.raises(ValueError):
        SK.arena_step(arena[0], "frames", st, IV, 0, cnt)
    with pytest.raises(ValueError):
        SK.arena_warp(arena[0], "frames", st, torch.zeros(V, 2), torch.zeros(V, 3), 64)
    with pytest.raises(ValueError):
        SK.fader_step(arena[0], "frames", _fader_state(rng, 64), (st, st),
                      (IV, torch.zeros(V)), 64, cnt)
