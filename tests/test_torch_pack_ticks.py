"""The ScenePack's stream-cursor tick replay (``ops/stream.py``
``TickGroup``): the pack's O(1) idle runs leave every scene's Stream leaf
of a pool the same deferred ticks, and the first mirror read of any of
them (a write, ``free()``, a handle's set, a checkpoint, a prepare)
replays every leaf that owes the same in one pass a tick over their
stacked mirrors.  Held bit for bit against each leaf's own replay (the
pack built with no tick groups): every leaf's mirrors and every stream's
``free()`` over random debts, and a config-5 pack's audio on 1 x 1 and
2 x 2 meshes, with the counters that say how often the grouped pass
engages.
"""

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import oddio_tpu_torch as pt
from oddio_tpu_torch.parallel import sharded
from oddio_tpu_torch.parallel.mesh import make_mesh
from oddio_tpu_torch.parallel.sharded import ScenePack
from oddio_tpu_torch.utils import checkpoint as CK
from oddio_tpu_torch.utils import profiler as P

torch.set_num_threads(1)

RATE, BLOCK = 48000, 512
CPU = [ProfilerActivity.CPU]
MIRRORS = ("t", "buflen", "start", "stopping")


@pytest.fixture(autouse=True)
def _fresh():
    P.clear()
    yield
    P.clear()


@pytest.fixture
def ungrouped(monkeypatch):
    """A context in which a pack built forms no tick groups: each leaf
    replays its own debt, as a lone Mixer's does."""

    @contextlib.contextmanager
    def off():
        with monkeypatch.context() as m:
            m.setattr(sharded, "TickGroup", lambda leaves: None)
            yield

    return off


def _mixers(S, streams, sines, seed, size=2528, mw=2400):
    """S config-5 Mixers of ``streams`` Adapt(Stream(8000, size)) and
    ``sines`` Adapt(Sine) voices, capacity ``streams`` a pool; returns
    (mixers, stream controls by scene)."""
    mixers, ctls = [], []
    rng = np.random.default_rng(seed)
    for _ in range(S):
        mixer = pt.Mixer(1, initial_capacity=streams, device="cpu")
        mc = pt.MixerControl(mixer)
        opt = pt.AdaptOptions(tau=0.1, max_gain=4.0)
        cs = []
        for _ in range(streams):
            stream = pt.Stream(8000, size, max_write_per_block=mw)
            cs.append(stream.control)
            mc.play(pt.Adapt(stream, 0.1, opt))
        for _ in range(sines):
            mc.play(pt.Adapt(pt.Sine(rng.uniform(0, 6), rng.uniform(50, 2000)), 0.1, opt))
        mixers.append(mixer)
        ctls.append(cs)
    return mixers, ctls


def _leaves(pack):
    """Each scene's Stream leaf (one stream pool a scene)."""
    return [[leaf for p in s._all_pools() if p.is_dr for leaf in p._ingest_leaves][0]
            for s in pack.scenes]


# -- the replay's math -----------------------------------------------------------


def _block_tick(t, buflen, start, rate, interval, counts, size_pad):
    """One block's mirror tick, the device's release math term for term,
    the ring start moved in int32 each block: what the replays are held
    to."""
    cnt = counts.astype(np.float32)
    nxt = (t + (np.float32(interval) * cnt * rate.astype(np.float32))).astype(np.float32)
    tc = np.minimum(nxt, buflen.astype(np.float32))
    released = np.trunc(tc).astype(np.int32)
    return ((tc - released).astype(np.float32), (buflen - released).astype(np.int32),
            ((start + released) % np.int32(size_pad)).astype(np.int32))


@pytest.mark.parametrize("seed", [0, 2**31 + 3])
def test_replay_is_the_block_tick_repeated(seed):
    """``_replay_ticks`` (the ring start moved once by the drop in the buffered
    length) and ``Stream._tick_math`` bit-equal to the block tick repeated:
    cursors up to 3e7, lengths up to 2**24, rates up to 2e5, steps past a
    whole ring, one voice's and many."""
    from oddio_tpu_torch.ops.stream import _replay_ticks

    rng = np.random.default_rng(seed)
    for N in (1, 4096):
        t = (rng.uniform(0, 1, N) * rng.choice([1, 1e3, 3e7], N)).astype(np.float32)
        buflen = rng.integers(0, 2**24, N).astype(np.int32)
        start = rng.integers(0, 2816, N).astype(np.int32)
        rate = rng.uniform(1, 2e5, N)
        debt = [[float(np.float32(1 / rng.choice([48000, 44100, 8000, 7]))),
                 int(rng.integers(0, 5000)), int(rng.integers(1, 30))] for _ in range(3)]
        want = (t, buflen, start)
        for iv, cnt, times in debt:
            for _ in range(times):
                want = _block_tick(*want, rate, iv, np.broadcast_to(np.int32(cnt), (N,)), 2816)
        got = _replay_ticks(t, buflen, start, rate.astype(np.float32), debt, 2816)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        leaf = pt.Stream(8000, 2528).clone_batched(N)
        leaf.t, leaf.buflen, leaf.start, leaf.rate = t, buflen, start, rate
        counts = rng.integers(0, 5000, N).astype(np.int32)
        leaf._tick_math(debt[0][0], counts)
        want = _block_tick(t, buflen, start, rate, debt[0][0], counts, leaf.size_pad)
        for f, w in zip(("t", "buflen", "start"), want):
            np.testing.assert_array_equal(getattr(leaf, f), w)


# -- random debts --------------------------------------------------------------

S_DEBT = 6
IV48, IV44 = float(np.float32(1 / 48000)), float(np.float32(1 / 44100))


def _randomize(pack, rng, clamp=False):
    """Random mirrors on every leaf: fractional cursors, buffered lengths
    (most of them longer than the debts consume; near zero with ``clamp``:
    the cursors reach them), ring starts, rates, closed and stopping
    streams."""
    for leaf in _leaves(pack):
        V = leaf.batch[0]
        leaf.t = rng.uniform(0, 1, V).astype(np.float32)
        lo, hi = (0, 40) if clamp else (leaf.size // 4, leaf.size)
        leaf.buflen = rng.integers(lo, hi, V).astype(np.int32)
        leaf.start = rng.integers(0, leaf.size_pad, V).astype(np.int32)
        leaf.rate = rng.choice([8000.0, 11025.0, 16000.0, 22050.0], V)
        leaf.closed = rng.random(V) < (0.5 if clamp else 0.2)
        leaf.stopping = rng.random(V) < 0.1


def _debt(rng):
    """A run of 1-3 idle ticks of 128-512 frames: up to ~700 samples of an
    8-22 kHz stream."""
    return (rng.choice([IV48, IV44]), int(rng.choice([512, 480, 128])), int(rng.integers(1, 4)))


def _owe(leaves, debt):
    for leaf in leaves:
        leaf.tick_debt_add(*debt)


def _scenario(case, seed):
    """Builds a pack of S_DEBT scenes, gives its leaves random mirrors and
    debts by ``case``, reads every stream's ``free()`` in a random order;
    returns (each leaf's mirrors, the frees, leaf-ticks replayed, of them
    batched)."""
    rng = np.random.default_rng(seed)
    mixers, ctls = _mixers(S_DEBT, 4, 2, seed)
    pack = ScenePack(mixers, RATE, make_mesh(1, 1, ["cpu"]))
    leaves = _leaves(pack)
    _randomize(pack, rng, clamp=case == "clamped_closed")
    with profile(activities=CPU):
        _owe(leaves, _debt(rng))
        if case == "two_debts":
            # half the scenes owe one more run, one scene another of its own
            _owe(leaves[::2], _debt(rng))
            _owe(leaves[3:4], _debt(rng))
        elif case == "handle_set":
            # a handle's set flushes its leaf (the group, where there is one)
            ctls[2][1].close()
            _owe(leaves, _debt(rng))
        elif case == "pool_grown":
            # scene 1's pool grows: its leaf's debt replays at the old shape
            # and its later debts at the new, apart from the others'
            pack.scenes[1]._all_pools()[0].grow()
            _owe(leaves, _debt(rng))
            assert leaves[1].batch != leaves[0].batch
            pack._equalize()
            _owe(leaves, _debt(rng))
        elif case == "checkpoint":
            snap = CK.snapshot(pack.scenes[4])
            _owe(leaves, _debt(rng))
            CK.restore(pack.scenes[4], snap)  # its leaf's later debt is dropped
            _owe(leaves, _debt(rng))
        order = rng.permutation(S_DEBT)
        frees = [[ctls[s][i].free() for i in range(4)] for s in order]
    assert all(not leaf._tick_debt for leaf in leaves)
    mirrors = [{f: getattr(leaf, f) for f in MIRRORS} for leaf in leaves]
    return mirrors, frees, P.counted("ticks.replayed"), P.counted("ticks.batched")


@pytest.mark.parametrize("case", ["clamped_closed", "two_debts", "handle_set", "pool_grown",
                                  "checkpoint"])
@pytest.mark.parametrize("seed", [7, 2**31 + 11])
def test_grouped_replay_matches_each_leafs_own(case, seed, ungrouped):
    """Every leaf's mirrors (values and dtypes) and every stream's
    ``free()`` equal each leaf's own replay's, over the same leaf-ticks;
    the grouped pass took some of them, the per-leaf one none."""
    got, frees, replayed, batched = _scenario(case, seed)
    P.clear()
    with ungrouped():
        want, want_frees, want_replayed, none = _scenario(case, seed)
    assert none is None and batched
    assert replayed == want_replayed
    assert frees == want_frees
    for a, b in zip(got, want):
        for f in MIRRORS:
            assert a[f].dtype == b[f].dtype
            np.testing.assert_array_equal(a[f], b[f])
    buflen = np.concatenate([m["buflen"][:4] for m in got])  # the played slots
    if case == "clamped_closed":
        # cursors that reached their buffered lengths, streams stopping
        assert (buflen == 0).any() and any(m["stopping"].any() for m in got)
    else:
        assert (buflen > 0).mean() > 0.6  # most cursors short of their lengths


# -- a rendered config-5 pack --------------------------------------------------

S_PACK, STREAMS, SINES, TALKERS, SAMPLES, CALLS = 8, 4, 12, 2, 2048, 6


def _render_pack(shape, seed=3):
    """``pack-offline``'s feed at a small size: 8 scenes, 24-block calls,
    every stream prefilled, then 2 of 4 streams a scene written 2048
    samples before each call, one handing over to a silent one.  Returns
    (the audio (calls, blocks, S, 1, n), every stream's ``free()`` after
    each call (the last scene's first), leaf-ticks replayed, of them
    batched)."""
    mixers, ctls = _mixers(S_PACK, STREAMS, SINES, seed)
    A, B = shape
    pack = ScenePack(mixers, RATE, make_mesh(A, B, ["cpu"] * (A * B)), scan_unroll=8)
    rng = np.random.default_rng(seed)
    talkers = np.stack([rng.choice(STREAMS, TALKERS, replace=False) for _ in range(S_PACK)])
    for s in range(S_PACK):
        for c in ctls[s]:
            assert c.write((rng.standard_normal(2400) * 0.1).astype(np.float32)) == 2400
    out, frees = [], []
    with profile(activities=CPU):
        for call in range(CALLS):
            if call >= 2:
                for s in range(S_PACK):
                    if call > 2:
                        silent = np.setdiff1d(np.arange(STREAMS), talkers[s])
                        talkers[s, rng.integers(TALKERS)] = rng.choice(silent)
                    for v in talkers[s]:
                        x = (rng.standard_normal(SAMPLES) * 0.1).astype(np.float32)
                        assert ctls[s][v].write(x) == SAMPLES
            x = pack.render_frames_device(24 * BLOCK)
            out.append(np.concatenate([np.asarray(b) for b in x]))
            frees.append([c.free() for cs in ctls[::-1] for c in cs])
    return np.stack(out), frees, P.counted("ticks.replayed"), P.counted("ticks.batched")


@pytest.mark.parametrize("shape", [(1, 1), (2, 2)])
def test_pack_audio_matches_per_leaf_replay(shape, ungrouped):
    """Six 24-block calls of the pack bit-equal with and without the
    tick groups, and every stream's ``free()`` after each; every
    leaf-tick replayed in a group pass in the pack."""
    got, frees, replayed, batched = _render_pack(shape)
    P.clear()
    with ungrouped():
        want, want_frees, want_replayed, none = _render_pack(shape)
    assert np.abs(got).max() > 1e-2
    np.testing.assert_array_equal(got, want)
    assert frees == want_frees
    assert replayed == want_replayed > 0
    assert batched / replayed == 1.0 and none is None


def test_lone_renderer_mixer_replays_per_leaf():
    """A Mixer under a Renderer is a group of none: its leaf replays its
    own debt, ``ticks.batched`` stays 0."""
    (mixer,), (ctls,) = _mixers(1, STREAMS, SINES, 5)
    r = pt.Renderer(mixer, RATE)
    rng = np.random.default_rng(5)
    with profile(activities=CPU):
        for _ in range(3):
            for c in ctls[:TALKERS]:
                c.write((rng.standard_normal(SAMPLES) * 0.1).astype(np.float32))
            r.render_frames(24 * BLOCK)
    assert P.counted("ticks.replayed") > 0
    assert (P.counted("ticks.batched") or 0) == 0
