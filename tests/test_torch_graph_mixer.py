"""The port's Renderer block step on BASELINE config 5's Mixer, on the CPU,
against the JAX package's Renderer.

A Mixer whose pools are all device-resident with Adapt, Stream and Sine
chains declares ``graph_capture``: its Renderer packs each block's params
into one float32 row (plays, stops, the stream ``closed`` control lane and
each ingest block's ``(V, C, mw+1)`` chunk and counts), keeps one block
step per ``(archetype, kind, pack spec)`` key and runs it through the
static-state protocol.  On a card the step is a CUDA graph; here the same
step runs uncaptured, so these tests hold the code that is captured there:
the row against the JAX package's ``_pack_row`` bit for bit, the audio
against the JAX Renderer within PARITY.md's 1e-5 (the voice sums' order
and a few ulps of the AGC gains, as in test_torch_mixer.py), the step keys
and dispatches against the JAX Renderer's, the step against ``eager()``
bit for bit, a replay emulated on a copy of the mixer frozen at each
step's first call (across an Adapt pool's flip from K7 to the scan), the
state leaves and rings where they were, and the handles' one-scan-late
``is_stopped()``.  Test names avoid the JAX tests' (``conftest.py`` marks
tests slow by name).
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
from oddio_tpu.core import run as jrun  # noqa: E402
from oddio_tpu_torch.core import run as prun  # noqa: E402
from oddio_tpu_torch.utils.scene_profile import build_mixer_agc, feed  # noqa: E402
from oddio_tpu_torch.utils.tree import tree_flatten, tree_leaves, tree_map  # noqa: E402
from test_torch_graph_step import _bits, _host, _offsets, _paths, host_read_guard  # noqa: E402
from test_torch_mixer import _jax_mixer_agc  # noqa: E402

torch.set_num_threads(1)

RATE, BLOCK, TOL = 48000, 512, 1e-5
VOICES = 32


def _build(m, voices=VOICES):
    """The config-5 mixer of ``voices`` voices in package ``m`` (the same
    draws): (control, mixer, stream controls, rng)."""
    return _jax_mixer_agc(voices) if m is ot else build_mixer_agc(voices, "cpu")


def _voice(m, tau=0.1):
    return m.Adapt(m.Sine(0.5, 300.0), 0.1, m.AdaptOptions(tau=tau, max_gain=4.0))


def _scheduled(mixer, actions):
    """Run ``actions[i]()`` just before the mixer's i-th ``host_prepare``
    (a control thread acting between two blocks of one render call)."""
    prepare, count = mixer.host_prepare, [0]

    def host_prepare(*a, **kw):
        act = actions.get(count[0])
        count[0] += 1
        if act is not None:
            act()
        return prepare(*a, **kw)

    mixer.host_prepare = host_prepare
    return count


# -- (a) the packed row --------------------------------------------------------------

ROW_BLOCKS = ("first", "idle", "plays", "stop_close", "ingest")


@functools.lru_cache(maxsize=None)
def _row_params():
    """Each package's params of five blocks rendered one by one: the first
    (the bulk plays, the prefill's ingest), an idle block, a block of two
    plays, a block with a play, a ``Mixed.stop()`` and a stream
    ``close()``, and an ingest block."""
    out = []
    for m in (ot, pt):
        control, mixer, ctls, rng = _build(m)
        r = m.Renderer(mixer, RATE)
        blocks = []
        prepare = mixer.host_prepare

        def spy(*a, _prepare=prepare, _blocks=blocks, **kw):
            _blocks.append(_prepare(*a, **kw))
            return _blocks[-1]

        mixer.host_prepare = spy
        r.render_block(BLOCK)
        r.render_block(BLOCK)
        hs = [control.play(_voice(m)), control.play(_voice(m, 0.2))]
        r.render_block(BLOCK)
        hs[0].stop()
        ctls[1].close()
        control.play(_voice(m, 0.3))
        r.render_block(BLOCK)
        feed(ctls[2:], rng, 700)
        r.render_block(BLOCK)
        out.append(blocks)
    return list(zip(*out))


@pytest.mark.parametrize("block", range(len(ROW_BLOCKS)), ids=ROW_BLOCKS)
def test_mixer_packed_row_matches_jax(block):
    """The port's row holds the JAX package's leaves, and only them, each
    bit for bit; it unpacks to the params."""
    jp, pp = _row_params()[block]
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
    pools = [p for p in pp.values() if p]
    if ROW_BLOCKS[block] == "idle":
        assert len(prow) == 0
    if ROW_BLOCKS[block] in ("first", "ingest"):
        (ing,) = [p["ing"] for p in pools if "ing" in p]
        assert ing["chunk"].shape[1:] == (1, 2401) and ing["wcount"].dtype == np.int32
    if ROW_BLOCKS[block] == "stop_close":  # a real stop lane (padding holds the capacity)
        idx = [np.asarray(p["stop_idx"]) for p in pools if "stop_idx" in p]
        assert sum(int((i < i.max()).sum()) for i in idx) == 1
        assert any("ctrl_idx0" in p for p in pools)


# -- (b), (c) the Renderer against the JAX package ------------------------------------


def script(m, unroll=1, buckets=None):
    """The config-5 mixer through one control script: an idle run, an
    ingest block, plays and a stop and a close, render_block and
    render_frames, and a play and a close issued between two blocks of
    one call.  Returns (audio, renderer, JAX dispatches by kind)."""
    control, mixer, ctls, rng = _build(m)
    r = m.Renderer(mixer, RATE, scan_unroll=unroll, scan_buckets=buckets)
    kinds = {}
    if m is ot:
        get_step = r._get_step

        def spy(kind, *a, **kw):
            k = kind if isinstance(kind, str) else tuple(kind)
            kinds[k] = kinds.get(k, 0) + 1
            return get_step(kind, *a, **kw)

        r._get_step = spy
    out = [r.render_frames(BLOCK * 20)]
    feed(ctls, rng, 700)
    out.append(r.render_frames(BLOCK * 6))
    h = control.play(_voice(m))
    out += [r.render_block(BLOCK) for _ in range(3)]
    h.stop()
    ctls[1].close()
    out.append(r.render_frames(BLOCK * 9))
    feed(ctls[2:], rng, 500)
    # a play and a close between the blocks of one call (a control thread):
    # after the ingest block, a run of two delta blocks, then idle blocks
    count = _scheduled(mixer, {1: lambda: control.play(_voice(m, 0.2)),
                               2: lambda: ctls[3].close()})
    out.append(r.render_frames(BLOCK * 12))
    assert count[0] == 4  # the rest of the call went as one idle run
    return np.concatenate(out), r, kinds


@functools.lru_cache(maxsize=None)
def _pair(unroll, buckets):
    a, rj, kinds = script(ot, unroll, buckets)
    b, rp, _ = script(pt, unroll, buckets)
    return a, b, rj, rp, kinds


@pytest.mark.parametrize("unroll,buckets", [(1, None), (4, None), (1, (12, 3, 1))],
                         ids=["unroll1", "unroll4", "buckets"])
def test_mixer_renderer_matches_jax(unroll, buckets):
    a, b, _, rp, _ = _pair(unroll, buckets)
    assert b.shape == a.shape and b.dtype == np.float32
    assert np.abs(a).max() > 0.1
    assert np.abs(a - b).max() <= TOL, np.abs(a - b).max()
    assert rp.signal.graph_capture and rp._steps
    assert rp.graph_counts["eager"] > 0 and rp.graph_counts["replays"] == 0
    if unroll == 4:  # runs went as calls of 4 blocks and their remainders
        assert any(k == 4 for steps in rp._steps.values() for k, _ in steps)


@pytest.mark.parametrize("buckets", [None, (12, 3, 1)], ids=["runs", "buckets"])
def test_mixer_step_keys_match_jax(buckets):
    """One block step per key the JAX Renderer compiles a program for;
    the dispatches by kind equal the JAX Renderer's (``scan_buckets``
    split runs as the JAX package splits them); an idle run goes as scan
    steps whose params are ``{}``."""
    _, _, rj, rp, kinds = _pair(1, buckets)
    assert len(rp._steps) == len(rj._steps)
    assert sorted(str(k[1]) for k in rp._steps) == sorted(str(k[1]) for k in rj._steps)
    assert rp.dispatch_counts == kinds
    assert any(k[1] == "scan" and k[2][1] == () for k in rp._steps)
    if buckets:
        assert rp.dispatch_counts["scan"] > _pair(1, None)[3].dispatch_counts["scan"]


# -- (d)-(g) the step itself ----------------------------------------------------------


def test_mixer_step_matches_eager_bit_for_bit():
    """The step path (packed rows, device lanes, copy-back) against
    ``eager()`` (numpy params, the state stored as returned): bit for bit
    at unroll 1 and 4 and with buckets, the same dispatches."""
    with prun.eager():
        ref, r0, _ = script(pt)
    assert r0._steps == {} and r0.graph_counts["eager"] > 0
    for unroll, buckets in ((1, None), (4, None), (1, (12, 3, 1))):
        got, r, _ = script(pt, unroll, buckets)
        np.testing.assert_array_equal(got, ref)
        if buckets is None:
            assert r.dispatch_counts == r0.dispatch_counts


def test_mixer_steps_read_no_tensor_on_host():
    """The config-5 mixer's script under ``host_read_guard``: no step reads
    a tensor on the host (plays, stops, closes, ingest blocks, an idle
    run), and the audio equals ``eager()``'s."""
    with host_read_guard() as hits:
        got, r, _ = script(pt, 4)
    assert hits == [] and r._steps and r.graph_counts["eager"] > 0
    with prun.eager():
        want, _, _ = script(pt, 4)
    np.testing.assert_array_equal(got, want)


def _mixer_host(mixer):
    """A comparable picture of the mixer's and its pools' host state (the
    device state and the count-tensor cache left out)."""
    return _host({"mixer": {k: v for k, v in vars(mixer).items() if k != "_pools"},
                  "pools": [{k: v for k, v in vars(p).items() if k not in ("state", "_count_t")}
                            for p in mixer._all_pools()]})


def _tau_flip_script(log):
    """A 16-voice Adapt(Sine) mixer (K7) whose pool flips to the scan when
    a tiny-tau voice is played between two blocks of one call (after a
    play, so that the first block is no idle run); ``log`` gets the
    call's prepare counter and the pool."""
    control, mixer = pt.Mixer.new(channels=1, device="cpu")
    rng = np.random.default_rng(12)
    for _ in range(16):
        control.play(pt.Adapt(pt.Sine(rng.uniform(0, 6), rng.uniform(100, 1000)), 0.1,
                              pt.AdaptOptions(tau=0.1, low=0.1, high=0.4, max_gain=4.0)))
    r = pt.Renderer(mixer, RATE)
    out = [r.render_frames(BLOCK * 4)]
    hs = []
    count = _scheduled(mixer, {
        0: lambda: hs.append(control.play(_voice(pt))),
        1: lambda: hs.append(control.play(_voice(pt, 1e-6))),
        2: lambda: hs[0].stop(),
    })
    pool = next(iter(mixer._pools.values()))
    log.append((count, pool))
    out.append(r.render_frames(BLOCK * 8))
    assert not pool._ema_fast
    return np.concatenate(out), r


def test_mixer_block_step_reads_no_host_state(monkeypatch):
    """A replay emulated: each call of a step also runs on a deep copy of
    the mixer frozen at that step's first call, from a copy of the same
    state and rows.  Its audio and state equal the live call's bit for bit
    (every host value the step reads is in the key: the interval, the
    count, K6's tier, K7 or the scan), and the live call changes no host
    attribute.  The run prepared before the tiny-tau play renders with K7,
    as its key says, though the pool holds the scan's flag by then."""
    frozen, calls, log = {}, [], []
    live_call = prun.Renderer._eager_call

    def spy(self, step, d0, dd):
        sig = self.signal
        if id(step) not in frozen:
            # the step is held too, so that its id is not reused
            frozen[id(step)] = (step, copy.deepcopy(sig))
        before = _mixer_host(sig)
        d_in = tree_map(torch.clone, d0)
        rows = None if step.rows is None else step.rows.clone()
        out = live_call(self, step, d0, dd)
        assert _mixer_host(sig) == before, "the block step changed a host attribute"
        d_f, out_f = prun.step_body(frozen[id(step)][1], step.kind, step.pack, step.n, step.k,
                                    d_in, dd, rows)
        assert torch.equal(_bits(out_f), _bits(out))
        for a, b in zip(tree_leaves(d_f), tree_leaves(sig.device_collect())):
            assert torch.equal(_bits(a), _bits(b))
        if log:
            count, pool = log[0]
            calls.append((count[0], pool.proto._pool_ema_fast))
        else:
            calls.append(None)
        return out

    monkeypatch.setattr(prun.Renderer, "_eager_call", spy)
    script(pt)
    got, _ = _tau_flip_script(log)
    with prun.eager():
        want, _ = _tau_flip_script([])
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).all() and len(calls) > 20
    flip = [c for c in calls if c is not None]
    # the run of the block prepared before the flip is dispatched after
    # the flip's prepare (the second): with K7, as its key says
    assert any(prepared >= 2 and k7 for prepared, k7 in flip)
    assert any(not k7 for _, k7 in flip)


def test_mixer_state_leaves_stay_put():
    """The step leaves every state leaf in the tensor it was collected in
    and never moves a ring; ``eager()`` stores what the render returns."""
    control, mixer, ctls, rng = _build(pt)
    r = pt.Renderer(mixer, RATE)
    r.render_block(BLOCK)
    before = tree_leaves(mixer.device_collect())
    rings = [p.state["inner"]["inner"]["ring"] for p in mixer._pools.values()
             if "ring" in p.state["inner"]["inner"]]
    assert len(rings) == 1
    r.render_frames(BLOCK * 20)
    feed(ctls, rng, 700)
    h = control.play(_voice(pt))
    r.render_frames(BLOCK * 4)
    h.stop()
    ctls[0].close()
    r.render_frames(BLOCK * 4)
    after = tree_leaves(mixer.device_collect())
    assert len(after) == len(before) and all(a is b for a, b in zip(after, before))
    with prun.eager():
        feed(ctls[1:], rng, 300)
        r.render_block(BLOCK)
    moved = tree_leaves(mixer.device_collect())
    assert any(a is not b for a, b in zip(moved, before))
    pools = [p for p in mixer._pools.values() if "ring" in p.state["inner"]["inner"]]
    assert pools[0].state["inner"]["inner"]["ring"] is rings[0]


def _drain_script(m, mode, prefetch):
    """A closed Adapt(Stream) of 200 samples beside Adapt(Sine) voices,
    rendered until it drains: ``is_stopped()`` after each block (with
    ``prefetch``, after a block whose handle readback was started and one
    more block rendered)."""
    control, mixer = m.Mixer.new(channels=1, **({"device": "cpu"} if m is pt else {}))
    for f in (220.0, 330.0):
        control.play(m.Adapt(m.Sine(0.5, f), 0.1, m.AdaptOptions(tau=0.1, max_gain=4.0)))
    ctl, s = m.Stream.new(8000, 512)
    ctl.write(np.full(200, 0.25, np.float32))
    ctl.close()
    h = control.play(m.Adapt(s, 0.1, m.AdaptOptions(tau=0.1, max_gain=4.0)))
    r = m.Renderer(mixer, RATE)
    seq = [h.is_stopped()]
    with prun.eager() if mode == "eager" else contextlib.nullcontext():
        for _ in range(8):
            if prefetch:
                r.render_frames_device(BLOCK)  # starts the readback
                r.render_frames_device(BLOCK, sync=False)
            else:
                r.render_block(BLOCK)
            seq.append(h.is_stopped())
    return seq


def test_mixer_is_stopped_one_scan_late_under_steps():
    """A closed stream drains (200 samples at 8 kHz: 2.3 blocks); its
    handle turns stopped one scan late (mixer.rs:129-147) under steps as
    under ``eager()`` and in the JAX package, and a readback started
    before a block is not taken for the state after it."""
    want = _drain_script(ot, "jax", False)
    k = want.index(True)
    assert k >= 3 and all(want[k:]) and not any(want[:k])
    assert _drain_script(pt, "step", False) == want
    assert _drain_script(pt, "eager", False) == want
    late = _drain_script(pt, "step", True)
    assert late == _drain_script(pt, "eager", True)
    assert late.index(True) == (k + 1) // 2


def test_mixer_graph_capture_declared():
    """Config 5's chains, bare Streams and Sines, Speed(Sine),
    Gain(Sine), a FramesSignal, a Fader(Sine) and config 2's
    Fader(Speed(FramesSignal)) declare ``graph_capture``, and so does a
    wrapper chain around a capturing Mixer (it renders the mixer
    directly); so do a host pool of Speed(Stream) voices (its params in
    the row) and a submix whose engine captures.  A host pool of a user
    signal (a Sine with its own finish rule) keeps op-by-op dispatch."""
    control, mixer = pt.Mixer.new(channels=1, device="cpu")
    assert mixer.graph_capture
    control.play(pt.Sine(0.0, 440.0))
    control.play(pt.Stream(8000, 256))
    control.play(_voice(pt))
    control.play(pt.Adapt(pt.Stream(8000, 256), 0.1))
    assert mixer.graph_capture
    chain = pt.Tanh(mixer)
    r = pt.Renderer(chain, RATE)
    r.render_frames(BLOCK * 2)
    assert chain.graph_capture and r._steps and r.graph_counts["eager"] == 2
    frames = pt.Frames.from_slice(RATE, np.zeros(64, np.float32))

    class FiniteSine(pt.Sine):
        def host_is_finished(self):
            return np.asarray(self.phase) > 2.0

    def submix():
        inner = pt.Mixer(1, device="cpu")
        pt.MixerControl(inner).play(_voice(pt))
        return inner

    for spec, captured in ((lambda: pt.Speed(pt.Stream(8000, 256)), True),
                           (lambda: pt.Mixer(1, device="cpu"), True),
                           (submix, True),
                           (lambda: FiniteSine(0.0, 220.0), False),
                           (lambda: pt.FramesSignal(frames, 0.0), True),
                           (lambda: pt.Fader(pt.Sine(0.0, 220.0)), True),
                           (lambda: pt.Fader(pt.Speed(pt.FramesSignal(frames, 0.0))), True),
                           (lambda: pt.Speed(pt.Sine(0.0, 220.0)), True),
                           (lambda: pt.Gain(pt.Sine(0.0, 220.0)), True)):
        control, mixer = pt.Mixer.new(channels=1, device="cpu")
        control.play(_voice(pt))
        control.play(spec())
        r = pt.Renderer(mixer, RATE)
        r.render_frames(BLOCK * 2)
        assert mixer.graph_capture is captured
        assert bool(r._steps) is captured
