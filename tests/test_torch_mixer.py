"""The port's device-resident Mixer with Stream ingest and Adapt AGC against
the JAX package, the reference's inline vectors and the numpy oracle.

Ports of the JAX package's mixer, stream and AGC tests
(tests/test_ops.py:246-378, tests/test_stream_adapt_fader.py, and
tests/test_agc_kernel.py:71/:106) run against the port.  These tests were
written before the port had Constant, FixedGain or FramesSignal: where a
JAX test used one, a Stream fed the same samples takes its place (an integer step
reads the written values exactly), and where a JAX test compared the
device-resident pool with the host pool, the port's device-resident pool
is compared with the JAX package's host pool.

Bounds: exact where the reference's vectors are dyadic; 1e-5 (the PARITY.md
contract) against the JAX package and the oracle.  The config-5 scene
differs from the JAX package by the order of the voice sums and by a few
ulps of the AGC gains (tests/test_torch_agc.py).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import oddio_tpu as ot  # noqa: E402
import oddio_tpu_torch as pt  # noqa: E402
import reference_impl as ref  # noqa: E402
from oddio_tpu_torch.ops import agc as A  # noqa: E402
from oddio_tpu_torch.utils.scene_profile import FILL, build_mixer_agc, feed  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-5
RATE = 48000


def kw(m):
    """The port renders on the CPU only when asked to."""
    return {"device": "cpu"} if m is pt else {}


def sample(sig, interval, n):
    """Drive a signal like oddio's tests drive ``Signal::sample``."""
    r = getattr(sig, "_test_renderer", None)
    if r is None:
        r = pt.Renderer(sig, 1, device="cpu")
        sig._test_renderer = r
    return r.render_block(n, interval=np.float32(interval))


def mono(block):
    assert block.shape[1] == 1
    return block[:, 0]


def held(value, k, rate=1):
    """A stream holding ``k`` samples of ``value``: a Constant for k frames
    at an integer step."""
    ctl, s = pt.Stream.new(rate, max(k, 1))
    assert ctl.write(np.full(k, value, np.float32)) == k
    return ctl, s


# --- Mixer (test_ops.py:246-378, mixer.rs:124-148) ------------------------------


def test_port_mixer_is_stopped_one_scan_late():
    """mixer.rs:129-147: a finished voice is noticed one scan late; the
    port's handle sequence equals the JAX package's on the same script."""
    seqs = []
    for m in (ot, pt):
        control, mixer = m.Mixer.new(channels=1, **kw(m))
        ctl, s = m.Stream.new(1, 8)
        ctl.write([0.0, 0.0])
        ctl.close()
        h = control.play(s)
        seq = [h.is_stopped()]
        r = m.Renderer(mixer, 1)
        for iv in (0.6, 0.6, 0.6, 0.6, 0.0, 0.0):
            r.render_block(1, interval=np.float32(iv))
            seq.append(h.is_stopped())
        seqs.append(seq)
    assert seqs[0] == seqs[1]
    k = seqs[1].index(True)
    assert k >= 2 and all(seqs[1][k:]) and not any(seqs[1][:k])


def test_port_mixer_sums_voices():
    control, mixer = pt.Mixer.new(channels=1, device="cpu")
    control.play(held(1.0, 8)[1])
    control.play(held(2.0, 8)[1])
    np.testing.assert_array_equal(mono(sample(mixer, 1.0, 4)), [3.0] * 4)
    # a different archetype joins a second pool
    control.play(pt.Sine(np.pi / 2, 0.0))  # constant 1.0 via sine
    np.testing.assert_allclose(mono(sample(mixer, 1.0, 4)), [4.0] * 4, atol=1e-6)
    assert len(mixer._pools) == 2


def test_port_mixer_stop_and_reuse():
    control, mixer = pt.Mixer.new(channels=1, device="cpu")
    h1 = control.play(held(1.0, 16)[1])
    sample(mixer, 1.0, 2)
    h1.stop()
    np.testing.assert_array_equal(mono(sample(mixer, 1.0, 2)), [0.0, 0.0])
    assert h1.is_stopped()
    h2 = control.play(held(5.0, 16)[1])
    np.testing.assert_array_equal(mono(sample(mixer, 1.0, 2)), [5.0, 5.0])
    assert not h2.is_stopped()
    assert h1.is_stopped()  # a stale handle stays stopped


def test_port_mixer_growth():
    control, mixer = pt.Mixer.new(channels=1, device="cpu")
    handles = [control.play(held(1.0, 4)[1]) for _ in range(40)]
    pool = next(iter(mixer._pools.values()))
    assert pool.capacity == 64
    np.testing.assert_array_equal(mono(sample(mixer, 1.0, 2)), [40.0, 40.0])
    for h in handles[:39]:
        h.stop()
    np.testing.assert_array_equal(mono(sample(mixer, 1.0, 2)), [1.0, 1.0])


def test_port_mixer_masked_equals_naive():
    """The masked dense mixer equals a naive per-voice loop."""
    rng = np.random.default_rng(0)
    control, mixer = pt.Mixer.new(channels=1, device="cpu")
    freqs = rng.uniform(50, 1000, size=8)
    for f in freqs:
        control.play(pt.Sine(0.0, f))
    out = mono(sample(mixer, 1.0 / 48000.0, 256))
    t = np.arange(256, dtype=np.float32) * np.float32(1.0 / 48000.0)
    naive = sum(
        np.sin(t * np.float32(np.float32(f) * np.float32(2 * np.pi)))
        for f in freqs
    )
    np.testing.assert_allclose(out, naive, atol=1e-5)


def test_port_dr_pool_matches_jax_host_pool():
    """The port's device-resident pool against the JAX package's HOST pool
    (vmapped per-voice renders, f64 sine phases) for the same Sine voices,
    before and after a stop (mixer.rs:92-118).  The JAX test wraps each
    sine in a FixedGain, which the port does not have yet."""
    rng = np.random.default_rng(3)
    freqs = rng.uniform(50, 800, 6)

    def build(m, dr):
        control, mixer = m.Mixer.new(channels=1, **kw(m))
        hs = []
        for f in freqs:
            sig = m.Sine(0.1, f)
            if not dr:
                sig.dr_supported = lambda: False  # force the host pool
            hs.append(control.play(sig))
        return mixer, hs

    mj, hj = build(ot, False)
    mp, hp = build(pt, True)
    assert not next(iter(mj._pools.values())).is_dr
    r1, r2 = ot.Renderer(mj, RATE), pt.Renderer(mp, RATE)
    a, b = r1.render_frames(1024, 256), r2.render_frames(1024, 256)
    assert np.abs(a).max() > 0.1 and np.abs(a - b).max() <= TOL
    hj[2].stop()
    hp[2].stop()
    a, b = r1.render_frames(512, 256), r2.render_frames(512, 256)
    assert np.abs(a - b).max() <= TOL
    assert hp[2].is_stopped() and not hp[0].is_stopped()


def test_port_mixer_dr_growth_and_finish():
    """Pool growth (plays beyond capacity) and natural-finish reclamation
    through a render_block-only loop (FramesSignal of 400 ones in the JAX
    test; here a closed stream of 400 ones)."""
    control, mixer = pt.Mixer.new(channels=1, device="cpu")
    handles = []
    for _ in range(40):
        ctl, s = held(1.0, 400, rate=8000)
        ctl.close()
        handles.append(control.play(s))
    pool = next(iter(mixer._pools.values()))
    assert pool.is_dr and pool.capacity >= 40
    r = pt.Renderer(mixer, 8000)
    np.testing.assert_array_equal(r.render_block(256)[:, 0], np.full(256, 40.0))
    out = r.render_block(256)  # sources end at frame 400
    np.testing.assert_array_equal(out[:144, 0], np.full(144, 40.0))
    np.testing.assert_array_equal(out[144:, 0], np.zeros(112))
    r.render_block(256)
    r.render_block(256)
    assert all(h.is_stopped() for h in handles)
    assert len(pool._free) == pool.capacity


def test_port_mixer_rejects_host_pool_chains():
    """Chains that are not device-resident capable once raised here; now
    they take the same pools as in the JAX package: a submix the
    singleton, a forced-host Sine and a Speed(Stream) the host pool, a
    Speed(Sine) and an Adapt(Stream) device-resident pools."""
    kinds = []
    for m in (ot, pt):
        control, mixer = m.Mixer.new(channels=1, **kw(m))
        control.play(m.Mixer(1, **kw(m)))  # a submix
        sine = m.Sine(0.0, 100.0)
        sine.dr_supported = lambda: False
        control.play(sine)
        control.play(m.Speed(m.Stream(8000, 256)))
        control.play(m.Speed(m.Sine(0.0, 100.0)))
        control.play(m.Adapt(m.Stream(8000, 256), 0.1))
        kinds.append([type(p).__name__ for p in mixer._pools.values()])
    assert kinds[0] == kinds[1] == ["PoolSingleton", "Pool", "Pool", "PoolDR", "PoolDR"]


# --- Stream (test_stream_adapt_fader.py, stream.rs:115-149) ----------------------


def test_port_stream_smoke():
    control, s = pt.Stream.new(1, 3)
    assert control.write([1.0, 2.0]) == 2
    assert control.write([3.0, 4.0]) == 1
    np.testing.assert_array_equal(mono(sample(s, 1.0, 5)), [1.0, 2.0, 3.0, 0.0, 0.0])
    assert control.write([5.0, 6.0, 7.0, 8.0]) == 3
    np.testing.assert_array_equal(mono(sample(s, 1.0, 1)), [5.0])
    np.testing.assert_array_equal(mono(sample(s, 1.0, 4)), [6.0, 7.0, 0.0, 0.0])
    np.testing.assert_array_equal(mono(sample(s, 1.0, 2)), [0.0, 0.0])


def test_port_stream_cleanup():
    """stream.rs:136-148: sender dropped -> finishes once drained."""
    control, s = pt.Stream.new(1, 4)
    assert control.write([1.0, 2.0]) == 2
    assert not bool(s.host_is_finished())
    control.close()
    assert not bool(s.host_is_finished())
    sample(s, 1.0, 1)
    assert not bool(s.host_is_finished())
    sample(s, 1.0, 1)
    assert bool(s.host_is_finished())
    sample(s, 1.0, 1)
    assert bool(s.host_is_finished())


def test_port_stream_resampling_lerp():
    control, s = pt.Stream.new(1, 8)
    control.write([0.0, 1.0, 2.0, 3.0])
    out = mono(sample(s, 0.5, 6))
    np.testing.assert_array_equal(out, [0.0, 0.5, 1.0, 1.5, 2.0, 2.5])


def test_port_stream_in_mixer_pool():
    control, mixer = pt.Mixer.new(channels=1, device="cpu")
    sc1, s1 = pt.Stream.new(1, 8)
    sc2, s2 = pt.Stream.new(1, 8)
    control.play(s1)
    control.play(s2)
    sc1.write([1.0, 1.0, 1.0])
    sc2.write([2.0, 2.0])
    np.testing.assert_array_equal(mono(sample(mixer, 1.0, 4)), [3.0, 3.0, 1.0, 0.0])


def test_port_stream_many_voices_ingest():
    """512 streams in one mixer: ingest is O(active writers); sustained
    block-by-block writes keep every written stream fed."""
    control, mixer = pt.Mixer.new(channels=1, device="cpu")
    controls = []
    for _ in range(512):
        sc, s = pt.Stream.new(1, 64)
        control.play(s)
        controls.append(sc)
    r = pt.Renderer(mixer, 1)
    for _ in range(4):
        for i in range(8):
            assert controls[i].write(np.full(16, float(i + 1), np.float32)) == 16
        out = r.render_block(16, interval=np.float32(1.0))
        np.testing.assert_array_equal(out[:, 0], np.full(16, 36.0))
    pool = next(iter(mixer._pools.values()))
    assert pool.proto._dirty == set()


def test_port_stream_dr_close_reclaims_and_slot_reuse():
    """stream.rs:88-91 in a DR pool: close() + drain finishes the voice
    (observed one sync late), the slot is reclaimed, and a new stream in
    the slot never hears the previous tenant's ring."""
    control, mixer = pt.Mixer.new(channels=1, device="cpu")
    ctl, s = pt.Stream.new(1, 64)
    h = control.play(s)
    r = pt.Renderer(mixer, 1)
    assert ctl.write(np.full(8, 0.5, np.float32)) == 8
    out = r.render_block(16, interval=np.float32(1.0))
    np.testing.assert_array_equal(out[:8, 0], np.full(8, 0.5))
    np.testing.assert_array_equal(out[8:, 0], np.zeros(8))  # underrun pad
    ctl.close()
    r.render_block(16, interval=np.float32(1.0))
    r.render_block(16, interval=np.float32(1.0))  # observed one block late
    assert h.is_stopped()
    assert ctl.write(np.ones(4, np.float32)) == 0  # a dead handle takes 0
    ctl2, s2 = pt.Stream.new(1, 64)
    control.play(s2)
    out = r.render_block(16, interval=np.float32(1.0))
    np.testing.assert_array_equal(out[:, 0], np.zeros(16))
    assert ctl2.write(np.full(5, -0.25, np.float32)) == 5
    out = r.render_block(16, interval=np.float32(1.0))
    np.testing.assert_array_equal(out[:5, 0], np.full(5, -0.25))
    np.testing.assert_array_equal(out[5:, 0], np.zeros(11))


# --- Adapt (adapt.rs:96-147) --------------------------------------------------------


def test_port_adapt_smoke():
    """adapt.rs:100-147: one continuous instance through all phases; the
    inner level changes between phases (a rate-10 stream read at one
    sample per 0.1 s frame)."""
    LOW, HIGH, MAX_GAIN = 0.1, 1.0, 10.0
    ctl, inner = pt.Stream.new(10, 64)
    adapt = pt.Adapt(
        inner, 0.0, pt.AdaptOptions(tau=0.5, low=LOW, high=HIGH, max_gain=MAX_GAIN)
    )
    ctl.write(np.zeros(10, np.float32))
    for _ in range(10):  # silence isn't modified
        assert mono(sample(adapt, 0.1, 1))[0] == 0.0
    ctl.write(np.full(10, 10.0, np.float32))  # loud: gain pulls down
    out = mono(sample(adapt, 0.1, 10))
    assert 0.0 < out[0] < 10.0
    assert np.all(np.diff(out) < 0)
    ctl.write(np.full(10, 0.01, np.float32))  # quiet: gain rises
    out = mono(sample(adapt, 0.1, 10))
    assert out[0] > 0.0
    assert np.all(np.diff(out) > 0)
    for _ in range(100):  # super quiet: capped by max_gain
        ctl.write(np.full(10, 1e-6, np.float32))
        out = mono(sample(adapt, 0.1, 10))
        assert np.all(out <= 1e-6 * MAX_GAIN + 1e-12)


def test_port_adapt_matches_scalar_reference():
    """Exact per-frame EMA against a scalar reimplementation."""
    rng = np.random.default_rng(1)
    data = rng.standard_normal(64).astype(np.float32)
    ctl, inner = pt.Stream.new(1, 64)
    ctl.write(data)
    sig = pt.Adapt(inner, 0.5, pt.AdaptOptions(tau=0.3, low=0.2, high=0.6, max_gain=4.0))
    out = mono(sample(sig, 1.0, 48))
    alpha = np.float32(1.0) - np.exp(np.float32(-1.0) / np.float32(0.3), dtype=np.float32)
    avg = np.float32(0.25)
    exp = []
    sq2 = np.sqrt(np.float32(2.0), dtype=np.float32)
    for i in range(48):
        x = data[i]
        avg = x * x * alpha + avg * (np.float32(1.0) - alpha)
        peak = np.sqrt(avg, dtype=np.float32) * sq2
        if peak < np.float32(0.2):
            g = min(np.float32(0.2) / peak, np.float32(4.0))
        elif peak > np.float32(0.6):
            g = np.float32(0.6) / peak
        else:
            g = np.float32(1.0)
        exp.append(x * g)
    np.testing.assert_allclose(out, np.float32(exp), atol=2e-6)


# --- AGC paths in DR pools (test_agc_kernel.py:71, :106) ----------------------------


def _adapt_scene(taus, freqs):
    control, mixer = pt.Mixer.new(channels=1, device="cpu")
    for tau, f in zip(taus, freqs):
        control.play(pt.Adapt(
            pt.Sine(0.3, f), 0.1,
            pt.AdaptOptions(tau=tau, low=0.1, high=0.4, max_gain=4.0),
        ))
    return mixer


def test_port_agc_fast_path_matches_scan_path(monkeypatch):
    """The same scene with K7's gate open and forced shut: the closed form
    and the scan agree (their carries drift apart by rounding only)."""
    rng = np.random.default_rng(7)
    freqs = rng.uniform(50, 2000, 24)
    outs = {}
    for gate in (32.0, -1.0):
        monkeypatch.setattr(A, "EMA_GATE", gate)
        mixer = _adapt_scene([0.1] * 24, freqs)
        r = pt.Renderer(mixer, RATE)
        outs[gate] = np.concatenate([r.render_block(512) for _ in range(4)])
        pool = next(iter(mixer._pools.values()))
        assert pool._ema_fast == (gate > 0)
        assert getattr(pool.proto, "_pool_ema_fast", False) == (gate > 0)
    assert np.isfinite(outs[32.0]).all()
    assert np.abs(outs[32.0] - outs[-1.0]).max() < 1e-4


def test_port_pathological_tau_flips_pool_to_scan():
    """A tiny-tau voice played into a live closed-form pool flips it to the
    scan (the closed form's exp would overflow); the render stays finite."""
    mixer = _adapt_scene([0.1] * 4, [200.0, 300.0, 400.0, 500.0])
    r = pt.Renderer(mixer, RATE)
    r.render_block(512)
    pool = next(iter(mixer._pools.values()))
    assert pool._ema_fast
    pt.MixerControl(mixer).play(pt.Adapt(
        pt.Sine(0.0, 440.0), 0.1,
        pt.AdaptOptions(tau=1e-6, low=0.1, high=0.4, max_gain=4.0),
    ))
    out = np.concatenate([r.render_block(512) for _ in range(3)])
    assert not pool._ema_fast
    assert not getattr(pool.proto, "_pool_ema_fast", True)
    assert np.isfinite(out).all()


# --- scenes -------------------------------------------------------------------------


def _jax_mixer_agc(voices, seed=0):
    """``build_mixer_agc`` in the JAX package (the same draws)."""
    rng = np.random.default_rng(seed)
    ns = voices // 8
    mixer = ot.Mixer(1, initial_capacity=max(ns, 1))
    control = ot.MixerControl(mixer)
    ctls = []
    for i in range(voices):
        opt = ot.AdaptOptions(tau=0.1, max_gain=4.0)
        if i < ns:
            stream = ot.Stream(8000, FILL + 128, max_write_per_block=FILL)
            ctls.append(stream.control)
            control.play(ot.Adapt(stream, 0.1, opt))
        else:
            control.play(ot.Adapt(
                ot.Sine(rng.uniform(0, 6), rng.uniform(50, 2000)), 0.1, opt
            ))
    feed(ctls, rng, FILL)
    return control, mixer, ctls, rng


def test_config5_scene_matches_jax():
    """BASELINE config 5's scene at 64 voices (8 Adapt(Stream), 56
    Adapt(Sine)) over 32 blocks: writes between blocks, a mid-run play and
    its stop(), a close(); the port against the JAX package."""
    outs = []
    for m, build in ((ot, _jax_mixer_agc), (pt, lambda v: build_mixer_agc(v, "cpu"))):
        control, mixer, ctls, rng = build(64)
        r = m.Renderer(mixer, RATE)
        blocks = []
        h = None
        for b in range(32):
            if b in (3, 11, 19):
                feed(ctls, rng, 700)
            if b == 6:
                h = control.play(m.Adapt(m.Sine(0.5, 300.0), 0.1,
                                         m.AdaptOptions(tau=0.1, max_gain=4.0)))
            if b == 14:
                h.stop()
            if b == 17:
                ctls[2].close()
            blocks.append(r.render_block(512))
        assert h.is_stopped()
        outs.append(np.concatenate(blocks))
    a, b = outs
    assert np.isfinite(b).all() and np.abs(b).max() > 0.1
    assert np.abs(a - b).max() <= TOL, np.abs(a - b).max()


def test_adapt_sine_mixer_matches_oracle():
    """A Mixer of 4 Adapt(Sine) voices against OMixer/OAdapt/OSine.  The
    taus are ones where numpy's float32 exp, which the oracle's alpha uses,
    rounds -interval/tau correctly (ROADMAP R8: where it does not, the
    oracle's alpha = 1 - exp(...) is off by ~1e-4 relative)."""
    specs = [(0.1, 220.0, 0.1), (1.3, 440.0, 0.2), (2.2, 97.0, 0.4), (4.0, 1500.0, 0.5)]
    low, high = np.float32(0.1 / np.sqrt(2.0)), np.float32(0.5 / np.sqrt(2.0))
    control, mixer = pt.Mixer.new(channels=1, device="cpu")
    omix = ref.OMixer()
    for ph, f, tau in specs:
        control.play(pt.Adapt(pt.Sine(ph, f), 0.3, pt.AdaptOptions(tau=tau, max_gain=4.0)))
        omix.play(ref.OAdapt(ref.OSine(ph, f, exact=True), 0.3, tau, 4.0, low, high))
    got = pt.Renderer(mixer, RATE).render_frames(512 * 8)[:, 0]
    want = np.zeros(512 * 8, np.float32)
    iv = np.float32(1.0 / RATE)
    for k in range(8):
        omix.sample(iv, want[512 * k : 512 * (k + 1)])
    assert np.abs(want).max() > 0.1
    assert np.abs(got - want).max() <= TOL, np.abs(got - want).max()
