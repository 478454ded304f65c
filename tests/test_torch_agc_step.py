"""The device-resident Adapt and Stream steps as one kernel each (K7
``agc.agc_step``, K6 ``stream_kernels.stream_step``) on the CPU, where
each runs its plain version:

* the plain Adapt step bit for bit against the unfused chain (a copy of
  the unfused ops below: alpha, the level, the packed scalars, the closed
  form, the gain multiply) at n in {128, 512}, one and two channels, a
  host and a per-voice interval, counts below n;
* the block length 513, which the buffered pools and submixes render and
  which takes the closed form where the unfused chain (K7 only at
  multiples of 128 frames) takes the scan:
  a chained render of 96 blocks (1.03 s at 48 kHz) at taus 0.1, 0.05,
  0.02 s and one within 1% of the gate, against the float64 sequential
  recurrence (alpha as adapt.rs:70 rounds it, its exp taken in float64,
  ROADMAP R8): output samples within 1e-5 (measured <= 3.0e-7 at every
  tau); against the JAX package's scan at 513 (its route there), whose
  distance from the port is its own drift from the recurrence (ROADMAP
  R9): 4.1e-5, 1.7e-5, 1.6e-6 and 3.6e-7 at the four taus, within 1e-6
  of the scan's distance from the recurrence (4.1e-5, 1.7e-5, 1.6e-6,
  1.2e-7);
* the pools' route: the host-pool scene's 513-frame Adapt pools call
  ``agc_step`` and their gate is computed at 513 frames; a tau that
  passes the gate at 512 but not at 513 keeps the scan;
* whole renders with the steps swapped back to the unfused chains: the
  64-voice config-5 mixer and a 4-scene config-5 pack bit-equal (their
  routes did not change); the 64-voice host-pool scene, whose 513-frame
  Adapt pools changed route, within 1e-5 (closed form against scan).
The host-pool scene against the JAX package is in
``test_torch_agc_step_jax.py``.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import oddio_tpu_torch as pt  # noqa: E402
from oddio_tpu.ops.adapt import _ema_gain as jax_ema_gain  # noqa: E402
from oddio_tpu_torch.ops import agc as A  # noqa: E402
from oddio_tpu_torch.ops import stream_kernels as SK  # noqa: E402
from oddio_tpu_torch.ops._dev import device_split_ds  # noqa: E402
from oddio_tpu_torch.ops.adapt import _ema_gain  # noqa: E402
from oddio_tpu_torch.utils.scene_profile import (build_config5_pack, build_host_pools,  # noqa: E402
                                                 build_mixer_agc, feed)

torch.set_num_threads(1)

IV = np.float32(1.0 / 48000.0)
LOW = np.float32(0.1 / np.sqrt(2))
HIGH = np.float32(0.5 / np.sqrt(2))


# --- the unfused chains ----------------------------------------------------------------


def unfused_alpha(interval, tau):
    if isinstance(interval, torch.Tensor):
        return 1.0 - torch.exp(-interval / tau)
    return 1.0 - torch.exp(torch.full_like(tau, -float(np.float32(interval))) / tau)


def unfused_pack(avg0, alpha, count, low, high, max_gain):
    lg = torch.log1p(-alpha)
    return torch.stack([avg0, alpha, lg, count.to(torch.float32), low, high, max_gain,
                        torch.zeros_like(avg0)], dim=-1)


def unfused_gain(avg2, low, high, max_gain):
    avg_peak = torch.sqrt(avg2) * float(np.sqrt(np.float32(2.0), dtype=np.float32))
    return torch.where(avg_peak < low, torch.minimum(low / avg_peak, max_gain),
                       torch.where(avg_peak > high, high / avg_peak, 1.0))


def unfused_gains_plain(s, scal, n):
    avg0, a, lg, cnt_f, low, high, mg = (scal[:, k : k + 1] for k in range(7))
    s2 = s * s
    i_f = torch.arange(n, dtype=torch.float32)
    M = torch.exp(torch.minimum(i_f + 1.0, cnt_f) * lg)
    terms = torch.where(i_f < cnt_f, (a * s2) / M, 0.0)
    csum = torch.cumsum(terms, dim=-1)
    carry = M[:, -1] * (avg0[:, 0] + csum[:, -1])
    prev = torch.exp(torch.minimum(i_f, cnt_f) * lg) * (avg0 + (csum - terms))
    avg2 = s2 * a + prev * (1.0 - a)
    return unfused_gain(avg2, low, high, mg), carry


def unfused_adapt_dr_render(self, state, ddata, interval, n, count):
    """``Adapt.dr_render`` one torch op at a time, with the closed form
    only at n a multiple of 128 up to 512 and the scan otherwise."""
    d2, samples = self.inner.dr_render(state["inner"], ddata.get("inner", {}), interval, n,
                                       count)
    alpha = unfused_alpha(interval, state["tau"])
    cnt = count.to(torch.int32).expand(state["avg"].shape)
    s = samples if samples.dim() == 2 else samples.sum(dim=1)
    if getattr(self, "_pool_ema_fast", False) and n % 128 == 0 and n <= 512:
        scal = unfused_pack(state["avg"], alpha, cnt, state["low"], state["high"],
                            state["max_gain"])
        gain, avg = unfused_gains_plain(s.contiguous(), scal, n)
    else:
        gain, avg = _ema_gain(state["avg"], s, alpha, cnt, state["low"], state["high"],
                              state["max_gain"], n)
    st = dict(state)
    st["avg"], st["inner"] = avg, d2
    return st, samples * (gain if samples.dim() == 2 else gain[:, None, :])


def unfused_stream_dr_render(self, state, ddata, interval, n, count):
    """``Stream.dr_render`` one torch op at a time: the step and its
    split, the split-operand read, the release."""
    iv = float(np.float32(interval))
    ring, t, len_, start = state["ring"], state["t"], state["len"], state["start"]
    ds = state["rate"] * iv
    if self._kernel_ok(n):
        ds_int, f_hi, f_lo = device_split_ds(ds)
        whole, p, fr = SK._positions(t, ds_int, f_hi, f_lo, n)
        flat = self._flat(ring)
        idx = torch.remainder(start.to(torch.int64)[:, None] + p, self.size_pad)
        a = torch.gather(flat, 1, idx)
        b = torch.gather(flat, 1, torch.remainder(idx + 1, self.size_pad))
        samp = torch.where(whole < len_[:, None], a + fr * (b - a), 0.0)[:, None, :]
    else:
        samp = self._read_plain(ring, t, ds, len_, start, n)
    out = dict(state)
    cf = count.to(torch.float32)
    nxt = t + (cf * iv) * state["rate"]
    tc = torch.minimum(nxt, len_.to(torch.float32))
    released = torch.trunc(tc).to(torch.int32)
    out["t"] = tc - released.to(torch.float32)
    out["len"] = len_ - released
    out["start"] = torch.remainder(start + released, self.size_pad)
    return out, samp[:, 0, :] if self.channels == 1 else samp


def unfused_step(samples, avg0, tau, interval, count, low, high, mg, n):
    """The unfused chain's closed-form branch on bare operands."""
    alpha = unfused_alpha(interval, tau)
    cnt = count.to(torch.int32).expand(avg0.shape)
    s = samples if samples.dim() == 2 else samples.sum(dim=1)
    gain, avg = unfused_gains_plain(s.contiguous(), unfused_pack(avg0, alpha, cnt, low, high, mg),
                                   n)
    return samples * (gain if samples.dim() == 2 else gain[:, None, :]), avg


# --- operands -------------------------------------------------------------------------


def operands(rng, V, C, n, taus, per_voice, amp=None):
    shape = (V, n) if C == 1 else (V, C, n)
    if amp is None:
        amp = rng.choice([0.01, 0.1, 0.5, 1.0], V)
    amp = np.reshape(amp, (V,) + (1,) * (len(shape) - 1))
    x = torch.tensor((rng.standard_normal(shape) * amp).astype(np.float32))
    tau = torch.tensor(np.resize(np.asarray(taus, np.float32), V))
    iv = (torch.tensor((IV * rng.uniform(0.8, 1.25, V)).astype(np.float32)) if per_voice
          else float(IV))
    count = rng.integers(0, n + 1, V).astype(np.int32)
    count[: V // 2] = n
    return (x, torch.tensor(rng.uniform(1e-4, 0.3, V).astype(np.float32)), tau, iv,
            torch.tensor(count), torch.full((V,), LOW), torch.full((V,), HIGH),
            torch.tensor(rng.uniform(1, 8, V).astype(np.float32)))


@pytest.mark.parametrize("n", [128, 512])
@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("per_voice", [False, True])
def test_plain_adapt_step_equals_unfused_chain(n, C, per_voice):
    rng = np.random.default_rng(n + 10 * C + per_voice)
    ops = operands(rng, 24, C, n, [0.1, 0.05, 0.02, 3.3e-4], per_voice)
    before = A.LAUNCHES["agc_gains"]
    out, carry = A.agc_step(*ops, n)
    assert A.LAUNCHES["agc_gains"] == before
    want, wcarry = unfused_step(*ops, n)
    assert out.shape == ops[0].shape and torch.equal(out, want) and torch.equal(carry, wcarry)
    assert (ops[4] < n).any() and float((out - ops[0]).abs().max()) > 1e-3


def test_agc_step_refusals():
    ops = list(operands(np.random.default_rng(1), 4, 1, 64, [0.1], False))
    for k, bad, err in ((0, ops[0].double(), TypeError),         # f64 samples
                        (0, ops[0][:, :32], ValueError),          # frames != n
                        (1, ops[1][:3], ValueError),              # a short column
                        (2, ops[2].double(), TypeError),          # f64 tau
                        (3, "0.1", TypeError),                    # a string interval
                        (3, torch.zeros(3), ValueError),          # a short interval
                        (4, ops[4].long(), TypeError),            # int64 count
                        (4, ops[4][:2], ValueError)):             # a (2,) count
        args = list(ops)
        args[k] = bad
        with pytest.raises(err):
            A.agc_step(*args, 64)
    for n in (0, A.AGC_NMAX + 1):
        x = torch.zeros((4, max(n, 1)))
        with pytest.raises(ValueError):
            A.agc_step(x, *ops[1:], n)
    with pytest.raises(ValueError):  # channels x frames past the staging
        A.agc_step(torch.zeros((4, 4, 512)), *ops[1:], 512)


# --- the block length 513 --------------------------------------------------------------


def sequential_f64(avg0, x, alpha, count, low, high, mg):
    """adapt.rs:69-88 frame by frame in float64 over one block, vectorized
    over voices: (gains (V, n), carry (V,))."""
    V, n = x.shape
    g = np.empty((V, n))
    avg = avg0.astype(np.float64).copy()
    x = x.astype(np.float64)
    for i in range(n):
        a2 = x[:, i] * x[:, i] * alpha + avg * (1.0 - alpha)
        avg = np.where(i < count, a2, avg)
        pk = np.sqrt(a2) * np.sqrt(2.0)
        g[:, i] = np.where(pk < low, np.minimum(low / pk, mg), np.where(pk > high, high / pk, 1.0))
    return g, avg


#: tau within 1% of the gate at n = 513, 48 kHz: 513 * IV / tau = 31.7
TAU_GATE = float(np.float32(513 / 48000 / 31.7))


@pytest.mark.parametrize("tau", [0.1, 0.05, 0.02, TAU_GATE])
def test_chained_513_renders_match_f64_recurrence_and_jax_scan(tau):
    """96 blocks of 513 frames, the carry chained and 512 or 513 frames
    consumed per block (a buffered pool's count), through ``agc_step``, the
    float64 recurrence (alpha in float64) and the JAX package's scan."""
    n, V, blocks = 513, 8, 96
    assert 0.99 * A.EMA_GATE < n * float(IV) / TAU_GATE <= A.EMA_GATE
    rng = np.random.default_rng(int(1e4 * tau))
    tau_t = torch.full((V,), np.float32(tau))
    cols = dict(low=np.full(V, LOW), high=np.full(V, HIGH), mg=np.full(V, np.float32(4.0)))
    # adapt.rs:70's f32 alpha with the exp taken in float64 and rounded
    # once (ROADMAP R8: numpy's float32 exp is an ulp off at some taus)
    q = np.float32(-IV) / np.float32(tau)
    alpha64 = np.float64(np.float32(1.0) - np.float32(np.exp(np.float64(q))))
    alpha32 = A._alpha(float(IV), tau_t)
    amp = np.array([0.01, 0.03, 0.1, 0.2, 0.5, 1.0, 0.05, 0.3], np.float32)[:, None]
    avg_port = torch.full((V,), np.float32(0.01))
    avg_f64 = np.full(V, 0.01)
    avg_jax = jnp.full((V,), np.float32(0.01))
    jscan = jax.jit(jax_ema_gain, static_argnums=7)
    worst_f64 = worst_jax = jax_f64 = 0.0
    for _ in range(blocks):
        x = (rng.standard_normal((V, n)) * amp).astype(np.float32)
        count = rng.integers(n - 1, n + 1, V).astype(np.int32)
        out, avg_port = A.agc_step(torch.tensor(x), avg_port, tau_t, float(IV),
                                   torch.tensor(count), torch.tensor(cols["low"]),
                                   torch.tensor(cols["high"]), torch.tensor(cols["mg"]), n)
        g64, avg_f64 = sequential_f64(avg_f64, x, alpha64, count, cols["low"], cols["high"],
                                      cols["mg"])
        gj, avg_jax = jscan(avg_jax, jnp.asarray(x), jnp.asarray(alpha32.numpy()),
                            jnp.asarray(count), jnp.asarray(cols["low"]),
                            jnp.asarray(cols["high"]), jnp.asarray(cols["mg"]), n)
        worst_f64 = max(worst_f64, float(np.abs(out.numpy() - x * g64).max()))
        worst_jax = max(worst_jax, float(np.abs(out.numpy() - x * np.asarray(gj)).max()))
        jax_f64 = max(jax_f64, float(np.abs(x * np.asarray(gj) - x * g64).max()))
    assert np.isfinite(out.numpy()).all()
    assert worst_f64 <= 1e-5, worst_f64
    assert worst_jax <= jax_f64 + 1e-6, (worst_jax, jax_f64)


def test_host_pool_scene_513_pools_take_the_step(monkeypatch):
    """The host-pool scene's device-resident Adapt(Stream) pool and its
    submix's two Adapt pools render 513 frames a block through
    ``agc_step``, each pool's gate computed at 513 frames."""
    calls = []

    def spy(samples, *a):
        calls.append(samples.shape[-1])
        return A.agc_step_plain(samples, *a)

    import oddio_tpu_torch.ops.adapt as adapt_mod

    monkeypatch.setattr(adapt_mod, "agc_step", spy)
    _, scene, ctls, _, rng = build_host_pools(16, "cpu", dr_voices=8, submix_voices=16)
    r = pt.Renderer(scene, 48000)
    r.render_frames(512 * 4)
    assert calls and set(calls) == {513}
    assert len(calls) == 3 * 4  # three Adapt pools, four blocks
    dr = [p for p in scene._buffered_pools.values() if type(p).__name__ == "_BufferedPoolDR"]
    assert dr and all(p._ema_fast and p._ds_n == 513 for p in dr)


def test_tau_past_the_gate_at_513_keeps_the_scan(monkeypatch):
    """A tau that passes the gate at 512 frames but not at 513 keeps the
    scan in a 513-frame pool (and K7 at 512 frames in a mixer)."""
    tau = float(np.float32(512.5 * IV / 32.0))  # 512 * iv/tau < 32 < 513 * iv/tau
    assert 512 * float(IV) / tau <= A.EMA_GATE < 513 * float(IV) / tau
    calls = []

    def spy(samples, *a):
        calls.append(samples.shape[-1])
        return A.agc_step_plain(samples, *a)

    import oddio_tpu_torch.ops.adapt as adapt_mod

    monkeypatch.setattr(adapt_mod, "agc_step", spy)
    control, mixer = pt.Mixer.new(channels=1, device="cpu")
    control.play(pt.Adapt(pt.Sine(0.3, 220.0), 0.1, pt.AdaptOptions(tau=tau, max_gain=4.0)))
    r = pt.Renderer(mixer, 48000)
    r.render_block(512)
    pool = next(iter(mixer._pools.values()))
    assert pool._ema_fast and calls == [512]
    r.render_block(513)
    assert not pool._ema_fast and calls == [512]
    assert np.isfinite(r.render_block(513)).all()


# --- whole renders with the unfused chains ----------------------------------------------


def swap_unfused(monkeypatch):
    monkeypatch.setattr(pt.Adapt, "dr_render", unfused_adapt_dr_render)
    monkeypatch.setattr(pt.Stream, "dr_render", unfused_stream_dr_render)


def mixer_render():
    _, mixer, ctls, rng = build_mixer_agc(64, "cpu")
    r = pt.Renderer(mixer, 48000)
    a = r.render_frames(512 * 6)
    feed(ctls, rng, 1024)
    return np.concatenate([a, r.render_frames(512 * 6)])


def pack_render():
    pack, ctls, rng = build_config5_pack(4, "cpu", voices=64)
    a = np.concatenate([pack.render_block(512) for _ in range(4)], axis=1)
    feed(ctls, rng, 1024)
    return np.concatenate([a] + [pack.render_block(512) for _ in range(4)], axis=1)


def host_pool_render():
    _, scene, ctls, speeds, rng = build_host_pools(64, "cpu")
    r = pt.Renderer(scene, 48000)
    a = r.render_frames(512 * 6)
    feed(ctls, rng, 1024)
    speeds[0].set_speed(1.2)
    return np.concatenate([a, r.render_frames(512 * 6)])


@pytest.mark.parametrize("render,exact", [(mixer_render, True), (pack_render, True),
                                          (host_pool_render, False)])
def test_whole_renders_against_the_unfused_chains(monkeypatch, render, exact):
    new = render()
    with monkeypatch.context() as m:
        swap_unfused(m)
        old = render()
    assert np.isfinite(new).all() and np.abs(new).max() > 0.05
    if exact:
        np.testing.assert_array_equal(new, old)
    else:
        assert np.abs(new - old).max() <= 1e-5, np.abs(new - old).max()
