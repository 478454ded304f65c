"""The port's stream ring kernels (oddio_tpu_torch/ops/stream_kernels.py)
against the JAX package's stream ingest and read, whose Pallas kernels
(``strip_place``, ``strip_resample``) run in interpret mode as its own
tests run them.

* K4 ``ring_place`` vs ``Stream._write_pool`` (row gather, strip_place,
  row scatter): exact (a copy), wrapping and non-wrapping writes, counts 0
  to the chunk width, one and two channels (the kernel's channel map);
  its record form vs the JAX host buffered pool's strip write, exact.
* K6 ``ring_resample`` (the step split inside) vs ``Stream.render_batched``'s
  kernel read (row strip gather, strip_resample, the underrun mask):
  within 2 ulp of the
  lerp's larger operand, over ds tiers 1/2/4, negative read offsets, ring
  wraps and ``len`` cuts mid-block.  Both evaluate the same f32 position
  math op for op, so they read the same samples at the same fractions: the
  JAX output equals, bit for bit, the port's samples and fractions put
  through a fused lerp.  The interpreted kernel's XLA:CPU program contracts
  ``a + fr*(b - a)`` into a fused multiply-add (ROADMAP R7), which the
  port's eager torch and its CUDA kernel (``--fmad=false``) round in two
  steps; that is the whole difference: at most ulp(max(|a|, |b|)) for a
  read offset in [0, 1), twice that for the extrapolating negative ones
  (|fr*(b - a)| up to 2 max(|a|, |b|)).
* K6's DR form ``stream_step`` (read and cursor release in one launch):
  its plain version bit for bit against the unfused chain (``rate*iv``,
  ``device_split_ds``, the split-operand read, the torch release), the
  release against the host mirror ``Stream._tick_math`` in numpy, and the
  wrappers' refusals.

The CUDA kernels are held to these plain versions in test_torch_cuda.py.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import oddio_tpu as ot  # noqa: E402
import oddio_tpu_torch as pt  # noqa: E402
from oddio_tpu_torch.ops import stream_kernels as SK  # noqa: E402
from oddio_tpu_torch.ops._dev import device_split_ds  # noqa: E402

torch.set_num_threads(1)

V = 8


def _wpos(rng, size_pad, mw):
    """Half the voices write across the ring's end, half inside it."""
    wrap = rng.integers(size_pad - mw + 1, size_pad, V // 2)
    inside = rng.integers(0, size_pad - mw, V - V // 2)
    return np.concatenate([wrap, inside]).astype(np.int32)


@pytest.mark.parametrize("size,mw", [(64, 16), (2528, 2401)])
def test_ring_place_matches_write_pool(size, mw):
    rng = np.random.default_rng(mw)
    js = ot.Stream(8000, size, max_write_per_block=mw - 1)
    assert js.max_write + 1 == mw
    R = js.size_pad // 128
    ring = rng.standard_normal((V, R, 128)).astype(np.float32)
    chunk = rng.standard_normal((V, 1, mw)).astype(np.float32)
    wpos = _wpos(rng, js.size_pad, mw)
    wcount = rng.integers(0, mw + 1, V).astype(np.int32)
    wcount[0], wcount[-1] = 0, mw
    ref = np.asarray(js._write_pool(jnp.asarray(ring), {
        "chunk": jnp.asarray(chunk), "wpos": jnp.asarray(wpos),
        "wcount": jnp.asarray(wcount),
    }))
    got = torch.tensor(ring)
    before = SK.LAUNCHES["ring_place"]
    SK.ring_place(got.view(V, -1), torch.tensor(chunk[:, 0]),
                  torch.tensor(wpos), torch.tensor(wcount))
    assert SK.LAUNCHES["ring_place"] == before  # the plain version launches nothing
    np.testing.assert_array_equal(got.numpy(), ref)
    # count-0 rows keep their history; others changed exactly where written
    np.testing.assert_array_equal(ref[0], ring[0])


@pytest.mark.parametrize("size,mw", [(64, 16), (2528, 2401)])
def test_stream_ingest_two_channels_matches_write_pool(size, mw):
    """A two-channel stream pool's ingest: K4 maps each voice's cursor and
    count to its two channel rows itself (``channels=2``), exactly as the
    JAX package's row gather, strip_place and scatter place them."""
    from oddio_tpu_torch.ops.stream import Stream

    rng = np.random.default_rng(mw + 2)
    js = ot.Stream(8000, size, max_write_per_block=mw - 1, channels=2)
    ps = Stream(8000, size, max_write_per_block=mw - 1, channels=2)
    assert ps.size_pad == js.size_pad and js.max_write + 1 == mw
    R = js.size_pad // 128
    ring = rng.standard_normal((V, 2 * R, 128)).astype(np.float32)
    chunk = rng.standard_normal((V, 2, mw)).astype(np.float32)
    wpos = _wpos(rng, js.size_pad, mw)
    wcount = rng.integers(0, mw + 1, V).astype(np.int32)
    wcount[0], wcount[-1] = 0, mw
    ref = np.asarray(js._write_pool(jnp.asarray(ring), {
        "chunk": jnp.asarray(chunk), "wpos": jnp.asarray(wpos),
        "wcount": jnp.asarray(wcount),
    }))
    got = torch.tensor(ring)
    ps._write(got, torch.tensor(chunk), torch.tensor(wpos), torch.tensor(wcount))
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(ref[0], ring[0])


@pytest.mark.parametrize("L", [1024, 16384])
def test_ring_place_record_matches_host_pool_strip_place(L):
    """K4's record form, as the host buffered pool writes its rings: the
    513-frame render placed at ``128*wrow + extra_w`` for ``n_write`` (512
    or 513) frames, half the voices' writes crossing the ring's end,
    exactly as the JAX package's host pool does it (oddio_tpu/spatial.py:
    520-530: row strips from ``wrow``, strip_place at ``extra_w``, rows
    scattered back)."""
    from oddio_tpu.ops import pallas_ring as PR
    from oddio_tpu_torch.ops import ring_kernels as RK

    rng = np.random.default_rng(L)
    mw, rpv = 513, L // 128
    ring = rng.standard_normal((V, L)).astype(np.float32)
    samples = rng.standard_normal((V, mw)).astype(np.float32)
    wrow = np.where(np.arange(V) % 2, rpv - 1 - rng.integers(0, 3, V),
                    rng.integers(0, rpv - 5, V)).astype(np.int32)
    extra_w = rng.integers(0, 128, V).astype(np.int32)
    n_write = rng.integers(mw - 1, mw + 1, V).astype(np.int32)
    assert ((128 * wrow + extra_w + n_write) > L).sum() >= V // 2  # writes wrap
    n_rows = (127 + mw - 1) // 128 + 1
    rows = (wrow[:, None] + np.arange(n_rows)) % rpv
    strips = np.stack([ring[v].reshape(rpv, 128)[rows[v]].reshape(-1) for v in range(V)])
    placed = np.asarray(PR.strip_place(jnp.asarray(strips), jnp.asarray(samples),
                                       jnp.asarray(extra_w), jnp.asarray(n_write),
                                       interpret=True))
    ref = ring.copy()
    for v in range(V):
        ref[v].reshape(rpv, 128)[rows[v]] = placed[v].reshape(n_rows, 128)
    z2 = np.zeros((V, 2), np.float32)
    rec = RK.voice_record(np.zeros(V, np.int32), np.zeros((V, 2), np.int32),
                          np.zeros((V, 2, 4), np.float32), z2, z2, np.zeros(V, np.float32),
                          wrow, extra_w, n_write)
    got = torch.tensor(ring)
    before = SK.LAUNCHES["ring_place"]
    SK.ring_place_record(got, torch.tensor(samples), torch.tensor(rec))
    assert SK.LAUNCHES["ring_place"] == before  # the plain version launches nothing
    np.testing.assert_array_equal(got.numpy(), ref)


def _read_case(rng, size_pad, n, ds, t_lo):
    t = rng.uniform(t_lo, 1.0, V).astype(np.float32)
    start = rng.integers(0, size_pad, V).astype(np.int32)
    start[:2] = size_pad - rng.integers(1, 64, 2)  # reads wrap the ring
    need = np.ceil(n * ds).astype(np.int32) + 2
    len_ = need.copy()
    len_[2:5] = (need[2:5] * rng.uniform(0.2, 0.9, 3)).astype(np.int32)  # cut
    len_[5] = 0
    return t, start, len_


@pytest.mark.parametrize("tier,ds_range", [(1, (0.1, 1.0)), (2, (1.0, 2.0)), (4, (2.0, 4.0))])
@pytest.mark.parametrize("t_lo", [0.0, -0.99])
def test_ring_resample_matches_strip_resample(tier, ds_range, t_lo):
    rng = np.random.default_rng(tier * 10 + int(t_lo < 0))
    n = 512
    js = ot.Stream(8000, 2528, max_write_per_block=2400)
    js._pool_ds_tier = tier
    R = js.size_pad // 128
    ring = rng.standard_normal((V, R, 128)).astype(np.float32)
    ds = rng.uniform(*ds_range, V).astype(np.float32)
    ds[0] = np.float32(8000.0) / np.float32(48000.0)
    ds = np.minimum(ds, np.float32(ds_range[1]))
    t, start, len_ = _read_case(rng, js.size_pad, n, ds, t_lo)
    params = {k: jnp.asarray(v) for k, v in
              (("t", t), ("ds", ds), ("len", len_), ("start", start))}
    _, ref = js.render_batched({"ring": jnp.asarray(ring)}, {}, params, n)
    ref = np.asarray(ref)[:, 0]
    di, fh, fl = device_split_ds(torch.tensor(ds))
    got = SK.ring_resample(
        torch.tensor(ring).view(V, -1), torch.tensor(t), torch.tensor(ds),
        torch.tensor(start), torch.tensor(len_), n,
    ).numpy()
    assert np.abs(ref).max() > 0.1
    # the port's read positions, fractions and mask, through a fused lerp
    whole, p, fr = SK._positions(torch.tensor(t), di, fh, fl, n)
    flat = ring.reshape(V, -1)
    idx = (start[:, None].astype(np.int64) + p.numpy()) % js.size_pad
    a = np.take_along_axis(flat, idx, 1).astype(np.float64)
    b = np.take_along_axis(flat, (idx + 1) % js.size_pad, 1).astype(np.float64)
    d = (b - a).astype(np.float32).astype(np.float64)
    fused = (a + fr.numpy().astype(np.float64) * d).astype(np.float32)
    np.testing.assert_array_equal(
        ref, np.where(whole.numpy() < len_[:, None], fused, 0.0)
    )
    ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float32))
    assert (np.abs(got - ref) <= (2 if t_lo < 0 else 1) * ulp).all()
    assert (got[5] == 0).all()  # len 0: silence


def test_wrappers_reject_bad_operands():
    ring = torch.zeros((4, 512))
    i4 = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        SK.ring_place(ring, torch.zeros((4, 600)), i4, i4)  # wider than the ring
    with pytest.raises(TypeError):
        SK.ring_place(ring, torch.zeros((4, 16)), i4.long(), i4)
    f4 = torch.zeros(4)
    with pytest.raises(ValueError):
        SK.ring_resample(ring, f4, f4, i4, i4, 5000)


def test_build_covers_and_hashes_every_source(tmp_path, monkeypatch):
    """Every csrc/*.cu has bound entry points, and a change to any source
    renames every library (so no stale library loads beside a newer
    wrapper)."""
    from oddio_tpu_torch.ops import _build

    names = _build.sources()
    assert set(names) == set(_build._SIGNATURES) >= {"stream_kernels", "agc_kernel"}
    for name in names:
        (tmp_path / f"{name}.cu").write_text("// " + name)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    tag = _build._tag()
    (tmp_path / f"{names[0]}.cu").write_text("// changed")
    assert _build._tag() != tag


# --- K6's DR form: the Stream step ------------------------------------------------


def _unfused_read(ring, t, ds_int, f_hi, f_lo, start, len_, n):
    """The read with the step split passed as separate operands."""
    size = ring.shape[1]
    whole, p, fr = SK._positions(t, ds_int, f_hi, f_lo, n)
    idx = torch.remainder(start.to(torch.int64)[:, None] + p, size)
    a = torch.gather(ring, 1, idx)
    b = torch.gather(ring, 1, torch.remainder(idx + 1, size))
    return torch.where(whole < len_[:, None], a + fr * (b - a), 0.0)


def _unfused_step(ring, state, interval, n, count, size_pad):
    """``Stream.dr_render``'s unfused chain on the kernel route: the step
    ``rate*iv`` split on the device, the read, then the release."""
    iv = float(np.float32(interval))
    ds_int, f_hi, f_lo = device_split_ds(state["rate"] * iv)
    samp = _unfused_read(ring, state["t"], ds_int, f_hi, f_lo, state["start"],
                        state["len"], n)
    cf = count.to(torch.float32)
    nxt = state["t"] + (cf * iv) * state["rate"]
    tc = torch.minimum(nxt, state["len"].to(torch.float32))
    released = torch.trunc(tc).to(torch.int32)
    return (samp, tc - released.to(torch.float32), state["len"] - released,
            torch.remainder(state["start"] + released, size_pad))


def _step_state(rng, size_pad, n, rates, interval):
    t = rng.uniform(-0.5, 1.0, V).astype(np.float32)
    t[:6] = 0.0  # row 5 (len 0) reads no frame
    ds = (rates * np.float32(interval)).astype(np.float32)
    start = rng.integers(0, size_pad, V).astype(np.int32)
    start[:2] = size_pad - rng.integers(1, 64, 2)
    need = np.ceil(n * ds).astype(np.int32) + 2
    len_ = need.copy()
    len_[2:5] = (need[2:5] * rng.uniform(0.2, 0.9, 3)).astype(np.int32)
    len_[5] = 0
    return {"t": torch.tensor(t), "rate": torch.tensor(rates), "start": torch.tensor(start),
            "len": torch.tensor(len_)}


@pytest.mark.parametrize("rate_hz", [8000.0, 48000.0, 192000.0])
@pytest.mark.parametrize("count_form", ["voice", "scalar"])
def test_stream_step_plain_equals_unfused_chain_and_host_mirror(rate_hz, count_form):
    rng = np.random.default_rng(int(rate_hz) + len(count_form))
    n, size_pad, interval = 513, 2816, np.float32(1.0 / 48000.0)
    rates = (rate_hz * rng.uniform(0.95, 1.0, V)).astype(np.float32)
    rates[0] = np.float32(rate_hz)
    st = _step_state(rng, size_pad, n, rates, interval)
    ring = torch.tensor(rng.standard_normal((V, size_pad)).astype(np.float32))
    if count_form == "voice":
        count = torch.tensor(rng.integers(n - 1, n + 1, V).astype(np.int32))
    else:
        count = torch.tensor(n, dtype=torch.int32)
    before = SK.LAUNCHES["ring_resample"]
    got = SK.stream_step(ring, st["t"], st["rate"], float(interval), count, st["start"],
                         st["len"], n)
    assert SK.LAUNCHES["ring_resample"] == before  # the plain version launches nothing
    want = _unfused_step(ring, st, interval, n, count, size_pad)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert np.abs(got[0].numpy()).max() > 0.1 and (got[0][5] == 0).all()
    # the release against the host mirror's numpy arithmetic
    host_m = pt.Stream(8000, 2528)  # only its cursor mirror is used
    host_m._alloc_host((V,))
    host_m.size_pad = size_pad
    host_m.rate = rates.astype(np.float64)
    host_m.t = st["t"].numpy().copy()
    host_m.buflen = st["len"].numpy().copy()
    host_m.start = st["start"].numpy().copy()
    host_m._tick_math(interval, np.broadcast_to(count.numpy(), (V,)).astype(np.int32))
    np.testing.assert_array_equal(got[1].numpy(), host_m.t)
    np.testing.assert_array_equal(got[2].numpy(), host_m.buflen)
    np.testing.assert_array_equal(got[3].numpy(), host_m.start)


def test_stream_step_rejects_bad_operands():
    ring = torch.zeros((4, 512))
    f4, i4 = torch.zeros(4), torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):  # int64 count
        SK.stream_step(ring, f4, f4, 0.1, i4.long(), i4, i4, 128)
    with pytest.raises(ValueError):  # count of another length
        SK.stream_step(ring, f4, f4, 0.1, torch.zeros(3, dtype=torch.int32), i4, i4, 128)
    with pytest.raises(TypeError):  # f64 rate
        SK.stream_step(ring, f4, f4.double(), 0.1, i4, i4, i4, 128)
    with pytest.raises(ValueError):  # n past the exact split products
        SK.stream_step(ring, f4, f4, 0.1, i4, i4, i4, 4097)
    with pytest.raises(TypeError):  # a tensor interval
        SK.stream_step(ring, f4, f4, f4, i4, i4, i4, 64)
    with pytest.raises(ValueError):  # a (3,) ds
        SK.ring_resample(ring, f4, torch.zeros(3), i4, i4, 128)
