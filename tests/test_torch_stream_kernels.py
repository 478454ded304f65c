"""The port's stream ring kernels (oddio_tpu_torch/ops/stream_kernels.py)
against the JAX package's stream ingest and read, whose Pallas kernels
(``strip_place``, ``strip_resample``) run in interpret mode as its own
tests run them.

* K4 ``ring_place`` vs ``Stream._write_pool`` (row gather, strip_place,
  row scatter): exact (a copy), wrapping and non-wrapping writes, counts 0
  to the chunk width.
* K6 ``ring_resample`` vs ``Stream.render_batched``'s kernel read (row
  strip gather, strip_resample, the underrun mask): within 2 ulp of the
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

The CUDA kernels are held to these plain versions in test_torch_cuda.py.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import oddio_tpu as ot  # noqa: E402
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
        torch.tensor(ring).view(V, -1), torch.tensor(t), di, fh, fl,
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
        SK.ring_resample(ring, f4, i4, f4, f4, i4, i4, 5000)


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
