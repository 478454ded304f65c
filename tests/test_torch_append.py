"""K1's cursor form (``ring_kernels.rows_append_cursor``) and the checks
of the slab-append wrappers (K1 ``rows_append``, K9
``flat_append_aligned``), on the CPU against the JAX package.

* The rows the cursor form derives equal the JAX package's
  ``(FP + start_i) // 128`` and ``(FP + where(start_i < M, start_i + cap,
  cap + M)) // 128`` (oddio_tpu/spatial.py, beside ``rows_append_dma``).
* The cursor form equals the interpreted ``rows_append_dma`` fed those
  rows, exactly (a copy), per scene.
* The buffered pool, which now appends through the cursor form, renders
  bit for bit as it did with the rows derived beside the call.
* Bad shapes, dtypes and legs still raise.

The CUDA kernels are held to these plain versions in test_torch_cuda.py.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import oddio_tpu_torch as pt  # noqa: E402
import oddio_tpu_torch.spatial as SP  # noqa: E402
from oddio_tpu.ops import pallas_ring as PR  # noqa: E402
from oddio_tpu_torch.ops import flat_kernels as FK  # noqa: E402
from oddio_tpu_torch.ops import ring_kernels as RK  # noqa: E402
from oddio_tpu_torch.utils.scene_profile import build_spatial, build_spatial_pack  # noqa: E402

torch.set_num_threads(1)

#: the buffered pool's front pad and mirror (spatial.py W_CHUNK, M_PAD)
FP, M = 1024, 1024
CAP = 4096
RPV = (FP + CAP + M + 1024) // 128

#: write cursors at the edges of the where: 0, M - 1, M, cap - 1
EDGES = {"zero": 0, "m_minus_1": M - 1, "m": M, "cap_minus_1": CAP - 1, "random": None}


def _starts(case, S, rng):
    start = rng.integers(0, CAP, S).astype(np.int32)
    if EDGES[case] is not None:
        start[0] = EDGES[case]
    return start


def _jax_rows(start):
    """The JAX package's rows, as ``_BufferedPoolDR`` derives them."""
    start_i = jnp.asarray(start, jnp.int32)
    r0 = (FP + start_i) // 128
    rm = (FP + jnp.where(start_i < M, start_i + CAP, CAP + M)) // 128
    return np.asarray(r0), np.asarray(rm)


@pytest.mark.parametrize("case", sorted(EDGES))
@pytest.mark.parametrize("S", [1, 16])
def test_cursor_rows_match_jax(S, case):
    start = _starts(case, S, np.random.default_rng(S))
    r0, rm = RK.cursor_rows(torch.tensor(start), FP, CAP, M)
    assert r0.dtype == torch.int32 and rm.dtype == torch.int32
    want = _jax_rows(start)
    np.testing.assert_array_equal(r0.numpy(), want[0])
    np.testing.assert_array_equal(rm.numpy(), want[1])


@pytest.mark.parametrize("S", [1, 16])
def test_cursor_form_matches_pallas(S):
    """The cursor form writes every scene's voices at its own cursor's
    rows, equal to the interpreted ``rows_append_dma`` on each scene; the
    slab is 512 frames of a 513-frame render, as the pool hands it; the
    CPU runs the plain version and counts no launch."""
    rng = np.random.default_rng(20 + S)
    Vs = 3
    ring = rng.standard_normal((S * Vs, RPV, 128)).astype(np.float32)
    samples = rng.standard_normal((S * Vs, 513)).astype(np.float32)
    start = _starts("m_minus_1" if S == 1 else "random", S, rng)
    before = dict(RK.LAUNCHES)
    got = RK.rows_append_cursor(torch.tensor(ring), torch.tensor(samples)[:, :512],
                                torch.tensor(start), FP, CAP, M).numpy()
    assert RK.LAUNCHES == before
    r0, rm = _jax_rows(start)
    for s in range(S):
        rows = slice(s * Vs, (s + 1) * Vs)
        ref = np.asarray(PR.rows_append_dma(
            jnp.asarray(ring[rows]), jnp.asarray(samples[rows, :512]), r0[s], rm[s],
            interpret=True))
        np.testing.assert_array_equal(got[rows], ref)


def _rows_beside_the_call(ring, slab, start_i, FP_, cap, M_):
    """The append as the pool made it before the cursor form: the rows
    derived by eager ops beside the call, then K1's row form."""
    r0 = torch.div(FP_ + start_i, 128, rounding_mode="floor")
    rm = torch.div(FP_ + torch.where(start_i < M_, start_i + cap, cap + M_), 128,
                   rounding_mode="floor")
    return RK.rows_append(ring, slab, r0, rm)


def _render(scene_kind, nblocks):
    if scene_kind == "buffered":
        _, scene = build_spatial(True, 24, "cpu")
        return pt.Renderer(scene, 48000).render_frames(512 * nblocks)
    pack = build_spatial_pack(3, "cpu", 8, 8)
    return np.concatenate([pack.render_block(512) for _ in range(nblocks)], axis=1)


@pytest.mark.parametrize("scene_kind", ["buffered", "spatial_pack"])
def test_buffered_pool_renders_as_before_the_cursor_form(scene_kind, monkeypatch):
    """A 24-voice buffered scene (multi-block groups included) and a
    3-scene spatial pack render bit for bit as with the rows derived
    beside the call, and the pool does append through the cursor form."""
    calls = []
    cursor = SP.rows_append_cursor

    def counted(*args):
        calls.append(args[2].shape)
        return cursor(*args)

    monkeypatch.setattr(SP, "rows_append_cursor", counted)
    now = _render(scene_kind, 12)
    assert calls and np.abs(now).max() > 1e-3
    monkeypatch.setattr(SP, "rows_append_cursor", _rows_beside_the_call)
    before = _render(scene_kind, 12)
    np.testing.assert_array_equal(now, before)


def _ring3(V=24, dtype=torch.float32):
    return torch.zeros((V, RPV, 128), dtype=dtype)


BAD = {
    "cursor_float_start": (lambda: RK.rows_append_cursor(
        _ring3(), torch.zeros((24, 512)), torch.zeros(1), FP, CAP, M), TypeError),
    "cursor_2d_start": (lambda: RK.rows_append_cursor(
        _ring3(), torch.zeros((24, 512)), torch.zeros((1, 1), dtype=torch.int32), FP, CAP, M),
        ValueError),
    "cursor_scene_count": (lambda: RK.rows_append_cursor(
        _ring3(), torch.zeros((24, 512)), torch.zeros(5, dtype=torch.int32), FP, CAP, M),
        ValueError),
    "cursor_width": (lambda: RK.rows_append_cursor(
        _ring3(), torch.zeros((24, 500)), torch.zeros(1, dtype=torch.int32), FP, CAP, M),
        ValueError),
    "rows_dtype": (lambda: RK.rows_append(
        _ring3(dtype=torch.float64), torch.zeros((24, 512), dtype=torch.float64), 0, 1),
        TypeError),
    "rows_too_wide": (lambda: RK.rows_append(
        _ring3(), torch.zeros((24, 128 * (RPV + 1))), 0, 0), ValueError),
    "rows_voices": (lambda: RK.rows_append(_ring3(), torch.zeros((23, 512)), 0, 8), ValueError),
    "rows_ring_lanes": (lambda: RK.rows_append(
        torch.zeros((24, RPV, 64)), torch.zeros((24, 512)), 0, 8), ValueError),
    "rows_scene_counts": (lambda: RK.rows_append(
        _ring3(), torch.zeros((24, 512)), torch.zeros(4, dtype=torch.int32), 8), ValueError),
    "rows_leg_outside": (lambda: RK.rows_append(
        _ring3(), torch.zeros((24, 512)), 0, RPV - 3), IndexError),
    "flat_width": (lambda: FK.flat_append_aligned(
        torch.zeros((8, 4096)), torch.zeros((8, 640)), 0, 2), ValueError),
    "flat_dtype": (lambda: FK.flat_append_aligned(
        torch.zeros((8, 4096), dtype=torch.float64), torch.zeros((8, 512)), 0, 2), TypeError),
    "flat_pair_shape": (lambda: FK.flat_append_aligned(
        torch.zeros((8, 4096)), torch.zeros((8, 512)), torch.tensor([0, 2, 4], dtype=torch.int32)),
        ValueError),
    "flat_page_outside": (lambda: FK.flat_append_aligned(
        torch.zeros((8, 4096)), torch.zeros((8, 512)), 0, 8), IndexError),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_append_wrappers_reject_bad_operands(case):
    call, err = BAD[case]
    with pytest.raises(err):
        call()
