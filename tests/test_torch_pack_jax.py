"""The port's ScenePack against the JAX package's per-scene Renderers on the
spatial cases of ``test_torch_pack.CASES`` (the JAX package's
``tests/test_sharding.py`` scenes at a 1 x 1 mesh).  Bound: the PARITY.md
1e-5 (2e-5 for the walk-tier scenes, as the JAX test holds its pack).  A
file of its own so that each file stays well inside a minute."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import oddio_tpu as ot  # noqa: E402
import oddio_tpu_torch as pt  # noqa: E402

from test_torch_pack import CASES, pack, renderers  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["clamped", "events", "growth", "spatial", "walk_tier"])
def test_pack_spatial_matches_jax_renderers(name):
    case, _, tol = CASES[name]
    ref, _ = case(ot, renderers)
    got, _ = case(pt, pack)
    assert np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
