"""The port's ScenePack on (scene, voice) meshes larger than 1 x 1 against
the JAX package's per-scene Renderers: each of ``test_torch_pack.CASES``
on a logical CPU mesh that its scene count and capacities divide, held to
the case's bound against the JAX package (the PARITY.md 1e-5; 2e-5 for
the walk-tier scenes, as the JAX test holds its pack).  A file of its own
so that each file stays well inside a minute; the names avoid the JAX
tests' (``conftest.py`` marks tests slow by name)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import oddio_tpu as ot  # noqa: E402
import oddio_tpu_torch as pt  # noqa: E402

from test_torch_mesh import mesh_render  # noqa: E402
from test_torch_pack import CASES, renderers  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("name, shape", [
    ("spatial", (2, 4)), ("events", (1, 4)), ("clamped", (2, 2)), ("walk_tier", (2, 4)),
    ("growth", (2, 4)), ("sines48k", (2, 4)), ("bare_stream", (2, 4)), ("config5_mini", (2, 2)),
])
def test_mesh_pack_matches_jax_renderers(name, shape):
    case, _, tol = CASES[name]
    ref, _ = case(ot, renderers)
    got, _ = case(pt, mesh_render(shape))
    assert np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
