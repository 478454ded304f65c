"""The 1 x 1 host-pool ScenePack's block steps on the CPU against the JAX
ScenePack: two scenes of ``test_torch_graph_host.py``'s host-pool scene
(host Speed(Stream) voices, device-resident Adapt(Stream) voices, a
config-5 submix) through the first calls of its script (plays, idle
blocks, a control block, PCM, writes and a close between two blocks of
one call), at ``scan_unroll`` 1 and 8, within PARITY.md's 1e-5.  Apart
from ``test_torch_graph_host.py`` because each JAX program of the pack
compiles for seconds on the CPU.  Test names avoid the JAX tests'
(``conftest.py`` marks tests slow by name).
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import oddio_tpu as ot  # noqa: E402
import oddio_tpu_torch as pt  # noqa: E402
from test_torch_graph_host import JAX_CALLS, TOL, render_case  # noqa: E402

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _jax_pack():
    return render_case("pack", ot, calls=JAX_CALLS)[0]


@pytest.mark.parametrize("unroll", [1, 8])
def test_host_pool_pack_steps_match_jax_pack(unroll):
    got, pack, _ = render_case("pack", pt, unroll, calls=JAX_CALLS)
    want = _jax_pack()
    assert pack.graph_capture and pack._steps and pack.graph_counts["replays"] == 0
    assert got.shape == want.shape and np.abs(want).max() > 0.02
    assert np.abs(got - want).max() <= TOL, np.abs(got - want).max()
