"""State carried across: the JAX scene renders k blocks, its device state
moves into the port with ``state_from_numpy``, and the port renders the
next blocks from it.  Both host sides are built by the same control script
(the port's host side steps through the same k block preparations)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import oddio_tpu as ot  # noqa: E402
import oddio_tpu_torch as pt  # noqa: E402
from oddio_tpu_torch.utils.convert import state_from_numpy, state_to_numpy  # noqa: E402

from test_torch_spatial import BLOCK, RATE, TOL, build_entry  # noqa: E402

torch.set_num_threads(1)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def test_state_roundtrip_keeps_keys_and_dtypes():
    _, sj, _ = build_entry(ot, 16, 8)
    ot.Renderer(sj, RATE).render_block(BLOCK)
    tree = jax.device_get(sj.device_collect())
    back = state_to_numpy(state_from_numpy(tree))
    a, b = dict(_leaves(tree)), dict(_leaves(back))
    assert a.keys() == b.keys()
    for k in a:
        x, y = np.asarray(a[k]), b[k]
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y)


def test_port_continues_from_jax_state():
    k, more = 5, 6
    cj, sj, hj = build_entry(ot)
    rj = ot.Renderer(sj, RATE)
    cp, sp, hp = build_entry(pt)
    rp = pt.Renderer(sp, RATE)
    for i in range(k):
        if i == 2:  # a delta block inside the carried history
            for h in (hj[1], hp[1]):
                h.set_motion([4.0, 0.0, -6.0], [0.0, 3.0, 0.0], False)
        rj.render_block(BLOCK)
        sp.host_prepare(rp.interval, BLOCK)  # the port's host side only

    tree = jax.device_get(sj.device_collect())
    sp.device_store(state_from_numpy(tree))
    ring = tree["b0"]["ring"]
    np.testing.assert_array_equal(state_to_numpy(sp.device_collect())["b0"]["ring"], ring)

    for h in (hj[70], hp[70]):  # and a delta after the hand-over
        h.set_motion([-3.0, 1.0, 2.0], [1.0, 0.0, 0.0], True)
    a = np.concatenate([rj.render_block(BLOCK) for _ in range(more)])
    b = np.concatenate([rp.render_block(BLOCK) for _ in range(more)])
    assert np.abs(a).max() > 1e-3
    assert np.abs(a - b).max() <= TOL, np.abs(a - b).max()
    after = jax.device_get(sj.device_collect())
    np.testing.assert_allclose(
        state_to_numpy(sp.device_collect())["b0"]["ring"], after["b0"]["ring"],
        rtol=0, atol=TOL,
    )
