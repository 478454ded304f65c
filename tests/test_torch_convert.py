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


def test_port_mixer_continues_from_jax_mixer():
    """A JAX config-5 Mixer (streams mid-buffer, Adapt carries set, a
    closed stream, queued PCM) carried across with ``carry_mixer``: both
    render the same 8 blocks, with a write between them."""
    from test_torch_mixer import _jax_mixer_agc

    from oddio_tpu_torch.utils.convert import carry_mixer
    from oddio_tpu_torch.utils.scene_profile import build_mixer_agc, feed

    cj, mj, kj, rngj = _jax_mixer_agc(64)
    rj = ot.Renderer(mj, RATE)
    for b in range(5):
        if b == 2:
            feed(kj, rngj, 500)
            kj[1].close()
        rj.render_block(BLOCK)
    feed(kj, rngj, 300)  # still queued at the hand-over
    cp, mp, kp, rngp = build_mixer_agc(64, "cpu")
    carry_mixer(mj, mp)
    pool = next(iter(mp._pools.values()))
    assert pool._ingest_leaves[0]._dirty and not pool.pending_plays
    np.testing.assert_array_equal(
        state_to_numpy(mp.device_collect())["p0"]["inner"]["inner"]["ring"],
        np.asarray(mj.device_collect()["p0"]["inner"]["inner"]["ring"]),
    )
    rp = pt.Renderer(mp, RATE)
    pcm = np.random.default_rng(9)
    a, b = [], []
    for i in range(8):
        if i == 4:
            x = (pcm.standard_normal((len(kj), 200)) * 0.1).astype(np.float32)
            for cj_, cp_, row in zip(kj, kp, x):
                assert cj_.write(row) == cp_.write(row)
        a.append(rj.render_block(BLOCK))
        b.append(rp.render_block(BLOCK))
    a, b = np.concatenate(a), np.concatenate(b)
    assert np.abs(a).max() > 0.1
    assert np.abs(a - b).max() <= TOL, np.abs(a - b).max()
    for cj_, cp_ in zip(kj, kp):
        assert cj_.free() == cp_.free()


def _host_pool_scene(m):
    """Every host pool kind beside a device-resident stream pool: Speed
    (Stream) voices (host buffered pool), Sines with their own finish rule
    (host seek pool), a Mixer submix (singleton) and Adapt(Stream) voices
    (device-resident buffered pool), on seeded draws."""
    kw = {"device": "cpu"} if m is pt else {}

    class Finite(m.Sine):
        def host_is_finished(self):
            return np.asarray(self.phase) > 2.5

    rng = np.random.default_rng(12)
    control, scene = m.SpatialScene.new(**kw)
    ctls, speeds = [], []
    for _ in range(4):
        st = m.Stream(8000, 2528, max_write_per_block=2400)
        sc, sp = m.Speed.new(st)
        sc.set_speed(rng.uniform(0.8, 1.25))
        control.play_buffered(sp, m.SpatialOptions(position=rng.uniform(-8, 8, 3)),
                              max_distance=50.0, rate=RATE, buffer_duration=0.1)
        ctls.append(st.control)
        speeds.append(sc)
    for _ in range(2):
        st = m.Stream(8000, 2528, max_write_per_block=2400)
        control.play_buffered(m.Adapt(st, 0.1, m.AdaptOptions(tau=0.1, max_gain=4.0)),
                              m.SpatialOptions(position=rng.uniform(-8, 8, 3)),
                              max_distance=50.0, rate=RATE, buffer_duration=0.1)
        ctls.append(st.control)
    for _ in range(2):
        control.play(Finite(rng.uniform(0, 1), rng.uniform(100, 900)),
                     m.SpatialOptions(position=rng.uniform(-8, 8, 3)))
    mc, mixer = m.Mixer.new(channels=1, **kw)
    mc.play(m.Sine(0.0, 330.0))
    control.play_buffered(mixer, m.SpatialOptions(position=[2.0, 0.0, -1.0]),
                          max_distance=20.0, rate=RATE)
    for c in ctls:
        c.write((rng.standard_normal(2400) * 0.2).astype(np.float32))
    return scene, ctls, speeds


def test_port_continues_a_jax_host_pool_scene():
    """``carry_scene`` hands a JAX scene with host pools to the port after
    k blocks (the port's host side steps through the same preparations
    for its device-resident pool); both render the next blocks, with a
    write and a set_speed between them."""
    from oddio_tpu_torch.utils.convert import carry_scene

    k, more = 3, 5
    sj, cj, vj = _host_pool_scene(ot)
    sp, cp, vp = _host_pool_scene(pt)
    rj, rp = ot.Renderer(sj, RATE), pt.Renderer(sp, RATE)
    for _ in range(k):
        rj.render_block(BLOCK)
        sp.host_prepare(rp.interval, BLOCK)
    carry_scene(sj, sp)
    np.testing.assert_array_equal(
        sp._buffered_pools[next(iter(sp._buffered_pools))].ring.numpy().reshape(-1),
        np.asarray(sj.device_collect()["b0"]["ring"]).reshape(-1),
    )
    a, b = [], []
    for i in range(more):
        if i == 2:
            pcm = (np.random.default_rng(3).standard_normal(500) * 0.2).astype(np.float32)
            for c in (cj[0], cp[0], cj[4], cp[4]):
                c.write(pcm)
            vj[1].set_speed(1.1)
            vp[1].set_speed(1.1)
        a.append(rj.render_block(BLOCK))
        b.append(rp.render_block(BLOCK))
    a, b = np.concatenate(a), np.concatenate(b)
    assert np.abs(a).max() > 1e-3
    assert np.abs(a - b).max() <= TOL, np.abs(a - b).max()
    assert [c.free() for c in cj] == [c.free() for c in cp]


def test_port_pack_continues_from_jax_pack():
    """A JAX ScenePack of two config-5 mini mixers (Adapt(Stream) and
    Adapt(Sine) voices) renders 3 blocks; ``carry_pack`` hands its carried
    state, with PCM still queued, to a port pack of the same scenes; both
    render the next 5 blocks with a write between them."""
    from oddio_tpu.parallel.mesh import make_mesh as jax_mesh
    from oddio_tpu.parallel.sharded import ScenePack as JaxPack
    from test_torch_pack import PCM, config5_mini

    from oddio_tpu_torch.parallel.mesh import make_mesh
    from oddio_tpu_torch.parallel.sharded import ScenePack
    from oddio_tpu_torch.utils.convert import carry_pack

    def build(m):
        scenes, ctls = zip(*[config5_mini(m, s) for s in range(2)])
        return list(scenes), [c for group in ctls for c in group]

    sj, cj = build(ot)
    jp = JaxPack(sj, 8000, jax_mesh(1, 1))
    for c, x in zip(cj, PCM):
        c.write(x)
    for _ in range(3):
        jp.render_block(512)
    for c, x in zip(cj, PCM):
        c.write(x[:300])  # still queued at the hand-over
    sp, cp = build(pt)
    pp = ScenePack(sp, 8000, make_mesh(1, 1))
    carry_pack(jp, pp)
    a, b = [], []
    for i in range(5):
        if i == 2:
            for c1, c2, x in zip(cj, cp, PCM):
                assert c1.write(x[:400]) == c2.write(x[:400])
        a.append(jp.render_block(512))
        b.append(pp.render_block(512))
    a, b = np.concatenate(a, axis=1), np.concatenate(b, axis=1)
    assert a.shape == b.shape == (2, 2560, 1)
    assert np.abs(a).max() > 0.05
    assert np.abs(a - b).max() <= TOL, np.abs(a - b).max()
    assert [c.free() for c in cj] == [c.free() for c in cp]
