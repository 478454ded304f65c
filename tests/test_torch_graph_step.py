"""The port's Renderer block step (core/run.py) on the CPU, against the JAX
package's Renderer.

A SpatialScene whose pools are all device-resident with Sine voices
declares ``graph_capture``: its Renderer packs each block's params into one
float32 row, keeps one block step per ``(archetype, kind, pack spec)`` key
and runs it through the static-state protocol (rebuilt leaves copied back,
in-place leaves kept, audio copied out per call).  On a card the step is a
CUDA graph; here the same step runs uncaptured, so these tests hold the
code that is captured there: the row against the JAX package's
``_pack_row`` bit for bit, the audio against the JAX Renderer within the
PARITY.md 1e-5 (they differ by XLA:CPU's fused multiply-adds and the
order of the voice sums, as in test_torch_spatial.py), the step keys
against the JAX Renderer's compiled-program keys, the step against
``eager()`` bit for bit, and a replay emulated by running each call on the
host object frozen at its step's first call.  Sine voices never finish,
so these scenes have no stops; their control traffic is plays, motion and
listener rotation.  Test names avoid the JAX tests' (``conftest.py``
marks tests slow by name).
"""

import contextlib
import copy
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import __graft_entry__ as entry  # noqa: E402
import oddio_tpu as ot  # noqa: E402
import oddio_tpu_torch as pt  # noqa: E402
from oddio_tpu.core import run as jrun  # noqa: E402
from oddio_tpu_torch.core import run as prun  # noqa: E402
from oddio_tpu_torch.core.drctrl import drop_lanes, scatter_drop_  # noqa: E402
from oddio_tpu_torch.parallel.context import in_block_step  # noqa: E402
from oddio_tpu_torch.utils.tree import tree_flatten, tree_leaves, tree_map  # noqa: E402
from test_torch_spatial import BLOCK, RATE, TOL, build_entry  # noqa: E402

torch.set_num_threads(1)


# -- (a) the packed row --------------------------------------------------------------


def _entry_params():
    """The params of three blocks of the entry scene (64 buffered, 32 seek
    Sine voices; ``__graft_entry__._build_scene`` in the JAX package, its
    script in the port) rendered by each package's Renderer: the first
    block (a forced delta block after the bulk plays), an idle block, and
    a block with three plays and two set_motion deltas."""
    out = []
    cj, sj = entry._build_scene()
    cp, sp, _ = build_entry(pt)
    for control, scene, m in ((cj, sj, ot), (cp, sp, pt)):
        r = m.Renderer(scene, RATE)
        blocks = []
        prepare = scene.host_prepare

        def spy(*a, _prepare=prepare, _blocks=blocks, **kw):
            _blocks.append(_prepare(*a, **kw))
            return _blocks[-1]

        scene.host_prepare = spy
        r.render_block(BLOCK)
        r.render_block(BLOCK)
        rng = np.random.default_rng(2)
        hs = []
        for _ in range(2):
            hs.append(control.play_buffered(
                m.Sine(rng.uniform(0, 6), rng.uniform(100, 2000)),
                m.SpatialOptions(position=rng.uniform(-30, 30, 3)),
                max_distance=50.0, rate=RATE, buffer_duration=0.1))
        hs.append(control.play(m.Sine(0.3, 440.0), m.SpatialOptions(position=[2.0, 0.0, 1.0])))
        for h in hs[:2]:
            h.set_motion(rng.uniform(-10, 10, 3), rng.uniform(-3, 3, 3), False)
        r.render_block(BLOCK)
        out.append(blocks)
    return out


@functools.lru_cache(maxsize=None)
def _entry_rows():
    jp, pp = _entry_params()
    return [(j, p) for j, p in zip(jp, pp)]


def _offsets(paths_shapes):
    """{path: (offset, size)} of each leaf in a packed row."""
    out, off = {}, 0
    for path, shape in paths_shapes:
        size = int(np.prod(shape, dtype=np.int64))
        out[path] = (off, size)
        off += size
    return out


def _paths(tree, pre=()):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], pre + (k,))]
    return [pre]


@pytest.mark.parametrize("block", [0, 1, 2], ids=["first", "idle", "plays_and_motion"])
def test_packed_row_matches_jax(block):
    """Every leaf the JAX package packs sits in the port's row bit for bit
    (the port's row adds the voice cursors ``vcur``/``vbase`` of its play
    rows, a leaf the JAX package does not have)."""
    jp, pp = _entry_rows()[block]
    assert prun._pack_spec(pp) is not None and jrun._pack_spec(jp) is not None
    jrow = jrun._pack_row(jp)
    prow = prun._pack_row(pp)
    assert prow.dtype == np.float32
    jleaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    jpaths = [tuple(k.key for k in path) for path, _ in jleaves]
    joff = _offsets([(p, np.shape(x)) for p, (_, x) in zip(jpaths, jleaves)])
    pleaves = tree_flatten(pp)[0]
    poff = _offsets([(p, np.shape(x)) for p, x in zip(_paths(pp), pleaves)])
    assert set(joff) <= set(poff)
    assert len(jrow) == sum(s for _, s in joff.values())
    for path, (o, s) in joff.items():
        po, ps = poff[path]
        assert ps == s, path
        np.testing.assert_array_equal(prow[po:po + ps].view(np.uint32),
                                      jrow[o:o + s].view(np.uint32), err_msg=str(path))
    if block == 2:
        idx = np.asarray(pp["b0"]["play_idx"])  # two plays, padding lanes hold the capacity
        assert len(jrow) > 0 and (idx < idx.max()).sum() == 2


@pytest.mark.parametrize("block", [0, 1, 2], ids=["first", "idle", "plays_and_motion"])
def test_packed_row_unpacks_to_params(block):
    _, pp = _entry_rows()[block]
    pack = prun._pack_spec(pp)
    got = prun._unpack_row(torch.from_numpy(prun._pack_row(pp)), *pack)
    assert _paths(got) == _paths(pp)
    for x, want in zip(tree_flatten(got)[0], tree_flatten(pp)[0]):
        want = np.asarray(want)
        x = x.numpy()
        if want.dtype.kind in "iu":
            assert x.dtype == np.int32
        assert x.shape == want.shape
        np.testing.assert_array_equal(x, want.astype(x.dtype))


# -- (b), (c) the Renderer against the JAX package ------------------------------------


def _play_script(hs, rng):
    """A smoothed move of a buffered voice to near where it is (a move far
    away reads its transition at the tier's capped walk, where both
    packages leave the oracle: ROADMAP R10), a discontinuous jump of
    another, and a seek voice's jump."""
    hs[0].set_motion([-25.0, -28.0, 19.5], [1.0, 0.0, 0.0], False)
    hs[5].set_motion([-12.0, 0.0, 4.0], [0.0, 0.0, 0.0], True)
    hs[-1].set_motion(rng.uniform(-10, 10, 3), [0.0, 0.0, 0.0], True)


def script(m, unroll=1, buckets=None, n_buffered=24, n_seek=12):
    """The entry scene at a small size through one control script: an
    idle run fused into (multi, 4) groups, motion (one discontinuous), a
    buffered and a seek play, a listener rotation, render_block and
    render_frames.  Returns (audio, renderer, scene)."""
    control, scene, hs = build_entry(m, n_buffered=n_buffered, n_seek=n_seek)
    r = m.Renderer(scene, RATE, scan_unroll=unroll, scan_buckets=buckets)
    rng = np.random.default_rng(5)
    out = [r.render_frames(BLOCK * 21)]
    _play_script(hs, rng)
    out.append(r.render_frames(BLOCK * 6))
    hs.append(control.play_buffered(
        m.Sine(1.0, 660.0), m.SpatialOptions(position=[4.0, 0.0, -3.0], velocity=[0.0, 2.0, 0.0]),
        max_distance=50.0, rate=RATE, buffer_duration=0.1))
    hs.append(control.play(m.Sine(0.5, 330.0), m.SpatialOptions(position=[-2.0, 1.0, 0.0])))
    out += [r.render_block(BLOCK) for _ in range(3)]
    control.set_listener_rotation([np.cos(0.3), 0.0, np.sin(0.3), 0.0])
    out.append(r.render_frames(BLOCK * 9))
    _play_script(hs, rng)
    out.append(r.render_frames(BLOCK * 19))
    return np.concatenate(out), r, scene


def subpass_script(m, unroll=1):
    """A buffered scene with offset-clamped voices (beyond max_delay*c,
    frozen reads, as bench.py's subpass scene) and voices crossing the
    clamp band at 40 m/s, which the family sub-pass lists: the delta
    blocks ship ``sub_idx``/``sub_on``."""
    rng = np.random.default_rng(4)
    kw = {"device": "cpu"} if m is pt else {}
    control, scene = m.SpatialScene.new(initial_capacity=32, **kw)
    for i in range(24):
        sig = m.Sine(rng.uniform(0, 6), rng.uniform(100, 2000))
        if i < 4:
            opts = m.SpatialOptions(position=rng.uniform(100, 150, 3) * rng.choice([-1.0, 1.0], 3))
        elif i < 10:
            d = rng.normal(size=3)
            d /= np.linalg.norm(d)
            opts = m.SpatialOptions(position=d * 82.0, velocity=d * 40.0)
        else:
            opts = m.SpatialOptions(position=rng.uniform(-15, 15, 3),
                                    velocity=rng.uniform(-1, 1, 3))
        control.play_buffered(sig, opts, max_distance=50.0, rate=RATE, buffer_duration=0.1)
    r = m.Renderer(scene, RATE, scan_unroll=unroll)
    out = np.concatenate([r.render_frames(BLOCK * 12) for _ in range(3)])
    return out, r, scene, control


@functools.lru_cache(maxsize=None)
def _pair(unroll, buckets):
    a, rj, _ = script(ot, unroll, buckets)
    b, rp, _ = script(pt, unroll, buckets)
    return a, b, rj, rp


@pytest.mark.parametrize("unroll", [1, 4])
def test_renderer_matches_jax(unroll):
    a, b, _, rp = _pair(unroll, None)
    assert b.shape == a.shape and b.dtype == np.float32
    assert np.abs(a).max() > 1e-3
    assert np.abs(a - b).max() <= TOL, np.abs(a - b).max()
    assert rp.dispatch_counts.get(("multi", 4), 0) >= 8
    assert rp.graph_counts["eager"] > 0 and rp.graph_counts["replays"] == 0
    if unroll == 4:  # runs went as calls of 4 blocks and their remainders
        assert any(k == 4 for steps in rp._steps.values() for k, _ in steps)


def test_subpass_scene_matches_jax():
    a, rj, _, _ = subpass_script(ot)
    b, rp, scene, control = subpass_script(pt)
    assert np.abs(a - b).max() <= TOL, np.abs(a - b).max()
    tiers = control.read_tiers()["b0"]
    assert tiers["listed"] > 0 and tiers["frozen"] == 4 and tiers["sub_cfg"] is not None
    assert any("sub_idx" in dict(dict(k[2][0])["b0"]) for k in rp._steps if k[2] is not None)
    assert len(rp._steps) == len(rj._steps)


@pytest.mark.parametrize("buckets", [None, (12, 3, 1)], ids=["runs", "buckets"])
def test_step_keys_match_jax(buckets):
    """One block step per key the JAX Renderer compiles a program for, with
    and without ``scan_buckets``; the buckets split runs as the JAX package
    splits them (its dispatch counts)."""
    a, b, rj, rp = _pair(1, buckets)
    assert np.abs(a - b).max() <= TOL
    assert len(rp._steps) == len(rj._steps)
    kinds = sorted(str(k[1]) for k in rp._steps)
    assert kinds == sorted(str(k[1]) for k in rj._steps)
    if buckets:
        assert rp.dispatch_counts["scan"] > _pair(1, None)[3].dispatch_counts["scan"]


def test_step_keys_hold_under_control_traffic():
    """After one delta and one idle block, plays and set_motion reuse the
    two steps (the JAX package's two programs): no key is added."""
    rng = np.random.default_rng(11)
    keys = []
    for m in (ot, pt):
        kw = {"device": "cpu"} if m is pt else {}
        control, scene = m.SpatialScene.new(initial_capacity=64, **kw)
        handles = []
        for _ in range(8):
            handles.append(control.play(
                m.Sine(rng.uniform(0, 6), rng.uniform(100, 1000)),
                m.SpatialOptions(position=rng.uniform(-10, 10, 3))))
            handles.append(control.play_buffered(
                m.Sine(rng.uniform(0, 6), rng.uniform(100, 1000)),
                m.SpatialOptions(position=rng.uniform(-10, 10, 3)),
                max_distance=20.0, rate=8000, buffer_duration=0.05))
        r = m.Renderer(scene, 8000)
        r.render_block(256)
        r.render_block(256)
        warm = set(r._steps)
        assert len(warm) == 2
        for i in range(12):
            if i % 3 == 0:
                handles.append(control.play(
                    m.Sine(0.0, 440.0), m.SpatialOptions(position=[1.0, 0.0, 0.0])))
            if i % 3 == 1:
                for h in handles[:4]:
                    h.set_motion(rng.uniform(-10, 10, 3), rng.uniform(-2, 2, 3), False)
            r.render_block(256)
        assert set(r._steps) == warm, "control events added a step"
        keys.append(len(r._steps))
    assert keys[0] == keys[1]


# -- (d), (e) the step itself ---------------------------------------------------------


def _bits(x):
    x = x.detach().cpu()
    if x.dtype == torch.float32:
        return x.view(torch.int32)
    return x


def _host(obj, depth=0):
    """A comparable picture of an object's host state (tensors left out)."""
    if isinstance(obj, torch.Tensor):
        return "tensor"
    if isinstance(obj, np.ndarray):
        return ("array", obj.dtype.str, obj.shape, obj.tobytes())
    if isinstance(obj, (float, np.floating)):
        return ("float", np.float64(obj).tobytes())
    if obj is None or isinstance(obj, (bool, int, str, np.integer, np.bool_)):
        return obj
    if isinstance(obj, dict):
        return {k: _host(v, depth) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set, frozenset)):
        items = sorted(obj, key=repr) if isinstance(obj, (set, frozenset)) else obj
        return (type(obj).__name__, [_host(v, depth) for v in items])
    if depth < 2 and hasattr(obj, "__dict__"):
        return (type(obj).__name__, _host(vars(obj), depth + 1))
    return type(obj).__name__


#: the tensor methods that read values on the host
_HOST_READS = ("__array__", "numpy", "item", "tolist")


@contextlib.contextmanager
def host_read_guard():
    """Inside ``block_step()`` (a render a CUDA graph may capture), make
    ``torch.Tensor.__array__``, ``numpy()``, ``item()`` and ``tolist()``
    raise: on a card such a read fails the capture or bakes one block's
    value into every replay, and on the CPU it passes silently.  Yields
    the list of the reads it refused (a caller that swallowed the error
    still leaves its entry)."""
    own = {name: torch.Tensor.__dict__.get(name) for name in _HOST_READS}
    hits = []

    def guard(name, fn):
        def guarded(self, *a, **kw):
            if in_block_step():
                hits.append(name)
                raise RuntimeError(f"a block step read a tensor on the host (Tensor.{name})")
            return fn(self, *a, **kw)

        return guarded

    for name in _HOST_READS:
        setattr(torch.Tensor, name, guard(name, getattr(torch.Tensor, name)))
    try:
        yield hits
    finally:
        for name, fn in own.items():
            if fn is None:
                delattr(torch.Tensor, name)
            else:
                setattr(torch.Tensor, name, fn)


def test_block_steps_read_no_tensor_on_host():
    """The main path's scripts (the entry scene's and the sub-pass
    scene's) under ``host_read_guard``: no step reads a tensor on the
    host, and the audio equals ``eager()``'s."""
    with host_read_guard() as hits:
        got, r, _ = script(pt, 4)
        sub, rs, _, _ = subpass_script(pt)
    assert hits == [] and r._steps and rs._steps
    with prun.eager():
        want, _, _ = script(pt, 4)
        want_sub, _, _, _ = subpass_script(pt)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(sub, want_sub)
    with host_read_guard(), pytest.raises(RuntimeError, match="Tensor.item"):
        with prun.block_step():
            torch.ones(1).item()
    assert torch.ones(1).item() == 1.0


def _scene_host(scene):
    return _host({"scene": {k: v for k, v in vars(scene).items() if k not in ("_rot_dev",)},
                  "pools": [{k: v for k, v in vars(p).items() if k != "state"}
                            for p in scene._all_pools()]})


def test_block_step_reads_no_host_state(monkeypatch):
    """A replay emulated: each call of a step also runs on a deep copy of
    the scene frozen at that step's first call, from a copy of the same
    state and rows.  Its audio and state equal the live call's bit for bit
    (every host value the step reads is in the key), and the live call
    changes no host attribute."""
    frozen, calls = {}, []
    live_call = prun.Renderer._eager_call

    def spy(self, step, d0, dd):
        sig = self.signal
        if id(step) not in frozen:
            # the step is held too, so that its id is not reused
            frozen[id(step)] = (step, copy.deepcopy(sig))
        before = _scene_host(sig)
        d_in = tree_map(torch.clone, d0)
        rows = None if step.rows is None else step.rows.clone()
        out = live_call(self, step, d0, dd)
        assert _scene_host(sig) == before, "the block step changed a host attribute"
        d_f, out_f = prun.step_body(frozen[id(step)][1], step.kind, step.pack, step.n, step.k,
                                    d_in, dd, rows)
        assert torch.equal(_bits(out_f), _bits(out))
        live = sig.device_collect()

        def same(a, b, path=()):
            if isinstance(a, dict):
                for k in a:
                    same(a[k], b[k], path + (k,))
            else:
                assert torch.equal(_bits(a), _bits(b)), path

        same(d_f, live)
        calls.append(step.kind)
        return out

    monkeypatch.setattr(prun.Renderer, "_eager_call", spy)
    script(pt)
    subpass_script(pt)
    assert {"single", "scan", ("multi", 4)} <= set(calls) and len(calls) > 40


def test_step_matches_eager_bit_for_bit():
    """The step path (packed rows, device lanes, copy-back) against
    ``eager()`` (numpy params, the state stored as returned): the same
    arithmetic, bit for bit, at unroll 1 and 4."""
    with prun.eager():
        ref, r0, _ = script(pt)
    assert r0._steps == {} and r0.graph_counts["eager"] > 0
    for unroll in (1, 4):
        got, r, _ = script(pt, unroll)
        np.testing.assert_array_equal(got, ref)
        assert r.dispatch_counts == r0.dispatch_counts


def test_run_returns_distinct_blocks():
    """Each call's audio is copied out of the step's buffer: a run of
    blocks (and of fused groups) returns every block, not the last one
    repeated, equal to ``eager()``'s."""
    outs = []
    for ctx in (prun.eager(), __import__("contextlib").nullcontext()):
        with ctx:
            control, scene, hs = build_entry(pt, n_buffered=16, n_seek=8)
            r = pt.Renderer(scene, RATE)
            got = r.render_frames_device(BLOCK * 23)
            hs[0].set_motion([1.0, 2.0, 3.0], [0.0, 0.0, 0.0], False)
            got += r.render_frames_device(BLOCK * 3)
            outs.append(got)
    assert [tuple(x.shape) for x in outs[1]] == [tuple(x.shape) for x in outs[0]]
    for want, x in zip(*outs):
        assert torch.equal(x, want)
        for i in range(1, x.shape[0]):
            assert not torch.equal(x[i], x[0])
    assert any(x.shape[-1] == 4 * BLOCK and x.shape[0] > 1 for x in outs[1])
    assert any(x.shape[-1] == BLOCK and x.shape[0] > 1 for x in outs[1])


def test_state_leaves_stay_put():
    """The step leaves every state leaf in the tensor it was collected in
    (the rings included); ``eager()`` stores what the render returns."""
    control, scene, hs = build_entry(pt, n_buffered=16, n_seek=8)
    r = pt.Renderer(scene, RATE)
    r.render_block(BLOCK)
    before = tree_leaves(scene.device_collect())
    ring = scene._buffered_pools[next(iter(scene._buffered_pools))].state["ring"]
    r.render_frames(BLOCK * 20)
    hs[3].set_motion([0.0, 1.0, -4.0], [2.0, 0.0, 0.0], False)
    control.set_listener_rotation([np.cos(0.1), 0.0, 0.0, np.sin(0.1)])
    r.render_frames(BLOCK * 4)
    after = tree_leaves(scene.device_collect())
    assert len(after) == len(before) and all(a is b for a, b in zip(after, before))
    with prun.eager():
        r.render_block(BLOCK)
    moved = tree_leaves(scene.device_collect())
    assert any(a is not b for a, b in zip(moved, before))
    assert scene._buffered_pools[next(iter(scene._buffered_pools))].state["ring"] is ring


def test_other_engines_dispatch_eagerly():
    """A Mixer of MonoToStereo(Sine) voices declares ``graph_capture`` and
    renders through block steps, and so does a scene with a
    device-resident buffered pool of Speed(Sine) voices (a chain of
    ``mixer._GRAPH_NODES``); a scene with a host seek pool (a seekable
    Sine with its own finish rule, ``_SeekPool``) keeps op-by-op
    dispatch."""
    control, mixer = pt.Mixer.new(channels=2, device="cpu")
    control.play(pt.MonoToStereo(pt.Sine(0.0, 440.0)))
    r = pt.Renderer(mixer, RATE)
    r.render_frames(BLOCK * 3)
    assert mixer.graph_capture and r._steps and r.graph_counts["eager"] == 3
    control, scene, _ = build_entry(pt, n_buffered=4, n_seek=2)
    assert scene.graph_capture
    control.play_buffered(pt.Speed(pt.Sine(0.0, 220.0)), pt.SpatialOptions(
        position=[1.0, 0.0, 0.0]), max_distance=10.0, rate=RATE, buffer_duration=0.1)
    assert scene.graph_capture
    r = pt.Renderer(scene, RATE)
    r.render_frames(BLOCK * 2)
    assert r._steps

    class FiniteSine(pt.Sine):
        def host_is_finished(self):
            return np.asarray(self.phase) > 2.0

    control.play(FiniteSine(0.0, 330.0), pt.SpatialOptions(position=[0.0, 2.0, 0.0]))
    assert "_SeekPool" in [type(p).__name__ for p in scene._seek_pools.values()]
    assert not scene.graph_capture
    r = pt.Renderer(scene, RATE)
    r.render_frames(BLOCK * 2)
    assert r._steps == {}


@pytest.mark.parametrize("case", ["some", "none", "all", "negative", "rows3"])
def test_drop_lanes_match_jax_drop(case):
    """``scatter_drop_`` against the JAX package's ``.at[idx].set(vals,
    mode="drop")``: padding lanes (V, past V, negative) write nothing."""
    rng = np.random.default_rng({"some": 1, "none": 2, "all": 3, "negative": 4, "rows3": 5}[case])
    V, K = 37, 8
    idx = np.full(K, V, np.int32)
    if case != "none":
        real = rng.choice(V, K if case == "all" else 3, replace=False)
        lanes = rng.choice(K, real.size, replace=False)
        idx[lanes] = real
    if case == "negative":  # padding lanes that must neither wrap nor clamp
        idx[np.nonzero(idx == V)[0][:2]] = [-1, V + 5]
    shape = (V, 3) if case == "rows3" else (V,)
    for dtype in (np.float32, np.int32, np.bool_):
        leaf = rng.standard_normal(shape).astype(dtype) if dtype != np.bool_ else (
            rng.uniform(size=shape) > 0.5)
        vals = (rng.standard_normal((K,) + shape[1:]) * 9).astype(dtype)
        j = np.asarray(jnp.asarray(leaf).at[jnp.asarray(np.where(idx < 0, V + 9, idx))].set(
            jnp.asarray(vals), mode="drop"))
        t = torch.from_numpy(leaf.copy())
        got = scatter_drop_(t, drop_lanes(torch.from_numpy(idx), V), torch.from_numpy(vals))
        assert got is t
        np.testing.assert_array_equal(t.numpy(), j)


def test_run_renders_as_of_its_archetype():
    """A run is dispatched after the next block's ``host_prepare``: the
    first block (a delta block, read tier (512, 64)) renders with its own
    tier, not the idle block's (512, 32) that the pool holds by then."""
    control, scene, hs = build_entry(pt, n_buffered=16, n_seek=8)
    pool = scene._buffered_pools[next(iter(scene._buffered_pools))]
    seen = []
    render = pool.render

    def spy(*a):
        seen.append(pool._read_cfg)
        return render(*a)

    pool.render = spy
    r = pt.Renderer(scene, RATE)
    r.render_frames(BLOCK * 3)
    assert pool._read_cfg == (512, 32)
    assert seen == [(512, 64), (512, 32), (512, 32)]
    assert r.dispatch_counts == {"single": 1, "scan": 1}
