"""The buffered pool's walk and read preparation (``ops/walk.py``) on the
CPU: the wrapper runs its plain version and launches nothing, refuses
operands of the wrong dtype, shape or layout as the other kernel wrappers
do, and the pools count the route once per block.  The kernel itself is
held bit-equal to the plain version on the card (``tests/test_torch_cuda.py
-k voice_walk``)."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import oddio_tpu_torch as pt
from oddio_tpu_torch.ops import walk as WALK
from oddio_tpu_torch.utils import kernel_bench as KB
from oddio_tpu_torch.utils import profiler as P
from oddio_tpu_torch.utils.scene_profile import build_main_path, build_spatial_pack

torch.set_num_threads(1)

BLOCK = 512


def _equal(a, b):
    """Two results equal bit for bit (NaN payloads included)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if a is None or b is None:
        return a is b
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _clone(st):
    return {k: v.clone() for k, v in st.items()}


@pytest.mark.parametrize("case", list(KB.WALK_CASES))
def test_voice_walk_on_the_cpu_is_its_plain_version(case):
    """On CPU tensors the wrapper is the torch chain: bit-equal to
    ``voice_walk_plain`` on the same operands, nothing launched, the
    caller's columns left as they were."""
    (st, *rest), kw = KB.walk_operands("cpu", np.random.default_rng(7), case)
    before = _clone(st)
    WALK.reset_launches()
    got = WALK.voice_walk(st, *rest, **kw)
    want = WALK.voice_walk_plain(_clone(st), *rest, **kw)
    assert WALK.LAUNCHES["voice_walk"] == 0
    assert _equal(got, want)
    assert _equal(st, before)
    cols, ro, n_write, late = got
    assert (late is None) == (not kw["late"])
    assert n_write.dtype == torch.int32 and bool((n_write[~cols["mask"]] == 0).all())


def test_voice_walk_cases_reach_every_branch():
    """The cases the card holds the kernel to take each branch: voices
    stop on expiry and newly finish, ears freeze, lanes land (and pad),
    late voices exist, every scene of the pack is rotated apart."""
    seen = {}
    for case in KB.WALK_CASES:
        (st, motion, rp, r, fin, nw), kw = KB.walk_operands("cpu", np.random.default_rng(7), case)
        cols, ro, _, late = WALK.voice_walk_plain(_clone(st), motion, rp, r, fin, nw, **kw)
        lingering = ~torch.isnan(st["finished_for"])
        seen[case] = {
            "expired": bool((cols["stopped"] & ~st["stopped"]).any()),
            "newly": bool((torch.isnan(st["finished_for"]) & ~torch.isnan(cols["finished_for"])).any()),
            "still": bool((lingering & ~cols["stopped"]).any()),
            "frozen": bool((ro["frz_c"][0] > 0).any() & (ro["frz_c"][1] > 0).any()),
            "moved": motion is not None and not torch.equal(cols["motion_pos"], st["motion_pos"]),
            "late": late is not None and bool(late.any()),
        }
    assert all(seen["lingering"][k] for k in ("expired", "newly", "still")), seen
    assert seen["frozen"]["frozen"] and seen["pack 16 x 256"]["frozen"]
    assert seen["motion lanes"]["moved"] and seen["4096 voices"]["moved"]
    assert seen["late"]["late"] and seen["pack 16 x 256"]["late"]


def _bad(case):
    """One operand of the "pack 16 x 256" case spoilt: (args, kwargs)."""
    (st, motion, rp, r, fin, nw), kw = KB.walk_operands("cpu", np.random.default_rng(3),
                                                        "pack 16 x 256")
    if case == "dtype":
        st["vcur"] = st["vcur"].double()
    elif case == "shape":
        st["prev_position"] = st["prev_position"][:, :2].contiguous()
    elif case == "layout":
        st["motion_pos"] = st["motion_pos"].t().contiguous().t()
    elif case == "lanes dtype":
        motion = (motion[0].long(),) + motion[1:]
    elif case == "lanes layout":
        motion = motion[:1] + (motion[1].t().contiguous().t(),) + motion[2:]
    elif case == "rotation rows":
        r = r[:3].contiguous()
    elif case == "scene counts":
        nw = nw[:5].contiguous()
    elif case == "finish flags":
        fin = fin.to(torch.uint8)
    elif case == "no lag":
        del st["lag"]
    return (st, motion, rp, r, fin, nw), kw


@pytest.mark.parametrize("case", ["dtype", "shape", "layout", "lanes dtype", "lanes layout",
                                  "rotation rows", "scene counts", "finish flags", "no lag"])
def test_voice_walk_refuses_wrong_operands(case):
    """A column of the wrong dtype, shape or layout, motion lanes of the
    wrong dtype or layout, rotations or cursor counts that do not split
    the voices, non-bool finish flags, a missing lag on the late path:
    the wrapper raises, as the other kernel wrappers do, before any
    arithmetic."""
    args, kw = _bad(case)
    with pytest.raises((TypeError, ValueError, KeyError)):
        WALK.voice_walk(*args, **kw)


@pytest.mark.parametrize("scene", ["buffered", "sampler", "pack"])
def test_walk_chain_counts_once_per_pool_per_block(scene):
    """On the CPU every buffered device-resident pool counts ``walk.chain``
    once a block in its prepare, and nothing counts ``walk.fused``: the
    main-path scene (one pool), the spatial sampler (four) and a spatial
    pack of 4 scenes (one pool a scene)."""
    from oddio_tpu_torch.utils.scene_profile import build_spatial_sampler

    if scene == "buffered":
        _, eng, _ = build_main_path("buffered", 32, "cpu")
        r = pt.Renderer(eng, 48000)
        pools = len(eng._buffered_pools)
        render = lambda: r.render_frames_device(6 * BLOCK)  # noqa: E731
    elif scene == "sampler":
        drv = build_spatial_sampler(64, "cpu")
        r = pt.Renderer(drv.scene, 48000)
        pools = len(drv.scene._buffered_pools)
        render = lambda: r.render_frames_device(6 * BLOCK)  # noqa: E731
    else:
        pack = build_spatial_pack(4, "cpu", 16, 48)
        pools = sum(len(s._buffered_pools) for s in pack.scenes)
        render = lambda: pack.render_frames_device(6 * BLOCK)  # noqa: E731
    render()
    P.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            render()
        assert P.counted("walk.chain") == 6 * pools
        assert P.counted("walk.fused") is None
        assert P.counted("walk") == 6 * pools
    finally:
        P.clear()
