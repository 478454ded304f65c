"""The ScenePack's ingest block (``parallel/sharded.py`` ``_IngestChunks``,
``ops/stream.py`` ``Stream._drain``) on the CPU: where a cell holds every
voice of its scenes, the Stream drains write their spans into the cell's
persistent chunk, which the pack ships as the merged chunk.  The chunk
each packed row carries is held against one built here from the PCM the
streams were sent (a FIFO per stream, ``max_write_per_block`` a block),
and the audio bit for bit against the concatenating path (a 1 x 1 pack
without the persistent chunks, and a voice-sharded mesh, which
concatenates), the scene groups of a 2 x 1 mesh and ``eager()``.
"""

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import oddio_tpu_torch as pt
from oddio_tpu_torch.core import run as prun
from oddio_tpu_torch.parallel.mesh import make_mesh
from oddio_tpu_torch.parallel.sharded import ScenePack
from oddio_tpu_torch.utils import checkpoint as CK
from oddio_tpu_torch.utils import profiler as P

torch.set_num_threads(1)

RATE, BLOCK, SCENES, STREAMS = 48000, 512, 4, 2
CPU = [ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def _fresh():
    P.clear()
    yield
    P.clear()


def _pack(shape=(1, 1), mw=2400, unroll=8, inplace=True):
    """SCENES config-5 Mixers of STREAMS ``Adapt(Stream(8000, 4096,
    max_write_per_block=mw))`` and two ``Adapt(Sine)`` voices, capacity 2
    a pool, on a logical CPU mesh of ``shape``; ``inplace`` False takes
    the persistent chunks away (the concatenating path on one cell).
    Returns ``(pack, stream controls by scene)``."""
    mixers, ctls = [], []
    for s in range(SCENES):
        rng = np.random.default_rng(s)
        mixer = pt.Mixer(1, initial_capacity=STREAMS, device="cpu")
        mc = pt.MixerControl(mixer)
        cs = []
        for i in range(STREAMS + 2):
            opt = pt.AdaptOptions(tau=0.1, max_gain=4.0)
            if i < STREAMS:
                stream = pt.Stream(8000, 4096, max_write_per_block=mw)
                cs.append(stream.control)
                mc.play(pt.Adapt(stream, 0.1, opt))
            else:
                mc.play(pt.Adapt(pt.Sine(rng.uniform(0, 6), rng.uniform(50, 2000)), 0.1, opt))
        mixers.append(mixer)
        ctls.append(cs)
    pack = ScenePack(mixers, RATE, make_mesh(*shape, ["cpu"] * (shape[0] * shape[1])),
                     scan_unroll=unroll)
    if not inplace:
        pack._ingest.arm = lambda pack: []
    return pack, ctls


#: the script's writes before each call: (scene, stream, samples); scenes 1
#: and 3 stay silent until the last call, a voice writes 2048 samples and
#: then 100, another more than one block takes at ``mw`` 256
WRITES = [
    [(0, 0, 2048), (2, 1, 700)],
    [(0, 0, 100), (2, 0, 300)],
    [],
    [(0, 1, 50), (1, 0, 600), (3, 1, 2048)],
]


def _pcm(call, s, v, k):
    return (np.random.default_rng((call, s, v)).standard_normal(k) * 0.1).astype(np.float32)


def _frames(pack, nb):
    x = np.concatenate([np.asarray(t) for t in pack.render_frames_device(BLOCK * nb)])
    B, S, C, n = x.shape
    return x.transpose(1, 0, 3, 2).reshape(S, B * n, C)


def _script(pack, ctls, mw, nb=8):
    """The WRITES, each call's ``nb`` blocks after them; returns the audio
    and the expected chunk (S·V, 1, mw+1) and counts (S·V,) of each
    ingest block, in order: each stream ships the oldest ``mw`` samples
    it was sent a block (stream voice v of scene s at row s·V + v)."""
    V = STREAMS
    queues = {}
    expected, out = [], []
    for call, writes in enumerate(WRITES):
        for s, v, k in writes:
            x = _pcm(call, s, v, k)
            assert ctls[s][v].write(x) == k
            queues.setdefault((s, v), []).extend(x)
        while any(queues.values()):
            chunk = np.zeros((SCENES * V, 1, mw + 1), np.float32)
            counts = np.zeros(SCENES * V, np.int32)
            for (s, v), q in queues.items():
                take, queues[s, v] = q[:mw], q[mw:]
                chunk[s * V + v, 0, :len(take)] = take
                counts[s * V + v] = len(take)
            expected.append((chunk, counts))
        out.append(_frames(pack, nb))
    return np.concatenate(out, axis=1), expected


def _ingest_of(params):
    """The ingest trees (``{"chunk", "wcount"}``) in a params tree."""
    if not isinstance(params, dict):
        return []
    if "ing" in params:
        return [params["ing"]]
    return [i for v in params.values() for i in _ingest_of(v)]


@pytest.fixture
def packed(monkeypatch):
    """Copies of each ingest chunk and wcount as the rows are packed."""
    got = []
    inner = prun._pack_into

    def spy(params, out):
        got.extend((i["chunk"].copy(), i["wcount"].copy()) for i in _ingest_of(params))
        inner(params, out)

    monkeypatch.setattr(prun, "_pack_into", spy)
    return got


def _check_chunks(got, expected):
    assert len(got) == len(expected)
    for (chunk, wcount), (want, counts) in zip(got, expected):
        np.testing.assert_array_equal(chunk, want)
        np.testing.assert_array_equal(wcount, counts)


@pytest.mark.parametrize("mw", [2400, 256])
def test_packed_chunks_are_the_written_pcm(packed, mw):
    """Every ingest block's packed chunk is built from the PCM sent alone:
    silent scenes' rows zero, zeros past each count (a voice that wrote
    2048 samples and then 100 reads zero past 100), and at ``mw`` 256 the
    blocks of one run each their own (none rewritten before it is
    packed); the same chunks as the concatenating path's."""
    pack, ctls = _pack(mw=mw)
    a, expected = _script(pack, ctls, mw)
    _check_chunks(packed, expected)
    if mw == 2400:
        second = packed[1][0]
        assert second[0, 0, :100].any() and not second[0, 0, 100:].any()
    got = list(packed)
    packed.clear()
    pack, ctls = _pack(mw=mw, inplace=False)
    b, _ = _script(pack, ctls, mw)
    assert len(packed) == len(got)
    for (c0, w0), (c1, w1) in zip(got, packed):
        np.testing.assert_array_equal(c0, c1)
        np.testing.assert_array_equal(w0, w1)
    assert np.abs(a).max() > 1e-2
    np.testing.assert_array_equal(a, b)


def test_two_ingest_blocks_in_one_run_take_two_chunks():
    """A stream queued past ``max_write_per_block`` ships over three
    blocks of one run: three chunks held at once, back in use once the
    run's rows are packed, and reused (not reallocated) after."""
    pack, ctls = _pack(mw=256)
    runs = []
    dispatch = pack._dispatch_steps

    def spy(arch, kind, pend, n):
        runs.append((len(pend), len(pack._ingest.held)))
        return dispatch(arch, kind, pend, n)

    pack._dispatch_steps = spy
    _frames(pack, 8)  # the plays
    runs.clear()
    ctls[2][1].write(_pcm(0, 2, 1, 700))
    _frames(pack, 8)
    # the run that holds the three ingest blocks goes with their chunks held
    assert runs[0][0] >= 3 and runs[0][1] == 3
    assert pack._ingest.held == []
    chunks = {id(c) for free in pack._ingest.free.values() for c, _ in free}
    assert len(chunks) == 2  # KEEP of the three
    ctls[0][0].write(_pcm(1, 0, 0, 100))
    _frames(pack, 8)
    after = {id(c) for free in pack._ingest.free.values() for c, _ in free}
    assert after == chunks


def test_writes_outside_scene_0_end_the_run():
    """Scene 0's archetype does not show a write in scenes 1 and 3 only:
    the ingest block and the idle blocks after it go in runs of their own
    (every run's rows one layout), bit-equal to ``eager()``."""
    outs, layouts = [], []
    for mode in ("step", "eager"):
        pack, ctls = _pack()
        dispatch = pack._dispatch_steps

        def spy(arch, kind, pend, n, dispatch=dispatch):
            layouts.append({repr(prun._pack_spec(p[0, 0])) for p in pend})
            return dispatch(arch, kind, pend, n)

        pack._dispatch_steps = spy
        with (prun.eager() if mode == "eager" else contextlib.nullcontext()):
            out = [_frames(pack, 8)]
            for call in range(3):
                for s in (1, 3):
                    ctls[s][call % 2].write(_pcm(call, s, call % 2, 1000))
                out.append(_frames(pack, 24))
        outs.append(np.concatenate(out, axis=1))
    assert len(layouts) >= 7 and all(len(x) == 1 for x in layouts)
    assert np.abs(outs[0][1]).max() > 1e-2
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
def test_meshes_match_one_cell(shape, packed):
    """Scene groups (2 x 1) write in place, a cell apiece; a voice-sharded
    mesh (1 x 2) concatenates; both bit-equal to 1 x 1."""
    pack, ctls = _pack(mw=256)
    a, expected = _script(pack, ctls, 256)
    with profile(activities=CPU):
        pack, ctls = _pack(shape, mw=256)
        b, _ = _script(pack, ctls, 256)
    # one merge a block in each cell whose scenes shipped PCM
    A, B = shape
    rows = SCENES // A * STREAMS
    merges = sum(B * int(counts[g * rows:(g + 1) * rows].any())
                 for _, counts in expected for g in range(A))
    if B == 1:
        assert P.counted("ingest.merged_inplace") == merges > len(expected)
        assert P.counted("ingest.merged_concat") is None
    else:
        assert P.counted("ingest.merged_concat") == merges == 2 * len(expected)
        assert P.counted("ingest.merged_inplace") is None
        assert not pack._ingest.free
    np.testing.assert_array_equal(a, b)


def test_eager_and_stepped_runs_are_equal():
    outs = []
    for mode in ("step", "eager"):
        pack, ctls = _pack(mw=256)
        with (prun.eager() if mode == "eager" else contextlib.nullcontext()):
            outs.append(_script(pack, ctls, 256)[0])
            ctls[1][1].write(_pcm(9, 1, 1, 300))
            outs[-1] = np.concatenate(
                [outs[-1]] + [pack.render_block(BLOCK) for _ in range(3)], axis=1)
    assert np.abs(outs[0]).max() > 1e-2
    np.testing.assert_array_equal(outs[0], outs[1])


def test_counters_count_every_ingest_block_once():
    """``ingest.merged_inplace`` counts each ingest block of a 1 x 1 pack;
    ``ingest.samples`` and ``ingest.slots`` count the written samples and
    the merged chunk's slots, silent scenes' rows included."""
    pack, ctls = _pack(mw=256)
    with profile(activities=CPU):
        _, expected = _script(pack, ctls, 256)
    assert P.counted("ingest.merged_inplace") == len(expected)
    assert P.counted("ingest.merged_concat") is None
    assert P.counted("ingest.samples") == sum(k for w in WRITES for _, _, k in w)
    assert P.counted("ingest.slots") == sum(c.size for c, _ in expected)


def test_checkpoint_between_a_write_and_the_next_block_keeps_the_write():
    """A snapshot of every scene taken after a write and before the next
    block, 8 blocks, a restore and ``drop_stack()``: the same 8 blocks
    again, the write shipped both times."""
    pack, ctls = _pack()
    _frames(pack, 8)
    ctls[0][1].write(_pcm(0, 0, 1, 1500))
    pack.sync()
    snaps = [CK.snapshot(s) for s in pack.scenes]
    with profile(activities=CPU):
        a = _frames(pack, 8)
    first = P.counted("ingest.samples")
    for s, snap in zip(pack.scenes, snaps):
        CK.restore(s, snap)
    pack.drop_stack()
    P.clear()
    with profile(activities=CPU):
        b = _frames(pack, 8)
    assert first == P.counted("ingest.samples") == 1500
    assert np.abs(a[0]).max() > 1e-2
    np.testing.assert_array_equal(a, b)
