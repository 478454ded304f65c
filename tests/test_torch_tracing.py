"""The port's spans and counters (``utils/profiler.py``): recorded only
inside a ``torch.profiler`` session, on the clock of the profiler's
events, nested at the layers' boundaries, and counting what the engines
ship.  Needs no JAX; the card tests skip without a CUDA card and run on
one with

    python -m pytest tests/test_torch_tracing.py -q
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import oddio_tpu_torch as pt
from oddio_tpu_torch.core.run import _pack_spec, _row_len
from oddio_tpu_torch.utils import profiler as P
from oddio_tpu_torch.utils.scene_profile import build_config5_pack, build_main_path

torch.set_num_threads(1)

BLOCK = 512
CPU = [ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def _fresh():
    P.clear()
    yield
    P.clear()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the profiler's device events")
    return torch.device("cuda")


def _by_id(spans):
    return {sp.id: sp for sp in spans}


def _buffered(voices=32, device="cpu"):
    control, scene, handles = build_main_path("buffered", voices, device)
    return pt.Renderer(scene, 48000), handles


def _move(handles, k, dx=1.0):
    for i, h in enumerate(handles[:k]):
        h.set_motion([dx + 0.01 * i, 2.0, -3.0], [0.5, 0.0, 0.0])


def test_nothing_is_recorded_outside_a_profiler_session():
    r, handles = _buffered()
    _move(handles, 8)
    r.render_frames_device(2 * BLOCK)
    r.render_block(BLOCK)
    assert not P.recording()
    assert P.recorded() == [] and P.dropped() == 0
    assert P.counted("motion.deferred") is None
    # off, a span is the one shared null context and a count is nothing
    assert P.span("a") is P.span("b", pool="x")
    with P.span("a") as sp:
        P.count("c", 3)
    assert sp is None and P.recorded() == [] and P.counted("c") is None


@pytest.mark.parametrize("call", ["render_frames_device", "render_frames", "render_block"])
def test_span_tree_of_one_renderer_call(call):
    r, handles = _buffered()
    r.render_frames_device(2 * BLOCK)
    _move(handles, 8)
    with profile(activities=CPU):
        out = getattr(r, call)(3 * BLOCK if call != "render_block" else BLOCK)
    del out
    spans = P.recorded()
    ids = _by_id(spans)
    roots = [sp for sp in spans if sp.parent is None]
    assert [sp.name for sp in roots] == ["render.call"]
    root = roots[0]
    assert all(sp.call == root.id for sp in spans)
    for sp in spans:
        if sp.parent is not None:
            up = ids[sp.parent]
            assert up.start_ns <= sp.start_ns <= sp.end_ns <= up.end_ns
    kinds = {sp.name: ids[sp.parent].name if sp.parent else None for sp in spans}
    assert kinds["render.prepare"] == "render.call"
    assert kinds["pool.deltas"] == "render.prepare"
    assert kinds["pool.plan"] == "render.prepare"
    assert kinds["steps.rows"] == "render.call"
    assert kinds["steps.eager"] == "render.call"  # the CPU runs the steps op by op
    blocks = 1 if call == "render_block" else 3
    assert sum(sp.name == "render.prepare" for sp in spans) == blocks
    pools = {p.name for p in r.signal._buffered_pools.values()}
    assert {sp.attrs["pool"] for sp in spans if sp.name.startswith("pool.")} <= pools
    assert P.counted("h2d.bytes") is None  # the CPU copies nothing to a device


def test_calls_get_their_own_ids():
    r, handles = _buffered()
    r.render_frames_device(2 * BLOCK)
    with profile(activities=CPU):
        r.render_frames_device(2 * BLOCK)
        r.render_frames_device(2 * BLOCK)
    roots = sorted((sp for sp in P.recorded() if sp.parent is None), key=lambda s: s.id)
    assert [sp.name for sp in roots] == ["render.call", "render.call"]
    for root in roots:
        inside = [sp for sp in P.recorded() if sp.call == root.id]
        assert all(root.start_ns <= sp.start_ns <= sp.end_ns <= root.end_ns for sp in inside)
        assert sum(sp.name == "render.prepare" for sp in inside) == 2


@pytest.mark.parametrize("k,deferred", [(100, (36, 0)), (64, (0, 0)), (128, (64, 0))])
def test_motion_deferred_counts_reports_left_for_later_blocks(k, deferred):
    r, handles = _buffered(voices=128)
    r.render_frames_device(BLOCK)
    _move(handles, k)
    with profile(activities=CPU):
        r.render_frames_device(BLOCK)
        r.render_frames_device(BLOCK)
    calls = sorted({sp.call for sp in P.recorded()})
    got = tuple(P.counted("motion.deferred", [sp for sp in P.recorded() if sp.call == c])
                for c in calls)
    assert got == deferred


def test_pack_ingest_counts_written_samples_and_the_chunks_slots():
    pack, ctls, rng = build_config5_pack(4, "cpu", voices=16)
    assert len(ctls) == 8  # 2 streams a scene
    pack.render_frames_device(2 * BLOCK)  # drains the prefill
    merged = []
    inner = pack._merge_ingest

    def spy(vals):
        out = inner(vals)
        merged.append(out["chunk"].size)
        return out

    pack._merge_ingest = spy
    for c in ctls[:2]:  # scene 0's two streams
        assert c.write(np.full(100, 0.1, np.float32)) == 100
    with profile(activities=CPU):
        pack.render_frames_device(2 * BLOCK)
    assert P.counted("ingest.samples") == 200
    assert merged and P.counted("ingest.slots") == sum(merged)
    spans = P.recorded()
    names = {sp.name for sp in spans}
    assert {"pack.call", "pack.coordinate", "pack.prepare", "pack.merge",
            "pack.merge_ingest", "pack.join", "steps.rows"} <= names
    ids = _by_id(spans)
    for sp in spans:
        if sp.name == "pack.merge_ingest":
            assert ids[sp.parent].name == "pack.merge"
    # one prepare span a block, whatever the number of scenes
    assert sum(sp.name == "pack.prepare" for sp in spans) == 2
    assert [sp.name for sp in spans if sp.parent is None] == ["pack.call"]


def test_the_buffer_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(P, "CAPACITY", 5)
    with profile(activities=CPU):
        for i in range(8):
            with P.span("s", i=i):
                P.count("n", i)
    assert len(P.recorded()) == 5 and P.dropped() == 3
    assert P.counted("n") == sum(range(5))
    assert P.span_seconds("s")[1] == 5
    with profile(activities=CPU):
        P.count("loose", 2)
    assert P.counted("loose") == 2
    P.clear()
    assert P.recorded() == [] and P.dropped() == 0 and P.counted("loose") is None


def test_a_region_inside_a_span_falls_within_it_on_the_profilers_clock():
    """kineto's own timestamps of a ``record_function`` region opened inside
    a program span lie between the span's start and end."""
    with profile(activities=CPU) as prof:
        with P.span("outer"):
            torch.ones(64).sum()
            with record_function("inner-region"):
                torch.ones(256).cumsum(0)
            torch.ones(64).sum()
    sp, = P.recorded()
    evs = [ev for ev in prof.profiler.kineto_results.events() if ev.name() == "inner-region"]
    assert len(evs) == 1
    start, end = evs[0].start_ns(), evs[0].start_ns() + evs[0].duration_ns()
    assert sp.start_ns <= start <= end <= sp.end_ns


def test_idle_split_sums_to_the_idle_time():
    class S:
        def __init__(self, name, a, b):
            self.name, self.start_ns, self.end_ns = name, a, b

    spans = [S("call", 10, 90), S("prepare", 20, 40), S("plan", 25, 30), S("rows", 50, 60)]
    busy = [(0, 22), (35, 52), (58, 70), (95, 120)]
    got = P.idle_split(busy, spans, 0, 100)
    assert got == pytest.approx({"prepare": 8e-9, "plan": 5e-9, "rows": 6e-9,
                                 "call": 20e-9, P.OUTSIDE: 5e-9})
    idle = 100 - (22 + 17 + 12 + 5)
    assert sum(got.values()) == pytest.approx(idle / 1e9)


@pytest.mark.parametrize("acts", [["cuda"], ["cpu", "cuda"]])
def test_a_kernel_inside_a_span_falls_within_it_on_the_card(cuda, acts):
    """A ``torch.cuda._sleep`` kernel launched and waited for inside a
    span: the profiler's device timestamps of the kernel lie inside the
    span (with the device's activity alone, as the benchmark traces, and
    with the CPU's beside it)."""
    kinds = {"cpu": ProfilerActivity.CPU, "cuda": ProfilerActivity.CUDA}
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with profile(activities=[kinds[a] for a in acts]) as prof:
        with P.span("sleep"):
            torch.cuda._sleep(20_000_000)
            torch.cuda.synchronize()
    sp, = P.recorded()
    kern = [ev for ev in prof.profiler.kineto_results.events()
            if ev.device_type() == torch.autograd.DeviceType.CUDA]
    assert kern, "the profiler saw no device event"
    for ev in kern:
        start, end = ev.start_ns(), ev.start_ns() + ev.duration_ns()
        assert sp.start_ns <= start <= end <= sp.end_ns, (ev.name(), sp, start, end)
    assert max(ev.duration_ns() for ev in kern) > 1_000_000  # the sleep itself


def test_h2d_bytes_of_a_call_are_its_rows_on_the_card(cuda):
    r, handles = _buffered(voices=64, device=cuda)
    sig = r.signal
    rows = []
    inner = sig.host_prepare

    def prepare(*a, **kw):
        p = inner(*a, **kw)
        spec = _pack_spec(p)
        rows.append(_row_len(spec[1]) if spec else 0)
        return p

    sig.host_prepare = prepare
    for i in range(4):  # warm-up, capture and replays of each key
        _move(handles, 8, dx=0.1 * i)
        r.render_frames_device(4 * BLOCK)
    torch.cuda.synchronize()
    rows.clear()
    _move(handles, 8, dx=0.5)
    with profile(activities=[ProfilerActivity.CUDA]):
        r.render_frames_device(4 * BLOCK)
        torch.cuda.synchronize()
    assert len(rows) == 4 and sum(rows) > 0
    assert P.counted("h2d.bytes") == P.counted("h2d.bytes.rows") == 4 * sum(rows)
    assert {sp.name for sp in P.recorded()} >= {"render.call", "steps.rows", "steps.replay"}
