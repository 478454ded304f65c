"""``tick_replay_ms``, read from the program's span ``stream.ticks``
(``oddio_tpu_torch.utils.profiler``), held as the other program-span
metrics are (``test_bench_program_metrics.py``): on a small made-up slice
it returns the ms a block its span gives, leaves out what was recorded
outside the slice, and returns None where the span is absent (as on a
program without it)."""

import pytest

from helpers import SPEC
from oddio_tpu_torch.utils import profiler as P
from test_bench_program_metrics import BLOCKS, _ctx, _reader, _record


@pytest.fixture(autouse=True)
def _fresh():
    P.clear()
    yield
    P.clear()


def test_tick_replay_ms_is_ms_a_block_of_its_span():
    outside = _record("stream.ticks")[1]  # recorded before the slice: left out
    h, sp = _record("stream.ticks", [("ticks.replayed", 5888), ("ticks.batched", 5888)])
    assert outside.end_ns < h[1]
    got = _reader("tick_replay_ms").read(_ctx([h]))
    assert got == pytest.approx(1e3 * (sp.end_ns - sp.start_ns) / 1e9 / BLOCKS)
    assert got >= 2.0 / BLOCKS


def test_tick_replay_ms_is_none_without_its_span():
    h, _ = _record("pack.merge", [("ticks.replayed", 23)])
    assert _reader("tick_replay_ms").read(_ctx([h])) is None
    assert _reader("tick_replay_ms").read({"trace": None}) is None


def test_tick_replay_ms_is_declared_where_its_span_runs():
    m = {m["name"]: m for m in SPEC["per_layer"]}["tick_replay_ms"]
    assert (m["moves"], m["source"], m["unit"]) == ("xrt", "program_span", "ms")
    assert m["layer"] == "Host prepare and control"
    assert m["workloads"] == ["c5pack256-offline"]
