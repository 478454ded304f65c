"""The per-layer metrics read from the program's own spans and counters
(``oddio_tpu_torch.utils.profiler``): each on a small made-up slice
returns the value its span or counter gives, leaves out what was recorded
outside the slice, and returns None where its span or counter is absent
(as on a program without them)."""

import time

import pytest
from torch.profiler import ProfilerActivity, profile

import harness
from helpers import SPEC
from oddio_tpu_torch.utils import profiler as P

BLOCKS = 4


@pytest.fixture(autouse=True)
def _fresh():
    P.clear()
    yield
    P.clear()


def _reader(name):
    return harness.Cell(SPEC, SPEC["workloads"][0]["name"]).reader(name)


def _record(name, counts=()):
    """One span ``name`` inside a harness span, under a profiler session;
    returns (the harness span, the program span)."""
    with profile(activities=[ProfilerActivity.CPU]):
        t0 = time.time_ns()
        with P.span("outer"):
            with P.span(name):
                time.sleep(0.002)
                for k, v in counts:
                    P.count(k, v)
        t1 = time.time_ns()
    sp = [s for s in P.recorded() if s.name == name][-1]
    return ("dispatch", t0, t1), sp


def _ctx(harness_spans, blocks=BLOCKS):
    return {"trace": {"blocks": blocks, "spans": list(harness_spans)}}


SPAN_METRICS = {"pack_merge_ms": "pack.merge", "walk_plan_ms": "pool.plan",
                "row_upload_ms": "steps.rows"}


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_span_metric_is_ms_a_block_of_its_span(metric):
    name = SPAN_METRICS[metric]
    outside = _record(name)[1]  # recorded before the slice: left out
    h, sp = _record(name)
    assert outside.end_ns < h[1]
    got = _reader(metric).read(_ctx([h]))
    assert got == pytest.approx(1e3 * (sp.end_ns - sp.start_ns) / 1e9 / BLOCKS)
    assert got >= 2.0 / BLOCKS


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS) + ["h2d_kb_per_block",
                                                           "ingest_useful_pct"])
def test_program_metric_is_none_without_its_span_or_counter(metric):
    h, _ = _record("some.other.span", [("other.count", 5)])
    assert _reader(metric).read(_ctx([h])) is None
    assert _reader(metric).read({"trace": None}) is None


def test_h2d_kb_per_block_sums_every_route():
    h, _ = _record("steps.rows", [("h2d.bytes.rows", 6000), ("h2d.bytes.pinned", 1000),
                                  ("h2d.bytes.pageable", 1000), ("ingest.slots", 99)])
    assert _reader("h2d_kb_per_block").read(_ctx([h])) == pytest.approx(8.0 / BLOCKS)


def test_ingest_useful_pct_is_samples_over_slots():
    h, _ = _record("pack.prepare", [("ingest.samples", 8192), ("ingest.slots", 76832)])
    assert _reader("ingest_useful_pct").read(_ctx([h])) == pytest.approx(
        100.0 * 8192 / 76832)


def test_program_metrics_are_declared_where_their_spans_run():
    per = {m["name"]: m for m in SPEC["per_layer"]}
    for name in list(SPAN_METRICS) + ["h2d_kb_per_block", "ingest_useful_pct"]:
        m = per[name]
        assert m["moves"] == "xrt" and m["workloads"]
        assert m["source"] == ("program_span" if name in SPAN_METRICS else "program_counter")
