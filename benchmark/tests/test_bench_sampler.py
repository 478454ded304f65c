"""The spatial sampler's cell, ``spatial-sampler4096-sfx-offline``, at a
tiny size on the CPU: it runs through the harness and agrees with its
plain reference; a Fader that ignores ``fade_to`` reads not correct; its
two per-layer metrics read None without their trace or spans and in the
other cells; the arena steps' bytes equal values worked out by hand."""

import time

import pytest

import arena_work
import harness
from helpers import SPEC

NAME = "spatial-sampler4096-sfx-offline"


@pytest.fixture(autouse=True)
def _fresh():
    from oddio_tpu_torch.utils import profiler

    profiler.clear()
    yield
    profiler.clear()


def sampler_cell():
    cell = harness.Cell(SPEC, NAME)
    cell.config.update({"voices": {"frames": 16, "speed": 8, "fader": 4, "cycle": 4},
                        "capacity": 4,
                        "bank": dict(cell.config["bank"], sounds=3, seconds=[0.2, 0.5])})
    cell.traffic.update({"tick": {"every_calls": 1, "voices": 8, "position_error_m": 1.0},
                         "speed_writes": 4, "fades": 2, "check_blocks": 8, "warm_calls": 3,
                         "blocks_per_call": 8, "trace_calls": 4})
    return cell


def _run(cell, trace=False, seed=3000000001, seconds=1.5):
    return harness.run_cell(cell, seed, seconds, trace, time.perf_counter(), device="cpu")


def test_sampler_cell_agrees_with_reference():
    cell = sampler_cell()
    r = _run(cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert 0 <= r["checks"]["pcm_err"]["value"] <= cell.limits["pcm_err"]["limit"]
    assert set(r["metrics"]) == {m["name"] for m in cell.end_to_end} == {"xrt", "setup_s"}
    assert list(r)[-1] == "checks"


def test_fader_ignoring_fade_to_is_caught(monkeypatch):
    import oddio_tpu_torch as pt

    monkeypatch.setattr(pt.FaderControl, "fade_to", lambda self, signal, duration: None)
    r = _run(sampler_cell())
    assert r["correct"] is False, r["checks"]


def test_traced_sampler_run_reads_lifecycle_ms():
    r = _run(sampler_cell(), trace=True)
    assert r["metrics"]["lifecycle_ms"]["value"] > 0
    # on the CPU no device kernel runs: nothing for the roofline to read
    assert "arena_roofline_pct" not in r["metrics"]


@pytest.mark.parametrize("metric", ["arena_roofline_pct", "lifecycle_ms"])
def test_metric_reads_none_without_its_trace_or_spans(metric):
    cell = harness.Cell(SPEC, NAME)
    reader = cell.reader(metric)
    shapes = {"kind": "sampler", "n": 512, "voices": {"frames": 1}, "ds": {"frames": 1.0},
              "fading": 0}
    assert reader.read({"trace": None, "shapes": shapes}) is None
    empty = {"ops": [("elementwise_kernel<128, 2>", 0, 1000, "kernel")], "spans": [],
             "blocks": 4}
    assert reader.read({"trace": empty, "shapes": shapes}) is None


def test_sampler_metrics_read_none_in_other_cells():
    """A spatial cell's shapes and a traced slice with its spans and
    kernels but no play, sync or arena step read nothing."""
    from oddio_tpu_torch.utils import profiler as P
    from torch.profiler import ProfilerActivity, profile

    cell = harness.Cell(SPEC, NAME)
    with profile(activities=[ProfilerActivity.CPU]):
        t0 = time.time_ns()
        with P.span("render.call"):
            with P.span("pool.deltas"):
                time.sleep(0.001)
        t1 = time.time_ns()
    trace = {"ops": [("ring_select_kernel(float const*, ...)", t0, 1000, "kernel")],
             "spans": [("dispatch", t0, t1)], "blocks": 4}
    shapes = {"kind": "spatial", "voices": 48, "n": 512}
    for metric in ("arena_roofline_pct", "lifecycle_ms"):
        assert cell.reader(metric).read({"trace": trace, "shapes": shapes}) is None
    sampler = {"kind": "sampler", "n": 512, "voices": {"frames": 1}, "ds": {"frames": 1.0},
               "fading": 0}
    assert cell.reader("arena_roofline_pct").read({"trace": trace, "shapes": sampler}) is None


def test_arena_bytes_by_hand():
    sh = {"n": 512, "voices": {"frames": 2048, "speed": 1024, "fader": 512, "cycle": 512},
          "ds": {"frames": 0.91875, "speed": 0.91875 * 1.025, "fader": 0.91875 * 1.025,
                 "cycle": 0.91875}, "fading": 4.0}
    b, f = arena_work.arena_step_work(sh)
    # spans: ceil(512 * ds) + 1 = 472, 484, 484, 472 samples
    want = (2048 * (4 * 472 + 2 * 48 + 2048) + 1024 * (4 * 484 + 2 * 52 + 2048)
            + 516 * 4 * 484 + 512 * (2 * 114 + 2048) + 512 * (4 * 472 + 2 * 40 + 2048))
    assert b == pytest.approx(want)
    assert f == (2048 + 1024 + 516 + 512) * 512 * 4


def test_lifecycle_ms_reads_the_median_call():
    """Four calls' controls, each with its sync and plays; a pause of
    0.25 s inside one call's play (a full cyclic collection) leaves the
    reading at the other calls' time a block."""
    from oddio_tpu_torch.utils import profiler as P
    from torch.profiler import ProfilerActivity, profile

    cell = harness.Cell(SPEC, NAME)
    calls = []
    with profile(activities=[ProfilerActivity.CPU]):
        for k in range(4):
            a = time.time_ns()
            with P.span("scene.sync"):
                time.sleep(0.001)
            with P.span("scene.play"):
                time.sleep(0.25 if k == 2 else 0.004)
            calls.append(("control", a, time.time_ns()))
    per_block = {}
    for k, (_, a, b) in enumerate(calls):
        inside = [sp for sp in P.recorded(a, b)]
        per_block[k] = sum(sp.end_ns - sp.start_ns for sp in inside) / 1e6 / 47
    trace = {"ops": [], "spans": calls, "blocks": 4 * 47}
    got = cell.reader("lifecycle_ms").read({"trace": trace, "shapes": {"kind": "sampler"}})
    quiet = sorted(v for k, v in per_block.items() if k != 2)
    assert quiet[0] <= got <= quiet[-1] < 0.5 * per_block[2]
