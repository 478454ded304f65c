"""Tiny cells for the CPU tests: each cell's configuration and traffic at
a size a test run holds, run through the harness on the CPU."""

import json
import time

import harness

SPEC = json.loads((harness.HERE.parent / "BENCHMARK.json").read_text())

#: the configuration and traffic overrides that shrink each cell
TINY = {
    "spatial4096-buffered-steer-offline": (
        {"voices": 48}, {"tick": {"every_calls": 1, "voices": 8, "position_error_m": 1.0},
                         "check_blocks": 6, "warm_calls": 2}),
    "spatial4096-buffered-steer-live": (
        {"voices": 48}, {"tick": {"every_calls": 4, "voices": 8, "position_error_m": 1.0},
                         "check_blocks": 6, "warm_calls": 4, "trace_calls": 8}),
    "c5pack256-offline": (
        {"scenes": 3, "voices_per_scene": 16, "stream_voices_per_scene": 2},
        {"feed": {"talkers": 1, "samples": 2048, "handover": 1, "bank": 8},
         "check_scenes": 2, "warm_calls": 3}),
}


def tiny_cell(name, spec=SPEC, root=harness.HERE):
    cell = harness.Cell(spec, name, root)
    conf, traffic = TINY[name]
    cell.config.update(conf)
    cell.traffic.update(traffic)
    return cell


def run_tiny(cell, seed=12345, seconds=1.0, trace=False):
    return harness.run_cell(cell, seed, seconds, trace, time.perf_counter(), device="cpu")
