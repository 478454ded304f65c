"""The harness is driven by data: a throwaway configuration, traffic mix,
cell and per-layer metric, written as new files into a copy of the
benchmark, are found by name and run; and a run whose process holds JAX
(planted as a metric's import) fails without a result."""

import json
import shutil
import subprocess
import sys
import textwrap

import harness

REPO = harness.HERE.parent

RUNNER = textwrap.dedent("""
    import json, sys, time
    root, repo, workload, trace = sys.argv[1:5]
    sys.path[:0] = [root + "/benchmark", root, repo]
    import harness, run
    spec = json.load(open(root + "/BENCHMARK.json"))
    cell = harness.Cell(spec, workload, root + "/benchmark")
    res = harness.run_cell(cell, 7, 0.5, bool(int(trace)), time.perf_counter(), device="cpu")
    sys.exit(run.finish(res, list(sys.modules)))
""")


def _copy(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    b = root / "benchmark"
    conf = json.loads((b / "configs" / "spatial4096.json").read_text())
    conf["voices"] = 16
    (b / "configs" / "toy.json").write_text(json.dumps(conf))
    shutil.copy(b / "scenes" / "spatial4096.py", b / "scenes" / "toy.py")
    traffic = json.loads((b / "traffic" / "buffered-steer-live.json").read_text())
    traffic.update({"tick": {"every_calls": 4, "voices": 4, "position_error_m": 1.0},
                    "warm_calls": 4, "trace_calls": 4, "check_blocks": 4})
    (b / "traffic" / "toy-steer.json").write_text(json.dumps(traffic))
    (b / "limits" / "toy-live.json").write_text(json.dumps({"pcm_err": {"limit": 1e-4}}))
    (b / "metrics" / "toy_blocks.py").write_text("def read(ctx):\n    return ctx['blocks']\n")
    spec["configs"].append({"name": "toy", "source": "a test's throwaway", "why": "a test",
                            "file": "benchmark/configs/toy.json", "reduced": []})
    spec["workloads"].append({"name": "toy-live", "config": "toy", "traffic": "toy-steer",
                              "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "toy_blocks", "unit": "count", "better": "higher",
                              "source": "host_clock", "layer": "Device", "moves": "xrt",
                              "workloads": ["toy-live"]})
    return root, spec


def _run(root, workload, trace):
    return subprocess.run([sys.executable, "-c", RUNNER, str(root), str(REPO), workload,
                           str(trace)], capture_output=True, text=True, timeout=600)


def test_new_cell_and_metric_are_found_and_run(tmp_path):
    root, spec = _copy(tmp_path)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    p = _run(root, "toy-live", 1)
    assert p.returncode == 0, p.stderr[-2000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["metrics"]["toy_blocks"]["value"] > 0
    assert "toy_blocks" in res["metrics"] and list(res)[-1] == "checks"


def test_a_run_holding_jax_fails(tmp_path):
    root, spec = _copy(tmp_path)
    # a stand-in "jax" package in the checkout, imported by a metric
    (root / "jax").mkdir()
    (root / "jax" / "__init__.py").write_text("")
    (root / "benchmark" / "metrics" / "planted.py").write_text(
        "import jax  # noqa: F401\n\ndef read(ctx):\n    return 1.0\n")
    spec["per_layer"].append({"name": "planted", "unit": "count", "better": "higher",
                              "source": "host_clock", "layer": "Device", "moves": "xrt",
                              "workloads": ["toy-live"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    p = _run(root, "toy-live", 1)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "jax" in p.stderr


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules(["oddio_tpu_torch", "oddio_tpu_torch.ops"]) == []
    assert harness.forbidden_modules(["oddio_tpu.ops", "jaxlib.xla", "jaxtyping"]) == [
        "jaxlib", "oddio_tpu"]
    assert harness.forbidden_modules(["flax", "numpy"]) == ["flax"]
