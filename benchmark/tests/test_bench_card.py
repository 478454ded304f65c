"""On the card: each cell runs from the command line for a short window,
comes out correct, and prints the contract's last line.  Skips without a
CUDA card."""

import json
import subprocess
import sys

import pytest

import harness
from helpers import SPEC


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_on_the_card(cuda, workload, trace):
    p = subprocess.run([sys.executable, str(harness.HERE / "run.py"), "--workload", workload,
                        "--seed", "3000000001", "--seconds", "2", "--trace", str(trace)],
                       cwd=harness.HERE.parent, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert list(res)[-1] == "checks"
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    cell = harness.Cell(SPEC, workload)
    want = cell.per_layer if trace else cell.end_to_end
    assert set(res["metrics"]) <= {m["name"] for m in want}
    if trace:
        assert res["device"]["busy_s"] > 0 and res["device"]["window_s"] > 0
        assert len(res["breakdown"]["device_ops"]) <= 10
    else:
        assert "setup_s" in res["metrics"] and "xrt" in res["metrics"]
