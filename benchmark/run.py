"""Run one cell of the benchmark of ``oddio_tpu_torch`` once, on the CUDA
card of this machine, and print the result as the last line of standard
output (one JSON object).

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run it from the root of a checkout that holds ``BENCHMARK.json`` and the
port.  ``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1``
its per-layer metrics, read from host spans over the window and from a
``torch.profiler`` trace of a slice of it.  The numbers compared with the
plain reference, each with its limit, are the last lines of standard
error and the last key of the result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# every kernel cache at a fixed path inside the checkout
_CACHE = ROOT / ".bench_cache"
os.environ["TRITON_CACHE_DIR"] = str(_CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(_CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(_CACHE / "nv")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(ROOT))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card_line():
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
        return out[0].strip() if out else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import harness

    spec_path = ROOT / "BENCHMARK.json"
    if not spec_path.exists():
        log("run: no BENCHMARK.json at the checkout's root")
        return 2
    spec = json.loads(spec_path.read_text())
    try:
        cell = harness.Cell(spec, args.workload)
    except harness.BenchError as e:
        log(f"run: {e}")
        return 2

    import torch

    chips = int(cell.workload.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"run: needs {chips} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    from oddio_tpu_torch.ops import _build

    built = _build.build()  # every kernel library, one nvcc each, in parallel
    log(f"run: card {card_line()}; kernel libraries "
        + ", ".join(f"{k} {v[1]:.1f} s" for k, v in sorted(built.items())))
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), T0, emit=log)
    return finish(result, list(sys.modules))


def finish(result, modules):
    """Print the result, its checks last on standard error, unless
    ``modules`` holds JAX or the JAX package: then print none and return
    a failing code."""
    import harness

    found = harness.forbidden_modules(modules)
    if found:
        log(f"run: the process holds {found}: no run may load JAX or the JAX package")
        return 4
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
