"""Readings for a cell's limits: the program's compared numbers over many
seeds and the control's (the plain reference computed in bfloat16 in the
program's place), each from a run of the cell at its own size and load.
The benchmark's own runs do not run the control.

    python benchmark/calibrate.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

Prints one JSON line per seed: the program's checks and the control's
numbers on the same blocks.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import run  # noqa: E402  (sets the caches and the import path)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    import harness
    import torch

    if not torch.cuda.is_available():
        run.log("calibrate: needs a CUDA card")
        return 3
    from oddio_tpu_torch.ops import _build

    _build.build()
    spec = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    cell = harness.Cell(spec, args.workload)
    run.log(f"calibrate: card {run.card_line()}")
    for seed in args.seeds:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        res = harness.run_cell(cell, seed, args.seconds, False, t0, emit=run.log,
                               controls=(torch.bfloat16,))
        line = {"seed": seed, "program": {k: c["value"] for k, c in res["checks"].items()},
                "control": res.get("controls", {}), "attempted": res["attempted"],
                "metrics": {k: m["value"] for k, m in res["metrics"].items()}}
        print(json.dumps(line), flush=True)
    found = harness.forbidden_modules(list(sys.modules))
    if found:
        run.log(f"calibrate: the process holds {found}")
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
