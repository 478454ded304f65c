"""Where the arena step's device time goes: variants of
``csrc/stream_kernels.cu``'s ``arena_step_kernel`` (K6's arena form as
whole steps).

Each variant is a copy of the kernel source with one design swapped or
one part removed, built with the package's nvcc flags and timed through
the package's step routes on the paths' captured states
(``kernel_bench.arena_states``: the 1024-voice sampler's whole Fader step
and one bank's step, the wavetable's Speed(Cycle) step, the seek
sampler's warped read), warm (one block's state, 50 calls) and cold (the
next of ``kernel_bench.SETS`` blocks' states each call).  A variant that
removes work computes a wrong step: it reports ``exact False`` and only
its time means anything.  Variants:

* ``as_built``: the source as it is (64 threads a row, two rows a CUDA
  block);
* ``warp_per_row``: the first form's layout, one warp a row, four rows a
  CUDA block (16 frames a thread at n = 512);
* ``tpr64_rows1``, ``tpr128``, ``tpr128_rows2``, ``tpr256``: 64, 128, 128
  or 256 threads a row, one or two rows a CUDA block;
* ``int64_position``: the read position converted to 64 bits, as the
  first form did (one slow conversion more a frame);
* ``no_reads``: no arena loads (each frame lerps two values made from its
  index), the time of everything but the reads;
* ``no_stores``: no output stores (the frames summed in a register);
* ``empty``: every thread returns at once, the launch of the grid alone.

Run on a machine with the card (every variant, or the ones named)::

    python3 -m oddio_tpu_torch.utils.step_ablate [VARIANT ...]
"""

from __future__ import annotations

import ctypes
import subprocess
import tempfile
from pathlib import Path

import torch

from oddio_tpu_torch.ops import _build
from oddio_tpu_torch.utils import kernel_bench as KB

SRC = Path(__file__).resolve().parents[1] / "csrc" / "stream_kernels.cu"
_TPR = "#define STEP_TPR 64    // threads per output row"
_ROWS = "#define STEP_ROWS 2    // output rows per CUDA block"


def _shape(tpr, rows):
    return [(_TPR, f"#define STEP_TPR {tpr}"), (_ROWS, f"#define STEP_ROWS {rows}")]


#: name: [(old, new) source edits]
VARIANTS = {
    "as_built": [],
    "warp_per_row": _shape(32, 4),
    "tpr64_rows1": _shape(64, 1),
    "tpr128": _shape(128, 1),
    "tpr128_rows2": _shape(128, 2),
    "tpr256": _shape(256, 1),
    "int64_position": [("  long long p = (long long)xc + 1 + __float2int_rn(wr);",
                        "  long long p = (long long)xc + 1 + (long long)wr;")],
    "no_reads": [("  const float a = __ldg(arena + p);\n  const float b = __ldg(arena + p + 1);",
                  "  const float a = (float)(p & 7);\n  const float b = (float)(p & 3);")],
    "no_stores": [
        ("  float* __restrict__ orow = A.out + (long long)r * A.n;\n",
         "  float* __restrict__ orow = A.out + (long long)r * A.n;\n  float sink = 0.0f;\n"),
        ("orow[j0 + jj] = ", "sink += "),
        ("}\n\ntemplate <bool CYC>\nstatic void step_launch",
         "  if (sink == 12345.678f) orow[0] = sink;\n}\n\ntemplate <bool CYC>\n"
         "static void step_launch")],
    "empty": [("  constexpr int NB = FORM == 2 ? 2 : 1;\n",
               "  constexpr int NB = FORM == 2 ? 2 : 1;\n  if (A.n > 0) return;\n")],
}


def variant_source(src, edits):
    for old, new in edits:
        if old not in src:
            raise ValueError(f"step_ablate: {old[:50]!r} is not in {SRC.name}")
        src = src.replace(old, new)
    return src


def build(src, edits, tmp, name):
    """Build a variant; (library, ptxas log) or (None, the error)."""
    cu, so = Path(tmp) / f"{name}.cu", Path(tmp) / f"{name}.so"
    cu.write_text(variant_source(src, edits))
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                       capture_output=True, text=True)
    if r.returncode:
        return None, r.stderr[-1500:]
    L = ctypes.CDLL(str(so))
    L.arena_step.argtypes = _build._SIGNATURES["stream_kernels"]["arena_step"]
    L.arena_step.restype = ctypes.c_int
    return L, r.stderr


def _equal(got, want):
    """Step results equal (a Fader's output up to the sign of an exact
    zero: equal values)."""
    if isinstance(got, dict):
        return all(_equal(got[k], want[k]) for k in got)
    if isinstance(got, tuple):
        return all(_equal(g, w) for g, w in zip(got, want))
    return bool(torch.equal(got, want))


def main(argv=None):
    import sys

    names = (sys.argv[1:] if argv is None else argv) or list(VARIANTS)
    for name in names:
        if name not in VARIANTS:
            raise SystemExit(f"step_ablate: unknown variant {name!r}; one of {list(VARIANTS)}")
    if not torch.cuda.is_available():
        raise SystemExit("step_ablate: needs a CUDA card")
    from oddio_tpu_torch.utils.read_ablate import ptxas_usage
    from oddio_tpu_torch.utils.scene_profile import card_line

    card = card_line()
    dev = torch.device("cuda")
    cases = []
    for label, proto, method, kind, C, calls in KB.arena_states(dev):
        cases.append((label, proto, method, kind, C, calls))
        if "prog" in calls[0][0]:  # one bank's step alone
            bank = [(a[0]["a"], a[1].get("a", {})) + a[2:] for a in calls]
            cases.append((f"{label} bank a", proto.a, "dr_render", kind, C, bank))
    plain = [KB.step_call(p, m, k, C, calls[0], plain=True)() for _, p, m, k, C, calls in cases]
    src = SRC.read_text()
    lib = _build._libs.get("stream_kernels")
    with tempfile.TemporaryDirectory() as tmp:
        try:
            for name in names:
                L, log = build(src, VARIANTS[name], tmp, name)
                if L is None:
                    print(f"{name}: build failed\n{log}")
                    continue
                _build._libs["stream_kernels"] = L
                parts = []
                for (label, proto, method, kind, C, calls), want in zip(cases, plain):
                    warm = KB.step_call(proto, method, kind, C, calls[0])
                    ok = _equal(warm(), want)
                    cold = KB.cycling([(KB.step_call(proto, method, kind, C, a),)
                                       for a in calls[1:1 + KB.SETS]], lambda f: f())
                    parts.append(f"{label}: device_ms warm {KB.device_ms(warm):.4f}, cold "
                                 f"{KB.device_ms(cold):.4f}, exact {ok}")
                regs = ptxas_usage(log, "arena_step_kernelILb0ELi2E")
                print(f"arena_step {name}: {'; '.join(parts)}; Fader form {regs} [{card}]",
                      flush=True)
        finally:
            if lib is None:
                _build._libs.pop("stream_kernels", None)
            else:
                _build._libs["stream_kernels"] = lib


if __name__ == "__main__":
    main()
