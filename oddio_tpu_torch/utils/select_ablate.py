"""Where K5's device time goes: ablations of ``csrc/select_kernel.cu``.

Each variant is a copy of the kernel source with one part removed or one
size changed, built with the package's nvcc flags and timed through
``strip_select_record`` at the host pool's main shape (4096 voices,
n = 512, L = 16384), warm and cold, as ``utils/kernel_bench.py`` times
K5.  A variant that removes work computes a wrong mix: it reports
``within_tol False`` and only its time means anything.  Variants:

* ``as_built``: the source as it is;
* ``no_reads``: no staging copies and no shared-memory taps;
* ``no_position``: the per-frame position math replaced by a constant;
* ``no_tail``: every cluster writes the output, no cross-cluster sum;
* ``vc16``/``vc64``: 16 or 64 voices per CUDA block (``VC``);
* ``vh4``: staging groups of 4 voices (``VH``);
* ``cl4``: clusters of 4 CUDA blocks (``CL_MAX``).

Run on a machine with the card::

    python3 -m oddio_tpu_torch.utils.select_ablate
"""

from __future__ import annotations

import ctypes
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from oddio_tpu_torch.ops import _build
from oddio_tpu_torch.ops import ring_kernels as RK
from oddio_tpu_torch.utils import kernel_bench as KB

SRC = Path(__file__).resolve().parents[1] / "csrc" / "select_kernel.cu"
_LERP = "          const float s = __fadd_rn(a, __fmul_rn(fr, __fsub_rn(b, a)));"
_STAGE = "        if (i < nv && s_m[i] != 0.0f && t < s_nq[i]) {  // nq <= STAGE/4 < SB"
_POS0 = "  const float H = __fmul_rn(t, f_hi);"
_POS1 = "  *kk = (int)k;\n}"

#: name: ([(old, new) source edits], K5's voices per block, cluster size)
VARIANTS = {
    "as_built": ([], 32, 8),
    "no_reads": ([(_LERP, "          a = 0.0f * fr; b = 1.0f;\n" + _LERP),
                  (_STAGE, "        if (false) {")], 32, 8),
    "no_position": ([(None, "  *fr = __fmul_rn(0.5f, o0); *kk = K;\n}")], 32, 8),
    "no_tail": ([("  if (cps == 1) {", "  if (true) {")], 32, 8),
    "vc16": ([("#define VC 32 ", "#define VC 16 ")], 16, 8),
    "vc64": ([("#define VC 32 ", "#define VC 64 ")], 64, 8),
    "vh4": ([("#define VH 8 ", "#define VH 4 ")], 32, 8),
    "cl4": ([("#define CL_MAX 8 ", "#define CL_MAX 4 ")], 32, 4),
}


def variant_source(src, edits):
    """``src`` with ``edits`` applied; an edit whose old text is None
    replaces the body of ``position()``."""
    for old, new in edits:
        if old is None:
            old = src[src.index(_POS0):src.index(_POS1) + len(_POS1)]
        if old not in src:
            raise ValueError(f"select_ablate: {old[:50]!r} is not in {SRC.name}")
        src = src.replace(old, new)
    return src


def load(so):
    """The strip_select entry of a built variant, typed as the package's."""
    L = ctypes.CDLL(str(so))
    L.strip_select.argtypes = _build._SIGNATURES["select_kernel"]["strip_select"]
    L.strip_select.restype = ctypes.c_int
    return L


def main():
    if not torch.cuda.is_available():
        raise SystemExit("select_ablate: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    label, V, L, lo, hi = KB.SELECT_CASES[0]
    kw = dict(n=KB.SELECT_N, K=KB.SELECT_K)
    sets = [KB.select_operands(dev, rng, V, L, lo, hi)]
    sets += [KB.select_operands(dev, rng, V, L, lo, hi, ring=sets[0][0])
             for _ in range(KB.SETS - 1)]
    recs = [(s[0], RK.voice_record(*s[1:])) for s in sets]
    plain = RK.strip_select_plain(*sets[0], **kw)
    tol = RK.strip_tolerance(*sets[0], **kw)
    src = SRC.read_text()
    chunk, cl_max, lib = RK.SELECT_CHUNK, RK.CLUSTER_MAX, _build._libs.get("select_kernel")
    with tempfile.TemporaryDirectory() as tmp:
        try:
            for name, (edits, vc, cl) in VARIANTS.items():
                cu, so = Path(tmp) / f"{name}.cu", Path(tmp) / f"{name}.so"
                cu.write_text(variant_source(src, edits))
                r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                                   capture_output=True, text=True)
                if r.returncode:
                    print(f"{name}: build failed\n{r.stderr[-1500:]}")
                    continue
                _build._libs["select_kernel"] = load(so)
                RK.SELECT_CHUNK, RK.CLUSTER_MAX = vc, cl  # the scratch sized to match
                RK._CLUSTER_SCRATCH.clear()
                got = RK.strip_select_record(*recs[0], **kw)
                ok = bool(((got - plain).abs().double() <= tol).all())
                warm = KB.device_ms(lambda: RK.strip_select_record(*recs[0], **kw))
                cold = KB.device_ms(KB.cycling(recs, lambda r, c: RK.strip_select_record(r, c, **kw)))
                regs = " ".join(x.split(":")[-1].strip() for x in r.stderr.splitlines() if "Used" in x)
                print(f"K5 {name} V={V}: device_ms warm {warm:.4f}, cold {cold:.4f}; within_tol "
                      f"{ok}; {regs} [{card}]", flush=True)
        finally:
            RK.SELECT_CHUNK, RK.CLUSTER_MAX = chunk, cl_max
            RK._CLUSTER_SCRATCH.clear()
            if lib is None:
                _build._libs.pop("select_kernel", None)
            else:
                _build._libs["select_kernel"] = lib


if __name__ == "__main__":
    main()
