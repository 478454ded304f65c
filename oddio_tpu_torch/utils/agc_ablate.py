"""Where K7's device time goes: variants of ``csrc/agc_kernel.cu``'s Adapt
step (``agc_step_kernel``).

Each variant is a copy of the kernel source with one part removed or one
design swapped, built with the package's nvcc flags and timed through
``agc.agc_step`` at the shapes the pools give it: 4096 mono voices at n =
512 (the config-5 mixer's block, scalar interval) and 512 at n = 513 (a
buffered pool's), warm (one operand set, 50 calls) and cold (each call on
the next of ``kernel_bench.SETS`` operand sets, whose samples pass the
card's 50 MB L2 at 4096 voices).  A variant that removes work computes a
wrong step: it reports ``within_tol False`` and only its time means
anything.  Variants:

* ``as_built``: the source as it is (a warp per voice, 8 voices per CUDA
  block, the samples staged in shared memory, one ``expf`` per frame);
* ``no_loads``: no sample loads (a constant staged instead);
* ``two_expf``: the prev factor ``expf(min(i, count)*lg)`` computed per
  frame instead of taken from the previous frame's ``M``;
* ``no_division``: the term's and the gain's divisions made products;
* ``warps1``/``warps4``: 1 or 4 voices (warps) per CUDA block;
* ``block_per_voice``: the fused step with a CUDA block per voice and a
  thread per frame (warp scans, the warp
  totals scanned by warp 0 between two block barriers, two ``expf`` per
  frame, no staging).

Two more builds write ``alpha`` and ``log1p(-alpha)`` where the carry goes
and compare them, bit for bit, with torch's CUDA ``1 - exp(-iv/tau)`` and
``log1p(-alpha)`` on 4096 voices of taus from 0.3 ms to 1 s and
per-voice intervals.

Run on a machine with the card (every variant, or the ones named)::

    python3 -m oddio_tpu_torch.utils.agc_ablate [VARIANT ...]
"""

from __future__ import annotations

import ctypes
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from oddio_tpu_torch.ops import _build
from oddio_tpu_torch.ops import agc as A
from oddio_tpu_torch.utils import kernel_bench as KB

SRC = Path(__file__).resolve().parents[1] / "csrc" / "agc_kernel.cu"
_CARRY = "      if (i == n - 1) A.carry[v] = __fmul_rn(M[k], __fadd_rn(avg0, excl));"
_DISPATCH = "  if (n <= 32) return launch<1>(A, stream);"
_BLOCK = r'''
__global__ void __launch_bounds__(1024) agc_block_kernel(const AgcArgs A) {
  __shared__ float wsum[32];
  const int v = blockIdx.x, i = threadIdx.x, lane = i & 31, warp = i >> 5;
  const int nw = blockDim.x >> 5, n = A.n, C = A.C;
  const float* src = A.x + (long long)v * C * n;
  const float iv = A.iv_v != nullptr ? A.iv_v[(long long)v * A.s_iv] : A.iv;
  const float a = __fsub_rn(1.0f, expf(__fdiv_rn(-iv, A.tau[v])));
  const float lg = log1pf(-a);
  const float lim = (float)A.count[(long long)v * A.s_count];
  const float avg0 = A.avg0[v];
  const bool live = i < n;
  float x = 0.0f;
  if (live) {
    x = src[i];
    for (int c = 1; c < C; ++c) x = __fadd_rn(x, src[c * n + i]);
  }
  const float fi = (float)i;
  const float M = live ? expf(__fmul_rn(fminf(__fadd_rn(fi, 1.0f), lim), lg)) : 1.0f;
  const float term =
      (live && fi < lim) ? __fdiv_rn(__fmul_rn(a, __fmul_rn(x, x)), M) : 0.0f;
  float cs = term;
  for (int d = 1; d < 32; d <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, cs, d);
    if (lane >= d) cs = __fadd_rn(cs, y);
  }
  if (lane == 31) wsum[warp] = cs;
  __syncthreads();
  if (warp == 0) {
    float w = lane < nw ? wsum[lane] : 0.0f;
    for (int d = 1; d < 32; d <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w = __fadd_rn(w, y);
    }
    if (lane < nw) wsum[lane] = w;
  }
  __syncthreads();
  if (warp > 0) cs = __fadd_rn(cs, wsum[warp - 1]);
  if (!live) return;
  const float excl = __fsub_rn(cs, term);
  const float prev =
      __fmul_rn(expf(__fmul_rn(fminf(fi, lim), lg)), __fadd_rn(avg0, excl));
  const float avg2 = __fadd_rn(__fmul_rn(__fmul_rn(x, x), a),
                               __fmul_rn(prev, __fsub_rn(1.0f, a)));
  const float g = agc_gain(avg2, A.low[v], A.high[v], A.mg[v]);
  for (int c = 0; c < C; ++c)
    A.out[(long long)v * C * n + c * n + i] = __fmul_rn(src[c * n + i], g);
  if (i == n - 1) A.carry[v] = __fmul_rn(M, __fadd_rn(avg0, cs));
}

extern "C" int agc_step('''

#: name: [(old, new) source edits]
VARIANTS = {
    "as_built": [],
    "no_loads": [("buf[j] = __ldg(src + j);",
                  "buf[j] = __int_as_float(0x3e800000 + (j & 1023)) + 0.0f * (float)(src != 0);")],
    "two_expf": [("      const float prev = __fmul_rn(Mprev, __fadd_rn(avg0, excl));",
                  "      const float prev = __fmul_rn(expf(__fmul_rn(fminf((float)i, lim), lg)),"
                  " __fadd_rn(avg0, excl));")],
    "no_division": [
        ("term[k] = __fdiv_rn(__fmul_rn(a, __fmul_rn(x, x)), M[k]);",
         "term[k] = __fmul_rn(__fmul_rn(a, __fmul_rn(x, x)), M[k]);"),
        ("const float q = __fdiv_rn(low, peak);", "const float q = __fmul_rn(low, peak);"),
        ("if (peak > high) return __fdiv_rn(high, peak);",
         "if (peak > high) return __fmul_rn(high, peak);")],
    "warps1": [("#define AGC_WARPS 8 ", "#define AGC_WARPS 1 ")],
    "warps4": [("#define AGC_WARPS 8 ", "#define AGC_WARPS 4 ")],
    "block_per_voice": [
        ("\nextern \"C\" int agc_step(", _BLOCK),
        (_DISPATCH, "  agc_block_kernel<<<V, 32 * ((n + 31) / 32), 0, stream>>>(A);\n"
                    "  return (int)cudaGetLastError();\n" + _DISPATCH)],
}
#: builds that write a per-voice value where the carry goes
PROBES = {"alpha": [(_CARRY, "      if (i == n - 1) A.carry[v] = a;")],
          "log1p": [(_CARRY, "      if (i == n - 1) A.carry[v] = lg;")]}

#: (label, voices, frames) of the timed shapes
SHAPES = (("mixer", 4096, 512), ("buffered", 512, 513))


def variant_source(src, edits):
    for old, new in edits:
        if old not in src:
            raise ValueError(f"agc_ablate: {old[:50]!r} is not in {SRC.name}")
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
    L.agc_step.argtypes = _build._SIGNATURES["agc_kernel"]["agc_step"]
    L.agc_step.restype = ctypes.c_int
    return L, r.stderr


def operands(dev, rng, Vs, n, per_voice=False, taus=(0.1,)):
    """``agc_step``'s operands: N(0, amp) samples with amp in {0.01, 0.1,
    0.5, 1}, counts below n on half the voices, the config-5 columns."""
    def t(x, dtype=np.float32):
        return torch.tensor(np.asarray(x, dtype), device=dev)

    amp = rng.choice([0.01, 0.1, 0.5, 1.0], (Vs, 1))
    count = np.where(np.arange(Vs) < Vs // 2, n, rng.integers(0, n + 1, Vs))
    iv = (t(rng.uniform(0.8, 1.25, Vs) / 48000.0) if per_voice
          else float(np.float32(1.0 / 48000.0)))
    return (t(rng.standard_normal((Vs, n)) * amp), t(rng.uniform(1e-3, 0.3, Vs)),
            t(np.resize(np.asarray(taus), Vs)), iv, t(count, np.int32),
            t(np.full(Vs, 0.1 / np.sqrt(2))), t(np.full(Vs, 0.5 / np.sqrt(2))),
            t(np.full(Vs, 4.0)))


def main(argv=None):
    import sys

    names = (sys.argv[1:] if argv is None else argv) or list(VARIANTS)
    for name in names:
        if name not in VARIANTS:
            raise SystemExit(f"agc_ablate: unknown variant {name!r}; one of {list(VARIANTS)}")
    if not torch.cuda.is_available():
        raise SystemExit("agc_ablate: needs a CUDA card")
    from oddio_tpu_torch.utils.read_ablate import ptxas_usage
    from oddio_tpu_torch.utils.scene_profile import card_line

    card = card_line()
    dev = torch.device("cuda")
    rng = np.random.default_rng(8)
    shapes = []
    for label, Vs, n in SHAPES:
        sets = [operands(dev, rng, Vs, n) for _ in range(KB.SETS)]
        plain = A.agc_step_plain(*sets[0], n)
        tol = A.agc_tolerance(*sets[0], n)
        shapes.append((label, Vs, n, sets, plain, tol))
    src = SRC.read_text()
    lib = _build._libs.get("agc_kernel")
    with tempfile.TemporaryDirectory() as tmp:
        try:
            for name in names:
                L, log = build(src, VARIANTS[name], tmp, name)
                if L is None:
                    print(f"{name}: build failed\n{log}")
                    continue
                _build._libs["agc_kernel"] = L
                parts = []
                for label, Vs, n, sets, plain, tol in shapes:
                    out, carry = A.agc_step(*sets[0], n)
                    ok = bool(((out - plain[0]).abs().double() <= tol[0]).all()
                              and ((carry - plain[1]).abs().double() <= tol[1]).all())
                    warm = KB.device_ms(lambda: A.agc_step(*sets[0], n))
                    cold = KB.device_ms(KB.cycling(sets, lambda *o: A.agc_step(*o, n)))
                    parts.append(f"{label} V={Vs} n={n}: device_ms warm {warm:.4f}, cold "
                                 f"{cold:.4f}, within_tol {ok}")
                regs = ptxas_usage(log, "agc_")
                print(f"K7 {name}: {'; '.join(parts)}; {regs} [{card}]", flush=True)
            # alpha and log1p(-alpha) against torch's CUDA ops, bit for bit
            ops = operands(dev, rng, 4096, 512, per_voice=True,
                           taus=np.geomspace(3.4e-4, 1.0, 4096))
            alpha = A._alpha(ops[3], ops[2])
            want = {"alpha": alpha, "log1p": torch.log1p(-alpha)}
            for probe, edits in PROBES.items():
                L, log = build(src, edits, tmp, probe)
                if L is None:
                    print(f"{probe}: build failed\n{log}")
                    continue
                _build._libs["agc_kernel"] = L
                got = A.agc_step(*ops, 512)[1]
                differ = int((got != want[probe]).sum())
                print(f"K7 {probe} in the kernel vs torch's CUDA op: {differ} of 4096 voices "
                      f"differ (taus 0.34 ms to 1 s, per-voice intervals; max |diff| "
                      f"{float((got - want[probe]).abs().max()):.3e}) [{card}]", flush=True)
        finally:
            if lib is None:
                _build._libs.pop("agc_kernel", None)
            else:
                _build._libs["agc_kernel"] = lib


if __name__ == "__main__":
    main()
