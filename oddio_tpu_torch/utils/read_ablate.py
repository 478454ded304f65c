"""Where K2/K3's device time goes: variants of ``csrc/ring_kernels.cu``'s
ring read (``ring_select_kernel``).

Each variant is a copy of the kernel source with one part removed, one
size changed or one design swapped, built with the package's nvcc flags
and timed through ``ring_select_ears`` and ``ring_select_multi`` on the
operands of the 4096-voice buffered scene (``kernel_bench.capture_states``:
an idle block's read and a fused group's, n = 512 at the scene's tier),
warm and cold (each call on the next of ``kernel_bench.SETS`` captured
blocks or groups), as ``chip_smoke.py`` times them.  A variant that
removes work computes a wrong mix: it reports ``within_tol False`` and
only its time means anything.  Variants:

* ``as_built``: the source as it is (reads through L1);
* ``first_form``: the form first built, with ``floorf`` and a
  float-to-int conversion (quarter-rate on Hopper) in the position math,
  the voice loop unrolled 4 deep and the tail's cluster loop not
  unrolled;
* ``staged``: each voice's union window of both ears for the CUDA
  block's sub-block copied into shared memory first (up to 320 floats a
  voice, the rest read from device memory), then both taps read there;
* ``no_reads``: no ring loads;
* ``no_position``: the per-frame position math replaced by a constant;
* ``no_tail``: every cluster writes the output, no cross-cluster sum;
* ``vc16``/``vc64``: 16 or 64 voices per CUDA block (``RS_VC``);
* ``cl4``: clusters of 4 CUDA blocks (``RS_CL``);
* ``unroll1``/``unroll4``: the voice loop unrolled 1 or 4 times (8 as
  built).

Run on a machine with the card (every variant, or the ones named)::

    python3 -m oddio_tpu_torch.utils.read_ablate [VARIANT ...]
"""

from __future__ import annotations

import ctypes
import subprocess
import tempfile
from pathlib import Path

import torch

from oddio_tpu_torch.ops import _build
from oddio_tpu_torch.ops import ring_kernels as RK
from oddio_tpu_torch.utils import kernel_bench as KB

SRC = Path(__file__).resolve().parents[1] / "csrc" / "ring_kernels.cu"
_READ = ("        const float a = __ldg(row + q);\n"
         "        const float s = __fadd_rn(a, __fmul_rn(fr, __fsub_rn(__ldg(row + q1), a)));")
_POS0 = "  const float H = __fmul_rn(t, f_hi);  // exact: 12-bit f_hi, t < 4096\n  const float Hf"
_POS1 = "0x4B400000;\n}"
_PREP_END = "    s_row[t] = (long long)v * rowlen + FP;\n  }\n  __syncthreads();\n"
_WRAP = ("        int q1 = q + 1;\n"
         "        if (wrap) {")

#: the staged variant: each voice's union window of both ears' reads in
#: this sub-block (frames jb..jb+127 of the chunk, a frozen ear's frame 0)
#: in shared memory; taps outside it read device memory
_STAGED_PREP = _PREP_END.replace("  }\n  __syncthreads();\n", """    int lo = 1 << 30, hi = -(1 << 30);
    for (int e = 0; e < 2; ++e) {
      const float4 P = s_pos[t][e];
      const int a0 = s_frz[t][e] ? 0 : jb - j0;
      const int a1 = s_frz[t][e] ? 0 : min(jb + SB, n) - 1 - j0;
      int k0, k1;
      float f;
      position(P.x, P.y, P.z, P.w, K, (float)a0, &k0, &f);
      position(P.x, P.y, P.z, P.w, K, (float)a1, &k1, &f);
      lo = min(lo, s_q[t][e] + a0 + min(k0, k1));
      hi = max(hi, s_q[t][e] + a1 + max(k0, k1) + 2);
    }
    s_lo[t] = lo;
    s_len[t] = min(hi - lo, 320);
  }
  __syncthreads();
  for (int i = 0; i < nv; ++i) {
    const float* row = ring + s_row[i];
    for (int k = t; k < s_len[i]; k += SB) {
      int q = s_lo[i] + k;
      if (wrap) {
        while (q >= cap) q -= cap;
      }
      s_win[i][k] = __ldg(row + q);
    }
  }
  __syncthreads();
""")
_STAGED_SMEM = ("  __shared__ int s_last;\n",
                "  __shared__ int s_last;\n  __shared__ float s_win[RS_VC][320];\n"
                "  __shared__ int s_lo[RS_VC], s_len[RS_VC];\n")
_STAGED_READ = """        const int o = q - s_lo[i];
        float a, bt;
        if (o >= 0 && o + 1 < s_len[i]) {
          a = s_win[i][o];
          bt = s_win[i][o + 1];
        } else {
          int q1 = q + 1;
          if (wrap) {
            while (q >= cap) q -= cap;
            q1 = q + 1 == cap ? 0 : q + 1;
          }
          a = __ldg(row + q);
          bt = __ldg(row + q1);
        }
        const float s = __fadd_rn(a, __fmul_rn(fr, __fsub_rn(bt, a)));"""

_UNROLL = "#pragma unroll 8\n    for (int i = 0; i < nv; ++i) {"
#: the form first built: floorf and a float-to-int conversion (quarter-rate
#: on Hopper) in the position math, the frame's float converted per voice,
#: the voice loop unrolled 4 deep, the tail's cluster loop not unrolled
_FIRST = [
    (_UNROLL, _UNROLL.replace("8", "4")),
    ("#pragma unroll 8\n  for (int r = 0; r < cps; ++r) {", "  for (int r = 0; r < cps; ++r) {"),
    ("  const float Hf = floor_small(H);", "  const float Hf = floorf(H);"),
    ("  const float fl_u = floor_small(u);", "  const float fl_u = floorf(u);"),
    ("  *kk = __float_as_int(__fadd_rn(k, MAGIC)) - 0x4B400000;\n}", "  *kk = (int)k;\n}"),
    ("        position(P.x, P.y, P.z, P.w, K, fz ? 0.0f : tl, &kk, &fr);",
     "        position(P.x, P.y, P.z, P.w, K, (float)jj, &kk, &fr);"),
]

#: name: ([(old, new) source edits], voices per CUDA block, cluster size)
VARIANTS = {
    "as_built": ([], 32, 8),
    "first_form": (_FIRST, 32, 8),
    "staged": ([_STAGED_SMEM, (_PREP_END, _STAGED_PREP),
                (_WRAP + "\n          while (q >= cap) q -= cap;\n"
                 "          q1 = q + 1 == cap ? 0 : q + 1;\n        }\n" + _READ,
                 _STAGED_READ)], 32, 8),
    "no_reads": ([(_READ, "        const float a = 0.0f * q1;\n"
                          "        const float s = __fadd_rn(a, __fmul_rn(fr, 1.0f));")], 32, 8),
    "no_position": ([(None, "  *fr = __fmul_rn(0.5f, o0);\n  *kk = K;\n}")], 32, 8),
    "no_tail": ([("  if (cps == 1) {", "  if (true) {")], 32, 8),
    "vc16": ([("#define RS_VC 32 ", "#define RS_VC 16 ")], 16, 8),
    "vc64": ([("#define RS_VC 32 ", "#define RS_VC 64 ")], 64, 8),
    "cl4": ([("#define RS_CL 8 ", "#define RS_CL 4 ")], 32, 4),
    "unroll1": ([(_UNROLL, _UNROLL.replace("8", "1"))], 32, 8),
    "unroll4": ([(_UNROLL, _UNROLL.replace("8", "4"))], 32, 8),
}


def variant_source(src, edits):
    """``src`` (ring_kernels.cu with select_read.cuh inlined) with
    ``edits`` applied; an edit whose old text is None replaces the body of
    ``position()``."""
    for old, new in edits:
        if old is None:
            old = src[src.index(_POS0):src.index(_POS1) + len(_POS1)]
        if old not in src:
            raise ValueError(f"read_ablate: {old[:50]!r} is not in {SRC.name}")
        src = src.replace(old, new)
    return src


def ptxas_usage(log, kernel):
    """The ``Used ... registers`` line ptxas printed for ``kernel``."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            for x in lines[i + 1:i + 4]:
                if "Used" in x:
                    return x.split(":", 1)[-1].strip()
    return ""


def load(so):
    """The ring_select entry of a built variant, typed as the package's."""
    L = ctypes.CDLL(str(so))
    L.ring_select.argtypes = _build._SIGNATURES["ring_kernels"]["ring_select"]
    L.ring_select.restype = ctypes.c_int
    return L


def main(argv=None):
    import sys

    names = (sys.argv[1:] if argv is None else argv) or list(VARIANTS)
    for name in names:
        if name not in VARIANTS:
            raise SystemExit(f"read_ablate: unknown variant {name!r}; one of {list(VARIANTS)}")
    if not torch.cuda.is_available():
        raise SystemExit("read_ablate: needs a CUDA card")
    from oddio_tpu_torch.utils.scene_profile import build_spatial, card_line

    card = card_line()
    dev = torch.device("cuda")
    pool, _, singles, groups = KB.capture_states(build_spatial(True, KB.V, dev)[1])
    R, K = pool._read_cfg
    n, nb = KB.W, groups[0][4]
    geo = dict(DMAX=pool.emax2, FP=pool.W_CHUNK, cap=pool.cap_pool)
    row0s, hs = RK.multi_rows(pool._prep_inv[2], K, nb)
    ears = []
    for s in singles:
        S, ros = KB.block_reads(pool, *s)
        ears.append((S["ring"], ros[0]))
    groups = [(S["ring"], ros) for S, ros in (KB.block_reads(pool, *g) for g in groups)]
    kw2 = dict(n=n, K=K, R=R, **geo)
    kw3 = dict(n=n, K=K, row0s=row0s, hs=hs, **geo)
    plain2 = RK.ring_select_ears_plain(*ears[0], **kw2)
    tol2 = RK.ring_select_ears_tolerance(*ears[0], **kw2)
    plain3 = RK.ring_select_multi_plain(*groups[0], **kw3)
    tol3 = RK.ring_select_multi_tolerance(*groups[0], **kw3)
    # the position math lives in select_read.cuh: inlined, so edits reach it
    header = SRC.with_name("select_read.cuh").read_text().replace("#pragma once\n", "")
    src = SRC.read_text().replace('#include "select_read.cuh"\n', header)
    chunk, cl_max, lib = RK.SELECT_CHUNK, RK.CLUSTER_MAX, _build._libs.get("ring_kernels")
    with tempfile.TemporaryDirectory() as tmp:
        try:
            for name in names:
                edits, vc, cl = VARIANTS[name]
                cu, so = Path(tmp) / f"{name}.cu", Path(tmp) / f"{name}.so"
                cu.write_text(variant_source(src, edits))
                r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(SRC.parent),
                                    "-o", str(so), str(cu)], capture_output=True, text=True)
                if r.returncode:
                    print(f"{name}: build failed\n{r.stderr[-1500:]}")
                    continue
                _build._libs["ring_kernels"] = load(so)
                RK.SELECT_CHUNK, RK.CLUSTER_MAX = vc, cl  # the scratch sized to match
                RK._CLUSTER_SCRATCH.clear()
                ok2 = bool(((RK.ring_select_ears(*ears[0], **kw2) - plain2).abs().double()
                            <= tol2).all())
                ok3 = bool(((RK.ring_select_multi(*groups[0], **kw3) - plain3).abs().double()
                            <= tol3).all())
                times = [KB.device_ms(KB.cycling(sets, call)) for sets, call in (
                    (ears[:1], lambda g, o: RK.ring_select_ears(g, o, **kw2)),
                    (ears, lambda g, o: RK.ring_select_ears(g, o, **kw2)),
                    (groups[:1], lambda g, o: RK.ring_select_multi(g, o, **kw3)),
                    (groups, lambda g, o: RK.ring_select_multi(g, o, **kw3)))]
                regs = ptxas_usage(r.stderr, "ring_select_kernel")
                print(f"K2/K3 {name} V={KB.V}: K2 device_ms warm {times[0]:.4f}, cold "
                      f"{times[1]:.4f}; K3 nb={nb} warm {times[2]:.4f}, cold {times[3]:.4f}; "
                      f"within_tol {ok2 and ok3}; {regs} [{card}]", flush=True)
        finally:
            RK.SELECT_CHUNK, RK.CLUSTER_MAX = chunk, cl_max
            RK._CLUSTER_SCRATCH.clear()
            if lib is None:
                _build._libs.pop("ring_kernels", None)
            else:
                _build._libs["ring_kernels"] = lib


if __name__ == "__main__":
    main()
