"""Where K8's and K10's device time goes: variants of the flat-window
select they share (``csrc/select_read.cuh``'s ``flat_select_kernel``).

Each variant is a copy of the kernel sources with one size changed,
built with the package's nvcc flags and timed through ``window_select``
(K8, emax2 = 163) and ``dma_window_select`` (K10, emax2 = 36, windows up
to 600 samples past their row end) at V = 4096, n = 512, K = 64, as
``chip_smoke.py`` phase 15 times them: warm (50 calls on one operand
set) and cold (each call on the next of ``kernel_bench.SETS`` sets: K8's
windows, K10's read starts over one 268 MB ring).  Each line gives the
device ms (``torch.profiler``), the ms per call (CUDA events, host issue
included) and the host ms (wall clock), whether the result is within the
plain version's tolerance and bit-equal twice, and the registers ptxas
reports.  Variants:

* ``as_built``: the sources as they are (32 voices a CUDA block,
  clusters of up to 8, two threads a frame, each half the block's
  voices: 256 threads a block);
* ``split1``/``split4``: 1 or 4 threads a frame (``FS_SPLIT``: 128 or
  512 threads a block);
* ``vc16``/``vc64``: 16 or 64 voices a CUDA block (``FS_VC``);
* ``cl4``: clusters of up to 4 CUDA blocks (``FS_CL``);
* ``package``: the package's kernels as its wrappers load them, no
  rebuild.  Run from another tree's root, it times that tree's K8 and
  K10 (the operands are built by this file's sibling ``kernel_bench``)::

    python3 -m oddio_tpu_torch.utils.flat_ablate [VARIANT ...]
    cd OTHER_TREE && PYTHONPATH=. python3 PATH/TO/flat_ablate.py package
"""

from __future__ import annotations

import ctypes
import importlib.util
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from oddio_tpu_torch.ops import _build
from oddio_tpu_torch.ops import flat_kernels as FK
from oddio_tpu_torch.ops import ring_kernels as RK

CSRC = Path(__file__).resolve().parents[1] / "csrc"
HEADER = "select_read.cuh"
#: the libraries holding K8's and K10's entry points
LIBS = ("ring_kernels", "flat_kernels")

#: name: ([(old, new) edits of the header], voices per CUDA block, cluster
#: size); None: the package as it is
VARIANTS = {
    "as_built": ([], 32, 8),
    "split1": ([("#define FS_SPLIT 2 ", "#define FS_SPLIT 1 ")], 32, 8),
    "split4": ([("#define FS_SPLIT 2 ", "#define FS_SPLIT 4 ")], 32, 8),
    "vc16": ([("#define FS_VC 32 ", "#define FS_VC 16 ")], 16, 8),
    "vc64": ([("#define FS_VC 32 ", "#define FS_VC 64 ")], 64, 8),
    "cl4": ([("#define FS_CL 8 ", "#define FS_CL 4 ")], 32, 4),
    "package": None,
}


def _kernel_bench():
    """This file's sibling ``kernel_bench`` (its operand builders), also
    where the package imported is another tree's."""
    spec = importlib.util.spec_from_file_location(
        "flat_ablate_kernel_bench", Path(__file__).with_name("kernel_bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def variant_source(src, edits):
    for old, new in edits:
        if old not in src:
            raise ValueError(f"flat_ablate: {old!r} is not in {HEADER}")
        src = src.replace(old, new)
    return src


def build(tmp, name, edits):
    """The variant's two libraries, typed as the package's: {lib: CDLL},
    and ptxas's register line per kernel (or None where a build failed,
    with its log)."""
    d = Path(tmp) / name
    shutil.copytree(CSRC, d)
    (d / HEADER).write_text(variant_source((CSRC / HEADER).read_text(), edits))
    libs, regs = {}, []
    for lib in LIBS:
        so = d / f"{lib}.so"
        r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                            str(d / f"{lib}.cu")], capture_output=True, text=True)
        if r.returncode:
            return None, r.stderr[-1500:]
        L = ctypes.CDLL(str(so))
        for f, argtypes in _build._SIGNATURES[lib].items():
            getattr(L, f).argtypes = argtypes
            getattr(L, f).restype = ctypes.c_int
        libs[lib] = L
        lines = r.stderr.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and "flat_select_kernel" in line:
                regs += [x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4] if "Used" in x]
    return libs, "; ".join(regs)


def cases(KB, dev):
    """(label, warm call, cold call, plain, tolerance) for K8 and K10 at
    phase 15's shapes."""
    rng = np.random.default_rng(22)
    V, n, K = KB.V, KB.W, 64
    out = []
    emax2 = 163
    win = torch.randn((V, RK.select_window(n, emax2, K)), device=dev)
    ops = (win,) + KB.flat_operands(dev, rng, V, n, K, emax2)
    kw = dict(n=n, K=K, emax2=emax2)
    out.append((f"K8 window_select emax2={emax2}", lambda: FK.window_select(*ops, **kw),
                KB.cycling(KB.k8_sets(dev, rng, KB.SETS, K, emax2),
                           lambda *o: FK.window_select(*o, **kw)),
                FK.window_select_plain(*ops, **kw), FK.window_select_tolerance(*ops, n=n, K=K)))
    emax2, rowlen = 36, 4096
    kw10 = dict(n=n, K=K, emax2=emax2)
    ring = torch.randn((V, rowlen), device=dev)
    ops10 = (ring, KB.flat_rstart(dev, rng, V, rowlen)) + KB.flat_operands(dev, rng, V, n, K,
                                                                           emax2)
    cring, csets = KB.k10_sets(dev, rng, KB.SETS, K, emax2)
    out.append((f"K10 dma_window_select emax2={emax2}",
                lambda: FK.dma_window_select(*ops10, **kw10),
                KB.cycling(csets, lambda *o: FK.dma_window_select(cring, *o, **kw10)),
                FK.dma_window_select_plain(*ops10, **kw10), FK.dma_tolerance(*ops10, n=n, K=K)))
    return out


def run(KB, name, regs, card):
    for label, warm, cold, plain, tol in cases(KB, torch.device("cuda")):
        got, again = warm(), warm()
        torch.cuda.synchronize()
        ok = bool(((got - plain).abs().double() <= tol).all()) and torch.equal(got, again)
        ms, host = KB.clocks(warm)
        cms, chost = KB.clocks(cold)
        # sessions until two agree on the kernels they saw (the tracer loses
        # records now and then, ROADMAP Q3.6)
        dw, dc = (sum(KB.device_profile(f, exact=True)[0].values()) for f in (warm, cold))
        print(f"{label} {name} V={KB.V} n={KB.W}: device warm {dw:.4f}, cold {dc:.4f}; ms "
              f"{ms:.4f} (host {host:.4f}), cold {cms:.4f} (host {chost:.4f}); within_tol and "
              f"bit-equal {ok}; {regs} [{card}]", flush=True)


def main(argv=None):
    import sys

    names = (sys.argv[1:] if argv is None else argv) or list(VARIANTS)
    for name in names:
        if name not in VARIANTS:
            raise SystemExit(f"flat_ablate: unknown variant {name!r}; one of {list(VARIANTS)}")
    if not torch.cuda.is_available():
        raise SystemExit("flat_ablate: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    KB = _kernel_bench()
    saved = {lib: _build._libs.get(lib) for lib in LIBS}
    chunk, cl_max = RK.SELECT_CHUNK, RK.CLUSTER_MAX

    def use(libs, vc, cl):
        for lib in LIBS:
            if libs.get(lib) is None:
                _build._libs.pop(lib, None)
            else:
                _build._libs[lib] = libs[lib]
        RK.SELECT_CHUNK, RK.CLUSTER_MAX = vc, cl  # the scratch sized to match
        RK._CLUSTER_SCRATCH.clear()

    with tempfile.TemporaryDirectory() as tmp:
        try:
            for name in names:
                if VARIANTS[name] is None:
                    use(saved, chunk, cl_max)
                    run(KB, name, "", card)
                    continue
                edits, vc, cl = VARIANTS[name]
                libs, regs = build(tmp, name, edits)
                if libs is None:
                    print(f"{name}: build failed\n{regs}")
                    continue
                use(libs, vc, cl)
                run(KB, name, regs, card)
        finally:
            use(saved, chunk, cl_max)


if __name__ == "__main__":
    main()
