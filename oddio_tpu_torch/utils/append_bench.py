"""K1 (``rows_append``) and K9 (``flat_append_aligned``) on the card, with
their operands warm in the L2 cache and cold.

Both copy a (V, W) slab into every voice's ring twice, 12*V*W bytes
(25.2 MB at V = 4096, W = 512).  Fifty back-to-back calls on the same ring
and slab find the slab and the rows they wrote in the card's 50 MB L2, so
they can run under the HBM byte bound.  On the buffered pool's path a
block's other kernels run between two appends and evict them.  The cold
case cycles each call over ``SETS`` rings and slabs (about 200 MB of
traffic per cycle), so every call reads its slab from HBM and its writes
evict earlier ones to HBM: in the steady state the calls move the bound's
bytes through HBM.

Each case prints ``ms`` (CUDA events around 50 calls, host issue
included), ``host_ms`` (their wall clock, no synchronise) and
``device_ms`` (the device work they launched, from ``torch.profiler``,
taken after every clock), per call, beside one ``index_copy_`` of both
legs on the same operands.  It calls only K1's row form (device rows) and
K9's page forms, so it times any tree of the port that has them::

    python3 -m oddio_tpu_torch.utils.append_bench            # this tree
    cd OTHER_TREE && PYTHONPATH=. python3 PATH/TO/append_bench.py

``chip_smoke.py`` builds its cold K1/K9 operands with ``k1_sets`` and
``k9_sets``.
"""

from __future__ import annotations

import itertools
import json
import subprocess
import time

import torch

V, W = 4096, 512
#: the buffered pool's ring rows at 48 kHz: front pad, ring modulus,
#: mirror (spatial.py W_CHUNK, cap_pool, M_PAD) and 1024 floats of slack
RPV = (1024 + 16384 + 1024 + 1024) // 128
#: K9's flat ring row: 8 pages of 512 floats
ROWLEN = 4096
#: operand sets a cold run cycles over: 8 x 25.2 MB of traffic, four
#: times the L2
SETS = 8
REPS = 50
HBM_BPS = 3.35e12  # H100 SXM device memory, bytes/s


def k1_sets(dev, n):
    """``n`` (ring, slab, slab2) sets at the buffered pool's shapes: a (V,
    RPV, 128) ring, the 512 frames K1 takes of a (V, 513) render (rows not
    16-byte aligned), and ``index_copy_``'s operand, the slab twice as (V,
    8, 128)."""
    out = []
    for _ in range(n):
        slab = torch.randn((V, W + 1), device=dev)[:, :W]
        out.append((torch.randn((V, RPV, 128), device=dev), slab,
                    torch.cat([slab.reshape(V, W // 128, 128)] * 2, dim=1)))
    return out


def k9_sets(dev, n):
    """``n`` (ring, slab, slab2) sets: a (V, ROWLEN) flat ring, a (V, W)
    slab and ``index_copy_``'s operand, the slab twice as (V, 2W)."""
    out = []
    for _ in range(n):
        slab = torch.randn((V, W), device=dev)
        out.append((torch.randn((V, ROWLEN), device=dev), slab, torch.cat([slab, slab], dim=1)))
    return out


def cycling(sets, call):
    """A no-argument function that calls ``call(*set)`` on the next of
    ``sets`` each time."""
    it = itertools.cycle(sets)
    return lambda: call(*next(it))


def clocks(fn, reps=REPS):
    """(ms, host_ms) per call of ``reps`` back-to-back calls after a
    warm-up: CUDA events around them, and their wall clock without a
    synchronise."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    ms = t0.elapsed_time(t1) / reps
    h0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = 1e3 * (time.perf_counter() - h0) / reps
    torch.cuda.synchronize()
    return ms, host


def device_ms(fn, reps=REPS):
    """The summed duration of the device work ``reps`` calls launch, per
    call (``torch.profiler``); None where it saw none."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [ev.time_range.elapsed_us() for ev in prof.events()
          if ev.device_type == torch.autograd.DeviceType.CUDA]
    return sum(us) / 1e3 / reps if us else None


def cases(dev):
    """{name: no-argument call} of every case, warm and cold."""
    from oddio_tpu_torch.ops import flat_kernels as FK
    from oddio_tpu_torch.ops import ring_kernels as RK

    rows = torch.tensor([48, 144], dtype=torch.int32, device=dev)
    legs = torch.cat([torch.arange(4, device=dev) + 48, torch.arange(4, device=dev) + 144])
    pages = torch.tensor([2, 6], dtype=torch.int32, device=dev)
    cols = torch.cat([torch.arange(W, device=dev) + 2 * 512, torch.arange(W, device=dev) + 6 * 512])
    k1, k9 = k1_sets(dev, SETS), k9_sets(dev, SETS)
    out = {}
    for heat, s1, s9 in (("warm", k1[:1], k9[:1]), ("cold", k1, k9)):
        out[f"K1 rows_append, device rows, {heat}"] = cycling(
            s1, lambda ring, slab, _: RK.rows_append(ring, slab, rows[0], rows[1]))
        out[f"index_copy_ (K1), {heat}"] = cycling(
            s1, lambda ring, _, slab2: ring.index_copy_(1, legs, slab2))
        out[f"K9 flat_append_aligned, device pair, {heat}"] = cycling(
            s9, lambda ring, slab, _: FK.flat_append_aligned(ring, slab, pages))
        out[f"K9 flat_append_aligned, host ints, {heat}"] = cycling(
            s9, lambda ring, slab, _: FK.flat_append_aligned(ring, slab, 2, 6))
        out[f"index_copy_ (K9), {heat}"] = cycling(
            s9, lambda ring, _, slab2: ring.index_copy_(1, cols, slab2))
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("append_bench: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    fns = cases(dev)
    res = {name: dict(zip(("ms", "host_ms"), clocks(fn))) for name, fn in fns.items()}
    for name, fn in fns.items():  # the profiler last: it slows later host calls
        res[name]["device_ms"] = device_ms(fn)
    bound = 1e3 * 12 * V * W / HBM_BPS
    for name, r in res.items():
        dev_ms = "not measured" if r["device_ms"] is None else f"{r['device_ms']:.4f}"
        print(f"{name}: ms {r['ms']:.4f}, device_ms {dev_ms}, host_ms {r['host_ms']:.4f} "
              f"(HBM byte bound {bound:.4f}) [{card}]")
    print(json.dumps({"card": card, "bound_ms": bound, "append": res}))


if __name__ == "__main__":
    main()
