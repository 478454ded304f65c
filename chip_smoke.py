"""Smoke run of oddio_tpu_torch on one CUDA card: builds every kernel,
checks each against its plain PyTorch version at its path's shapes, drives
the SpatialScene render path, the AGC mixer path (BASELINE config 5's
scene) and the host-pool path at 4096 voices, and times them.

    python3 chip_smoke.py

Phases (each prints one or more lines; any failure exits non-zero):
 1. the card: name and power limit (nvidia-smi);
 2. the kernel build (one nvcc per csrc/*.cu, all at once, sm_90a);
 3. K1 (both row forms and the cursor form)/K2/K3 against their plain
    versions at V = 4096, n = 512;
 4. the 4096-voice buffered and seek scenes through render_frames and
    render_frames_device, counting kernel launches on that run (K1's all
    through its cursor form);
 5. a 256-voice buffered scene on the card against the CPU (plain) render;
 6. real-time factors of both 4096-voice scenes;
 7. K4/K6/K7 against their plain versions at the mixer path's shapes;
 8. the 4096-voice config-5 mixer (512 Adapt(Stream), 3584 Adapt(Sine))
    through render_frames and render_frames_device with new stream PCM
    between them, counting kernel launches on that run;
 9. the 256-voice config-5 mixer on the card against the CPU render;
10. the real-time factor of the 4096-voice mixer;
11. K5 against its plain version at the host pool's shapes (4096 voices,
    the singleton, and near the gate where its walk clamp binds);
12. the 4096-voice host-pool scene (4096 Speed(Stream) voices in the host
    buffered pool, 512 Adapt(Stream) in the device-resident one, a
    256-voice config-5 submix) through render_frames and
    render_frames_device with new stream PCM and set_speed changes
    between them, counting kernel launches on that run;
13. the same scene at 256 / 32 / 64 voices on the card against the CPU;
14. the real-time factor of the 4096-voice host-pool scene;
15. K8, K9 (three page forms, W = 512 and 1024) and K10 against their
    plain versions at V = 4096, n = 512 (no path calls them: their
    launches, counted on every path run of phases 4, 8, 12 and 17, must
    be 0);
16. K1 (row and cursor forms) and K2 with a ScenePack's scene axis (16
    scenes of 256 voices);
17. the config-5 ScenePack at 16 and 64 scenes of 256 voices through
    render_block and render_frames_device with new stream PCM between,
    counting K4/K6/K7 launches per block (equal at both sizes), and the
    16-scene spatial pack counting K1/K2;
18. a 4 x 64-voice config-5 pack and a 4-scene spatial pack on the card
    against the same packs on the CPU and per-scene Renderers on the card;
19. real-time factors per scene of the config-5 pack at 16, 64 and 256
    scenes and of the 16-scene spatial pack.
Each kernel's bound is the larger of the bytes it must move over the
card's 3.35 TB/s and its float32 operations over 67 TFLOP/s (the
published H100 SXM peaks), from the timed case's own inputs.  Each
kernel and library yardstick is timed three ways over 50 back-to-back
calls (``timed``): ``ms`` with CUDA events (host issue included),
``device_ms`` the device work the calls launched (torch.profiler) and
``host_ms`` the host's issue time.  K1 and K9, whose operands fit in the
card's 50 MB L2, are timed again cold, each call on the next of
``append_bench.SETS`` rings and slabs (``cold``, ``library_cold``).  The
line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import sys
import time
import types

import numpy as np
import torch

VOICES = 4096
RATE = 48000
BLOCK = 512
TOL = 1e-5  # PARITY.md contract, port on the card vs port on the CPU
HBM_BPS = 3.35e12  # H100 SXM device memory, bytes/s
F32_OPS = 67e12  # H100 SXM float32 outside the tensor cores, FLOP/s


def bound(nbytes, nops):
    """(ms, "bytes" or "operations"): the least time the card could take."""
    tb, to = 1e3 * nbytes / HBM_BPS, 1e3 * nops / F32_OPS
    return (tb, "bytes") if tb >= to else (to, "operations")


def span_bytes(idx):
    """Bytes a gather must read: per row of the (R, ...) int index tensor,
    the span from its smallest index to its largest plus the lerp's next
    sample."""
    flat = idx.reshape(idx.shape[0], -1)
    return 4 * int((flat.max(dim=1).values - flat.min(dim=1).values + 2).sum())


#: K8-K10's LAUNCHES keys and their names in the kernels line
FLAT_KERNELS = {"window_select": "window_select", "flat_append": "flat_append_aligned",
                "dma_window_select": "dma_window_select"}
#: K8-K10's launches summed over the path runs (they belong to no path)
FLAT_PATH_LAUNCHES = dict.fromkeys(FLAT_KERNELS, 0)


def reset_launches():
    """Every kernel's launch count to 0, just before a path's run."""
    from oddio_tpu_torch.ops import agc, flat_kernels, ring_kernels, stream_kernels

    for m in (ring_kernels, stream_kernels, agc, flat_kernels):
        m.reset_launches()


def read_flat_launches(label):
    """Add K8-K10's launches on the path run just made to
    ``FLAT_PATH_LAUNCHES``; none of the package's paths calls them, so a
    launch fails the run."""
    from oddio_tpu_torch.ops import flat_kernels as FK

    for k, v in FK.LAUNCHES.items():
        FLAT_PATH_LAUNCHES[k] += v
    if any(FK.LAUNCHES.values()):
        raise AssertionError(f"{label} launched K8-K10: {FK.LAUNCHES}")


def time_ms(fn, reps=50):
    """Time per call of ``reps`` back-to-back calls, host issue included:
    CUDA events recorded before and after the calls (after a warm-up
    call), so where the host issues a call more slowly than the device
    runs it, this is the host's time."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


#: (label, fn, reps, result) of every ``timed`` call, whose device_ms
#: ``profile_device`` fills in at the end of the run
DEFERRED = []


def timed(label, fn, reps=50):
    """``{"ms", "device_ms", "host_ms"}`` per call of ``fn``, each over
    ``reps`` back-to-back calls: ``ms`` as ``time_ms``; ``host_ms`` the
    wall clock of the calls with no synchronise, the host's issue time;
    ``device_ms`` (None until ``profile_device`` runs) the summed duration
    of every device activity the calls launch.  The profiler runs last:
    after a ``torch.profiler`` run every later CUDA call cost the host
    more, and with it every later host time and xRT of the run; ``fn`` is
    kept with its free variables' values of now, as loops rebind them."""
    ms = time_ms(fn, reps)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = 1e3 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    if fn.__closure__:
        cells = tuple(types.CellType(c.cell_contents) for c in fn.__closure__)
        fn = types.FunctionType(fn.__code__, fn.__globals__, closure=cells)
    result = {"ms": ms, "device_ms": None, "host_ms": host}
    DEFERRED.append((label, fn, reps, result))
    return result


def profile_device(tag):
    """Fill in device_ms of every ``timed`` call from ``torch.profiler``
    over the same number of calls, and print them."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for label, fn, reps, result in DEFERRED:
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [ev.time_range.elapsed_us() for ev in prof.events()
              if ev.device_type == torch.autograd.DeviceType.CUDA]
        result["device_ms"] = sum(us) / 1e3 / reps if us else None
        dev = "not measured" if result["device_ms"] is None else f"{result['device_ms']:.4f}"
        print(f"device time {label}: {dev} ms per call (ms {result['ms']:.4f}, host issue "
              f"{result['host_ms']:.4f}) {tag}")
    DEFERRED.clear()


def times_str(t):
    """A ``timed`` result as text (device_ms follows at the run's end)."""
    return f"{t['ms']:.4f} ms (host issue {t['host_ms']:.4f})"


def record(replaces, source, err, t, plain_ms, bound_ms, bound_by, library=None):
    """One kernel's entry of the kernels line; ``t`` and ``library`` are
    ``timed`` results, kept by reference until ``profile_device`` has
    filled in their device_ms (``library`` None where no one PyTorch call
    computes the function)."""
    return dict(replaces=replaces, source=source, err=err, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, times=t, library=library or {})


def kernel_line(name, k):
    """A kernel's entry of the kernels JSON line (K1 and K9 add ``timed``
    results: their other form's under "other_form", their cold times
    under "cold" and "library_cold")."""
    t, lib = k["times"], k["library"]
    line = {"name": name, "route": "cuda", "source": k["source"], "replaces": k["replaces"],
            "launches": k.get("launches"), "max_abs_err": k["err"], "ms": t["ms"],
            "device_ms": t["device_ms"], "host_ms": t["host_ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": lib.get("ms"), "library_device_ms": lib.get("device_ms"),
            "library_host_ms": lib.get("host_ms")}
    return {**line, **{key: k[key] for key in ("other_form", "cold", "library_cold")
                     if key in k}}


#: the buffered pool's ring geometry at 48 kHz: front pad, ring modulus,
#: mirror (spatial.py W_CHUNK, cap_pool, M_PAD) and 1024 floats of slack
FP, CAP, MPAD = 1024, 16384, 1024
RPV_MAIN = (FP + CAP + MPAD + 1024) // 128


def rows_append_check(dev, tag):
    """Phase 3, K1 at the buffered pool's shapes: a 4096-voice ring of
    ``RPV_MAIN`` rows, the 512-frame slab cut from the pool's 513-frame
    render (row stride 513, not 16-byte aligned) and its contiguous copy,
    exact against the plain versions with the rows as device int32
    scalars and as host ints, and through the cursor form at write
    cursors 0, M - 128, M, 5120 and cap - 512.  Timed with device rows and
    through the cursor form on the stride-513 slab, the main path's call,
    beside one ``index_copy_`` of both legs, warm (the same operands every
    call) and, the cursor form and ``index_copy_``, cold.  Returns K1's
    record: the cursor form's times, the row form's under "other_form"."""
    from oddio_tpu_torch.ops import ring_kernels as RK
    from oddio_tpu_torch.utils import append_bench as AB

    V, W = VOICES, BLOCK
    ring = torch.randn((V, RPV_MAIN, 128), device=dev)
    slab = torch.randn((V, W + 1), device=dev)[:, :W]
    rows = torch.tensor([48, 144], dtype=torch.int32, device=dev)
    starts = [0, MPAD - 128, MPAD, 5120, CAP - W]
    err = 0.0
    for src in (slab, slab.contiguous()):
        plain = RK.rows_append_plain(ring.clone(), src, 48, 144)
        for form in ((rows[0], rows[1]), (48, 144)):
            got = RK.rows_append(ring.clone(), src, *form)
            torch.cuda.synchronize()
            err = max(err, float((got - plain).abs().max()))
        for st in starts:
            start = torch.tensor([st], dtype=torch.int32, device=dev)
            plain = RK.rows_append_cursor_plain(ring.clone(), src, start, FP, CAP, MPAD)
            got = RK.rows_append_cursor(ring.clone(), src, start, FP, CAP, MPAD)
            torch.cuda.synchronize()
            err = max(err, float((got - plain).abs().max()))
    if err != 0.0:
        raise AssertionError(f"rows_append differs from its plain version by {err}")
    start = torch.tensor([5120], dtype=torch.int32, device=dev)  # rows 48 and 144
    trows = timed("K1 rows_append, device rows",
                  lambda: RK.rows_append(ring, slab, rows[0], rows[1]))
    tk = timed("K1 rows_append_cursor",
               lambda: RK.rows_append_cursor(ring, slab, start, FP, CAP, MPAD))
    pms = time_ms(lambda: RK.rows_append_plain(ring, slab, rows[0], rows[1]))
    # the library yardstick: one index_copy_ of both legs (index and the
    # doubled slab prepared outside the timed call)
    both = torch.cat([torch.arange(4, device=dev) + 48, torch.arange(4, device=dev) + 144])
    slab2 = torch.cat([slab.reshape(V, 4, 128)] * 2, dim=1)
    lt = timed("index_copy_ (K1)", lambda: ring.index_copy_(1, both, slab2))
    sets = AB.k1_sets(dev, AB.SETS)
    tc = timed("K1 rows_append_cursor, cold", AB.cycling(
        sets, lambda r, s, _: RK.rows_append_cursor(r, s, start, FP, CAP, MPAD)))
    lc = timed("index_copy_ (K1), cold", AB.cycling(
        sets, lambda r, _, s2: r.index_copy_(1, both, s2)))
    bms, by = bound(3 * V * W * 4 + 8, 0)
    print(f"K1 rows_append V={V} W={W} (slab stride {slab.stride(0)}): max|diff| {err} "
          f"(tolerance 0, exact; device rows, host ints, cursor form at {len(starts)} "
          f"cursors); device rows {times_str(trows)}; cursor form {times_str(tk)}, cold "
          f"{times_str(tc)}; plain {pms:.4f} ms, index_copy_ {times_str(lt)}, cold "
          f"{times_str(lc)}; bound {bms:.4f} ms ({by}) {tag}")
    rec = record("oddio_tpu/ops/pallas_ring.py:932", "oddio_tpu_torch/csrc/ring_kernels.cu",
                 err, tk, pms, bms, by, lt)
    rec.update(other_form=trows, cold=tc, library_cold=lc)
    return rec


def select_operands(rng, dev, V, n, K, S2, nb, hcap):
    """Main-path-shaped K2/K3 operands (the layout the buffered pool builds)."""
    def t(x):
        return torch.tensor(x, device=dev)

    ds = rng.uniform(1 - K / n, 1 + K / n, (V, 2 * nb)).astype(np.float32)
    ds_t = t(ds)
    ds_int = torch.floor(ds_t)
    f = ds_t - ds_int
    f_hi = torch.floor(f * 4096.0) * (1.0 / 4096.0)
    f_lo = f - f_hi
    ofrac = t(rng.uniform(0, 1, (V, 2 * nb)).astype(np.float32))
    scal = torch.stack([ofrac, f_hi, f_lo, ds_int], -1)  # (V, 2nb, 4)
    scal01 = [scal[:, e::2].reshape(V, 4 * nb).contiguous() for e in range(2)]
    gain = rng.uniform(0, 0.05, (V, 2 * nb, 2)).astype(np.float32)
    gain[..., 1] = rng.uniform(-1e-4, 1e-4, (V, 2 * nb))
    g = t(gain)
    g01 = [g[:, e::2].reshape(V, 2 * nb).contiguous() for e in range(2)]
    e01 = [t(rng.integers(0, 160, (V, nb)).astype(np.int32)) for _ in range(2)]
    frz01 = [t((rng.uniform(0, 1, (V, nb)) > 0.9).astype(np.float32)) for _ in range(2)]
    wide = torch.randn((V, S2), device=dev)
    rowshift = t(rng.integers(0, hcap, (V, nb)).astype(np.int32))
    return wide, rowshift, scal01, g01, e01, frz01


def select_bytes(RK, wide, col0s, rowshift, hs, scal01, e01, n, K, nb):
    """Bytes K2/K3 must move: each voice's read span per block (both ears),
    its operand rows (16 + 8 + 4 + 4 + 4 bytes per ear and block), the
    (2, nb*n) output."""
    total = 0
    for b in range(nb):
        idx = []
        for e in range(2):
            kk, _ = RK._positions(scal01[e][:, 4 * b:4 * b + 4], n, K)
            sh = rowshift[:, b].long().clamp(0, hs[b] - 1)
            j = torch.arange(n, device=wide.device)
            idx.append((col0s[b] + 128 * sh)[:, None] + e01[e][:, b:b + 1].long() + j + kk.long())
        total += span_bytes(torch.stack(idx, 1))
    V = wide.shape[0]
    return total + 36 * 2 * V * nb + 4 * V * nb + 2 * nb * n * 4


def check_select(RK, got, plain, samps, gs, n, label):
    """|kernel - plain| against the voice-sum rounding tolerance
    (``ring_kernels.mix_tolerance``); returns max |diff| and the largest
    ratio |diff| / tolerance (at most 1 to pass)."""
    diff = (got - plain).abs().double()
    worst = float((diff / RK.mix_tolerance(samps, gs, n).clamp_min(1e-300)).max())
    if not worst <= 1.0:
        raise AssertionError(
            f"{label}: kernel disagrees with its plain version: max|diff| "
            f"{float(diff.max()):.3e}, {worst:.1f}x its tolerance"
        )
    return float(diff.max()), worst


def stream_agc_kernels(dev, kern, tag):
    """Phase 7: K4, K6 and K7 against their plain versions at the shapes the
    config-5 mixer gives them (ring 2816 floats per stream, 2401-wide
    ingest chunks, n = 512)."""
    from oddio_tpu_torch.ops import agc as A
    from oddio_tpu_torch.ops import stream_kernels as SK
    from oddio_tpu_torch.ops._dev import device_split_ds

    rng = np.random.default_rng(7)
    SIZE, n = 2816, BLOCK

    def t(x, dtype=np.float32):
        return torch.tensor(np.asarray(x, dtype), device=dev)

    # K4: a 2401-wide prefill chunk and a 128-wide steady one, half wrapping
    V = 512
    for mw in (2401, 128):
        ring = torch.randn((V, SIZE), device=dev)
        chunk = torch.randn((V, mw), device=dev)
        wpos = t(np.where(np.arange(V) % 2, rng.integers(SIZE - mw + 1, SIZE, V),
                          rng.integers(0, SIZE - mw, V)), np.int32)
        wcount = t(rng.integers(0, mw + 1, V), np.int32)
        plain = SK.ring_place_plain(ring.clone(), chunk, wpos, wcount)
        got = SK.ring_place(ring.clone(), chunk, wpos, wcount)
        torch.cuda.synchronize()
        err = float((got - plain).abs().max())
        if err != 0.0:
            raise AssertionError(f"ring_place (mw={mw}) differs from its plain version by {err}")
        tk = timed(f"K4 ring_place mw={mw}", lambda: SK.ring_place(ring, chunk, wpos, wcount))
        pms = time_ms(lambda: SK.ring_place_plain(ring, chunk, wpos, wcount))
        # the library yardstick: one index_put_ of the written lanes (their
        # flat indices and values prepared outside the timed call)
        j = torch.arange(mw, device=dev)
        keep = j[None, :] < wcount.long()[:, None]
        flat_idx = (torch.arange(V, device=dev)[:, None] * SIZE
                    + torch.remainder(wpos.long()[:, None] + j, SIZE))[keep]
        vals = chunk[keep]
        lt = timed(f"index_put_ (K4 mw={mw})",
                   lambda: ring.view(-1).index_put_((flat_idx,), vals))
        nw = int(wcount.sum())
        bms, by = bound(8 * nw + 8 * V, 0)
        print(f"K4 ring_place V={V} mw={mw}: max|diff| {err} (tolerance 0, exact); "
              f"{times_str(tk)} vs plain {pms:.4f} ms, index_put_ {times_str(lt)}, bound "
              f"{bms:.4f} ms ({by}) {tag}")
        if mw == 2401:
            kern["ring_place"] = record("oddio_tpu/ops/pallas_ring.py:148",
                                        "oddio_tpu_torch/csrc/stream_kernels.cu",
                                        err, tk, pms, bms, by, lt)

    # K6: V = 512 (the stream pool) and 4096, ds in {1/6, 1, 4}
    worst = 0.0
    for V in (512, 4096):
        ring = torch.randn((V, SIZE), device=dev)
        for ds in (8000.0 / 48000.0, 1.0, 4.0):
            dsv = t(np.full(V, np.float32(ds)))
            di, fh, fl = device_split_ds(dsv)
            args = (ring, t(rng.uniform(0, 1, V)), di, fh, fl,
                    t(rng.integers(0, SIZE, V), np.int32),
                    t(rng.integers(0, int(n * ds) + 3, V), np.int32), n)
            plain = SK.ring_resample_plain(*args)
            got = SK.ring_resample(*args)
            torch.cuda.synchronize()
            err = float((got - plain).abs().max())
            if err != 0.0:
                raise AssertionError(f"ring_resample V={V} ds={ds} differs from its plain version by {err}")
            worst = max(worst, err)
            tk = timed(f"K6 ring_resample V={V} ds={ds:.4f}", lambda: SK.ring_resample(*args))
            pms = time_ms(lambda: SK.ring_resample_plain(*args))
            print(f"K6 ring_resample V={V} ds={ds:.4f}: max|diff| {err} (tolerance 0, exact); "
                  f"{times_str(tk)} vs plain {pms:.4f} ms {tag}")
            if V == 512 and ds < 1.0:
                _, pos, _ = SK._positions(args[1], di, fh, fl, n)
                bms, by = bound(span_bytes(pos) + V * n * 4 + 7 * 4 * V, 16 * V * n)
                kern["ring_resample"] = record("oddio_tpu/ops/pallas_ring.py:1203",
                                               "oddio_tpu_torch/csrc/stream_kernels.cu",
                                               worst, tk, pms, bms, by)
    kern["ring_resample"]["err"] = worst

    # K7: V = 4096, n = 512, the scene's tau and one near the closed form's gate
    V = 4096
    iv = np.float32(1.0 / RATE)
    worst = 0.0
    for tau in (0.1, 3.34e-4):
        alpha = np.float32(1.0) - np.exp(-iv / np.float32(tau), dtype=np.float32)
        s_ = torch.randn((V, n), device=dev) * 0.3
        count = t(np.where(np.arange(V) < V // 2, n, rng.integers(0, n + 1, V)), np.int32)
        scal = A.pack_agc_scalars(
            t(rng.uniform(1e-3, 0.3, V)), t(np.full(V, alpha)), count,
            t(np.full(V, 0.1 / np.sqrt(2))), t(np.full(V, 0.5 / np.sqrt(2))),
            t(np.full(V, 4.0)),
        )
        gp, cp = A.agc_gains_plain(s_, scal, n)
        g, c = A.agc_gains(s_, scal, n)
        torch.cuda.synchronize()
        tol_g, tol_c = A.agc_tolerance(s_, scal, n)
        dg = (g - gp).abs().double()
        dc = (c - cp).abs().double()
        ratio = max(float((dg / tol_g.clamp_min(1e-300)).max()),
                    float((dc / tol_c.clamp_min(1e-300)).max()))
        err = max(float(dg.max()), float(dc.max()))
        if not ratio <= 1.0:
            raise AssertionError(
                f"agc_gains tau={tau}: kernel disagrees with its plain version: "
                f"max|diff| {err:.3e}, {ratio:.1f}x its tolerance")
        worst = max(worst, err)
        tk = timed(f"K7 agc_gains tau={tau}", lambda: A.agc_gains(s_, scal, n))
        pms = time_ms(lambda: A.agc_gains_plain(s_, scal, n))
        print(f"K7 agc_gains V={V} tau={tau}: max|diff| {err:.3e} ({ratio:.3f} of its "
              f"tolerance, largest tolerance {float(tol_g.max()):.3e}); "
              f"{times_str(tk)} vs plain {pms:.4f} ms {tag}")
        if tau == 0.1:
            # s read, gains written, 8 scalars in, the carry out; ~20 f32
            # operations per frame (square, prefix sum, exp, sqrt, clamps)
            bms, by = bound(8 * V * n + 36 * V, 20 * V * n)
            kern["agc_gains"] = record("oddio_tpu/ops/pallas_agc.py:155",
                                       "oddio_tpu_torch/csrc/agc_kernel.cu", 0.0, tk, pms, bms, by)
    kern["agc_gains"]["err"] = worst


def mixer_path(pt, dev, kern, tag):
    """Phases 8-10: the config-5 mixer at 4096 voices (launch counts), at
    256 voices card vs CPU, and its real-time factor."""
    from oddio_tpu_torch.ops import agc as A
    from oddio_tpu_torch.ops import ring_kernels as RK
    from oddio_tpu_torch.ops import stream_kernels as SK
    from oddio_tpu_torch.utils.scene_profile import build_mixer_agc, feed

    t0 = time.perf_counter()
    _, mixer, ctls, rng = build_mixer_agc(VOICES, dev)
    r = pt.Renderer(mixer, RATE)
    print(f"mixer: {VOICES} voices ({len(ctls)} Adapt(Stream), {VOICES - len(ctls)} "
          f"Adapt(Sine)) built in {time.perf_counter() - t0:.2f} s {tag}")
    reset_launches()
    a = r.render_frames(RATE)
    feed(ctls, rng, 1024)
    dev_out = r.render_frames_device(BLOCK * 94)
    torch.cuda.synchronize()
    launches = {**SK.LAUNCHES, **A.LAUNCHES}
    ring_launches = dict(RK.LAUNCHES)
    read_flat_launches("the mixer path")
    mixer.sync()
    b = torch.cat([o.permute(0, 2, 1).reshape(-1, 1) for o in dev_out]).cpu().numpy()
    for name, x in (("mixer render_frames", a), ("mixer render_frames_device", b)):
        if not np.isfinite(x).all() or np.abs(x).max() <= 1e-3:
            raise AssertionError(f"{name}: non-finite or silent output")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the mixer path never launched: {launches}")
    if any(ring_launches.values()):
        raise AssertionError(f"the mixer path launched ring kernels: {ring_launches}")
    for name in launches:
        kern[name]["launches"] = launches[name]
    print(f"mixer path: 1 s + {BLOCK * 94 / RATE:.3f} s, peak |out| {np.abs(a).max():.4f}/"
          f"{np.abs(b).max():.4f}; launches {launches} {tag}")

    # -- 9. 256 voices on the card vs the CPU ----------------------------------
    outs = []
    for device in (dev, "cpu"):
        _, m256, c256, rng256 = build_mixer_agc(256, device)
        r256 = pt.Renderer(m256, RATE)
        x = r256.render_frames(BLOCK * 24)
        feed(c256, rng256, 1024)
        outs.append(np.concatenate([x, r256.render_frames(BLOCK * 24)]))
    err = float(np.abs(outs[0] - outs[1]).max())
    if not err <= TOL:
        raise AssertionError(f"256-voice mixer card render differs from the CPU render by {err}")
    print(f"reference: 256-voice mixer, card vs CPU plain, 48 blocks, max|diff| {err:.3e} "
          f"(<= {TOL}) {tag}")

    # -- 10. real-time factor ---------------------------------------------------
    r.render_frames_device(BLOCK * 94, sync=False)
    feed(ctls, rng, 1024)  # the timed run starts with an ingest block
    torch.cuda.synchronize()
    nblk = 188
    t0 = time.perf_counter()
    r.render_frames_device(BLOCK * nblk, sync=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"xRT mixer {VOICES} voices: {(nblk * BLOCK / RATE) / wall:.2f}x "
          f"({nblk} blocks in {wall:.3f} s) {tag}")


def strip_select_kernel(dev, kern, tag):
    """Phase 11: K5 against its plain version at the host pool's shapes
    (V = 4096, n = 512, L = 16384, K = 64, read windows within emax =
    128 + 33 of their row at 48 kHz), at V = 1 (the singleton), and near
    the strip gate (|ds - 1| in [0.119, 0.125]), where its SELECT_R walk
    clamp binds, elementwise within ``ring_kernels.strip_tolerance``."""
    from oddio_tpu_torch.ops import ring_kernels as RK
    from oddio_tpu_torch.ops._dev import device_split_ds

    rng = np.random.default_rng(11)
    n, K = BLOCK, 64

    def t(x, dtype=np.float32):
        return torch.tensor(np.asarray(x, dtype), device=dev)

    for label, V, L, lo, hi in (("main", VOICES, 16384, 0.0, 0.09),
                                ("singleton", 1, 2048, 0.0, 0.09),
                                ("near-gate", 1024, 16384, 0.119, 0.125)):
        mag = rng.uniform(lo, hi, (V, 2)) * rng.choice([-1.0, 1.0], (V, 2))
        di, fh, fl = device_split_ds(t(1.0 + mag))
        scal = torch.stack([t(rng.uniform(0, 1, (V, 2))), fh, fl, di.float()], -1).contiguous()
        ops = (t(rng.standard_normal((V, L))), t(rng.integers(0, L // 128, V), np.int32),
               t(rng.integers(0, 161, (V, 2)), np.int32), scal,
               t(rng.uniform(0, 0.1, (V, 2))), t(rng.uniform(-1e-4, 1e-4, (V, 2))),
               t(rng.uniform(0, 1, V) > 0.2))
        plain = RK.strip_select_plain(*ops, n=n, K=K)
        got = RK.strip_select(*ops, n=n, K=K)
        torch.cuda.synchronize()
        diff = (got - plain).abs().double()
        share = float((diff / RK.strip_tolerance(*ops, n=n, K=K).clamp_min(1e-300)).max())
        err = float(diff.max())
        if not share <= 1.0:
            raise AssertionError(f"strip_select ({label}): kernel disagrees with its plain version: "
                                 f"max|diff| {err:.3e}, {share:.1f}x its tolerance")
        binds = 0
        for e in range(2):
            off, _ = RK.strip_positions(scal[:, e], n, K)
            kk, _ = RK._positions(scal[:, e], n, K)
            binds += int((off != kk.long()).sum())
        if (binds > 0) != (label == "near-gate"):
            raise AssertionError(f"strip_select ({label}): the SELECT_R clamp binds on {binds} reads")
        tk = timed(f"K5 strip_select {label}", lambda: RK.strip_select(*ops, n=n, K=K))
        pms = time_ms(lambda: RK.strip_select_plain(*ops, n=n, K=K))
        print(f"K5 strip_select {label} V={V} L={L}: max|diff| {err:.3e} ({share:.3f} of its "
              f"tolerance); clamp binds on {binds} reads; {times_str(tk)} vs plain {pms:.4f} ms "
              f"{tag}")
        if label == "main":
            idx = []
            for e in range(2):
                off, _ = RK.strip_positions(scal[:, e], n, K)
                idx.append(128 * ops[1].long()[:, None] + ops[2][:, e:e + 1].long()
                           + torch.arange(n, device=dev) + off)
            # spans, 44 bytes of operands per voice, the (2, n) output;
            # 22 f32 operations per (voice, ear, frame)
            bms, by = bound(span_bytes(torch.stack(idx, 1)) + 44 * V + 8 * n, 22 * V * 2 * n)
            kern["strip_select"] = record("oddio_tpu/ops/pallas_ring.py:392",
                                          "oddio_tpu_torch/csrc/select_kernel.cu",
                                          err, tk, pms, bms, by)
        kern["strip_select"]["err"] = max(kern["strip_select"]["err"], err)


def host_pool_path(pt, dev, kern, tag):
    """Phases 12-14: the host-pool scene at 4096 voices (launch counts), at
    256 voices card vs CPU, and its real-time factor."""
    from oddio_tpu_torch.ops import agc as A
    from oddio_tpu_torch.ops import ring_kernels as RK
    from oddio_tpu_torch.ops import stream_kernels as SK
    from oddio_tpu_torch.utils.scene_profile import build_host_pools, feed

    t0 = time.perf_counter()
    _, scene, ctls, speeds, rng = build_host_pools(VOICES, dev)
    r = pt.Renderer(scene, RATE)
    kinds = {p.name: f"{type(p).__name__}({p.capacity})" for p in scene._buffered_pools.values()}
    print(f"host pools: {VOICES} Speed(Stream) + {VOICES // 8} Adapt(Stream) + a "
          f"{max(VOICES // 16, 64)}-voice submix built in {time.perf_counter() - t0:.2f} s; "
          f"pools {kinds} {tag}")
    reset_launches()
    a = r.render_frames(RATE)
    feed(ctls, rng, 1024)
    for sc in speeds[:64]:
        sc.set_speed(float(rng.uniform(0.8, 1.25)))
    dev_out = r.render_frames_device(BLOCK * 94)
    torch.cuda.synchronize()
    launches = {**RK.LAUNCHES, **SK.LAUNCHES, **A.LAUNCHES}
    read_flat_launches("the host-pool path")
    scene.sync()
    b = torch.cat([o.permute(0, 2, 1).reshape(-1, 2) for o in dev_out]).cpu().numpy()
    for name, x in (("host pools render_frames", a), ("host pools render_frames_device", b)):
        if not np.isfinite(x).all() or np.abs(x).max() <= 1e-3:
            raise AssertionError(f"{name}: non-finite or silent output")
    # the kernels of this path; K3 needs an all-device-resident scene (the
    # JAX package's gate) and K7 a block of a multiple of 128 frames (a
    # buffered pool renders 513), so they launch on their own paths
    path = ("append", "select_ears", "strip_select", "ring_place", "ring_resample")
    if min(launches[k] for k in path) < 1:
        raise AssertionError(f"a kernel of the host-pool path never launched: {launches}")
    kern["strip_select"]["launches"] = launches["strip_select"]
    print(f"host-pool path: 1 s + {BLOCK * 94 / RATE:.3f} s, peak |out| {np.abs(a).max():.4f}/"
          f"{np.abs(b).max():.4f}; launches {launches} {tag}")

    # -- 13. 256 voices on the card vs the CPU -------------------------------------
    outs = []
    for device in (dev, "cpu"):
        _, s256, c256, sp256, rng256 = build_host_pools(256, device, dr_voices=32,
                                                        submix_voices=64)
        r256 = pt.Renderer(s256, RATE)
        x = r256.render_frames(BLOCK * 24)
        feed(c256, rng256, 1024)
        for sc in sp256[:16]:
            sc.set_speed(1.1)
        outs.append(np.concatenate([x, r256.render_frames(BLOCK * 24)]))
    err = float(np.abs(outs[0] - outs[1]).max())
    if not err <= TOL:
        raise AssertionError(f"256-voice host-pool scene card render differs from the CPU by {err}")
    print(f"reference: host-pool scene 256/32/64 voices, card vs CPU plain, 48 blocks, max|diff| "
          f"{err:.3e} (<= {TOL}) {tag}")

    # -- 14. real-time factor ----------------------------------------------------
    r.render_frames_device(BLOCK * 94, sync=False)
    feed(ctls, rng, 1024)  # the timed run starts with an ingest block
    torch.cuda.synchronize()
    nblk = 188
    t0 = time.perf_counter()
    r.render_frames_device(BLOCK * nblk, sync=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"xRT host pools {VOICES} voices: {(nblk * BLOCK / RATE) / wall:.2f}x "
          f"({nblk} blocks in {wall:.3f} s) {tag}")


def within(got, plain, tol, label):
    """Max |kernel - plain| and its largest share of the elementwise
    tolerance ``tol``; raises past it."""
    diff = (got - plain).abs().double()
    share = float((diff / tol.clamp_min(1e-300)).max())
    err = float(diff.max())
    if not share <= 1.0:
        raise AssertionError(f"{label}: kernel disagrees with its plain version: "
                             f"max|diff| {err:.3e}, {share:.1f}x its tolerance")
    return err, share


def flat_select_operands(rng, dev, V, n, K, emax2):
    """K8/K10 operands: scal (V, 2, 4) for |ds - 1| <= K/n, gains, a 0/1
    mask, staggers below ``emax2``."""
    def t(x, dtype=np.float32):
        return torch.tensor(np.asarray(x, dtype), device=dev)

    from oddio_tpu_torch.ops._dev import device_split_ds

    di, fh, fl = device_split_ds(t(rng.uniform(1 - K / n, 1 + K / n, (V, 2))))
    scal = torch.stack([t(rng.uniform(0, 1, (V, 2))), fh, fl, di.float()], -1).contiguous()
    return (scal, t(rng.uniform(0, 0.1, (V, 2))), t(rng.uniform(-1e-4, 1e-4, (V, 2))),
            t(rng.uniform(0, 1, V) > 0.2), t(rng.integers(0, emax2, (V, 2)), np.int32))


def flat_read_span(RK, base, scal, extra, n, K):
    """Bytes K8/K10 must read: each voice's span over both ears' reads
    from ``base`` (V,) plus the lerp's next sample."""
    j = torch.arange(n, device=scal.device)
    idx = []
    for e in range(2):
        kk, _ = RK._positions(scal[:, e], n, K)
        idx.append((base + extra[:, e].long())[:, None] + j + kk.long())
    return span_bytes(torch.stack(idx, 1))


def flat_append_check(dev, tag):
    """K9 exact against its plain version in every page form (host ints, a
    (2,) device pair, int32 scalar tensors) at W = 512 and 1024, timed at
    V = 4096, W = 512 with the pair (a device-resident cursor's form) and
    host ints, beside one ``index_copy_`` of both legs, warm and, the pair
    and ``index_copy_``, cold.  Returns K9's record: the pair's times, with
    the host ints' under "other_form"."""
    from oddio_tpu_torch.ops import flat_kernels as FK
    from oddio_tpu_torch.utils import append_bench as AB

    V, rowlen = VOICES, 4096
    ring = torch.randn((V, rowlen), device=dev)
    pages = torch.tensor([2, 6], dtype=torch.int32, device=dev)
    err = 0.0
    for W in (BLOCK, 2 * BLOCK):
        slab = torch.randn((V, W), device=dev)
        plain = FK.flat_append_aligned_plain(ring.clone(), slab, 2, 6)
        for form in ((2, 6), (pages,), (pages[0], pages[1])):
            got = FK.flat_append_aligned(ring.clone(), slab, *form)
            torch.cuda.synchronize()
            err = max(err, float((got - plain).abs().max()))
    if err != 0.0:
        raise AssertionError(f"flat_append_aligned differs from its plain version by {err}")
    W = BLOCK
    slab = torch.randn((V, W), device=dev)
    tk = timed("K9 flat_append_aligned, device pair",
               lambda: FK.flat_append_aligned(ring, slab, pages))
    ti = timed("K9 flat_append_aligned, host ints",
               lambda: FK.flat_append_aligned(ring, slab, 2, 6))
    pms = time_ms(lambda: FK.flat_append_aligned_plain(ring, slab, 2, 6))
    # the library yardstick: one index_copy_ of both legs (index and the
    # doubled slab prepared outside the timed call)
    cols = torch.cat([torch.arange(W, device=dev) + 2 * FK.APPEND_PW,
                      torch.arange(W, device=dev) + 6 * FK.APPEND_PW])
    slab2 = torch.cat([slab, slab], dim=1)
    lt = timed("index_copy_ (K9)", lambda: ring.index_copy_(1, cols, slab2))
    sets = AB.k9_sets(dev, AB.SETS)
    tc = timed("K9 flat_append_aligned, device pair, cold", AB.cycling(
        sets, lambda r, s, _: FK.flat_append_aligned(r, s, pages)))
    lc = timed("index_copy_ (K9), cold", AB.cycling(
        sets, lambda r, _, s2: r.index_copy_(1, cols, s2)))
    bms, by = bound(12 * V * W + 8, 0)
    print(f"K9 flat_append_aligned V={V} W={W}: max|diff| {err} (tolerance 0, exact, W = 512 "
          f"and 1024, three page forms); device page pair {times_str(tk)}, cold "
          f"{times_str(tc)}; host ints {times_str(ti)}; plain {pms:.4f} ms, index_copy_ "
          f"{times_str(lt)}, cold {times_str(lc)}; bound {bms:.4f} ms ({by}); launches: no "
          f"path {tag}")
    rec = record("oddio_tpu/ops/pallas_ring.py:209", "oddio_tpu_torch/csrc/flat_kernels.cu",
                 err, tk, pms, bms, by, lt)
    rec.update(other_form=ti, cold=tc, library_cold=lc)
    return rec


def flat_kernels(dev, kern, tag):
    """Phase 15: K8, K9 and K10 against their plain versions at V = 4096,
    n = 512.  No path of the package calls them (nor of the JAX package:
    K2's test reference, a superseded append, a probe): their launches are
    those counted on the path runs (``read_flat_launches``), not these."""
    from oddio_tpu_torch.ops import flat_kernels as FK
    from oddio_tpu_torch.ops import ring_kernels as RK

    rng = np.random.default_rng(15)
    V, n, K = VOICES, BLOCK, 64
    zero = torch.zeros(V, dtype=torch.int64, device=dev)

    # K8 at both table widths test_ops.py holds the TPU kernel at
    errs = []
    for emax2 in (36, 163):
        win = torch.randn((V, RK.select_window(n, emax2, K)), device=dev)
        ops = (win,) + flat_select_operands(rng, dev, V, n, K, emax2)
        kw = dict(n=n, K=K, emax2=emax2)
        plain = FK.window_select_plain(*ops, **kw)
        got = FK.window_select(*ops, **kw)
        torch.cuda.synchronize()
        err, share = within(got, plain, FK.window_select_tolerance(*ops, n=n, K=K),
                            f"window_select emax2={emax2}")
        errs.append(err)
        tk = timed(f"K8 window_select emax2={emax2}", lambda: FK.window_select(*ops, **kw))
        pms = time_ms(lambda: FK.window_select_plain(*ops, **kw))
        # read spans, 60 bytes of operands per voice, the (2, n) output;
        # 21 f32 operations per (voice, ear, frame), as K2
        bms, by = bound(flat_read_span(RK, zero, ops[1], ops[5], n, K) + 60 * V + 8 * n,
                        21 * V * 2 * n)
        print(f"K8 window_select emax2={emax2} V={V} n={n} K={K}: max|diff| {err:.3e} "
              f"({share:.3f} of its tolerance); {times_str(tk)} vs plain {pms:.4f} ms, bound "
              f"{bms:.4f} ms ({by}); launches: no path {tag}")
    kern["window_select"] = record("oddio_tpu/ops/pallas_ring.py:604",
                                   "oddio_tpu_torch/csrc/ring_kernels.cu", max(errs), tk, pms,
                                   bms, by)

    kern["flat_append_aligned"] = flat_append_check(dev, tag)

    # K10: windows anywhere in a 4096-float row, some past its end (they read
    # the next row, as the TPU's fetch from the flat ring does)
    emax2, rowlen = 36, 4096
    ring = torch.randn((V, rowlen), device=dev)
    rstart = torch.tensor(rng.integers(0, rowlen - 2048 + 600, V).astype(np.int32), device=dev)
    rstart[-1] = 0
    ops = (ring, rstart) + flat_select_operands(rng, dev, V, n, K, emax2)
    kw = dict(n=n, K=K, emax2=emax2)
    plain = FK.dma_window_select_plain(*ops, **kw)
    got = FK.dma_window_select(*ops, **kw)
    torch.cuda.synchronize()
    err, share = within(got, plain, FK.dma_tolerance(*ops, n=n, K=K), "dma_window_select")
    tk = timed("K10 dma_window_select", lambda: FK.dma_window_select(*ops, **kw))
    pms = time_ms(lambda: FK.dma_window_select_plain(*ops, **kw))
    base = torch.arange(V, device=dev) * rowlen + rstart.long()
    # read spans, 64 bytes of operands per voice, the (2, n) output; 23 f32
    # operations per (voice, ear, frame)
    bms, by = bound(flat_read_span(RK, base, ops[2], ops[6], n, K) + 64 * V + 8 * n,
                    23 * V * 2 * n)
    kern["dma_window_select"] = record("oddio_tpu/ops/pallas_ring.py:1039",
                                       "oddio_tpu_torch/csrc/flat_kernels.cu", err, tk, pms, bms, by)
    print(f"K10 dma_window_select V={V} n={n} K={K} emax2={emax2}: max|diff| {err:.3e} "
          f"({share:.3f} of its tolerance); {times_str(tk)} vs plain {pms:.4f} ms, bound "
          f"{bms:.4f} ms ({by}); launches: no path {tag}")


def scene_axis_kernels(dev, tag):
    """Phase 16: K1 and K2 with a ScenePack's scene axis, S = 16 scenes of
    V = 256 voices, against their plain versions (K1 exact, K2 within
    ``mix_tolerance`` per scene), one launch per call."""
    from oddio_tpu_torch.ops import ring_kernels as RK

    rng = np.random.default_rng(16)
    S, Vs, n, K = 16, 256, BLOCK, 32
    V = S * Vs
    RPV = RPV_MAIN
    ring = torch.randn((V, RPV, 128), device=dev)
    slab = torch.randn((V, 512), device=dev)
    r0 = torch.tensor(rng.integers(0, RPV - 4, S).astype(np.int32), device=dev)
    rm = torch.tensor(rng.integers(0, RPV - 4, S).astype(np.int32), device=dev)
    plain = RK.rows_append_plain(ring.clone(), slab, r0, rm)
    before = RK.LAUNCHES["append"]
    got = RK.rows_append(ring.clone(), slab, r0, rm)
    torch.cuda.synchronize()
    err = float((got - plain).abs().max())
    if err != 0.0 or RK.LAUNCHES["append"] != before + 1:
        raise AssertionError(f"rows_append with {S} scenes: max|diff| {err}, "
                             f"{RK.LAUNCHES['append'] - before} launches")
    tk = timed(f"K1 rows_append S={S}", lambda: RK.rows_append(ring, slab, r0, rm))
    pms = time_ms(lambda: RK.rows_append_plain(ring, slab, r0, rm))
    # the cursor form with one write cursor per scene, as the spatial pack
    # calls it
    start = torch.tensor(rng.integers(0, CAP - 512, S).astype(np.int32), device=dev)
    plain = RK.rows_append_cursor_plain(ring.clone(), slab, start, FP, CAP, MPAD)
    before = RK.LAUNCHES["append_cursor"]
    got = RK.rows_append_cursor(ring.clone(), slab, start, FP, CAP, MPAD)
    torch.cuda.synchronize()
    cerr = float((got - plain).abs().max())
    if cerr != 0.0 or RK.LAUNCHES["append_cursor"] != before + 1:
        raise AssertionError(f"rows_append_cursor with {S} scenes: max|diff| {cerr}, "
                             f"{RK.LAUNCHES['append_cursor'] - before} launches")
    ctk = timed(f"K1 rows_append_cursor S={S}",
                lambda: RK.rows_append_cursor(ring, slab, start, FP, CAP, MPAD))
    print(f"K1 rows_append S={S} x V={Vs}: max|diff| {err} (exact), one launch; {times_str(tk)} "
          f"vs plain {pms:.4f} ms; cursor form max|diff| {cerr} (exact), one launch; "
          f"{times_str(ctk)} {tag}")
    del ring, slab

    wide, rowshift, scal01, g01, e01, frz01 = select_operands(rng, dev, V, n, K, 2048, 1, 8)
    rs = rowshift[:, 0].contiguous()
    kw = dict(n=n, K=K, emax2=127 + 33, hmax=8, frz01=frz01, scenes=S)
    plain = RK.window_select_ears_plain(wide, rs, scal01, g01, e01, **kw)
    before = RK.LAUNCHES["select_ears"]
    got = RK.window_select_ears(wide, rs, scal01, g01, e01, **kw)
    torch.cuda.synchronize()
    if got.shape != (S, 2, n) or RK.LAUNCHES["select_ears"] != before + 1:
        raise AssertionError(f"window_select_ears with {S} scenes: shape {tuple(got.shape)}, "
                             f"{RK.LAUNCHES['select_ears'] - before} launches")
    samps = [RK.ear_samples(wide, 0, rs, 8, scal01[e], e01[e], frz01[e], n, K) for e in range(2)]
    err, share = within(got, plain, RK.mix_tolerance(samps, g01, n, scenes=S),
                        f"window_select_ears S={S}")
    tk = timed(f"K2 window_select_ears S={S}",
               lambda: RK.window_select_ears(wide, rs, scal01, g01, e01, **kw))
    pms = time_ms(lambda: RK.window_select_ears_plain(wide, rs, scal01, g01, e01, **kw))
    print(f"K2 window_select_ears S={S} x V={Vs}: max|diff| {err:.3e} ({share:.3f} of its "
          f"per-scene tolerance), one launch; {times_str(tk)} vs plain {pms:.4f} ms {tag}")


def drain(batches):
    """A pack's ``render_frames_device`` list of (B, S, C, n) tensors as
    numpy (S, B*n, C)."""
    x = torch.cat(list(batches)).cpu().numpy()  # (B, S, C, n)
    B, S, C, n = x.shape
    return x.transpose(1, 0, 3, 2).reshape(S, B * n, C)


def config5_pack_run(pack, ctls, pcm, nb0=4, nb1=60):
    """``nb0`` blocks through ``render_block``, one write of ``pcm`` (one
    row per stream), ``nb1`` blocks through ``render_frames_device``:
    (S, (nb0 + nb1)*n, C) numpy."""
    a = np.concatenate([pack.render_block(BLOCK) for _ in range(nb0)], axis=1)
    for c, x in zip(ctls, pcm):
        c.write(x)
    return np.concatenate([a, drain(pack.render_frames_device(BLOCK * nb1))], axis=1)


def pack_path(pt, dev, tag):
    """Phase 17: the config-5 pack (S Mixers of 256 voices) at S = 16 and 64
    through render_block and render_frames_device with new stream PCM
    between them, counting K4/K6/K7 launches (equal per block at both S:
    one launch per pool per block, whatever S is); the 16-scene spatial
    pack the same way with K1/K2.  Returns the built packs for phase 19."""
    from oddio_tpu_torch.ops import agc as A
    from oddio_tpu_torch.ops import ring_kernels as RK
    from oddio_tpu_torch.ops import stream_kernels as SK
    from oddio_tpu_torch.utils.scene_profile import build_config5_pack, build_spatial_pack

    nb0, nb1 = 4, 60
    packs, per_block = {}, {}
    for S in (16, 64):
        t0 = time.perf_counter()
        pack, ctls, rng = build_config5_pack(S, dev)
        built = time.perf_counter() - t0
        pcm = (rng.standard_normal((len(ctls), 1024)) * 0.1).astype(np.float32)
        reset_launches()
        out = config5_pack_run(pack, ctls, pcm, nb0, nb1)
        torch.cuda.synchronize()
        launches = {**SK.LAUNCHES, **A.LAUNCHES}
        read_flat_launches(f"the config-5 pack path (S={S})")
        if any(RK.LAUNCHES.values()):
            raise AssertionError(f"the config-5 pack launched ring kernels: {RK.LAUNCHES}")
        if out.shape != (S, (nb0 + nb1) * BLOCK, 1) or not np.isfinite(out).all():
            raise AssertionError(f"config-5 pack S={S}: shape {out.shape} or non-finite output")
        if np.abs(out).max(axis=(1, 2)).min() <= 1e-3:
            raise AssertionError(f"config-5 pack S={S}: a silent scene")
        if min(launches.values()) < 1:
            raise AssertionError(f"a kernel of the pack path never launched: {launches}")
        per_block[S] = {k: v / (nb0 + nb1) for k, v in launches.items()}
        packs[S] = (pack, ctls, rng)
        print(f"config-5 pack S={S} x 256 voices (built in {built:.2f} s): {nb0} blocks "
              f"render_block + {nb1} render_frames_device, a 1024-sample write between; peak "
              f"|out| {np.abs(out).max():.4f}; launches {launches}, per block "
              f"{per_block[S]} {tag}")
    if per_block[16] != per_block[64]:
        raise AssertionError(f"launches per block differ: S=16 {per_block[16]}, S=64 {per_block[64]}")

    t0 = time.perf_counter()
    sp = build_spatial_pack(16, dev)
    built = time.perf_counter() - t0
    reset_launches()
    a = np.concatenate([sp.render_block(BLOCK) for _ in range(nb0)], axis=1)
    out = np.concatenate([a, drain(sp.render_frames_device(BLOCK * nb1))], axis=1)
    torch.cuda.synchronize()
    launches = dict(RK.LAUNCHES)
    read_flat_launches("the spatial pack path")
    if not np.isfinite(out).all() or np.abs(out).max(axis=(1, 2)).min() <= 1e-3:
        raise AssertionError("spatial pack: non-finite output or a silent scene")
    if launches["append"] < 1 or launches["select_ears"] < 1:
        raise AssertionError(f"a kernel of the spatial pack path never launched: {launches}")
    print(f"spatial pack S=16 x (64 buffered + 192 seek) (built in {built:.2f} s): "
          f"{nb0 + nb1} blocks, peak |out| {np.abs(out).max():.4f}; launches {launches}, per "
          f"block { {k: v / (nb0 + nb1) for k, v in launches.items()} } {tag}")
    packs["spatial"] = sp
    return packs


def pack_reference(pt, dev, tag):
    """Phase 18: a 4-scene x 64-voice config-5 pack and a 4-scene spatial
    pack on the card against the same packs on the CPU and against
    per-scene Renderers on the card, each within TOL."""
    from oddio_tpu_torch.utils.scene_profile import (build_config5_pack, build_mixer_agc,
                                                     build_pack_scene, build_spatial_pack)

    S, nb0, nb1 = 4, 12, 12
    pcm = None
    outs = []
    for device in (dev, "cpu"):
        pack, ctls, rng = build_config5_pack(S, device, voices=64)
        if pcm is None:
            pcm = (rng.standard_normal((len(ctls), 1024)) * 0.1).astype(np.float32)
        outs.append(config5_pack_run(pack, ctls, pcm, nb0, nb1))
    singles = []
    for s in range(S):
        _, mixer, ctls, _ = build_mixer_agc(64, dev, s)
        r = pt.Renderer(mixer, RATE)
        a = np.stack([r.render_block(BLOCK) for _ in range(nb0)])
        for c, x in zip(ctls, pcm[len(ctls) * s:]):
            c.write(x)
        b = r.render_frames(BLOCK * nb1)
        singles.append(np.concatenate([a.reshape(-1, a.shape[-1]), b]))
    errs = (float(np.abs(outs[0] - outs[1]).max()), float(np.abs(outs[0] - np.stack(singles)).max()))
    if not max(errs) <= TOL or np.abs(outs[1]).max() <= 1e-2:
        raise AssertionError(f"config-5 pack 4 x 64: card vs CPU {errs[0]}, vs per-scene "
                             f"Renderers {errs[1]}")
    print(f"reference: config-5 pack 4 x 64 voices, {nb0 + nb1} blocks with a write: card vs "
          f"CPU plain max|diff| {errs[0]:.3e}, vs per-scene Renderers on the card "
          f"{errs[1]:.3e} (<= {TOL}) {tag}")

    outs = []
    for device in (dev, "cpu"):
        pack = build_spatial_pack(S, device)
        outs.append(np.concatenate([pack.render_block(BLOCK) for _ in range(nb0)]
                                   + [drain(pack.render_frames_device(BLOCK * nb1))], axis=1))
    singles = []
    for s in range(S):
        r = pt.Renderer(build_pack_scene(dev, s), RATE)
        singles.append(np.concatenate([r.render_block(BLOCK) for _ in range(nb0 + nb1)]))
    errs = (float(np.abs(outs[0] - outs[1]).max()), float(np.abs(outs[0] - np.stack(singles)).max()))
    if not max(errs) <= TOL or np.abs(outs[1]).max() <= 1e-2:
        raise AssertionError(f"spatial pack 4 scenes: card vs CPU {errs[0]}, vs per-scene "
                             f"Renderers {errs[1]}")
    print(f"reference: spatial pack 4 x (64 buffered + 192 seek), {nb0 + nb1} blocks: card vs "
          f"CPU plain max|diff| {errs[0]:.3e}, vs per-scene Renderers on the card "
          f"{errs[1]:.3e} (<= {TOL}) {tag}")


def pack_xrt(packs, dev, tag):
    """Phase 19: real-time factor per scene (one scene's audio seconds per
    wall second, as bench.py counts a pack) of the config-5 pack at S = 16,
    64 and 256 (BASELINE config 5's 256 x 256, built and timed once) and
    of the 16-scene spatial pack, 188 blocks each after a warm-up; each
    config-5 run starts with a 1024-sample write to every stream."""
    from oddio_tpu_torch.utils.scene_profile import build_config5_pack, feed

    nblk = 188
    runs = [(S, packs[S]) for S in (16, 64)]
    t0 = time.perf_counter()
    runs.append((256, build_config5_pack(256, dev)))
    print(f"config-5 pack S=256 x 256 voices (65,536) built in {time.perf_counter() - t0:.2f} s "
          f"{tag}")
    runs.append(("spatial 16", (packs["spatial"], None, None)))
    for label, (pack, ctls, rng) in runs:
        pack.render_frames_device(BLOCK * 8)
        if ctls is not None:
            feed(ctls, rng, 1024)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pack.render_frames_device(BLOCK * nblk)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if not bool(torch.isfinite(out[-1]).all()):
            raise AssertionError(f"pack {label}: non-finite output")
        kind = "spatial pack" if ctls is None else "config-5 pack"
        print(f"xRT per scene {kind} S={label if ctls is not None else 16}: "
              f"{(nblk * BLOCK / RATE) / wall:.2f}x ({nblk} blocks in {wall:.3f} s, "
              f"{1e3 * wall / nblk:.3f} ms per block) {tag}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs a CUDA card",
              file=sys.stderr)
        return 1
    import oddio_tpu_torch as pt
    from oddio_tpu_torch.ops import _build
    from oddio_tpu_torch.ops import ring_kernels as RK
    from oddio_tpu_torch.utils.scene_profile import build_spatial, card_line

    card = card_line()
    print(f"card: {card}")
    tag = f"[{card}]"
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 2. build ------------------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build()
    wall = time.perf_counter() - t0
    for name, (so, secs, ptxas) in built.items():
        _build.lib(name)
        print(f"build: {so.name} in {secs:.2f} s (nvcc {' '.join(_build.NVCC_FLAGS[:2])}) {tag}")
        if ptxas:
            print(ptxas.strip(), file=sys.stderr)
    print(f"build: {len(built)} libraries in {wall:.2f} s wall (parallel) {tag}")

    # -- 3. kernels vs plain at main-path shapes -------------------------------------
    rng = np.random.default_rng(0)
    V, n, K = VOICES, BLOCK, 32
    kern = {}

    kern["rows_append"] = rows_append_check(dev, tag)

    S2 = 2048
    wide, rowshift, scal01, g01, e01, frz01 = select_operands(rng, dev, V, n, K, S2, 1, 8)
    emax2 = 127 + 33
    errs = []
    for frz in (None, frz01):
        kw = dict(n=n, K=K, emax2=emax2, hmax=8, frz01=frz)
        args = (wide, rowshift[:, 0].contiguous(), scal01, g01, e01)
        plain = RK.window_select_ears_plain(*args, **kw)
        got = RK.window_select_ears(*args, **kw)
        torch.cuda.synchronize()
        samps = [RK.ear_samples(wide, 0, args[1], 8, scal01[e], e01[e],
                                None if frz is None else frz[e], n, K) for e in range(2)]
        e_, b_ = check_select(RK, got, plain, samps, g01, n, "window_select_ears")
        errs.append(e_)
        tk = timed(f"K2 window_select_ears frz={frz is not None}",
                   lambda: RK.window_select_ears(*args, **kw))
        pms = time_ms(lambda: RK.window_select_ears_plain(*args, **kw))
        print(f"K2 window_select_ears frz={frz is not None}: max|diff| {e_:.3e} "
              f"({b_:.3f} of its tolerance); {times_str(tk)} vs plain {pms:.4f} ms {tag}")
    bms, by = bound(select_bytes(RK, wide, [0], args[1][:, None], [8], scal01, e01, n, K, 1),
                    21 * V * 2 * n)
    kern["window_select_ears"] = record("oddio_tpu/ops/pallas_ring.py:724",
                                        "oddio_tpu_torch/csrc/ring_kernels.cu", max(errs), tk, pms,
                                        bms, by)

    nb = 4
    row0s = [max(0, int(np.floor(b * (n - K) / 128))) for b in range(nb)]
    hs = [int(1023 + b * (n + K)) // 128 - row0s[b] + 1 for b in range(nb)]
    wide, rowshift, scal01, g01, e01, frz01 = select_operands(rng, dev, V, n, K, 4096, nb, min(hs))
    kw = dict(n=n, K=K, emax2=emax2, nb=nb, row0s=row0s, hs=hs)
    args = (wide, rowshift, scal01, g01, e01, frz01)
    plain = RK.window_select_multi_plain(*args, **kw)
    got = RK.window_select_multi(*args, **kw)
    torch.cuda.synchronize()
    err, bnd = 0.0, 0.0
    for b in range(nb):
        sl = slice(b * n, (b + 1) * n)
        samps = [RK.ear_samples(wide, 128 * row0s[b], rowshift[:, b], hs[b],
                                scal01[e][:, 4 * b:4 * b + 4], e01[e][:, b:b + 1],
                                frz01[e][:, b:b + 1], n, K) for e in range(2)]
        e_, b_ = check_select(RK, got[:, sl], plain[:, sl], samps,
                              [g[:, 2 * b:2 * b + 2] for g in g01], n, "window_select_multi")
        err, bnd = max(err, e_), max(bnd, b_)
    tk = timed("K3 window_select_multi", lambda: RK.window_select_multi(*args, **kw))
    pms = time_ms(lambda: RK.window_select_multi_plain(*args, **kw))
    bms, by = bound(select_bytes(RK, wide, [128 * r for r in row0s], rowshift, hs, scal01, e01, n, K, nb),
                    21 * V * 2 * n * nb)
    kern["window_select_multi"] = record("oddio_tpu/ops/pallas_ring.py:843",
                                         "oddio_tpu_torch/csrc/ring_kernels.cu", err, tk, pms, bms, by)
    print(f"K3 window_select_multi nb=4: max|diff| {err:.3e} ({bnd:.3f} of its tolerance); "
          f"{times_str(tk)} vs plain {pms:.4f} ms {tag}")
    del wide, plain, got

    # -- 4. the main path at 4096 voices ---------------------------------------------
    t0 = time.perf_counter()
    _, sb = build_spatial(True, VOICES, dev)
    _, ss = build_spatial(False, VOICES, dev)
    rb = pt.Renderer(sb, RATE)
    rs = pt.Renderer(ss, RATE)
    print(f"scenes: {VOICES} buffered + {VOICES} seek voices built in "
          f"{time.perf_counter() - t0:.2f} s {tag}")
    reset_launches()
    a = rb.render_frames(RATE)
    dev_out = rb.render_frames_device(BLOCK * 94)
    torch.cuda.synchronize()
    launches = {k: RK.LAUNCHES[k] for k in ("append", "select_ears", "select_multi")}
    read_flat_launches("the spatial path")
    b = torch.cat([o.permute(0, 2, 1).reshape(-1, 2) for o in dev_out]).cpu().numpy()
    c = rs.render_frames(RATE)
    for name, x in (("buffered render_frames", a), ("buffered render_frames_device", b),
                    ("seek render_frames", c)):
        if not np.isfinite(x).all() or np.abs(x).max() <= 1e-3:
            raise AssertionError(f"{name}: non-finite or silent output")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    if RK.LAUNCHES["append_cursor"] != launches["append"]:
        raise AssertionError(f"the main path launched K1 {launches['append']} times, "
                             f"{RK.LAUNCHES['append_cursor']} through the cursor form")
    print(f"main path: 1 s + {BLOCK * 94 / RATE:.3f} s buffered, 1 s seek; peak "
          f"|out| {np.abs(a).max():.4f}/{np.abs(c).max():.4f}; launches {launches} {tag}")

    # -- 5. 256 voices on the card vs the CPU ----------------------------------------
    _, s_gpu = build_spatial(True, 256, dev)
    _, s_cpu = build_spatial(True, 256, "cpu")
    x_gpu = pt.Renderer(s_gpu, RATE).render_frames(BLOCK * 48)
    x_cpu = pt.Renderer(s_cpu, RATE).render_frames(BLOCK * 48)
    err = float(np.abs(x_gpu - x_cpu).max())
    if not err <= TOL:
        raise AssertionError(f"256-voice card render differs from the CPU render by {err}")
    print(f"reference: 256 voices, card vs CPU plain, max|diff| {err:.3e} (<= {TOL}) {tag}")

    # -- 6. real-time factors ----------------------------------------------------------
    for label, r in (("buffered", rb), ("seek", rs)):
        r.render_frames_device(BLOCK * 94, sync=False)
        torch.cuda.synchronize()
        nblk = 188
        t0 = time.perf_counter()
        r.render_frames_device(BLOCK * nblk, sync=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        xrt = (nblk * BLOCK / RATE) / wall
        print(f"xRT {label} {VOICES} voices: {xrt:.2f}x ({nblk} blocks in {wall:.3f} s) {tag}")

    for name, key in zip(("rows_append", "window_select_ears", "window_select_multi"),
                         ("append", "select_ears", "select_multi")):
        kern[name]["launches"] = launches[key]

    # -- 7-10. the config-5 mixer path ----------------------------------------------
    stream_agc_kernels(dev, kern, tag)
    mixer_path(pt, dev, kern, tag)

    # -- 11-14. the host-pool path ----------------------------------------------------
    strip_select_kernel(dev, kern, tag)
    host_pool_path(pt, dev, kern, tag)

    # -- 15-19. K8-K10, the scene axis, the ScenePack paths ----------------------------
    flat_kernels(dev, kern, tag)
    scene_axis_kernels(dev, tag)
    packs = pack_path(pt, dev, tag)
    for key, name in FLAT_KERNELS.items():
        kern[name]["launches"] = FLAT_PATH_LAUNCHES[key]
    pack_reference(pt, dev, tag)
    pack_xrt(packs, dev, tag)

    profile_device(tag)
    print(json.dumps({"kernels": [kernel_line(name, k) for name, k in kern.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
