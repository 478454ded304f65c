"""Smoke run of oddio_tpu_torch on one CUDA card: builds the ring kernels,
checks each against its plain PyTorch version at the main path's shapes,
drives the SpatialScene render path at 4096 voices, and times it.

    python3 chip_smoke.py

Phases (each prints one line; any failure exits non-zero):
 1. the card: name and power limit (nvidia-smi);
 2. the kernel build (nvcc, sm_90a);
 3. K1/K2/K3 against their plain versions at V = 4096, n = 512;
 4. the 4096-voice buffered and seek scenes through render_frames and
    render_frames_device, counting kernel launches on that run;
 5. a 256-voice buffered scene on the card against the CPU (plain) render;
 6. real-time factors of both 4096-voice scenes.
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import sys
import time

import numpy as np
import torch

VOICES = 4096
RATE = 48000
BLOCK = 512
TOL = 1e-5  # PARITY.md contract, port on the card vs port on the CPU


def time_ms(fn, reps=50):
    """Mean device time per call (CUDA events, after a warm-up call)."""
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
    so, secs, ptxas = _build.build()
    _build.lib()
    print(f"build: {so.name} in {secs:.2f} s (nvcc {' '.join(_build.NVCC_FLAGS[:2])}) {tag}")
    if ptxas:
        print(ptxas.strip(), file=sys.stderr)

    # -- 3. kernels vs plain at main-path shapes -------------------------------------
    rng = np.random.default_rng(0)
    V, n, K = VOICES, BLOCK, 32
    kern = {}

    RPV = (1024 + 16384 + 1024 + 1024) // 128
    ring = torch.randn((V, RPV, 128), device=dev)
    samples = torch.randn((V, 513), device=dev)
    rows = torch.tensor([8 + 40, 136], dtype=torch.int32, device=dev)
    plain = RK.rows_append_plain(ring.clone(), samples[:, :512], rows[0], rows[1])
    got = RK.rows_append(ring.clone(), samples[:, :512], rows[0], rows[1])
    torch.cuda.synchronize()
    err = float((got - plain).abs().max())
    if err != 0.0:
        raise AssertionError(f"rows_append differs from its plain version by {err}")
    ms = time_ms(lambda: RK.rows_append(ring, samples[:, :512], rows[0], rows[1]))
    pms = time_ms(lambda: RK.rows_append_plain(ring, samples[:, :512], rows[0], rows[1]))
    kern["rows_append"] = dict(replaces="oddio_tpu/ops/pallas_ring.py:932", err=err, ms=ms, plain_ms=pms)
    print(f"K1 rows_append: max|diff| {err} (tolerance 0, exact); {ms:.4f} ms vs plain {pms:.4f} ms {tag}")

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
        ms = time_ms(lambda: RK.window_select_ears(*args, **kw))
        pms = time_ms(lambda: RK.window_select_ears_plain(*args, **kw))
        print(f"K2 window_select_ears frz={frz is not None}: max|diff| {e_:.3e} "
              f"({b_:.3f} of its tolerance); {ms:.4f} ms vs plain {pms:.4f} ms {tag}")
    kern["window_select_ears"] = dict(replaces="oddio_tpu/ops/pallas_ring.py:724", err=max(errs), ms=ms, plain_ms=pms)

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
    ms = time_ms(lambda: RK.window_select_multi(*args, **kw))
    pms = time_ms(lambda: RK.window_select_multi_plain(*args, **kw))
    kern["window_select_multi"] = dict(replaces="oddio_tpu/ops/pallas_ring.py:843", err=err, ms=ms, plain_ms=pms)
    print(f"K3 window_select_multi nb=4: max|diff| {err:.3e} ({bnd:.3f} of its tolerance); "
          f"{ms:.4f} ms vs plain {pms:.4f} ms {tag}")
    del ring, samples, wide, plain, got

    # -- 4. the main path at 4096 voices ---------------------------------------------
    t0 = time.perf_counter()
    _, sb = build_spatial(True, VOICES, dev)
    _, ss = build_spatial(False, VOICES, dev)
    rb = pt.Renderer(sb, RATE)
    rs = pt.Renderer(ss, RATE)
    print(f"scenes: {VOICES} buffered + {VOICES} seek voices built in "
          f"{time.perf_counter() - t0:.2f} s {tag}")
    RK.reset_launches()
    a = rb.render_frames(RATE)
    dev_out = rb.render_frames_device(BLOCK * 94)
    torch.cuda.synchronize()
    launches = dict(RK.LAUNCHES)
    b = torch.cat([o.permute(0, 2, 1).reshape(-1, 2) for o in dev_out]).cpu().numpy()
    c = rs.render_frames(RATE)
    for name, x in (("buffered render_frames", a), ("buffered render_frames_device", b),
                    ("seek render_frames", c)):
        if not np.isfinite(x).all() or np.abs(x).max() <= 1e-3:
            raise AssertionError(f"{name}: non-finite or silent output")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
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

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": "oddio_tpu_torch/csrc/ring_kernels.cu",
         "replaces": k["replaces"], "launches": launches[key],
         "max_abs_err": k["err"], "ms": k["ms"], "plain_ms": k["plain_ms"]}
        for (name, k), key in zip(kern.items(), ("append", "select_ears", "select_multi"))
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
