"""Kernels timed alone on the card, with their operands warm in the L2
cache and cold: K1 (``rows_append``) and K9 (``flat_append_aligned``),
the appends; K4 (``ring_place``) and K5 (``strip_select``), the host
buffered pool's ring write and two-ear read; and the device-resident
buffered pool's whole read (K2, K3 and whatever the pool launches around
them), through pool methods every tree of the port has.

Fifty back-to-back calls on the same operands find what they read in the
card's 50 MB L2, so they can run under the HBM byte bound; on a path, a
block's other kernels run between two calls and evict them.  A cold case
cycles each call over operand sets whose bytes together pass the L2:

* K1/K9: ``SETS`` rings and slabs, 25.2 MB each;
* K5 at 4096 voices: ``SETS`` sets of read rows over one 268 MB ring
  (each call reads about 9.5 MB at other places of every voice's ring);
  its scene form the same at the host-pool pack's 16 scenes x 256, beside
  the (2, n) form on the same rows;
* K4 at the mixer's shape: ``PLACE_RINGS`` rings of 5.8 MB; at the host
  pool's, ``SETS`` chunks of 8.4 MB written at other cursors of one
  268 MB ring;
* the pool's read (``read``): the states of ``SETS`` consecutive blocks
  (or fused groups) of one 4096-voice scene, each reading ~10 MB (~40 MB
  a group) at other places of its 318 MB ring.

``read`` builds ``scene_profile.build_spatial(True, 4096)`` (the buffered
scene: K2 on single blocks, K3 on fused idle groups of 4), renders it
through a ``Renderer`` while it captures the arguments of the pool's
``render`` and ``render_multi``, and replays them: ``render`` (a block's
control walk, append, read operands and read), ``render_multi`` (four
blocks' and one fused read) and ``_advance_block`` alone (all but the
read).  The read's own numbers are the differences, ``read K2`` and
``read K3`` (device kernels included), beside its byte bound; its host
time also as ``paired_host_ms``, the median over ``PAIRS`` alternated
calls of render's host time less advance's (a replay takes ~6 ms of
host time, whose drift between two separate 50-call clocks is larger
than the read's share).

``agc`` and ``resample`` time a device-resident pool's whole Adapt step
(K7 and whatever the step launches around it) and whole Stream step (K6
and the same) on captured states (``step_states``): the 4096-voice
config-5 mixer's two Adapt pools at n = 512, and a host-pool scene's
device-resident Adapt(Stream) pool (512 voices) at n = 513.  ``agc``'s
``...: render`` is the Adapt pool's ``dr_render`` and ``...: advance``
its inner's alone, so the differences are the Adapt step; ``resample``'s
``...: render`` is the Stream's ``dr_render`` and its advance does
nothing.  Warm: one block's state, 50 calls; cold: ``SETS`` consecutive
blocks' states in turn.  Both run on any tree of the port (pool methods
only), so two trees of the port are timed in turns.

Each case prints ``ms`` (CUDA events around 50 calls, host issue
included), ``host_ms`` (their wall clock, no synchronise) and
``device_ms`` (the device work they launched, from ``torch.profiler``,
taken after every clock), per call, with the device time of each kernel
the calls launched, beside a one-call library yardstick where there is
one.  K4 and K5 are timed through their tensor forms and their record
forms; the same file times another tree's kernels from that tree's
root::

    python3 -m oddio_tpu_torch.utils.kernel_bench [append] [place] [select] [read] [agc] [resample] [arena]
    cd OTHER_TREE && PYTHONPATH=. python3 PATH/TO/kernel_bench.py place select read agc resample

``arena`` times K6's arena form (the FramesSignal, Cycle and seek-pool
sampler reads) alone at the three paths' shapes (``ARENA_SHAPES``), warm
and cold over ``ARENA_SETS`` operand sets in a ~43 MB guarded arena, and
its plain version, beside the byte bound of each shape.

``chip_smoke.py`` builds its cold operands, K5's and K6's arena-form
cases and K8/K10's operands (``flat_operands``, ``k8_sets``, ``k10_sets``)
here.
"""

from __future__ import annotations

import collections
import itertools
import json
import subprocess
import sys
import time

import numpy as np
import torch

V, W = 4096, 512
#: the buffered pool's ring rows at 48 kHz: front pad, ring modulus,
#: mirror (spatial.py W_CHUNK, cap_pool, M_PAD) and 1024 floats of slack
RPV = (1024 + 16384 + 1024 + 1024) // 128
#: K9's flat ring row: 8 pages of 512 floats
ROWLEN = 4096
#: operand sets a cold run cycles over: 8 x 25.2 MB of traffic for the
#: appends, four times the L2
SETS = 8
#: K4's mixer-shape rings a cold run cycles over: 10 x 5.8 MB
PLACE_RINGS = 10
REPS = 50
#: alternated (render, advance) calls of ``paired_host``
PAIRS = 100
HBM_BPS = 3.35e12  # H100 SXM device memory, bytes/s
F32_OPS = 67e12  # H100 SXM float32 outside the tensor cores, FLOP/s

#: K5's cases (label, voices, ring length, |ds - 1| range): the host
#: pool, the singleton (a submix), and near the strip gate where the
#: SELECT_R walk clamp binds
SELECT_CASES = (("main", 4096, 16384, 0.0, 0.09),
                ("singleton", 1, 2048, 0.0, 0.09),
                ("near-gate", 1024, 16384, 0.119, 0.125))
SELECT_N, SELECT_K = 512, 64
#: K5's scene-form cases (label, scenes, voices per scene, ring length):
#: the host-pool pack's 16 x 256 host rows, one scene of 4096, and 3
#: scenes of 17 (a scene boundary inside a block of 32 voices)
SELECT_SCENES = (("pack", 16, 256, 16384), ("one", 1, 4096, 16384),
                 ("boundary", 3, 17, 2048))
#: K4 at the config-5 mixer (V rows of size_pad 2816, a 2401-wide prefill
#: chunk and a 128-wide steady one) and at the host pool (4096 rings of
#: 16384, n_inner = 513 frames, n_write 512 or 513)
PLACE_MIXER = (512, 2816, (2401, 128))
PLACE_HOST = (4096, 16384, 513)


def bound(nbytes, nops=0):
    """(ms, "bytes" or "operations"): the least time the card could take."""
    tb, to = 1e3 * nbytes / HBM_BPS, 1e3 * nops / F32_OPS
    return (tb, "bytes") if tb >= to else (to, "operations")


def span_bytes(idx):
    """Bytes a gather must read: per row of the (R, ...) int index tensor,
    the span from its smallest index to its largest plus the lerp's next
    sample."""
    flat = idx.reshape(idx.shape[0], -1)
    return 4 * int((flat.max(dim=1).values - flat.min(dim=1).values + 2).sum())


def union_bytes(idx):
    """Bytes a gather whose rows may share samples must read: the union,
    over the rows of the (R, ...) int index tensor, of each row's span from
    its smallest index to its largest plus the lerp's next sample (rows that
    read the same samples fetch them once)."""
    flat = idx.reshape(idx.shape[0], -1)
    lo = flat.min(dim=1).values.cpu().numpy()
    hi = flat.max(dim=1).values.cpu().numpy() + 2
    order = np.argsort(lo, kind="stable")
    lo, hi = lo[order], hi[order]
    # spans sorted by start: each adds what lies past every earlier end
    reach = np.concatenate(([lo[0]], np.maximum.accumulate(hi)[:-1]))
    return 4 * int(np.maximum(hi - np.maximum(lo, reach), 0).sum())


def _t(x, dev, dtype=np.float32):
    return torch.tensor(np.asarray(x, dtype), device=dev)


# --- operands ------------------------------------------------------------------


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


#: K10's cold ring row: 16 pages of 1024, so calls on other read starts
#: touch other samples (a (V, FLAT_COLD_ROW) ring is 268 MB)
FLAT_COLD_ROW = 16384


def flat_operands(dev, rng, Vs, n, K, emax2, strided=False):
    """K8/K10's per-voice operands (scal, gain0, d_gain, maskf, extra):
    steps with |ds - 1|*n <= K, fractions, gains at frame 0 in [0, 0.5)
    and steps in +-1e-3, a 0/1 mask (a fifth off, voice 0 on), staggers below
    ``emax2``.  ``strided``: each a view that is not contiguous, as a
    caller may hand them over: scal ``[:, :, :4]`` of a (Vs, 2, 8) tensor,
    gain0 and d_gain the two halves of one (Vs, 2, 2), maskf a column of a
    (Vs, 2), extra column-major."""
    from oddio_tpu_torch.ops._dev import device_split_ds

    di, fh, fl = device_split_ds(_t(rng.uniform(1 - K / n, 1 + K / n, (Vs, 2)), dev))
    scal = torch.stack([_t(rng.uniform(0, 1, (Vs, 2)), dev), fh, fl, di.float()], -1)
    gains = _t(np.stack([rng.uniform(0, 0.5, (Vs, 2)), rng.uniform(-1e-3, 1e-3, (Vs, 2))],
                        -1), dev)
    maskf = _t((rng.uniform(0, 1, Vs) > 0.2) | (np.arange(Vs) == 0), dev)
    extra = _t(rng.integers(0, emax2, (Vs, 2)), dev, np.int32)
    if not strided:
        return (scal.contiguous(), gains[..., 0].contiguous(), gains[..., 1].contiguous(),
                maskf, extra)
    wide = torch.zeros((Vs, 2, 8), device=dev)
    wide[:, :, :4] = scal
    m2 = torch.zeros((Vs, 2), device=dev)
    m2[:, 1] = maskf
    return wide[:, :, :4], gains[..., 0], gains[..., 1], m2[:, 1], extra.t().contiguous().t()


def flat_rstart(dev, rng, Vs, rowlen, past=600):
    """K10's window base columns: anywhere in a ``rowlen`` row, up to
    ``past`` of the two-page fetch past its end (reading the next row), the
    last voice's inside its row (its fetch stays in the ring)."""
    rs = rng.integers(0, rowlen - 2048 + past, Vs)
    rs[-1] = min(rs[-1], rowlen - 2048)
    return _t(rs, dev, np.int32)


def k8_sets(dev, rng, n_sets, K, emax2, n=W):
    """K8's cold sets: ``n_sets`` (windows (V, select_window), operands),
    12.6 MB of windows each at emax2 36, 14.7 MB at 163."""
    from oddio_tpu_torch.ops.ring_kernels import select_window

    return [(torch.randn((V, select_window(n, emax2, K)), device=dev),)
            + flat_operands(dev, rng, V, n, K, emax2) for _ in range(n_sets)]


def k10_sets(dev, rng, n_sets, K, emax2, n=W):
    """K10's cold sets: one (V, FLAT_COLD_ROW) ring and ``n_sets``
    (rstart, operands) reading other places of it."""
    ring = torch.randn((V, FLAT_COLD_ROW), device=dev)
    return ring, [(flat_rstart(dev, rng, V, FLAT_COLD_ROW),) + flat_operands(dev, rng, V, n, K,
                                                                           emax2)
                  for _ in range(n_sets)]


def select_operands(dev, rng, Vs, L, lo, hi, ring=None):
    """K5's operands at the host pool's layout: (ring (Vs, L), rrow,
    extra (< 161: emax at 48 kHz), scal for |ds - 1| in [lo, hi], gain0,
    d_gain, maskf with a fifth of the voices masked).  ``ring`` reuses a
    ring (cold sets)."""
    from oddio_tpu_torch.ops._dev import device_split_ds

    mag = rng.uniform(lo, hi, (Vs, 2)) * rng.choice([-1.0, 1.0], (Vs, 2))
    di, fh, fl = device_split_ds(_t(1.0 + mag, dev))
    scal = torch.stack([_t(rng.uniform(0, 1, (Vs, 2)), dev), fh, fl, di.float()], -1).contiguous()
    if ring is None:
        ring = _t(rng.standard_normal((Vs, L)), dev)
    return (ring, _t(rng.integers(0, L // 128, Vs), dev, np.int32),
            _t(rng.integers(0, 161, (Vs, 2)), dev, np.int32), scal,
            _t(rng.uniform(0, 0.1, (Vs, 2)), dev), _t(rng.uniform(-1e-4, 1e-4, (Vs, 2)), dev),
            _t(rng.uniform(0, 1, Vs) > 0.2, dev))


def select_scene_operands(dev, rng, V, L, ring=None):
    """K5's operands for a scene-form case: ``select_operands`` with steps
    up to the strip gate (|ds - 1| <= 0.125, where the SELECT_R clamp
    binds), every other voice's read windows across the ring's end, and
    every seventh voice frozen (ds = 0, a fully clamped offset)."""
    ops = list(select_operands(dev, rng, V, L, 0.0, 0.125, ring))
    ops[1][::2] = L // 128 - 1
    ops[3][::7, :, 1:] = 0.0
    return ops


def select_bytes(RK, ops, n=SELECT_N, K=SELECT_K, scenes=1):
    """Bytes K5 must move: each voice's read span over both ears, its
    operands (44 bytes), the (2, n) output (one per scene)."""
    ring, rrow, extra, scal = ops[:4]
    idx = []
    for e in range(2):
        off, _ = RK.strip_positions(scal[:, e], n, K)
        idx.append(128 * rrow.long()[:, None] + extra[:, e:e + 1].long()
                   + torch.arange(n, device=ring.device) + off)
    return span_bytes(torch.stack(idx, 1)) + 44 * ring.shape[0] + 8 * n * scenes


def place_operands(dev, rng, rows, size, mw, host_pool):
    """K4's (chunk, wpos, wcount): at the mixer's shape cursors anywhere,
    every other row's write wrapping, counts uniform in [0, mw]; at the
    host pool's, cursors anywhere and n_write 512 or 513 (``host_prepare``
    at 48 kHz, 512-frame blocks)."""
    chunk = torch.randn((rows, mw), device=dev)
    if host_pool:
        wpos = rng.integers(0, size, rows)
        wcount = rng.integers(mw - 1, mw + 1, rows)
    else:
        wpos = np.where(np.arange(rows) % 2, rng.integers(size - mw + 1, size, rows),
                        rng.integers(0, size - mw, rows))
        wcount = rng.integers(0, mw + 1, rows)
    return chunk, _t(wpos, dev, np.int32), _t(wcount, dev, np.int32)


def place_library(ring, chunk, wpos, wcount):
    """``index_put_``'s operands for K4's function: the written lanes'
    flat indices and values."""
    rows, size = ring.shape
    mw = chunk.shape[1]
    dev = ring.device
    j = torch.arange(mw, device=dev)
    keep = j[None, :] < wcount.long()[:, None]
    flat = (torch.arange(rows, device=dev)[:, None] * size
            + torch.remainder(wpos.long()[:, None] + j, size))[keep]
    return flat, chunk[keep]


def place_record(RK, wpos, wcount):
    """A voice record carrying K4's cursor (``wrow``, ``extra_w``) and
    count (``n_write``); the read fields are zero."""
    Vs = wpos.shape[0]
    dev = wpos.device
    z2i = torch.zeros((Vs, 2), dtype=torch.int32, device=dev)
    z2 = torch.zeros((Vs, 2), device=dev)
    return RK.voice_record(
        torch.zeros(Vs, dtype=torch.int32, device=dev), z2i,
        torch.zeros((Vs, 2, 4), device=dev), z2, z2, torch.zeros(Vs, device=dev),
        wpos // 128, wpos % 128, wcount)


# --- clocks --------------------------------------------------------------------


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


#: profiled sessions of a call before ``device_profile`` reports that the
#: profiler saw no device work at all
PROFILE_TRIES = 3
#: sessions ``device_profile(..., exact=True)`` may take to find two
#: consecutive ones that agree before it raises
EXACT_TRIES = 8
#: sessions ``device_profile`` has taken again since the process started
PROFILE_RETAKES = {"sessions": 0}
#: the range each profiled session wraps its calls in: device records that
#: start before it belong to an earlier session
_MARK = "kernel_bench.device_profile"


def _session(fn, reps):
    """({kernel name: ms per call}, device kernels, stale records) of one
    ``torch.profiler`` session of ``reps`` calls: copies and memsets count
    in the split, not as kernels; device records that start before the
    session's own range (an earlier session's, delivered late) count in
    neither, only in ``stale``."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(_MARK):
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    events = list(prof.events())
    t0 = min((ev.time_range.start for ev in events
              if ev.name == _MARK and ev.device_type != torch.autograd.DeviceType.CUDA),
             default=float("-inf"))
    split = collections.Counter()
    kernels = stale = 0
    for ev in events:
        if ev.device_type != torch.autograd.DeviceType.CUDA or ev.name == _MARK:
            continue
        if ev.time_range.start < t0:
            stale += 1
            continue
        split[ev.name] += ev.time_range.elapsed_us() / 1e3 / reps
        kernels += not ev.name.startswith(("Memcpy", "Memset"))
    return dict(split), kernels, stale


def device_profile(fn, reps=REPS, exact=False):
    """({kernel name: ms per call}, device kernels per call) of the device
    work ``reps`` calls launch (``torch.profiler``; copies and memsets
    count in the split, not as kernels); empty where it saw none.

    The tracer on the card loses records now and then (ROADMAP Q3.6): a
    session has come back empty, or short of a kernel, for calls that
    launched (the kernels' launch counters said so).  By default a session
    that records no device activity at all is taken again, up to
    ``PROFILE_TRIES`` sessions (three empty sessions still read 0).  With
    ``exact`` (the one-kernel checks, whose counts are compared exactly)
    sessions are taken until two consecutive ones count the same nonzero
    number of kernels and hold no stale record, up to ``EXACT_TRIES``,
    and a ``RuntimeError`` says what each session counted where none did;
    the count is never 0, so it cannot hide a call that launches nothing.
    Every session taken beyond the first (two with ``exact``) counts in
    ``PROFILE_RETAKES``."""
    if exact:
        seen = []
        for _ in range(EXACT_TRIES):
            split, kernels, stale = _session(fn, reps)
            seen.append((kernels, stale))
            if kernels and not stale and len(seen) > 1 and seen[-2] == (kernels, 0):
                PROFILE_RETAKES["sessions"] += len(seen) - 2
                return split, kernels / reps
        raise RuntimeError(f"no two consecutive profiled sessions agreed in {EXACT_TRIES} "
                           f"(device kernels, stale records) of each: {seen}")
    for attempt in range(PROFILE_TRIES):
        PROFILE_RETAKES["sessions"] += attempt > 0
        split, kernels, _ = _session(fn, reps)
        if split:
            break
    return split, kernels / reps


def device_split(fn, reps=REPS):
    """{kernel name: ms per call} of the device work ``reps`` calls launch
    (``torch.profiler``); empty where it saw none."""
    return device_profile(fn, reps)[0]


def device_ms(fn, reps=REPS):
    """The summed duration of the device work ``reps`` calls launch, per
    call; None where the profiler saw none."""
    split = device_split(fn, reps)
    return sum(split.values()) if split else None


# --- cases ---------------------------------------------------------------------


def append_cases(dev):
    """{name: (call, bound ms)} of K1/K9 and ``index_copy_``, warm and
    cold."""
    from oddio_tpu_torch.ops import flat_kernels as FK
    from oddio_tpu_torch.ops import ring_kernels as RK

    rows = torch.tensor([48, 144], dtype=torch.int32, device=dev)
    legs = torch.cat([torch.arange(4, device=dev) + 48, torch.arange(4, device=dev) + 144])
    pages = torch.tensor([2, 6], dtype=torch.int32, device=dev)
    cols = torch.cat([torch.arange(W, device=dev) + 2 * 512, torch.arange(W, device=dev) + 6 * 512])
    k1, k9 = k1_sets(dev, SETS), k9_sets(dev, SETS)
    bms = bound(12 * V * W)[0]
    out = {}
    for heat, s1, s9 in (("warm", k1[:1], k9[:1]), ("cold", k1, k9)):
        out[f"K1 rows_append, device rows, {heat}"] = (cycling(
            s1, lambda ring, slab, _: RK.rows_append(ring, slab, rows[0], rows[1])), bms)
        out[f"index_copy_ (K1), {heat}"] = (cycling(
            s1, lambda ring, _, slab2: ring.index_copy_(1, legs, slab2)), bms)
        out[f"K9 flat_append_aligned, device pair, {heat}"] = (cycling(
            s9, lambda ring, slab, _: FK.flat_append_aligned(ring, slab, pages)), bms)
        out[f"K9 flat_append_aligned, host ints, {heat}"] = (cycling(
            s9, lambda ring, slab, _: FK.flat_append_aligned(ring, slab, 2, 6)), bms)
        out[f"index_copy_ (K9), {heat}"] = (cycling(
            s9, lambda ring, _, slab2: ring.index_copy_(1, cols, slab2)), bms)
    return out


def select_cases(dev):
    """{name: (call, bound ms)} of K5 at its three shapes, warm, and at
    4096 voices cold (``SETS`` read-row sets); through ``strip_select``
    and ``strip_select_record``; and its scene form at ``SELECT_SCENES``,
    beside the (2, n) form on the same rows, warm and (the pack's 16 x
    256) cold."""
    from oddio_tpu_torch.ops import ring_kernels as RK

    rng = np.random.default_rng(11)
    kw = dict(n=SELECT_N, K=SELECT_K)
    out = {}
    for label, Vs, L, lo, hi in SELECT_CASES:
        sets = [select_operands(dev, rng, Vs, L, lo, hi)]
        if label == "main":
            sets += [select_operands(dev, rng, Vs, L, lo, hi, ring=sets[0][0])
                     for _ in range(SETS - 1)]
        bms = bound(select_bytes(RK, sets[0]), 22 * Vs * 2 * SELECT_N)[0]
        recs = [(s[0], RK.voice_record(*s[1:])) for s in sets]
        for heat, n_sets in (("warm", 1), ("cold", len(sets))):
            if heat == "cold" and n_sets == 1:
                continue
            out[f"K5 strip_select {label} V={Vs}, {heat}"] = (cycling(
                sets[:n_sets], lambda *ops: RK.strip_select(*ops, **kw)), bms)
            out[f"K5 strip_select_record {label} V={Vs}, {heat}"] = (cycling(
                recs[:n_sets], lambda ring, rec: RK.strip_select_record(ring, rec, **kw)), bms)
    # the scene form at the host-pool pack's shapes, beside the (2, n) form
    # on the same rows
    for label, S, vps, L in SELECT_SCENES:
        sets = [select_scene_operands(dev, rng, S * vps, L)]
        if label == "pack":
            sets += [select_scene_operands(dev, rng, S * vps, L, ring=sets[0][0])
                     for _ in range(SETS - 1)]
        bms = bound(select_bytes(RK, sets[0], scenes=S), 22 * S * vps * 2 * SELECT_N)[0]
        recs = [(s[0], RK.voice_record(*s[1:])) for s in sets]
        for heat, n_sets in (("warm", 1), ("cold", len(sets))):
            if heat == "cold" and n_sets == 1:
                continue
            out[f"K5 scene form {label} S={S} x {vps}, {heat}"] = (cycling(
                recs[:n_sets], lambda ring, rec, S=S: RK.strip_select_record(
                    ring, rec, scenes=S, **kw)), bms)
            out[f"K5 (2, n) form {label} {S * vps} rows, {heat}"] = (cycling(
                recs[:n_sets], lambda ring, rec: RK.strip_select_record(ring, rec, **kw)), bms)
    return out


def place_cases(dev):
    """{name: (call, bound ms)} of K4 and ``index_put_`` at the mixer's
    shape (mw = 2401 and 128) and the host pool's, warm and cold; at the
    host pool's also through ``ring_place_record``."""
    from oddio_tpu_torch.ops import ring_kernels as RK
    from oddio_tpu_torch.ops import stream_kernels as SK

    rng = np.random.default_rng(4)
    out = {}
    rows, size, mws = PLACE_MIXER
    for mw in mws:
        sets = []
        for _ in range(PLACE_RINGS):
            ring = torch.randn((rows, size), device=dev)
            chunk, wpos, wcount = place_operands(dev, rng, rows, size, mw, False)
            sets.append((ring, chunk, wpos, wcount) + place_library(ring, chunk, wpos, wcount))
        bms = bound(8 * int(sets[0][3].sum()) + 8 * rows)[0]
        for heat, ss in (("warm", sets[:1]), ("cold", sets)):
            out[f"K4 ring_place mixer mw={mw}, {heat}"] = (cycling(
                ss, lambda r, c, p, k, *_: SK.ring_place(r, c, p, k)), bms)
            out[f"index_put_ (K4 mixer mw={mw}), {heat}"] = (cycling(
                ss, lambda r, c, p, k, fi, vals: r.view(-1).index_put_((fi,), vals)), bms)
    rows, size, mw = PLACE_HOST
    ring = torch.randn((rows, size), device=dev)
    sets = []
    for _ in range(SETS):
        chunk, wpos, wcount = place_operands(dev, rng, rows, size, mw, True)
        sets.append((ring, chunk, wpos, wcount, place_record(RK, wpos, wcount))
                    + place_library(ring, chunk, wpos, wcount))
    bms = bound(8 * int(sets[0][3].sum()) + 12 * rows)[0]
    for heat, ss in (("warm", sets[:1]), ("cold", sets)):
        out[f"K4 ring_place host-pool mw={mw}, {heat}"] = (cycling(
            ss, lambda r, c, p, k, *_: SK.ring_place(r, c, p, k)), bms)
        out[f"K4 ring_place_record host-pool mw={mw}, {heat}"] = (cycling(
            ss, lambda r, c, p, k, rec, *_: SK.ring_place_record(r, c, rec)), bms)
        out[f"index_put_ (K4 host-pool mw={mw}), {heat}"] = (cycling(
            ss, lambda r, c, p, k, rec, fi, vals: r.view(-1).index_put_((fi,), vals)), bms)
    return out


#: the device-resident buffered pool's row at 48 kHz: front pad, the
#: ring modulus, the mirror and the dump slack (spatial.py W_CHUNK,
#: cap_pool, M_PAD); its inter-ear stagger bound (emax2)
READ_FP, READ_CAP, READ_M, READ_DMAX = 1024, 16384, 1024, 33


def read_ring(dev, Vs, cap=READ_CAP, seed=0):
    """A (Vs, RPV, 128) ring of N(0, 1) samples in the pool's row layout,
    made on ``dev`` from ``seed``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((Vs, (READ_FP + cap + READ_M + 1024) // 128, 128), device=dev,
                       generator=g)


def read_operands(dev, rng, Vs, K, R, base0=None, frozen=0.2, cap=READ_CAP):
    """One block's read operands in ``_advance_block``'s layout, for
    ``ring_kernels.ring_select_ears``: ear 0's int32 cursor ``base0``
    (default: anywhere, also outside [0, cap)), ear 1's within a few
    DMAX of it, steps with |ds - 1|*R <= K, fractions, gains at frame 0
    in [0, 0.5) and steps in +-1e-3 (so the chunk gain fold matters),
    frozen flags on a share ``frozen`` of the ears, a 0/1 mask (voice 0
    on)."""
    from oddio_tpu_torch.ops._dev import device_split_ds

    if base0 is None:
        base0 = rng.integers(-cap, 2 * cap, Vs)
    base1 = base0 + rng.integers(-READ_DMAX - 8, READ_DMAX + 8, Vs)
    ds = 1.0 + rng.uniform(-1.0, 1.0, (2, Vs)) * K / R
    return {"base_c": [_t(base0, dev, np.int32), _t(base1, dev, np.int32)],
            "frac_c": [_t(rng.uniform(0, 1, Vs), dev) for _ in range(2)],
            "split_c": [device_split_ds(_t(ds[e], dev)) for e in range(2)],
            "p_gain_c": [_t(rng.uniform(0, 0.5, Vs), dev) for _ in range(2)],
            "d_gain_c": [_t(rng.uniform(-1e-3, 1e-3, Vs), dev) for _ in range(2)],
            "frz_c": [_t(rng.uniform(0, 1, Vs) < frozen, dev) for _ in range(2)],
            "maskf": _t((rng.uniform(0, 1, Vs) > 0.2) | (np.arange(Vs) == 0), dev)}


def group_operands(dev, rng, Vs, K, n, base0, nb=4, walk=0.9, cap=READ_CAP):
    """``nb`` consecutive blocks' read operands for
    ``ring_kernels.ring_select_multi``, block b's cursors ``b*n`` past
    block 0's, give or take ``walk*b*K`` (past 1: out of the tier's
    contract), and ``render_multi``'s static row0s and shift ranges at a
    block advance of n frames.  Returns (ros, row0s, hs)."""
    from oddio_tpu_torch.ops.ring_kernels import multi_rows

    ros = [read_operands(dev, rng, Vs, K, n, base0 + b * n + np.round(
        rng.uniform(-walk, walk, Vs) * b * K).astype(np.int64), cap=cap) for b in range(nb)]
    return (ros,) + multi_rows(n, K, nb)


def capture_states(scene, sets=SETS):
    """Render the buffered ``scene`` (one device-resident pool) through a
    ``Renderer`` and capture its pool's ``render`` and ``render_multi``
    arguments: the first, delta block's, ``sets`` idle single blocks' and
    the last ``sets`` fused groups'.  Returns (pool, delta, singles,
    groups); each state replays with ``pool.render(*state)`` or
    ``pool.render_multi(*group)``."""
    import oddio_tpu_torch as pt
    from oddio_tpu_torch.core.run import eager

    pool = next(iter(scene._buffered_pools.values()))
    caps = {"render": [], "render_multi": []}
    for kind in caps:
        def spy(*a, _inner=getattr(pool, kind), _kind=kind):
            caps[_kind].append(a)
            return _inner(*a)
        setattr(pool, kind, spy)
    r = pt.Renderer(scene, 48000)
    try:
        # op by op: a replayed graph calls no render, and a step's state
        # leaves are rewritten in place by the next block
        with eager():
            for _ in range(sets + 1):  # a delta block, then idle single blocks
                r.render_block(W)
            r.render_frames(W * 4 * (sets + 2))  # fused idle groups of 4
    finally:
        for kind in caps:
            delattr(pool, kind)
    delta, singles, groups = caps["render"][0], caps["render"][1:], caps["render_multi"][-sets:]
    if len(singles) < sets or len(groups) < sets:
        raise RuntimeError(f"captured {len(singles)} single blocks and {len(groups)} groups")
    return pool, delta, singles, groups


def block_reads(pool, dstate, ddata, params, n, nb=1):
    """The read operands ``_advance_block`` leaves for a captured state's
    ``nb`` blocks (their appends land in the ring, as in the render):
    (the last block's state, [ro per block])."""
    ros = []
    for _ in range(nb):
        dstate, ro = pool._advance_block(dstate, ddata, params, n)
        ros.append(ro)
    return dstate, ros


def read_bytes(ros, n):
    """Bytes the pool's read must move for blocks ``ros`` (``_advance_block``'s
    read operands): per voice and block the span of both ears' positions
    ``base + frac + j*ds`` over the n frames plus the lerp's next sample,
    17 words of operands, the (2, n) output."""
    total = 0
    for ro in ros:
        lo = hi = None
        for e in range(2):
            ds, fh, fl = (x.double() for x in ro["split_c"][e])
            p0 = ro["base_c"][e].double() + ro["frac_c"][e].double()
            p1 = p0 + (n - 1) * (ds + fh + fl)
            a, b = torch.minimum(p0, p1), torch.maximum(p0, p1)
            lo = a if lo is None else torch.minimum(lo, a)
            hi = b if hi is None else torch.maximum(hi, b)
        total += 4 * int((hi.floor() - lo.floor() + 2).sum()) + 68 * lo.shape[0] + 8 * n
    return total


def read_cases(dev):
    """{name: (call, bound ms)} of the buffered pool's read at 4096 voices:
    ``render``, ``render_multi`` and their ``_advance_block`` chains
    replayed on captured states, warm (one state) and cold (``SETS``
    states), and the first, delta block's ``render`` (plays and motion
    shipped) warm."""
    from oddio_tpu_torch.utils.scene_profile import build_spatial

    pool, delta, singles, groups = capture_states(build_spatial(True, V, dev)[1])

    def advance(*state):
        return block_reads(pool, *state)

    out = {}
    bd = bound(read_bytes(advance(*delta)[1], W))[0]
    out["read K2 delta block, warm: render"] = (lambda: pool.render(*delta), bd)
    out["read K2 delta block, warm: advance"] = (lambda: advance(*delta), bd)
    b2 = bound(read_bytes(advance(*singles[0])[1], W))[0]
    b3 = bound(read_bytes(advance(*groups[0])[1], W))[0]
    for heat, k in (("warm", 1), ("cold", SETS)):
        out[f"read K2 idle block, {heat}: render"] = (cycling(singles[:k], pool.render), b2)
        out[f"read K2 idle block, {heat}: advance"] = (cycling(singles[:k], advance), b2)
        out[f"read K3 group nb=4, {heat}: render"] = (cycling(groups[:k], pool.render_multi), b3)
        out[f"read K3 group nb=4, {heat}: advance"] = (cycling(groups[:k], advance), b3)
    return out


def paired_host(fa, fb, pairs=PAIRS):
    """Median over ``pairs`` alternated calls of fa's host time (wall clock,
    no synchronise) less fb's, in ms; the device work queues behind."""
    d = []
    for _ in range(pairs):
        t0 = time.perf_counter()
        fa()
        t1 = time.perf_counter()
        fb()
        d.append((t1 - t0) - (time.perf_counter() - t1))
    torch.cuda.synchronize()
    return 1e3 * float(np.median(d))


def read_differences(res):
    """The read's own numbers: each ``...: render`` entry less its
    ``...: advance`` entry (ms, host_ms, device_ms, device kernels)."""
    out = {}
    for name, r in res.items():
        if not name.endswith(": render"):
            continue
        a = dict(res[name[:-len("render")] + "advance"])
        if a["kernels"] == 0 and a["device_ms"] is None:
            a["device_ms"] = 0.0  # a call that launches nothing
        d = {k: (None if r[k] is None or a[k] is None else r[k] - a[k])
             for k in ("ms", "host_ms", "device_ms", "kernels")}
        out[name[:-len(": render")]] = dict(d, bound_ms=r["bound_ms"],
                                            paired_host_ms=r.get("paired_host_ms"))
    return out


# --- the device-resident Adapt and Stream steps (K7, K6) ------------------------


def dr_pools(engine):
    """Every device-resident voice pool of a Mixer or SpatialScene
    ``engine``, its submixes' (singleton pools' engines) included."""
    out = []
    pools = list(getattr(engine, "_pools", {}).values())
    pools += list(getattr(engine, "_buffered_pools", {}).values())
    for p in pools:
        if p.is_dr:
            out.append(p)
        sub = getattr(p, "sig", None)
        if sub is not None and (hasattr(sub, "_pools") or hasattr(sub, "_buffered_pools")):
            out.extend(dr_pools(sub))
    return out


def capture_steps(pools, render, method="dr_render"):
    """Run ``render()`` under ``core.run.eager()`` with every pool's
    ``proto.<method>`` spied on: {pool: [the arguments of each call:
    (state, ddata, interval, n, count) of ``dr_render``]}.  Each replays
    with ``pool.proto.<method>(*args)``.  Op by op: a replayed graph calls
    no render, and a step's state leaves are rewritten in place by the
    next block."""
    from oddio_tpu_torch.core.run import eager

    caps = {p: [] for p in pools}
    for p in pools:
        def spy(*a, _inner=getattr(p.proto, method), _caps=caps[p]):
            _caps.append(a)
            return _inner(*a)
        setattr(p.proto, method, spy)
    try:
        with eager():
            render()
    finally:
        for p in pools:
            delattr(p.proto, method)
    return caps


def adapt_step(proto, args):
    """(the whole Adapt(inner) render, the inner's render alone) as
    no-argument calls on captured ``args``: their difference is the Adapt
    step."""
    state, ddata, rest = args[0], args[1], args[2:]
    return (lambda: proto.dr_render(*args),
            lambda: proto.inner.dr_render(state["inner"], ddata.get("inner", {}), *rest))


def step_kernels(proto, args):
    """Device kernels of one Adapt step (the whole render less the
    inner's) and of one Stream step on captured ``args`` of an Adapt pool
    (the Stream's None where the inner is no Stream)."""
    whole, inner = adapt_step(proto, args)
    k_inner = device_profile(inner, reps=1, exact=True)[1]
    k_adapt = device_profile(whole, reps=1, exact=True)[1] - k_inner
    is_stream = type(proto.inner).__name__ == "Stream"
    return k_adapt, (k_inner if is_stream else None)


#: blocks captured for the step modes: one warm state, SETS cold ones
STEP_BLOCKS = SETS + 2
_STEP_STATES = {}


def step_states(dev):
    """Captured Adapt-pool states: the 4096-voice config-5 mixer's two
    pools (512 Adapt(Stream), 3584 Adapt(Sine); n = 512, a write before
    the capture so one block ingests) and a host-pool scene's
    device-resident Adapt(Stream) pool (512 voices at n = 513).  Returns
    [(label, proto, [args per block])], built once per device."""
    if dev in _STEP_STATES:
        return _STEP_STATES[dev]
    import oddio_tpu_torch as pt
    from oddio_tpu_torch.utils.scene_profile import build_host_pools, build_mixer_agc, feed

    out = []
    _, mixer, ctls, rng = build_mixer_agc(V, dev)
    r = pt.Renderer(mixer, 48000)
    r.render_frames(W * 4)
    feed(ctls, rng, 1024)
    pools = dr_pools(mixer)
    caps = capture_steps(pools, lambda: [r.render_block(W) for _ in range(STEP_BLOCKS)])
    for p in pools:
        out.append((f"{type(p.proto.inner).__name__} V={p.capacity} n={W}", p.proto,
                    caps[p][-STEP_BLOCKS:]))
    _, scene, ctls, _, rng = build_host_pools(64, dev, dr_voices=512, submix_voices=64)
    r = pt.Renderer(scene, 48000)
    r.render_frames(W * 4)
    feed(ctls, rng, 1024)
    pools = [p for p in scene._buffered_pools.values() if p.is_dr]
    caps = capture_steps(pools, lambda: [r.render_block(W) for _ in range(STEP_BLOCKS)])
    for p in pools:
        args = caps[p][-STEP_BLOCKS:]
        out.append((f"{type(p.proto.inner).__name__} V={p.capacity} n={args[0][3]} "
                    "(host-pool scene)", p.proto, args))
    _STEP_STATES[dev] = out
    return out


def agc_bytes(args):
    """Bytes the Adapt step must move: the inner's samples in, the output
    out, 24 bytes of per-voice columns in (avg, tau, count, low, high,
    max_gain) and the carry out."""
    state, n = args[0], args[3]
    Vs = state["avg"].shape[0]
    return 8 * Vs * n + 28 * Vs


def agc_cases(dev):
    """{name: (call, bound ms)} of the whole Adapt step on captured pool
    states (``step_states``), warm (one block's state) and cold (``SETS``
    blocks' states in turn): ``...: render`` the Adapt pool's
    ``dr_render``, ``...: advance`` its inner's alone."""
    out = {}
    for label, proto, states in step_states(dev):
        bms = bound(agc_bytes(states[0]), 20 * states[0][0]["avg"].shape[0] * states[0][3])[0]
        for heat, ss in (("warm", states[:1]), ("cold", states[1:1 + SETS])):
            out[f"agc step {label}, {heat}: render"] = (
                cycling([adapt_step(proto, a) for a in ss], lambda w, i: w()), bms)
            out[f"agc step {label}, {heat}: advance"] = (
                cycling([adapt_step(proto, a) for a in ss], lambda w, i: i()), bms)
    return out


def resample_bytes(SK, state, n):
    """Bytes the Stream step must move: each voice's read span, the (V, n)
    output, 40 bytes of cursors (t, rate, start, len, count in; t', len',
    start' out)."""
    from oddio_tpu_torch.ops._dev import device_split_ds

    t, rate = state["t"], state["rate"]
    ds = rate * float(np.float32(1.0 / 48000.0))
    _, pos, _ = SK._positions(t, *device_split_ds(ds), n)
    Vs = t.shape[0]
    return span_bytes(pos) + 4 * Vs * n + 40 * Vs


def resample_cases(dev):
    """{name: (call, bound ms)} of the whole Stream step (``Stream.dr_render``
    of the Adapt(Stream) pools' captured inner states), warm and cold;
    ``...: advance`` does nothing, so the differences are the step."""
    from oddio_tpu_torch.ops import stream_kernels as SK

    out = {}
    for label, proto, states in step_states(dev):
        if type(proto.inner).__name__ != "Stream":
            continue
        inner = [adapt_step(proto, a)[1] for a in states]
        n = states[0][3]
        bms = bound(resample_bytes(SK, states[0][0]["inner"], n))[0]
        for heat, fs in (("warm", inner[:1]), ("cold", inner[1:1 + SETS])):
            out[f"stream step {label}, {heat}: render"] = (cycling([(f,) for f in fs],
                                                                   lambda f: f()), bms)
            out[f"stream step {label}, {heat}: advance"] = (lambda: None, bms)
    return out


# --- K6's arena form: the sampler reads ----------------------------------------

#: operand sets of a "cold" arena case: a sampler or seek set reads ~3.6 MB
#: (the union of its rows' spans) at other places of a ~43 MB arena; the
#: arena fits the 50 MB L2, so no set's reads are cold-cache reads (the
#: wavetable's sets all read one 10 KB table, as its path does)
ARENA_SETS = 16
#: the arena form's shapes on the three paths, one launch each: (label,
#: rows, region kind, per-frame step range).  The sampler's rows are one
#: fader bank of 1024 stereo voices (44.1 kHz sounds at 48 kHz, speeds
#: 0.8-1.25); the wavetable's 1024 Speed(Cycle) voices at ratio 1; the
#: seek pool's 1024 voices x 2 ears at doppler-warped ratio ~1
ARENA_SHAPES = (("sampler", 2048, "stereo", (0.735, 1.149)),
                ("wavetable", 1024, "looped", (1.0, 1.0)),
                ("seek", 2048, "mono", (0.98, 1.02)))
ARENA_N = 512


def arena_setup(seed=0, sounds=8, seconds=10.0, table=2048):
    """A guarded arena laid out as core/frames.py lays it, in a private
    ``_Arena``: ``sounds`` stereo sounds of ``seconds`` at 44.1 kHz (one
    guarded region per channel), as many mono ones, and one looped
    ``table``-sample region.  Returns (host garena (rows, 256), regions
    {kind: [(offset, length, channel stride)]})."""
    from oddio_tpu_torch.core import frames as FR

    rng = np.random.default_rng(seed)
    A = FR._Arena(1)
    n = int(seconds * 44100)
    reg = {"mono": [], "stereo": [], "looped": []}
    for _ in range(sounds):
        st = (rng.standard_normal((n, 2)) * 0.3).astype(np.float32)
        g = [A.add_guarded(np.ascontiguousarray(st[:, c])) for c in range(2)]
        reg["stereo"].append((g[0], n, g[1] - g[0]))
        reg["mono"].append((A.add_guarded((rng.standard_normal(n) * 0.3).astype(np.float32)),
                            n, 0))
    loff, _ = A.add_looped(np.sin(np.linspace(0, 2 * np.pi, table, endpoint=False))
                           .astype(np.float32))
    reg["looped"].append((loff, table, 0))
    return np.concatenate(A._gchunks).reshape(-1, FR.ARENA_ROW), reg


def arena_operands(dev, rng, regions, rows, kind, ds_range, edges=True):
    """K6 arena-form operands ``(xg, lo, hi, o0, ds_int, f_hi, f_lo)`` for
    ``rows`` rows reading ``kind`` regions as the paths build them: a
    guarded region's rows clamp to [goff - ARENA_GUARD, goff + len] (a
    stereo sound's two channel rows adjacent, at ``goff + c*stride``), a
    looped one's to [loff - 1, loff + len - 1]; cursors anywhere in a
    region, some (with ``edges``) before it, past it and far outside
    (the clamp); trunc-form fractions in (-1, 1); steps uniform in
    ``ds_range``, split on the host."""
    from oddio_tpu_torch.core.frames import ARENA_GUARD
    from oddio_tpu_torch.ops._dev import split_ds

    regs = regions[kind]
    pick = rng.integers(len(regs), size=rows)
    off = np.array([regs[i][0] for i in pick], np.int64)
    length = np.array([regs[i][1] for i in pick], np.int64)
    # stereo rows in channel pairs (0, 1), (2, 3), ...: one voice's sound
    # and cursor, channel 1 a stride past channel 0 (an odd last row is a
    # channel 0 alone)
    pairs = slice(0, 2 * (rows // 2), 2)
    if kind == "stereo":
        first = pick[pairs]
        off[1::2] = off[pairs] + np.array([regs[i][2] for i in first], np.int64)
        length[1::2] = length[pairs]
    if kind == "looped":
        base = rng.integers(0, length)
        lo, hi = off - 1, off + length - 1
    else:
        base = rng.integers(-600, length + 200)
        if edges:
            base[::7] = -rng.integers(1, 40, base[::7].shape)  # just before the sound
            base[3::11] = length[3::11] - rng.integers(0, 40, base[3::11].shape)  # its end
            base[5::13] = rng.choice([-10**6, 10**7], base[5::13].shape)  # the clamp
        lo, hi = off - ARENA_GUARD, off + length
    if kind == "stereo":
        base[1::2] = base[pairs]
    o0 = rng.uniform(-0.99 if kind != "looped" else 0.0, 0.999, rows).astype(np.float32)
    ds = rng.uniform(*ds_range, rows).astype(np.float32)
    di, fh, fl = split_ds(ds)
    xg = off + base
    return tuple(torch.tensor(np.asarray(x, dt), device=dev) for x, dt in (
        (xg, np.int32), (lo, np.int32), (hi, np.int32), (o0, np.float32), (di, np.int32),
        (fh, np.float32), (fl, np.float32)))


def arena_bytes(SK, ops, n):
    """Bytes K6's arena form must move: the union of the rows' read spans
    (rows reading one sound, or the one table, share their samples), the
    (R, n) output and 28 bytes of operands a row."""
    xg, lo, hi, o0, di, fh, fl = ops
    _, p, _ = SK._positions(o0, di, fh, fl, n)
    idx = torch.clamp(xg - 1, lo, hi).to(torch.int64)[:, None] + 1 + p
    R = xg.shape[0]
    return union_bytes(idx) + 4 * R * n + 28 * R


def arena_cases(dev):
    """{name: (call, bound ms)} of K6's arena form at the three paths'
    shapes (``ARENA_SHAPES``, n = 512) on the paths' own operands (no edge
    cases), warm (one operand set) and cold (``ARENA_SETS`` sets in turn),
    and its plain version warm."""
    from oddio_tpu_torch.ops import stream_kernels as SK

    host, regions = arena_setup()
    garena = torch.tensor(host, device=dev)
    rng = np.random.default_rng(6)
    out = {}
    for label, rows, kind, dsr in ARENA_SHAPES:
        sets = [arena_operands(dev, rng, regions, rows, kind, dsr, edges=False)
                for _ in range(ARENA_SETS)]
        bms = bound(arena_bytes(SK, sets[0], ARENA_N))[0]
        for heat, ss in (("warm", sets[:1]), ("cold", sets)):
            out[f"arena {label} {rows} rows, {heat}"] = (
                cycling(ss, lambda *o: SK.arena_resample(garena, *o, ARENA_N)), bms)
        out[f"arena {label} {rows} rows, plain"] = (
            lambda o=sets[0]: SK.arena_resample_plain(garena, *o, ARENA_N), bms)
    return out


# --- K6's arena form, whole steps: the sampler, wavetable and seek steps --------

#: the interval of the 48 kHz paths
STEP_IV = float(np.float32(1.0 / 48000.0))
#: per-frame step ranges of the tiers 1, 2 and 4, as Speed factors of a
#: 44.1 kHz sound at 48 kHz
STEP_TIERS = {1: (0.3, 1.05), 2: (1.1, 2.1), 4: (2.2, 4.3)}


def _unwrap(state):
    """A Speed chain's leaf state and its Speed factors, outer first."""
    speeds = []
    while "speed" in state and "inner" in state:
        speeds.append(state["speed"])
        state = state["inner"]
    return state, speeds


def _leaf_reads(kind, st, split, n, C, cur=None):
    """The (rows, n) arena indices a leaf's first <= 512-frame chunk reads
    (each row's span ends one past its last index), from the chains'
    position math: rows of a C-channel FramesSignal at goff +
    c*guard_stride(len), Cycle at loff."""
    from oddio_tpu_torch.core.frames import ARENA_GUARD as guard
    from oddio_tpu_torch.core.frames import ARENA_ROW as row
    from oddio_tpu_torch.ops import stream_kernels as SK

    b, o = cur if cur is not None else (st["base"], st["frac"])
    if kind == "cycle":
        roff, length = st["loff"], st["length"]
        lo, hi = roff - 1, roff + length - 1
    else:
        length = st["length"]
        stride = 2 * guard + length + torch.remainder(-length, row)
        c = torch.arange(C, dtype=torch.int32, device=length.device)
        roff = (st["goff"][:, None] + c * stride[:, None]).reshape(-1)
        length = length.repeat_interleave(C)
        lo, hi = roff - guard, roff + length
        b, o = b.repeat_interleave(C), o.repeat_interleave(C)
        split = tuple(x.repeat_interleave(C) for x in split)
    _, p, _ = SK._positions(o, *split, min(n, 512))
    xc = torch.clamp(roff + b - 1, lo, hi).to(torch.int64)
    return xc[:, None] + 1 + p


def _leaf_split(kind, st, interval, speeds):
    """The step split the chain derives (Speed factors applied outer
    first), written out here so that the bench runs on an older tree."""
    from oddio_tpu_torch.ops._dev import device_split_ds

    for sp in speeds:
        interval = (interval * sp if isinstance(interval, torch.Tensor)
                    else sp * float(np.float32(interval)))
    if not isinstance(interval, torch.Tensor):
        return st["ds_int"], st["f_hi"], st["f_lo"]
    ds = st["rate"] * interval
    if kind == "frames":
        ds = torch.where(torch.abs(ds - 1.0) <= float(np.finfo(np.float32).eps), 1.0, ds)
    return device_split_ds(ds)


#: bytes of a leaf's per-voice state a step reads (t, base, frac, region,
#: length, rate, one Speed factor) and writes (its cursor)
_LEAF_IN = {"frames": 8 + 4 * 6, "cycle": 4 * 6}
_LEAF_OUT = {"frames": 16, "cycle": 8}


def step_bytes(method, kind, C, args):
    """Bytes a whole step must move on captured ``args``: the union of the
    rows' read spans (a Fader's non-fading voices read their active bank
    only), the output, and the per-voice state in and out (a Fader's own
    prog, inc, fading and flip too; the count)."""
    if method == "dr_warp_render":
        from oddio_tpu_torch.ops._dev import device_split_ds

        st, _, t0, dt, n = args
        V, E = t0.shape
        if kind == "frames":
            s0 = (st["t"][:, None] + t0.to(torch.float64)) * st["rate"][:, None].double()
            bt = torch.trunc(s0)
            b, o = bt.to(torch.int32).reshape(-1), (s0 - bt).float().reshape(-1)
        else:  # the warp's cursor shifts stay within the rows' spans to an ulp
            b = st["base"].repeat_interleave(E)
            o = st["frac"].repeat_interleave(E)
        split = tuple(x.reshape(-1) for x in device_split_ds(dt * st["rate"][:, None]))
        rows = {k: st[k].repeat_interleave(E) for k in ("goff", "loff", "length") if k in st}
        idx = _leaf_reads(kind, rows, split, n, 1, (b, o))
        per_voice = _LEAF_IN[kind] - 4 + 8 * E  # no split; t0 and dt per ear
        return union_bytes(idx) + 4 * V * E * n + per_voice * V
    state, ddata, interval, n, count = args
    if "prog" in state:  # a Fader: each bank as its chain, the active bank where idle
        done = state["fading"] & (state["prog"] >= 1.0)
        flip = state["flip"] ^ done
        fading = state["fading"] & ~done
        reads = []
        for bank, need in (("a", fading | ~flip), ("b", fading | flip)):
            st, sp = _unwrap(state[bank])
            idx = _leaf_reads(kind, st, _leaf_split(kind, st, interval, sp), n, C)
            reads.append(idx[need.repeat_interleave(C)])
        V = state["prog"].shape[0]
        idx = torch.cat(reads)
        return (union_bytes(idx) + 4 * V * C * n
                + V * (2 * (_LEAF_IN[kind] + _LEAF_OUT[kind]) + 10 + 6 + 4))
    st, sp = _unwrap(state)
    V = st["base"].shape[0]
    idx = _leaf_reads(kind, st, _leaf_split(kind, st, interval, sp), n, C)
    return union_bytes(idx) + 4 * V * C * n + V * (_LEAF_IN[kind] + _LEAF_OUT[kind] + 4)


_ARENA_STATES = {}


#: voices of each captured arena-step scene
STEP_VOICES = 1024


def arena_states(dev):
    """Captured arguments of the three paths' steps, ``STEP_BLOCKS`` blocks
    each after a 1 s warm-up: the sampler's Fader pool (``build_sampler``,
    its control script of speed writes and fades every 8 blocks), the
    wavetable's Speed(Cycle) pool (``build_wavetable``, 64 speed writes
    before the capture) and the seek sampler's seek pool
    (``build_seek_sampler``, its ``dr_warp_render``).  Returns [(label,
    proto, method, kind, C, [args per block])], built once per device."""
    if dev in _ARENA_STATES:
        return _ARENA_STATES[dev]
    import oddio_tpu_torch as pt
    from oddio_tpu_torch.utils.scene_profile import (build_sampler, build_seek_sampler,
                                                     build_wavetable)

    voices = STEP_VOICES
    out = []
    drv = build_sampler(voices, dev)
    r = pt.Renderer(drv.mixer, 48000)
    drv.render(r, 96)
    pools = dr_pools(drv.mixer)
    caps = capture_steps(pools, lambda: drv.render(r, STEP_BLOCKS))
    out.append((f"sampler Fader(Speed(FramesSignal)) V={voices} stereo", pools[0].proto,
                "dr_render", "frames", 2, caps[pools[0]][-STEP_BLOCKS:]))
    mixer, scs, rng = build_wavetable(voices, dev)
    r = pt.Renderer(mixer, 48000)
    r.render_frames(48000)
    for sc in scs[:64]:
        sc.set_speed(float(rng.uniform(0.8, 1.25)))
    pools = dr_pools(mixer)
    caps = capture_steps(pools, lambda: [r.render_block(W) for _ in range(STEP_BLOCKS)])
    out.append((f"wavetable Speed(Cycle) V={voices}", pools[0].proto, "dr_render", "cycle", 1,
                caps[pools[0]][-STEP_BLOCKS:]))
    _, scene, _, _ = build_seek_sampler(voices, dev)
    r = pt.Renderer(scene, 48000)
    r.render_frames(48000)
    pools = [p for p in scene._seek_pools.values() if p.is_dr]
    caps = capture_steps(pools, lambda: [r.render_block(W) for _ in range(STEP_BLOCKS)],
                         method="dr_warp_render")
    out.append((f"seek FramesSignal V={voices} E=2", pools[0].proto, "dr_warp_render",
                "frames", 1, caps[pools[0]][-STEP_BLOCKS:]))
    _ARENA_STATES[dev] = out
    return out


def arena_step_cases(dev):
    """{name: (call, bound ms)} of the three paths' whole steps on captured
    states (``arena_states``), warm (one block's state) and cold
    (``SETS`` blocks' states in turn): the sampler's whole Fader step and
    one bank's step (its ``a`` chain's ``dr_render``), the wavetable's
    Speed(Cycle) step and the seek pool's warped read.  ``...: advance``
    does nothing, so each difference is the step; both run on any tree of
    the port (pool methods only)."""
    out = {}
    for label, proto, method, kind, C, calls in arena_states(dev):
        fn = getattr(proto, method)
        steps = [(label, lambda a, fn=fn: fn(*a), calls, step_bytes(method, kind, C, calls[0]))]
        if method == "dr_render" and "prog" in calls[0][0]:
            def bank(a, proto=proto):
                st, dd, iv, n, cnt = a
                return proto.a.dr_render(st["a"], dd.get("a", {}), iv, n, cnt)

            one = (calls[0][0]["a"],) + calls[0][1:]
            steps.append((f"{label} bank a", bank, calls,
                          step_bytes(method, kind, C, one)))
        for name, call, cs, nbytes in steps:
            bms = bound(nbytes)[0]
            for heat, ss in (("warm", cs[:1]), ("cold", cs[1:1 + SETS])):
                out[f"arena step {name}, {heat}: render"] = (
                    cycling([(a,) for a in ss], call), bms)
                out[f"arena step {name}, {heat}: advance"] = (lambda: None, bms)
    return out


def step_call(proto, method, kind, C, args, plain=False):
    """A no-argument call of the whole step on captured ``args`` straight
    through ``stream_kernels.fader_step``/``arena_step``/``arena_warp``
    (or, with ``plain``, their plain versions), its operands taken from
    the captured state as the Fader, Speed and leaf routes take them."""
    from oddio_tpu_torch.ops import speed as SP
    from oddio_tpu_torch.ops import stream_kernels as SK

    if method == "dr_warp_render":
        st, dd, t0, dt, n = args
        fn = SK.arena_warp_plain if plain else SK.arena_warp
        return lambda: fn(dd["garena"], kind, st, t0, dt, n)
    state, ddata, interval, n, count = args
    if "prog" in state:
        k = SP.arena_chain(proto.a)[0]
        la, ld, iva, spa = SP.chain_operands(k, state["a"], ddata.get("a", {}), interval)
        lb, _, ivb, spb = SP.chain_operands(k, state["b"], ddata.get("a", {}), interval)
        fn = SK.fader_step_plain if plain else SK.fader_step
        return lambda: fn(ld["garena"], kind, state, (la, lb), (iva, ivb), n, count, C,
                          (spa, spb))
    k = SP.arena_chain(proto)[0]
    ls, ld, iv, sp = SP.chain_operands(k, state, ddata, interval)
    fn = SK.arena_step_plain if plain else SK.arena_step
    return lambda: fn(ld["garena"], kind, ls, iv, n, count, C, sp)


def step_leaf(dev, rng, regions, V, kind, C=1, edges=True):
    """A FramesSignal (``kind`` "frames", C channels: "mono" or "stereo"
    regions) or Cycle ("cycle": the looped table) leaf's (V,) state as a
    pool keeps it: 44.1 kHz sounds, cursors anywhere in the sound and (with
    ``edges``) before it, past it, far outside it (the clamp), negative
    fractions, and two voices at the ``dr_state_init`` row; the slot
    rows' split of the 48 kHz interval."""
    from oddio_tpu_torch.ops import stream_kernels as SK
    from oddio_tpu_torch.ops._dev import split_ds, top12

    eps = np.finfo(np.float32).eps
    if kind == "cycle":
        off, length, _ = regions["looped"][0]
        rate = np.full(V, np.float32(44100.0))
        rate[::3] = np.float32(48000.0)
        st = {"base": rng.integers(0, length, V).astype(np.int32),
              "frac": rng.uniform(0.0, 0.999, V).astype(np.float32),
              "loff": np.full(V, off, np.int32), "length": np.full(V, length, np.int32)}
    else:
        regs = regions["stereo" if C == 2 else "mono"]
        pick = rng.integers(len(regs), size=V)
        length = np.array([regs[i][1] for i in pick], np.int32)
        rate = np.full(V, np.float32(44100.0))
        t = rng.uniform(-0.05, 1.0, V) * (length / 44100.0)
        if edges:
            t[::7] = -rng.uniform(1e-5, 1e-3, t[::7].shape)
            t[3::11] = length[3::11] / 44100.0 - rng.uniform(0, 1e-3, t[3::11].shape)
            t[5::13] = rng.choice([-30.0, 300.0], t[5::13].shape)
        st = {"t": t, "goff": np.array([regs[i][0] for i in pick], np.int32), "length": length}
        if edges and V > 8:
            st["goff"][-2:], st["length"][-2:], rate[-2:], t[-2:] = SK.ARENA_GUARD, 1, 1.0, 0.0
        s0 = t * rate.astype(np.float64)
        st["base"] = np.trunc(s0).astype(np.int32)
        st["frac"] = (s0 - np.trunc(s0)).astype(np.float32)
    ds = (np.float32(STEP_IV) * rate).astype(np.float32)
    if kind == "frames":
        ds = np.where(np.abs(ds - np.float32(1.0)) <= eps, np.float32(1.0), ds)
    di, fh, fl = split_ds(ds)
    st.update(rate=rate, r_hi=top12(rate), ds_int=di, f_hi=fh, f_lo=fl,
              off=np.zeros(V, np.int32))
    return {k: torch.tensor(np.asarray(v), device=dev) for k, v in st.items()}


def step_speeds(dev, rng, V, tier):
    """(V,) Speed factors whose steps fall in ``tier`` (one a unit step)."""
    s = rng.uniform(*STEP_TIERS[tier], V).astype(np.float32)
    s[0] = np.float32(48000.0 / 44100.0)
    return torch.tensor(s, device=dev)


def step_count(dev, rng, V, n, full=False):
    """The frames each voice consumes: n, or (as a buffered pool's
    n_write) some below n and some 0."""
    c = np.full(V, n, np.int32)
    if not full:
        c[1::5] = rng.integers(1, n, c[1::5].shape)
        c[3::7] = 0
    return torch.tensor(c, device=dev)


def fade_columns(dev, rng, V, frac_fading=0.5):
    """A Fader's (V,) prog, inc, fading and flip with fading, done (prog 1
    at block start), starting (prog 0), flipped and idle voices mixed."""
    fading = rng.random(V) < frac_fading
    prog = rng.uniform(0.0, 1.0, V).astype(np.float32)
    prog[::4] = 1.0
    prog[1::6] = 0.0
    inc = np.where(fading, np.float32(STEP_IV) / rng.uniform(STEP_IV, 0.05, V)
                   .astype(np.float32), 0.0).astype(np.float32)
    return {"prog": torch.tensor(prog, device=dev), "inc": torch.tensor(inc, device=dev),
            "fading": torch.tensor(fading, device=dev),
            "flip": torch.tensor(rng.random(V) < 0.5, device=dev)}


def seek_offsets(dev, rng, V, E=2):
    """A seek read's (V, E) second-offsets and per-frame intervals:
    propagation delays up to 60 ms and doppler-warped steps (one a unit
    step)."""
    t0 = rng.uniform(-0.06, 0.002, (V, E)).astype(np.float32)
    dt = (np.float32(STEP_IV) * rng.uniform(0.8, 1.25, (V, E))).astype(np.float32)
    dt[0] = np.float32(1.0 / 44100.0)
    return torch.tensor(t0, device=dev), torch.tensor(dt, device=dev)


MODES = {"append": append_cases, "place": place_cases, "select": select_cases,
         "read": read_cases, "agc": agc_cases, "resample": resample_cases,
         "arena": arena_cases, "arena_step": arena_step_cases}


def main(argv=None):
    modes = (sys.argv[1:] if argv is None else argv) or list(MODES)
    for m in modes:
        if m not in MODES:
            raise SystemExit(f"kernel_bench: unknown mode {m!r}; one of {list(MODES)}")
    if not torch.cuda.is_available():
        raise SystemExit("kernel_bench: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    res = {}
    for m in modes:
        fns = MODES[m](dev)
        res.update({name: dict(zip(("ms", "host_ms"), clocks(fn)), bound_ms=b)
                    for name, (fn, b) in fns.items()})
        for name, (fn, _) in fns.items():  # the read's host time, paired
            if name.endswith(": render"):
                other = fns[name[:-len("render")] + "advance"][0]
                res[name]["paired_host_ms"] = paired_host(fn, other)
        for name, (fn, _) in fns.items():  # the profiler last: it slows later host calls
            split, kernels = device_profile(fn)
            res[name]["device_ms"] = sum(split.values()) if split else None
            res[name]["device_split"] = split
            res[name]["kernels"] = kernels
        del fns
        torch.cuda.empty_cache()
    for name, r in res.items():
        dev_ms = "not measured" if r["device_ms"] is None else f"{r['device_ms']:.4f}"
        split = sorted(r["device_split"].items(), key=lambda kv: -kv[1])
        split = ", ".join(f"{k[:40]} {v:.4f}" for k, v in split[:8])
        print(f"{name}: ms {r['ms']:.4f}, device_ms {dev_ms} ({r['kernels']:.1f} kernels: "
              f"{split}), host_ms {r['host_ms']:.4f} (bound {r['bound_ms']:.4f}) [{card}]")
    reads = read_differences(res)
    for name, d in reads.items():
        fmt = {k: "not measured" if v is None else f"{v:.4f}" for k, v in d.items()}
        print(f"{name} (render less advance): ms {fmt['ms']}, device_ms {fmt['device_ms']}, "
              f"host_ms {fmt['host_ms']}, paired host_ms {fmt['paired_host_ms']}, device "
              f"kernels {fmt['kernels']} (bound {fmt['bound_ms']}) [{card}]")
    print(json.dumps({"card": card, "kernels": res, "reads": reads}))


if __name__ == "__main__":
    main()
