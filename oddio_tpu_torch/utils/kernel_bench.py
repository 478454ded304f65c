"""Operand and capture builders for the kernel tests: operands at the
pools' shapes for K2/K3 (``read_*``, ``group_operands``), K8/K10
(``flat_*``) and K6's arena form and whole steps (``arena_*``,
``step_*``, ``fade_columns``, ``seek_offsets``); the captured arguments
of a buffered pool's reads (``capture_states``, ``block_reads``) and of
the device-resident pools' steps (``dr_pools``, ``capture_steps``,
``arena_states``), replayed through the kernels or their plain versions
(``step_call``); the buffered pool's walk (``walk_operands``); and
``device_profile``, the device kernels a call launches, as
``torch.profiler`` counts them on the card.

Timing lives in ``benchmark/``: its traced slice reads each kernel's
device time on the cells and its ``*_roofline_pct`` metrics hold it
against the card's byte bound.
"""

from __future__ import annotations

import numpy as np
import torch

#: the paths' block
W = 512


def _t(x, dev, dtype=np.float32):
    return torch.tensor(np.asarray(x, dtype), device=dev)


# --- K8/K10 ----------------------------------------------------------------------


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


# --- device kernels a call launches --------------------------------------------------

#: sessions ``device_profile`` may take to find two consecutive ones that
#: agree before it raises
EXACT_TRIES = 8
#: the range each profiled session wraps its calls in: device records that
#: start before it belong to an earlier session
_MARK = "kernel_bench.device_profile"


def _session(fn):
    """(device kernels, stale records) of one ``torch.profiler`` session of
    one call: copies and memsets are not kernels; device records that
    start before the session's own range (an earlier session's, delivered
    late) count only in ``stale``."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(_MARK):
            fn()
            torch.cuda.synchronize()
    events = list(prof.events())
    t0 = min((ev.time_range.start for ev in events
              if ev.name == _MARK and ev.device_type != torch.autograd.DeviceType.CUDA),
             default=float("-inf"))
    kernels = stale = 0
    for ev in events:
        if ev.device_type != torch.autograd.DeviceType.CUDA or ev.name == _MARK:
            continue
        if ev.time_range.start < t0:
            stale += 1
        else:
            kernels += not ev.name.startswith(("Memcpy", "Memset"))
    return kernels, stale


def device_profile(fn):
    """The device kernels one call of ``fn`` launches, as ``torch.profiler``
    counts them (copies and memsets are not kernels).

    The tracer on the card loses records now and then (ROADMAP Q3.6): a
    session has come back empty, or short of a kernel, for calls that
    launched (the kernels' launch counters said so), and most sessions
    come back empty once a process has taken a dozen heavy ones.  So
    sessions are taken until two consecutive ones count the same nonzero
    number of kernels and hold no stale record, up to ``EXACT_TRIES``, and
    a ``RuntimeError`` says what each session counted where none did; the
    count is never 0, so it cannot hide a call that launches nothing."""
    seen = []
    for _ in range(EXACT_TRIES):
        seen.append(_session(fn))
        kernels, stale = seen[-1]
        if kernels and not stale and len(seen) > 1 and seen[-2] == (kernels, 0):
            return kernels
    raise RuntimeError(f"no two consecutive profiled sessions agreed in {EXACT_TRIES} "
                       f"(device kernels, stale records) of each: {seen}")


# --- K2/K3: the buffered pool's reads ----------------------------------------------

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


def _walk_copy(dstate):
    """``dstate`` with its walked columns (``ops.walk.WALK_KEYS``) copied: on
    a card the walk writes them in place, and a captured block replays
    from its own.  The ring stays shared, as every append writes it in
    place."""
    from oddio_tpu_torch.ops.walk import WALK_KEYS

    return {k: v.clone() if k in WALK_KEYS else v for k, v in dstate.items()}


def capture_states(scene):
    """Render the buffered ``scene`` (one device-resident pool) through a
    ``Renderer`` and capture its pool's ``render`` and ``render_multi``
    arguments: the first, delta block's, two idle single blocks' and the
    last two fused groups'.  Returns (pool, delta, singles,
    groups); each state replays with ``pool.render(*state)`` or
    ``pool.render_multi(*group)``."""
    import oddio_tpu_torch as pt
    from oddio_tpu_torch.core.run import eager

    sets = 2
    pool = next(iter(scene._buffered_pools.values()))
    caps = {"render": [], "render_multi": []}
    for kind in caps:
        def spy(dstate, *a, _inner=getattr(pool, kind), _kind=kind):
            caps[_kind].append((_walk_copy(dstate),) + a)
            return _inner(dstate, *a)
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
    ``nb`` blocks (their appends land in the ring, as in the render; the
    captured columns stay as they were): (the last block's state, [ro per
    block])."""
    ros = []
    dstate = _walk_copy(dstate)
    for _ in range(nb):
        dstate, ro = pool._advance_block(dstate, ddata, params, n)
        ros.append(ro)
    return dstate, ros


# --- the buffered pool's walk ------------------------------------------------------

#: ``walk_operands``' cases: (voices, scenes, motion lanes a scene, late
#: path, share of lingering voices, share of voices out past max_delay*c)
WALK_CASES = {
    "4096 voices": (4096, 1, 64, False, 0.0, 0.0),
    "pack 16 x 256": (4096, 16, 64, True, 0.02, 0.02),
    "late": (1000, 1, 0, True, 0.0, 0.0),
    "motion lanes": (1000, 1, 200, False, 0.0, 0.0),
    "lingering": (1000, 1, 0, False, 0.3, 0.0),
    "frozen": (1000, 1, 16, True, 0.0, 0.3),
}


def _unit_quats(rng, k):
    q = rng.standard_normal((k, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def walk_operands(dev, rng, case, rate=48000, cap=16384, n=W):
    """One block's ``ops.walk.voice_walk`` operands for a ``WALK_CASES``
    case, on ``dev``: voices within +-15 m moving at up to 2 m/s, a third
    still smoothing toward a 1 m jump; the ``far`` share 100-150 m out
    (offset-clamped: frozen); a 5% share of slots free; a ``linger``
    share finished 0 to 0.3 s ago (many expire: 15 m is 44 ms of sound)
    and as many whose source finished this block; cursors anywhere in
    their rings, a third of the late path's lags 1.  Motion lanes per
    scene: its distinct slots, a fifth padding (slot V), one lane
    repeating another's slot and values, discontinuities on a third.
    Returns (args, kwargs) as ``voice_walk`` takes them."""
    V, S, k, late, linger, far = WALK_CASES[case]
    F = np.float32
    vps = V // S
    pos = rng.uniform(-15, 15, (V, 3))
    out = rng.uniform(0, 1, V) < far
    pos[out] = rng.uniform(100, 150, (int(out.sum()), 3)) * rng.choice([-1.0, 1.0], (int(out.sum()), 3))
    vel = np.where(out[:, None], 0.0, rng.uniform(-2, 2, (V, 3)))
    smoothing = rng.uniform(0, 1, V) < 1 / 3
    prev = pos + np.where(smoothing[:, None], rng.uniform(-1, 1, (V, 3)), 0.0)
    smdt = np.where(smoothing, rng.uniform(0, 0.5, V), rng.uniform(0.5, 4, V))
    md = np.full(V, F(F(50.0) / F(343.0)) + F(0.1), F)
    mask = rng.uniform(0, 1, V) > 0.05
    ff = np.full(V, np.nan, F)
    lingering = mask & (rng.uniform(0, 1, V) < linger)
    ff[lingering] = rng.uniform(0, 0.3, int(lingering.sum()))
    fin = mask & ~lingering & (rng.uniform(0, 1, V) < linger)
    c = np.ceil(md * F(rate)) + 1
    st = {"mask": mask, "stopped": ~mask, "finished_for": ff, "smdt": smdt,
          "prev_position": prev, "motion_pos": pos, "motion_vel": vel,
          "vcur": rng.uniform(0, 1, V) * (c - 1), "vbase": rng.integers(0, cap, V),
          "radius": rng.uniform(0.1, 1.0, V), "max_delay": md}
    st = {key: _t(x, dev, np.int32 if key == "vbase" else bool if key in ("mask", "stopped")
                  else np.float32) for key, x in st.items()}
    if late:
        st["lag"] = _t(rng.uniform(0, 1, V) < 1 / 3, dev, np.int32)
    motion = None
    if k:
        idx, mpos, mvel, disc = [], [], [], []
        for s in range(S):
            slots = s * vps + rng.choice(vps, k, replace=False)
            slots[rng.uniform(0, 1, k) < 0.2] = V  # padding
            p = rng.uniform(-15, 15, (k, 3))
            v = rng.uniform(-2, 2, (k, 3))
            d = rng.uniform(0, 1, k) < 1 / 3
            slots[-1], p[-1], v[-1], d[-1] = slots[0], p[0], v[0], d[0]  # a repeat
            idx.append(slots)
            mpos.append(p)
            mvel.append(v)
            disc.append(d)
        motion = (_t(np.concatenate(idx), dev, np.int32), _t(np.concatenate(mpos), dev),
                  _t(np.concatenate(mvel), dev), _t(np.concatenate(disc), dev, bool))
    rots = [_t(_unit_quats(rng, S), dev) for _ in range(2)]
    if S == 1:
        rots = [r[0].contiguous() for r in rots]
    elapsed = F(F(F(1.0) / F(rate)) * F(n))
    kw = dict(elapsed=elapsed, adv=float(F(elapsed * F(rate))), rate=rate, cap=cap, n=n,
              late=late)
    nw = _t(np.full(S, n), dev, np.int32)
    inner_fin = _t(fin, dev, bool)
    return (st, motion, rots[0], rots[1], inner_fin, nw), kw


# --- the device-resident pools' steps (K6, K7) -------------------------------------


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


def step_kernels(proto, args):
    """Device kernels of one Adapt step (the whole render less the
    inner's) and of one Stream step on captured ``args`` of an Adapt pool
    (the Stream's None where the inner is no Stream)."""
    state, ddata, rest = args[0], args[1], args[2:]
    k_inner = device_profile(
        lambda: proto.inner.dr_render(state["inner"], ddata.get("inner", {}), *rest))
    k_adapt = device_profile(lambda: proto.dr_render(*args)) - k_inner
    is_stream = type(proto.inner).__name__ == "Stream"
    return k_adapt, (k_inner if is_stream else None)


# --- K6's arena form: the sampler reads and whole steps ------------------------------


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


#: the interval of the 48 kHz paths
STEP_IV = float(np.float32(1.0 / 48000.0))
#: per-frame step ranges of the tiers 1, 2 and 4, as Speed factors of a
#: 44.1 kHz sound at 48 kHz
STEP_TIERS = {1: (0.3, 1.05), 2: (1.1, 2.1), 4: (2.2, 4.3)}


#: the captured sampler paths' voices and blocks
ARENA_VOICES, ARENA_BLOCKS = 1024, 10


def arena_states(dev, path):
    """Captured arguments of one path's whole arena steps at
    ``ARENA_VOICES`` voices, ``ARENA_BLOCKS`` blocks after a warm-up:
    ``path`` "sampler" (``build_sampler``'s Fader
    pool, its control script of speed writes and fades every 8 blocks),
    "wavetable" (``build_wavetable``'s Speed(Cycle) pool, 64 speed writes
    before the capture) or "seek" (``build_seek_sampler``'s seek pool, its
    ``dr_warp_render``).  Returns (proto, method, kind, channels, [args per
    block])."""
    import oddio_tpu_torch as pt
    from oddio_tpu_torch.utils.scene_profile import (build_sampler, build_seek_sampler,
                                                     build_wavetable)

    voices, blocks = ARENA_VOICES, ARENA_BLOCKS
    if path == "sampler":
        drv = build_sampler(voices, dev)
        r = pt.Renderer(drv.mixer, 48000)
        drv.render(r, 96)
        pools = dr_pools(drv.mixer)
        caps = capture_steps(pools, lambda: drv.render(r, blocks))
        return pools[0].proto, "dr_render", "frames", 2, caps[pools[0]][-blocks:]
    if path == "wavetable":
        mixer, scs, rng = build_wavetable(voices, dev)
        r = pt.Renderer(mixer, 48000)
        r.render_frames(48000)
        for sc in scs[:64]:
            sc.set_speed(float(rng.uniform(0.8, 1.25)))
        pools = dr_pools(mixer)
        caps = capture_steps(pools, lambda: [r.render_block(W) for _ in range(blocks)])
        return pools[0].proto, "dr_render", "cycle", 1, caps[pools[0]][-blocks:]
    _, scene, _, _ = build_seek_sampler(voices, dev)
    r = pt.Renderer(scene, 48000)
    r.render_frames(48000)
    pools = [p for p in scene._seek_pools.values() if p.is_dr]
    caps = capture_steps(pools, lambda: [r.render_block(W) for _ in range(blocks)],
                         method="dr_warp_render")
    return pools[0].proto, "dr_warp_render", "frames", 1, caps[pools[0]][-blocks:]


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
