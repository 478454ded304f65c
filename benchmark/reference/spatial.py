"""Plain reference of a SpatialScene of Sine voices: oddio 0.7.4's
``spatial.rs`` (the walk, the motion smoothing, the ear states), ``ring.rs``
(the delay ring of ``play_buffered``) and ``sine.rs``, written from those
semantics in NumPy and plain PyTorch, vectorised over voices.

It renders any chosen blocks of a scene in closed form from the inputs the
harness made: each voice's phase, frequency, position and velocity at play
time, and every ``set_motion`` call with the block it landed before.  It
imports nothing of the program.

Where the semantics round in float32 (the write cursor of a delay ring,
the time a smoothed motion has run, the read offsets and the per-block
gain and doppler ramps), the reference rounds the same way in NumPy
float32, block by block: these are per-voice scalars.  Everything per
frame (the sine samples, the ring's linear interpolation, the gain ramp,
the sum over voices) is computed in ``dtype`` (float64 by default), from
the float32 inputs.
"""

from __future__ import annotations

import numpy as np
import torch

F = np.float32
SPEED_OF_SOUND = F(343.0)
HEAD_RADIUS = F(0.1075)
#: spatial.rs: position changes are smoothed over this many seconds
POS_SMOOTH = F(0.5)
_SQ17 = np.sqrt(F(17.0), dtype=F)
EAR_POS = np.array([[-HEAD_RADIUS, 0, 0], [HEAD_RADIUS, 0, 0]], F)
EAR_DIR = np.array([[F(-4.0) / _SQ17, 0, F(-1.0) / _SQ17],
                    [F(4.0) / _SQ17, 0, F(-1.0) / _SQ17]], F)
TAU = F(6.283185307179586)


class SceneInputs:
    """What the harness gave the scene: ``V`` Sine voices (``phase``,
    ``freq_hz``; ``pos``, ``vel`` (V, 3) at play time), all played with
    ``play_buffered`` (``max_distance``, ``buffer_duration``); ``radius``
    0.1 m; and the motion events, a list of ``(block, voice indices,
    positions, velocities)``: ``set_motion`` calls (no discontinuity) made
    before that block's render."""

    def __init__(self, phase, freq_hz, pos, vel, rate=48000, block=512,
                 max_distance=50.0, buffer_duration=0.1, radius=0.1):
        self.phase = np.asarray(phase, F)
        self.freq_hz = np.asarray(freq_hz, F)
        self.pos = np.asarray(pos, F).reshape(-1, 3)
        self.vel = np.asarray(vel, F).reshape(-1, 3)
        self.rate, self.block = int(rate), int(block)
        self.max_distance, self.buffer_duration = F(max_distance), F(buffer_duration)
        self.radius = F(radius)
        self.events = []

    def add_event(self, block, idx, pos, vel):
        self.events.append((int(block), np.asarray(idx, np.int64), np.asarray(pos, F),
                            np.asarray(vel, F)))


def _smooth(prev, smdt, extra, mpos, mvel):
    """State::smoothed_position (spatial.rs:501-511) in float32."""
    dt = (smdt + F(extra)).astype(F)
    change = (mvel * dt[:, None]).astype(F)
    naive = (prev + change).astype(F)
    intended = (mpos + change).astype(F)
    r = np.minimum((dt / POS_SMOOTH).astype(F), F(1.0))[:, None]
    return ((F(1.0) - r) * naive + r * intended).astype(F)


def _ears(position, radius):
    """EarState::new (spatial.rs:530-550) for both ears: offsets (V, 2) in
    seconds (negative) and gains (V, 2), float32."""
    rel = (position[:, None, :] - EAR_POS[None]).astype(F)
    x, y, z = rel[..., 0], rel[..., 1], rel[..., 2]
    dist = np.sqrt((x * x + (y * y + z * z)).astype(F)).astype(F)
    offset = (dist * (F(-1.0) / SPEED_OF_SOUND)).astype(F)
    dgain = (radius / np.maximum(dist, radius)).astype(F)
    with np.errstate(divide="ignore", invalid="ignore"):
        sc = (position[:, None, :] * (F(0.5) / dist)[..., None]).astype(F)
    d = (EAR_DIR[None, :, 0] * sc[..., 0]
         + (EAR_DIR[None, :, 1] * sc[..., 1] + EAR_DIR[None, :, 2] * sc[..., 2])).astype(F)
    stereo = np.where(dist < F(1e-3), F(1.0), (F(0.5) + d).astype(F)).astype(F)
    return offset, (stereo * dgain).astype(F)


class _Geometry:
    """Per-voice listener-space positions at the start and end of chosen
    blocks, following the motion events in order."""

    def __init__(self, inp, last_block):
        self.inp = inp
        e = (F(1.0) / F(inp.rate) * F(inp.block)).astype(F)
        self.elapsed = F(e)
        # the time a motion has run after m blocks, as a float32 sum
        T = np.zeros(last_block + 2, F)
        for m in range(1, len(T)):
            T[m] = F(T[m - 1] + self.elapsed)
        self.T = T

    def positions(self, blocks):
        """{block: (prev_pos, next_pos)} for the sorted ``blocks``."""
        inp = self.inp
        prev, mpos, mvel = inp.pos.copy(), inp.pos.copy(), inp.vel.copy()
        k0 = np.zeros(len(prev), np.int64)
        out = {}
        events = sorted(inp.events, key=lambda ev: ev[0])
        ei = 0
        for b in blocks:
            while ei < len(events) and events[ei][0] <= b:
                blk, idx, p, v = events[ei]
                sm = _smooth(prev[idx], self.T[blk - k0[idx]], 0.0, mpos[idx], mvel[idx])
                prev[idx], k0[idx], mpos[idx], mvel[idx] = sm, blk, p, v
                ei += 1
            smdt = self.T[b - k0]
            out[b] = (_smooth(prev, smdt, 0.0, mpos, mvel),
                      _smooth(prev, smdt, self.elapsed, mpos, mvel))
        return out


def _ring_cursors(inp, wanted):
    """The delay rings' float32 write cursors (ring.rs), followed block by
    block: (c, max_delay, {k: (w, W)} for each ``wanted`` k, ceil(W_0)),
    ``w`` the physical cursor after k blocks and ``W`` the same unwrapped,
    in float64."""
    rate = F(inp.rate)
    max_delay = (inp.max_distance / SPEED_OF_SOUND + inp.buffer_duration).astype(F)
    c = F(np.ceil(F(max_delay * rate)) + 1)
    x, y, z = inp.pos[:, 0], inp.pos[:, 1], inp.pos[:, 2]
    dist = np.sqrt((x * x + (y * y + z * z)).astype(F)).astype(F)
    delay = np.minimum((dist / SPEED_OF_SOUND).astype(F), max_delay)
    w = np.fmod((F(0.0) + rate * delay).astype(F), c).astype(F)
    adv = F(F(F(1.0) / rate * F(inp.block)) * rate)
    W = w.astype(np.float64)
    cw0 = np.ceil(W)
    out = {}
    wanted = set(wanted)
    for k in range(max(wanted) + 1):
        if k in wanted:
            out[k] = (w, W)
        nw = np.fmod((w + adv).astype(F), c).astype(F)
        W = W + np.mod(nw.astype(np.float64) - w, np.float64(c))
        w = nw
    return c, max_delay, out, cw0


def render(inp, blocks, device="cpu", dtype=torch.float64, round_to=None):
    """The stereo PCM of the chosen ``blocks`` (global block indices from
    the scene's first), (len(blocks), 2, n) in ``dtype`` on ``device``.
    ``round_to`` (a torch dtype) rounds every per-voice sample, each
    voice's contribution and the mix to it: the reference computed at a
    lower precision, as the benchmark's control."""
    blocks = [int(b) for b in blocks]
    order = sorted(set(blocks))
    last = order[-1]
    n = inp.block
    geo = _Geometry(inp, last)
    pos = geo.positions(order)
    dev = torch.device(device)
    iv = F(F(1.0) / F(inp.rate))
    # sine.rs: the frequency in radians per second, the phase wrapped
    # modulo the float32 TAU after every block, so a cycle is TAU32
    # radians: the phase runs in cycles of freq / TAU32 per second
    freq = (inp.freq_hz * TAU).astype(F)
    fcyc = torch.tensor(freq.astype(np.float64) / np.float64(TAU), dtype=dtype, device=dev)
    w_cyc = fcyc * np.float64(iv)
    ph0 = torch.tensor(inp.phase.astype(np.float64) / np.float64(TAU), dtype=dtype, device=dev)

    def sin_cycles(c):
        return torch.sin((2 * np.pi) * torch.remainder(c, 1.0))
    j = torch.arange(n, dtype=dtype, device=dev)
    jf = torch.arange(n, dtype=torch.float32, device=dev)
    rnd = (lambda x: x.to(round_to).to(dtype)) if round_to is not None else (lambda x: x)
    c, max_delay, cur, cw0 = _ring_cursors(inp, [b + 1 for b in order])
    res = {}
    e = geo.elapsed
    for b in order:
        p0, p1 = pos[b]
        poff, pgain = _ears(p0, inp.radius)
        noff, ngain = _ears(p1, inp.radius)
        dgain = ((ngain - pgain).astype(F) / F(n)).astype(F)
        gains = (torch.as_tensor(pgain, device=dev)[:, :, None]
                 + jf * torch.as_tensor(dgain, device=dev)[:, :, None]).to(dtype)
        prev_off = np.maximum((poff - e).astype(F), -max_delay).astype(F)
        next_off = np.maximum(noff, -max_delay).astype(F)
        dt = ((next_off - prev_off).astype(F) / F(n)).astype(F)
        ds = (dt * F(inp.rate)).astype(F)
        w, W = (x[:, None] for x in cur[b + 1])
        x = (w + (prev_off * F(inp.rate)).astype(F)).astype(F)
        lap = x < 0
        off0 = np.where(lap, (x + c).astype(F), x).astype(F)
        # the read's start in the unwrapped ring, as a sample index of
        # the voice's source: the ring holds source sample m at
        # unwrapped position ceil(W[0]) + m
        start = (W - w) + off0.astype(np.float64) - np.where(lap, np.float64(c), 0.0)
        start = start - cw0[:, None]
        P = (torch.as_tensor(start, device=dev).to(dtype)[:, :, None]
             + j * torch.as_tensor(ds.astype(np.float64), device=dev).to(dtype)[:, :, None])
        m0 = torch.floor(P)
        frac = P - m0

        def src(m):
            val = sin_cycles(ph0[:, None, None] + m * w_cyc[:, None, None])
            return torch.where(m >= 0, rnd(val.float().to(dtype)), torch.zeros((), dtype=dtype,
                                                                              device=dev))

        a, bb = src(m0), src(m0 + 1)
        val = rnd(a + frac * (bb - a))
        res[b] = rnd(rnd(val * gains).sum(0))
    return torch.stack([res[b] for b in blocks])
