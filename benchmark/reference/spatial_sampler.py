"""Plain reference of a SpatialScene of sampler voices: oddio 0.7.4's
``spatial.rs`` (the walk, the motion smoothing, the ear states, the
lingering of a finished voice), ``ring.rs`` (the delay ring of
``play_buffered``), ``frames.rs`` (``FramesSignal``), ``speed.rs``,
``fader.rs`` and ``cycle.rs``, written from those semantics in NumPy and
plain PyTorch.  It imports nothing of the program and nothing of JAX.

The scene is a list of lives: each ``play_buffered`` call starts one, of
one of four kinds,

* ``"frames"``: ``FramesSignal`` of a sound, from its start;
* ``"speed"``: ``Speed(FramesSignal)``, its speed set at play and by
  ``set_speed`` calls;
* ``"fader"``: ``Fader(Speed(FramesSignal))``, crossfaded by ``fade_to``
  calls to fresh ``Speed(FramesSignal)`` sources;
* ``"cycle"``: ``Cycle`` of a sound, seeked to an offset;

with the ``set_motion`` calls, speed writes and fades given by block: a
call made before block ``b``'s render lands at block ``b``.  The reference
renders any chosen blocks in closed form from these inputs.

Semantics, each as oddio states it:

* A buffered voice writes its source into its own delay ring, one block's
  samples at a time (ring.rs:18-41), and reads two ears from it
  (spatial.rs:409-431).  The ring's float32 write cursor rounds as
  ``ring.rs`` rounds it, and so do the read offsets, the smoothing, the
  ear states and the per-block gain and doppler ramps: those are
  per-voice scalars, computed in NumPy float32.  The cursor also sets how
  many samples a block writes, ``ceil(end) - ceil(start)``, and so where
  a voice's source starts each block, which is where a speed write or a
  fade lands.  With a whole-sample advance (512 frames at 48 kHz) that is
  512 samples, except that a first-lap cursor whose fraction rounds away
  as it grows past a power of two writes 511 once (about 0.1% of voices);
  every later block of that voice then starts one sample earlier in its
  source.
* ``FramesSignal``: a float64 time cursor; each block starts at
  ``s0 = t * rate``, reads at ``trunc(s0) + f32(s0 - trunc(s0)) + j*ds``
  with ``ds`` the float32 step (1 where within an ulp of it), the exact
  form of frames.rs:176-201, and advances ``t`` by ``f64(interval) *
  count``.  Samples outside the sound read 0.  It is finished once
  ``t * rate >= len - 1`` (frames.rs:204-206).
* ``Speed``: the inner interval is ``f32(interval * speed)``
  (speed.rs:32-36); a write applies from the next block.
* ``Fader``: a fade starts at a block boundary once the previous one has
  completed (a newer waiting command replaces an older one); while
  fading, ``sqrt(1 - p) * old + sqrt(p) * new`` with ``p`` the float32
  ramp ``min(p_k + j * inc, 1)``, ``inc = f32(interval / max(duration,
  interval))``, ``p_k`` advanced by the block's write count times ``inc``;
  on completion the new source replaces the old at the next block
  (fader.rs:38-77).  A
  Fader never finishes.
* ``Cycle``: the position ``(c0 + m * ds) mod len``, read between
  ``data[x]`` and ``data[(x + 1) mod len]`` (cycle.rs, computed in
  float64 as the exact oracle's Cycle); it never finishes.
* A finished voice lingers while its last samples travel: at each later
  block's walk it stops once the time since it finished exceeds the
  distance over the speed of sound (spatial.rs:241-261), and renders
  nothing from that block on.

Everything per frame (the sources' interpolation, the crossfade, the
ring's linear interpolation, the gain ramp, the sum over voices) is
computed in ``dtype`` (float64 by default).  ``benchmark/reference/
spatial_sampler.py`` is a copy of this file, byte for byte.
"""

from __future__ import annotations

import math

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

F = np.float32
SPEED_OF_SOUND = F(343.0)
HEAD_RADIUS = F(0.1075)
#: spatial.rs: position changes are smoothed over this many seconds
POS_SMOOTH = F(0.5)
_SQ17 = np.sqrt(F(17.0), dtype=F)
EAR_POS = np.array([[-HEAD_RADIUS, 0, 0], [HEAD_RADIUS, 0, 0]], F)
EAR_DIR = np.array([[F(-4.0) / _SQ17, 0, F(-1.0) / _SQ17],
                    [F(4.0) / _SQ17, 0, F(-1.0) / _SQ17]], F)
EPS32 = np.finfo(F).eps
KINDS = ("frames", "speed", "fader", "cycle")


def _smooth(prev, smdt, extra, mpos, mvel):
    """State::smoothed_position (spatial.rs:501-511) in float32."""
    dt = (smdt + F(extra)).astype(F)
    change = (mvel * dt[:, None]).astype(F)
    naive = (prev + change).astype(F)
    intended = (mpos + change).astype(F)
    r = np.minimum((dt / POS_SMOOTH).astype(F), F(1.0))[:, None]
    return ((F(1.0) - r) * naive + r * intended).astype(F)


def _norm(p):
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    return np.sqrt((x * x + (y * y + z * z)).astype(F)).astype(F)


def _ears(position, radius):
    """EarState::new (spatial.rs:530-550) for both ears: offsets (V, 2) in
    seconds (negative) and gains (V, 2), float32."""
    rel = (position[:, None, :] - EAR_POS[None]).astype(F)
    x, y, z = rel[..., 0], rel[..., 1], rel[..., 2]
    dist = np.sqrt((x * x + (y * y + z * z)).astype(F)).astype(F)
    offset = (dist * (F(-1.0) / SPEED_OF_SOUND)).astype(F)
    dgain = (radius[:, None] / np.maximum(dist, radius[:, None])).astype(F)
    with np.errstate(divide="ignore", invalid="ignore"):
        sc = (position[:, None, :] * (F(0.5) / dist)[..., None]).astype(F)
    d = (EAR_DIR[None, :, 0] * sc[..., 0]
         + (EAR_DIR[None, :, 1] * sc[..., 1] + EAR_DIR[None, :, 2] * sc[..., 2])).astype(F)
    stereo = np.where(dist < F(1e-3), F(1.0), (F(0.5) + d).astype(F)).astype(F)
    return offset, (stereo * dgain).astype(F)


def _unit_ds(iv, rate):
    """frames.rs:178: the float32 step, snapped to 1 within an ulp."""
    ds = (np.asarray(iv, F) * F(rate)).astype(F)
    return np.where(np.abs(ds - F(1.0)) <= EPS32, F(1.0), ds).astype(F)


class SamplerInputs:
    """What a game gave a SpatialScene of sampler voices: the sound bank
    (mono float32 arrays at ``sound_rate``), each ``play_buffered`` (a
    life), and the ``set_motion`` calls, speed writes and fades, each with
    the block it landed before.  Every voice is played with
    ``play_buffered(max_distance, rate, buffer_duration)`` at ``radius``."""

    def __init__(self, sounds, sound_rate=44100, rate=48000, block=512, max_distance=100.0,
                 buffer_duration=0.1, radius=0.1):
        self.sounds = [np.asarray(s, F) for s in sounds]
        self.sound_rate = float(sound_rate)
        self.rate, self.block = int(rate), int(block)
        self.max_distance, self.buffer_duration = F(max_distance), F(buffer_duration)
        self.radius = F(radius)
        self.interval = F(F(1.0) / F(self.rate))
        self.elapsed = F(self.interval * F(self.block))
        if float(F(self.elapsed * F(self.rate))) != float(self.block):
            raise ValueError("the reference needs a whole-sample ring advance a block")
        #: the lives: kind, play block, position, velocity, sound, speed,
        #: offset (a FramesSignal's start, a Cycle's seek, in seconds)
        self.kind, self.pblock, self.pos, self.vel = [], [], [], []
        self.sound, self.speed, self.offset = [], [], []
        self.motion = []  # (block, life indices, positions, velocities)
        self.speeds = []  # (block, life, speed)
        self.fades = []  # (block, life, sound, speed, duration)

    def play(self, block, kind, pos, vel, sound, speed=1.0, offset=0.0):
        """A ``play_buffered`` before ``block``: returns the life's index."""
        self.kind.append(KINDS.index(kind))
        self.pblock.append(int(block))
        self.pos.append(np.asarray(pos, F).reshape(3))
        self.vel.append(np.asarray(vel, F).reshape(3))
        self.sound.append(int(sound))
        self.speed.append(F(speed))
        self.offset.append(float(offset))
        return len(self.kind) - 1

    def move(self, block, lives, pos, vel):
        """``set_motion`` (no discontinuity) on ``lives`` before ``block``."""
        self.motion.append((int(block), np.asarray(lives, np.int64).reshape(-1),
                            np.asarray(pos, F).reshape(-1, 3), np.asarray(vel, F).reshape(-1, 3)))

    def set_speed(self, block, life, speed):
        self.speeds.append((int(block), int(life), F(speed)))

    def fade(self, block, life, sound, speed, duration):
        """``fade_to`` a fresh ``Speed(FramesSignal)`` of ``sound`` at
        ``speed`` over ``duration`` seconds, before ``block``."""
        self.fades.append((int(block), int(life), int(sound), F(speed), F(duration)))

    # -- derived: the sources, the fades' schedules, the stops ---------------------------

    def _plan(self, upto):
        """Every FramesSignal source (a frames or speed life's, each of a
        fader life's chain) as padded tables, the fader lives' schedules,
        the Cycle lives' cursors, and the block each life stops rendering
        at (``STOP_NEVER`` where not before ``upto``)."""
        n, L = self.block, len(self.kind)
        iv0 = self.interval
        self._k = np.array(self.kind, np.int64)
        self._pb = np.array(self.pblock, np.int64)
        speeds, fades = {}, {}
        for b, life, s in sorted(self.speeds, key=lambda e: e[0]):
            speeds.setdefault(life, []).append((b, s))
        for ev in sorted(self.fades, key=lambda e: e[0]):
            fades.setdefault(ev[1], []).append(ev)
        short = self._short_writes()
        self._skip = np.where(short >= 0, n * (short + 1) - 1, STOP_NEVER)
        srcs = []  # (sound, t0, [(block-aligned local index, iv)], skip)
        first = np.full(L, -1, np.int64)
        chains = {}  # fader life -> [(life index start, source, prog table, inc)]
        for li in range(L):
            kind, pb = KINDS[self.kind[li]], self.pblock[li]
            if kind == "cycle":
                continue
            segs = [(0, iv0 if kind == "frames" else F(iv0 * self.speed[li]))]
            if kind == "speed":
                for b, s in speeds.get(li, ()):
                    if b >= pb:
                        segs.append((n * (b - pb), F(iv0 * s)))
            first[li] = len(srcs)
            srcs.append((self.sound[li], np.float64(self.offset[li]), segs, self._skip[li]))
            if kind == "fader":
                r = short[li]
                chain = [(0, first[li], np.zeros(1, F), F(0.0))]
                end, pending = pb, None
                for ev in [e for e in fades.get(li, ()) if e[0] >= pb] + [None]:
                    if pending is not None and (ev is None or max(pending[0], end) < ev[0]):
                        # the waiting fade starts once the last completed,
                        # its ramp advanced by each block's write count
                        start = max(pending[0], end)
                        k0 = start - pb
                        inc = F(iv0 / max(pending[4], iv0))
                        prog = [F(0.0)]
                        while prog[-1] < F(1.0):
                            cnt = F(n - 1 if k0 + len(prog) - 1 == r else n)
                            prog.append(F(min(F(prog[-1] + cnt * inc), F(1.0))))
                        chain.append((n * k0, len(srcs), np.array(prog[:-1], F), inc))
                        skip = n * (r + 1 - k0) - 1 if r >= k0 else STOP_NEVER
                        srcs.append((pending[2], np.float64(0.0), [(0, F(iv0 * pending[3]))],
                                     skip))
                        end, pending = start + len(prog) - 1, None
                    if ev is not None:
                        pending = ev  # a newer waiting command replaces an older
                chains[li] = chain
        S = max((len(s[2]) for s in srcs), default=1)
        Ns = max(len(srcs), 1)
        self._si = np.full((Ns, S), np.iinfo(np.int64).max, np.int64)
        self._st = np.zeros((Ns, S), np.float64)
        self._ssnd = np.zeros(Ns, np.int64)
        self._sskip = np.full(Ns, STOP_NEVER, np.int64)
        ivs = np.ones((Ns, S), F)
        for r, (snd, t0, segs, skip) in enumerate(srcs):
            self._ssnd[r], self._sskip[r] = snd, skip
            t = t0
            for j, (i0, iv) in enumerate(segs):
                if j:  # t at this segment's first block, in exact float64 sums
                    t = t + np.float64(_true(i0, skip) - _true(segs[j - 1][0], skip)) * \
                        np.float64(segs[j - 1][1])
                self._si[r, j], self._st[r, j], ivs[r, j] = i0, t, iv
        self._siv = ivs.astype(np.float64)
        self._sds = _unit_ds(ivs, F(self.sound_rate)).astype(np.float64)
        self._first = first
        # the fader lives' chains, padded: a source index, its start, its
        # fade's length in blocks, inc and the progress at each block start
        frow = np.full(L, -1, np.int64)
        Q = max((len(c) for c in chains.values()), default=1)
        Kmax = max((len(p) for c in chains.values() for _, _, p, _ in c), default=1)
        nf = max(len(chains), 1)
        self._fsrc = np.zeros((nf, Q), np.int64)
        self._fstart = np.full((nf, Q), np.iinfo(np.int64).max, np.int64)
        self._fK = np.zeros((nf, Q), np.int64)
        self._finc = np.zeros((nf, Q), F)
        self._fprog = np.ones((nf, Q, Kmax), F)
        for r, (li, chain) in enumerate(sorted(chains.items())):
            frow[li] = r
            for q, (st, s, prog, inc) in enumerate(chain):
                self._fsrc[r, q], self._fstart[r, q] = s, st
                self._fK[r, q] = len(prog) if q else 0
                self._finc[r, q] = inc
                self._fprog[r, q, :len(prog)] = prog
        self._frow = frow
        # the Cycle lives' cursors after their seek (cycle.rs:56-60)
        ln = np.array([len(self.sounds[s]) for s in self.sound], np.float64)
        rate = np.float64(int(self.sound_rate))
        self._c0 = np.remainder(np.array([np.float64(F(o)) for o in self.offset]) * rate,
                                np.maximum(ln, 1.0))
        self._stop = self._stop_blocks(upto)

    def _short_writes(self):
        """Each life's block (counted from its play) whose ring write is one
        sample short, or -1: its float32 cursor (ring.rs:18-41) over its
        first lap, where alone it can round to a whole sample (a later
        lap's sums stay below the power of two the first one reached)."""
        L, n = len(self.kind), self.block
        rate = F(self.rate)
        max_delay = (self.max_distance / SPEED_OF_SOUND + self.buffer_duration).astype(F)
        c = F(np.ceil(F(max_delay * rate)) + 1)
        adv = F(self.elapsed * rate)
        if np.frexp(c)[1] != np.frexp(F(c + adv))[1]:
            raise ValueError("a later lap of the ring cursor could round: not modelled")
        out = np.full(L, -1, np.int64)
        if not L:
            return out
        delay = np.minimum((_norm(np.stack(self.pos)) / SPEED_OF_SOUND).astype(F), max_delay)
        w = np.fmod((F(0.0) + rate * delay).astype(F), c).astype(F)
        for k in range(int(np.ceil(c / adv)) + 2):
            un = (w + adv).astype(F)
            nw = np.fmod(un, c).astype(F)
            cnt = (np.ceil(nw) - np.ceil(w) + (un - nw)).astype(np.int64)
            if ((cnt != n) & ((cnt != n - 1) | (out >= 0))).any():
                raise ValueError("the reference takes one short write a voice at most")
            out[cnt == n - 1] = k
            w = nw
        return out

    def _finish_all(self, rows, pbs):
        """``_finish`` for every source of ``rows`` at once: the closed form
        where a source has one segment (checked at the block it gives and
        the one before), ``_finish`` for the others."""
        n = self.block
        sr = np.float64(self.sound_rate)
        rows, pbs = np.asarray(rows, np.int64), np.asarray(pbs, np.int64)
        goal = np.array([len(self.sounds[s]) - 1 for s in self._ssnd[rows]], np.float64)
        one = self._si[rows, 1] == np.iinfo(np.int64).max if self._si.shape[1] > 1 else \
            np.ones(len(rows), bool)
        t0, step = self._st[rows, 0], np.float64(n) * self._siv[rows, 0]
        k = np.maximum(np.floor((goal / sr - t0) / step).astype(np.int64) - 1, 1)
        for _ in range(4):  # at most a step or two from the estimate
            ok = (t0 + k.astype(np.float64) * step) * sr >= goal
            k = np.where(ok, k, k + 1)
        done = (t0 + k.astype(np.float64) * step) * sr >= goal
        back = (k > 1) & ((t0 + (k - 1).astype(np.float64) * step) * sr >= goal)
        out = np.where(done & ~back, pbs + k, -1)
        moved = self._sskip[rows] != STOP_NEVER  # a short write: walked one by one
        for q in np.nonzero(~one | ~done | back | moved)[0]:
            f = self._finish(int(rows[q]), int(pbs[q]))
            out[q] = -1 if f is None else f
        return out

    def _finish(self, r, pb):
        """The first walk at which source ``r`` of a one-shot life played
        before block ``pb`` reads finished: ``t * rate >= len - 1`` after
        the blocks rendered since its play (None: never)."""
        n = self.block
        sr = np.float64(self.sound_rate)
        goal = np.float64(len(self.sounds[self._ssnd[r]]) - 1)
        skip = int(self._sskip[r])
        nseg = int((self._si[r] < np.iinfo(np.int64).max).sum())
        for j in range(nseg):
            k0 = int(self._si[r, j]) // n
            k1 = int(self._si[r, j + 1]) // n if j + 1 < nseg else None
            iv = self._siv[r, j]
            step = np.float64(n) * iv
            k = max(k0, 1, k0 + int(math.floor((goal / sr - self._st[r, j]) / step)) - 1)
            while k1 is None or k <= k1:
                done = np.float64(_true(n * k, skip) - _true(n * k0, skip))
                if (self._st[r, j] + done * iv) * sr >= goal:
                    return pb + k
                k += 1
        return None

    def _stop_blocks(self, upto):
        """Each life's first block it no longer renders: a one-shot lingers
        from its source's finish (spatial.rs:241-261)."""
        L = len(self.kind)
        stop = np.full(L, STOP_NEVER, np.int64)
        lives = np.nonzero(np.isin(self._k, [KINDS.index("frames"), KINDS.index("speed")]))[0]
        if not len(lives):
            return stop
        fin = self._finish_all(self._first[lives], self._pb[lives])
        keep = (fin >= 0) & (fin < upto)
        fin_l, fin_b = lives[keep], fin[keep]
        e = self.elapsed
        ff = np.zeros(LINGER_BLOCKS, F)
        ff[0] = e
        for k in range(1, LINGER_BLOCKS):
            ff[k] = F(ff[k - 1] + e)
        # most voices stop within the first blocks a walk admits; the rest
        # are walked again over the whole horizon
        for H in (LINGER_BLOCKS // 2, LINGER_BLOCKS):
            if not len(fin_l):
                break
            ql = np.repeat(fin_l, H)
            qb = (fin_b[:, None] + np.arange(1, H + 1)[None]).reshape(-1)
            p0, _ = self._positions(ql, qb)
            thr = (_norm(p0) / SPEED_OF_SOUND).astype(F).reshape(-1, H)
            hit = ff[None, :H] > thr
            got = hit.any(axis=1)
            stop[fin_l[got]] = fin_b[got] + 1 + hit[got].argmax(axis=1)
            fin_l, fin_b = fin_l[~got], fin_b[~got]
        if len(fin_l):
            raise ValueError("a voice lingers past the reference's horizon")
        return stop

    def _positions(self, lives, blocks):
        """Listener-space positions of ``lives`` at the start and end of
        ``blocks`` (two arrays of queries): ``(p0, p1)``, (N, 3) each."""
        e = self.elapsed
        lives, blocks = np.asarray(lives, np.int64), np.asarray(blocks, np.int64)
        p0 = np.zeros((len(lives), 3), F)
        p1 = np.zeros((len(lives), 3), F)
        if not len(lives):
            return p0, p1
        k0 = np.array(self.pblock, np.int64)
        T = np.zeros(int(blocks.max() - k0.min()) + 2, F)
        for m in range(1, len(T)):
            T[m] = F(T[m - 1] + e)
        prev = np.stack(self.pos).astype(F)
        mpos, mvel = prev.copy(), np.stack(self.vel).astype(F)
        events = sorted(self.motion, key=lambda ev: ev[0])
        order = np.argsort(blocks, kind="stable")
        ub, at = np.unique(blocks[order], return_index=True)
        bounds = list(at) + [len(order)]
        ei = 0
        for g, b in enumerate(ub):
            while ei < len(events) and events[ei][0] <= b:
                blk, idx, p, v = events[ei]
                sm = _smooth(prev[idx], T[blk - k0[idx]], 0.0, mpos[idx], mvel[idx])
                prev[idx], k0[idx], mpos[idx], mvel[idx] = sm, blk, p, v
                ei += 1
            q = order[bounds[g]:bounds[g + 1]]
            li = lives[q]
            smdt = T[b - k0[li]]
            p0[q] = _smooth(prev[li], smdt, 0.0, mpos[li], mvel[li])
            p1[q] = _smooth(prev[li], smdt, e, mpos[li], mvel[li])
        return p0, p1

    def stops(self, upto):
        """{life: the first block it no longer renders} for the lives that
        stop before ``upto``."""
        self._plan(upto)
        return {int(li): int(b) for li, b in enumerate(self._stop) if b < STOP_NEVER}


#: a stop block for a life that renders past the blocks asked for (and
#: the skip of a source with no short write)
STOP_NEVER = np.iinfo(np.int64).max


def _true(v, skip):
    """A source's sample at index ``v``, where indices count ``n`` to a
    block (block ``k`` starts at ``k * n``) and ``skip`` is the index of
    the sample that a short write left out (the last of the short
    block's): one less from there on."""
    return v - (v > skip) * 1
#: blocks after a finish in which a lingering voice must stop: 0.51 s, past
#: the longest delay a 100 m clamp admits (0.29 s)
LINGER_BLOCKS = 48


class _Tables:
    """``_plan``'s tables and the sound bank on the device, for one render."""

    def __init__(self, inp, device, dtype):
        t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        offs, pieces, o = [], [], 0
        for s in inp.sounds:
            offs.append(o)
            pieces.append(np.concatenate([s.astype(np.float64), [0.0]]))
            o += len(s) + 1
        self.data = torch.as_tensor(np.concatenate(pieces), dtype=dtype, device=device)
        self.off = t(np.array(offs, np.int64))
        self.len = t(np.array([len(s) for s in inp.sounds], np.int64))
        self.si, self.st, self.siv, self.sds = t(inp._si), t(inp._st), t(inp._siv), t(inp._sds)
        self.ssnd, self.sskip, self.lskip = t(inp._ssnd), t(inp._sskip), t(inp._skip)
        self.fsrc, self.fstart, self.fK = t(inp._fsrc), t(inp._fstart), t(inp._fK)
        self.finc, self.fprog = t(inp._finc), t(inp._fprog)
        self.k, self.first, self.frow = t(inp._k), t(inp._first), t(inp._frow)
        self.snd, self.c0 = t(np.array(inp.sound, np.int64)), t(inp._c0)
        self.cds = float(_unit_ds(inp.interval, F(int(inp.sound_rate))))
        self.n, self.sr = inp.block, np.float64(inp.sound_rate)

    def _zero_out(self, snd, k):
        ok = (k >= 0) & (k < self.len[snd])
        return torch.where(ok, self.data[self.off[snd] + torch.where(ok, k, 0)],
                           torch.zeros((), dtype=self.data.dtype, device=k.device))

    def source(self, src, i):
        """Sources ``src`` at their local samples ``i`` (int64 tensors of
        one shape): FramesSignal's exact read (frames.rs:176-201) under
        each source's speed segments, block by block as its ring writes
        it, zero outside the sound."""
        n = self.n
        skip = self.sskip[src]
        v = i + (i >= skip) * 1  # the sample's index, n to a block
        j = ((v[..., None] >= self.si[src]).sum(-1) - 1).clamp(min=0)
        i0, t0, iv, ds = (x[src, j] for x in (self.si, self.st, self.siv, self.sds))
        blk = v - torch.remainder(v, n)  # the block's first index
        s0 = (t0 + (_true(blk, skip) - _true(i0, skip)).to(torch.float64) * iv) * self.sr
        base = torch.trunc(s0)
        p = base + (s0 - base).to(torch.float32).to(torch.float64) + (v - blk).to(
            torch.float64) * ds
        x = torch.floor(p)
        fr = (p - x).to(self.data.dtype)
        x = x.to(torch.int64)
        snd = self.ssnd[src]
        a, b = self._zero_out(snd, x), self._zero_out(snd, x + 1)
        return a + fr * (b - a)

    def cycle(self, life, m):
        """Cycle lives at their samples ``m``: ``(c0 + m*ds) mod len``."""
        snd = self.snd[life]
        ln = self.len[snd]
        p = torch.remainder(self.c0[life] + m.to(torch.float64) * self.cds, ln.to(torch.float64))
        x = torch.floor(p)
        fr = (p - x).to(self.data.dtype)
        x = x.to(torch.int64)
        a = self.data[self.off[snd] + x]
        b = self.data[self.off[snd] + torch.remainder(x + 1, ln)]
        return a + fr * (b - a)

    def fader(self, life, m, rnd):
        """Fader lives at their samples ``m``: the newest source started,
        crossfaded with the one before it while its fade runs (the float32
        ramp, ``sqrt(1 - p)`` and ``sqrt(p)``, fader.rs:38-70)."""
        n = self.n
        r = self.frow[life]
        skip = self.lskip[life]
        v = m + (m >= skip) * 1  # the sample's index, n to a block
        q = (v[..., None] >= self.fstart[r]).sum(-1) - 1
        cur_s, cur_at = self.fsrc[r, q], self.fstart[r, q]
        cur = rnd(self.source(cur_s, m - _true(cur_at, skip)))
        rel = v - cur_at
        blk = torch.div(rel, n, rounding_mode="floor")
        fading = (q >= 1) & (blk < self.fK[r, q])
        prog = self.fprog[r, q, blk.clamp(max=self.fprog.shape[-1] - 1)]
        p = torch.minimum(prog + torch.remainder(rel, n).to(torch.float32) * self.finc[r, q],
                          torch.ones((), dtype=torch.float32, device=m.device))
        p = p.to(self.data.dtype)
        qo = (q - 1).clamp(min=0)
        old = rnd(self.source(self.fsrc[r, qo], (m - _true(self.fstart[r, qo], skip)).clamp(
            min=0)))
        mixed = rnd(old * torch.sqrt(1 - p) + cur * torch.sqrt(p))
        return torch.where(fading, mixed, cur)

    def lives(self, life, m, rnd):
        """Each life's source sample ``m`` (``life`` broadcast over ``m``),
        0 before its first sample."""
        mm = m.clamp(min=0)
        out = torch.zeros(m.shape, dtype=self.data.dtype, device=m.device)
        k = self.k[life]
        for code, fn in ((0, None), (1, None), (2, "fader"), (3, "cycle")):
            sel = k == code
            if not bool(sel.any()):
                continue
            lv, ms = life[sel], mm[sel]
            if fn == "cycle":
                v = rnd(self.cycle(lv, ms))
            elif fn == "fader":
                v = self.fader(lv, ms, rnd)
            else:
                v = rnd(self.source(self.first[lv], ms))
            out[sel] = v
        return torch.where(m >= 0, out, torch.zeros((), dtype=out.dtype, device=m.device))


def _ring_cursors(inp, lives, steps):
    """Each life's float32 ring write cursor (ring.rs) after ``steps``
    blocks from its play, for the queries (``lives``, ``steps``): ``(w,
    W)``, the physical cursor and the same unwrapped in float64; with the
    ring length ``c``, the clamp ``max_delay`` and ``ceil(W_0)`` a
    query."""
    rate = F(inp.rate)
    max_delay = (inp.max_distance / SPEED_OF_SOUND + inp.buffer_duration).astype(F)
    c = F(np.ceil(F(max_delay * rate)) + 1)
    steps = np.asarray(steps, np.int64)
    uniq, row = np.unique(lives, return_inverse=True)
    # rows in order of the most steps any query of theirs asks, longest
    # first: at step k only the first ``alive[k]`` rows still advance
    most = np.zeros(len(uniq), np.int64)
    np.maximum.at(most, row, steps)
    order_u = np.argsort(-most, kind="stable")
    uniq, most = uniq[order_u], most[order_u]
    row = np.argsort(order_u)[row]
    dist = _norm(np.stack([inp.pos[li] for li in uniq]))
    delay = np.minimum((dist / SPEED_OF_SOUND).astype(F), max_delay)
    w = np.fmod((F(0.0) + rate * delay).astype(F), c).astype(F)
    adv = F(inp.elapsed * rate)
    W = w.astype(np.float64)
    cw0 = np.ceil(W)
    qw = np.zeros(len(lives), F)
    qW = np.zeros(len(lives), np.float64)
    order = np.argsort(steps, kind="stable")
    us, at = np.unique(np.asarray(steps)[order], return_index=True)
    bounds = list(at) + [len(order)]
    g = 0
    live = len(uniq)
    for k in range(int(us[-1]) + 1):
        if us[g] == k:
            q = order[bounds[g]:bounds[g + 1]]
            qw[q], qW[q] = w[row[q]], W[row[q]]
            g += 1
        while live and most[live - 1] <= k:
            live -= 1
        nw = np.fmod((w[:live] + adv).astype(F), c).astype(F)
        W[:live] = W[:live] + np.mod(nw.astype(np.float64) - w[:live], np.float64(c))
        w[:live] = nw
    return c, max_delay, qw, qW, cw0[row]


def render(inp, blocks, device="cpu", dtype=torch.float64, round_to=None):
    """The stereo PCM of the chosen ``blocks`` (global block indices),
    (len(blocks), 2, n) in ``dtype`` on ``device``.  ``round_to`` (a torch
    dtype) rounds every per-voice sample, each voice's contribution and the
    mix to it: the reference computed at a lower precision, the control
    of the comparison."""
    blocks = [int(b) for b in blocks]
    order = sorted(set(blocks))
    inp._plan(order[-1] + 1)
    n = inp.block
    dev = torch.device(device)
    tab = _Tables(inp, dev, dtype)
    rnd = (lambda x: x.to(round_to).to(dtype)) if round_to is not None else (lambda x: x)
    act = [np.nonzero((inp._pb <= b) & (inp._stop > b))[0] for b in order]
    ql = np.concatenate(act)
    qb = np.concatenate([np.full(len(a), b, np.int64) for a, b in zip(act, order)])
    res = {b: torch.zeros((2, n), dtype=dtype, device=dev) for b in order}
    if not len(ql):
        return torch.stack([res[b] for b in blocks])
    P0, P1 = inp._positions(ql, qb)
    c, max_delay, QW, QWU, CW0 = _ring_cursors(inp, ql, qb + 1 - inp._pb[ql])
    e = inp.elapsed
    j = torch.arange(n, dtype=dtype, device=dev)
    jf = torch.arange(n, dtype=torch.float32, device=dev)
    lo = 0
    for b, lv in zip(order, act):
        sl = slice(lo, lo + len(lv))
        lo += len(lv)
        if not len(lv):
            continue
        rad = np.full(len(lv), inp.radius, F)
        poff, pgain = _ears(P0[sl], rad)
        noff, ngain = _ears(P1[sl], rad)
        dgain = ((ngain - pgain).astype(F) / F(n)).astype(F)
        gains = (torch.as_tensor(pgain, device=dev)[:, :, None]
                 + jf * torch.as_tensor(dgain, device=dev)[:, :, None]).to(dtype)
        prev_off = np.maximum((poff - e).astype(F), -max_delay).astype(F)
        next_off = np.maximum(noff, -max_delay).astype(F)
        dt = ((next_off - prev_off).astype(F) / F(n)).astype(F)
        ds = (dt * F(inp.rate)).astype(F)
        w, W = QW[sl][:, None], QWU[sl][:, None]
        x = (w + (prev_off * F(inp.rate)).astype(F)).astype(F)
        lap = x < 0
        off0 = np.where(lap, (x + c).astype(F), x).astype(F)
        # the read's start as a sample index of the life's source: the
        # ring holds source sample m at unwrapped position ceil(W_0) + m
        start = (W - w) + off0.astype(np.float64) - np.where(lap, np.float64(c), 0.0)
        start = start - CW0[sl][:, None]
        P = (torch.as_tensor(start, device=dev).to(dtype)[:, :, None]
             + j * torch.as_tensor(ds.astype(np.float64), device=dev).to(dtype)[:, :, None])
        m0 = torch.floor(P)
        frac = P - m0
        m0 = m0.to(torch.int64)
        life = torch.as_tensor(lv, device=dev)[:, None, None].expand(m0.shape)
        a = tab.lives(life, m0, rnd)
        bb = tab.lives(life, m0 + 1, rnd)
        val = rnd(a + frac * (bb - a))
        res[b] = rnd(rnd(val * gains).sum(0))
    return torch.stack([res[b] for b in blocks])
