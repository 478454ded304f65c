"""The driver of ``spatial-sampler4096``: one SpatialScene of recorded
sound effects, every voice played with ``play_buffered`` (delay rings)
and rendered by a ``Renderer``: ``FramesSignal``, ``Speed(FramesSignal)``,
``Fader(Speed(FramesSignal))`` and ``Cycle`` voices over a bank of mono
sounds made from the seed.

The configuration gives the voices of each kind, the bank and the ring;
the traffic gives the area the voices walk in, their walking speeds, the
blocks a call renders, and what the game does before each call: it
syncs the scene (from the digest it prefetched at the last call, so the
call in flight is not waited for), replaces each one-shot its handle shows
finished by a new one of the same kind (a new sound from its start, a new
position and walk), re-reports the next ``tick.voices`` voices' motion,
writes the speed of the next ``speed_writes`` Speed voices and fades the
next ``fades`` Fader voices to fresh sources.  Everything it does is kept
as the plain reference's inputs.
"""

from __future__ import annotations

import gc
import math

import numpy as np
import torch

import oddio_tpu_torch as pt
from common import device_info, seed_rng, timed_prepare
from reference import spatial_sampler as ref

F = np.float32
KINDS = ("frames", "speed", "fader", "cycle")


def split_blocks(pieces, n):
    """A call's outputs, (B, C, k*n) each, as (blocks, C, n)."""
    out = []
    for x in pieces:
        B, C, L = x.shape
        out.append(x.reshape(B, C, L // n, n).transpose(0, 2, 1, 3).reshape(-1, C, n))
    return np.concatenate(out)


def make_bank(rng, bank):
    """The sound bank: ``bank["sounds"]`` mono float32 sounds at
    ``bank["rate"]``, each of a length uniform in ``bank["seconds"]``: a
    sum of ``bank["partials"]`` sines in ``bank["partials_hz"]`` at random
    phases, scaled by ``bank["tone"]``, plus ``bank["noise"]`` white
    noise."""
    sr = float(bank["rate"])
    sounds = []
    for _ in range(int(bank["sounds"])):
        n = int(rng.uniform(*bank["seconds"]) * sr)
        t = np.arange(n, dtype=np.float64) / sr
        f = rng.uniform(*bank["partials_hz"], int(bank["partials"]))
        x = sum(np.sin(2 * np.pi * fk * t + rng.uniform(0, 6)) for fk in f) / len(f)
        sounds.append((bank["tone"] * x + bank["noise"] * rng.standard_normal(n)).astype(F))
    return sounds


class Driver:
    layer = "renderer"

    def __init__(self, config, traffic, seed, device, spans):
        self.seed, self.device, self.spans = seed, device, spans
        self.rate, self.block = int(config["rate"]), int(config["block"])
        self.calls = int(traffic["blocks_per_call"])
        self.cfg, self.traffic = config, traffic
        rng = seed_rng(seed, 0)
        bank = config["bank"]
        self.sounds = make_bank(rng, bank)
        self.frames = [pt.Frames.from_slice(int(bank["rate"]), s) for s in self.sounds]
        for fr in self.frames:
            fr.guard_off()  # every FramesSignal region now: no new arena after set-up
        self.inputs = ref.SamplerInputs(self.sounds, bank["rate"], self.rate, self.block,
                                        config["max_distance"], config["buffer_duration"],
                                        config["radius"])
        self.area, self.walk = float(traffic["area_m"]), traffic["speed_m_s"]
        control, scene = pt.SpatialScene.new(initial_capacity=int(config["capacity"]),
                                             device=device)
        self.control_half, self.scene = control, scene
        self.rng = seed_rng(seed, 1)
        self.block_index = 0
        # one entry a voice: kind, handle, life, speed control, fader control
        self.voices = []
        counts = config["voices"]
        for kind in KINDS:
            for _ in range(int(counts[kind])):
                self.voices.append(self._play(kind, first=True))
        V = len(self.voices)
        self.of = {k: [i for i, v in enumerate(self.voices) if v["kind"] == k] for k in KINDS}
        timed_prepare([scene], spans)
        self.renderer = pt.Renderer(scene, self.rate,
                                    scan_buckets=tuple(config["renderer"]["scan_buckets"]))
        self.tick = traffic["tick"]
        self.next = {"motion": 0, "speed": 0, "fader": 0}
        # each voice's last motion as set: position, velocity, block
        self.mpos = np.stack([v["pos"] for v in self.voices])
        self.mvel = np.stack([v["vel"] for v in self.voices])
        self.mblock = np.zeros(V, np.int64)
        self.kept = []  # (first block, (blocks, 2, n))
        self.check_blocks = int(traffic["check_blocks"])
        self.plays = self.fade_count = 0
        self.speed_sum = self.speed_calls = 0.0

    # -- the game's control ----------------------------------------------------------

    def _walk(self, rng, pos):
        """Velocities (float32) toward a waypoint of the area drawn for each
        of ``pos``, at a walking speed drawn from the traffic's range."""
        way = rng.uniform(-self.area, self.area, pos.shape)
        speed = rng.uniform(*self.walk, len(pos))
        d = way - pos
        return (d * (speed / np.maximum(np.linalg.norm(d, axis=1), 1e-6))[:, None]).astype(F)

    def _source(self, rng):
        """A fresh ``Speed(FramesSignal)`` on a sound of the bank from its
        start: (its speed control, the signal, sound, speed)."""
        snd = int(rng.integers(len(self.frames)))
        spd = F(rng.uniform(*self.cfg["speed"]))
        sc, sig = pt.Speed.new(pt.FramesSignal(self.frames[snd], 0.0))
        sc.set_speed(float(spd))
        return sc, sig, snd, spd

    def _play(self, kind, first=False):
        """Play one voice of ``kind`` at a new position, walking: the first
        voices' one-shots start at a uniform point of their sound, a
        replay's at its start; a Cycle is seeked to a uniform point."""
        rng = self.rng
        pos = rng.uniform(-self.area, self.area, (1, 3)).astype(F)
        vel = self._walk(rng, pos)
        pos, vel = pos[0], vel[0]
        sc = fc = None
        snd = int(rng.integers(len(self.frames)))
        spd, offset = F(1.0), 0.0
        length = len(self.sounds[snd]) / float(self.cfg["bank"]["rate"])
        if kind == "cycle":
            offset = float(rng.uniform(0, length))
            sig = pt.Cycle(self.frames[snd])
            sig.seek(offset)
        else:
            start = float(rng.uniform(0, length)) if first else 0.0
            offset = start
            sig = pt.FramesSignal(self.frames[snd], start)
            if kind != "frames":
                spd = F(rng.uniform(*self.cfg["speed"]))
                sc, sig = pt.Speed.new(sig)
                sc.set_speed(float(spd))
            if kind == "fader":
                fc, sig = pt.Fader.new(sig)
        c = self.cfg
        h = self.control_half.play_buffered(
            sig, pt.SpatialOptions(position=pos, velocity=vel, radius=c["radius"]),
            max_distance=c["max_distance"], rate=self.rate, buffer_duration=c["buffer_duration"])
        life = self.inputs.play(self.block_index, kind, pos, vel, snd, speed=spd, offset=offset)
        return {"kind": kind, "handle": h, "life": life, "speed": sc, "fader": fc,
                "pos": pos, "vel": vel}

    def _take(self, name, items, k):
        if not items or k <= 0:
            return []
        i0 = self.next[name]
        idx = [items[(i0 + j) % len(items)] for j in range(min(k, len(items)))]
        self.next[name] = (i0 + len(idx)) % len(items)
        return idx

    def control(self, call):
        """Before each call: sync, replays, motion, speeds, fades and the
        next digest's prefetch.  Returns the plays made."""
        b, tr, inp = self.block_index, self.traffic, self.inputs
        self.scene.sync()
        played = 0
        for i in self.of["frames"] + self.of["speed"]:
            v = self.voices[i]
            if v["handle"].is_finished():
                self.voices[i] = v = self._play(v["kind"])
                self.mpos[i], self.mvel[i], self.mblock[i] = v["pos"], v["vel"], b
                played += 1
        self.plays += played
        if not call % int(self.tick["every_calls"]):
            idx = np.array(self._take("motion", list(range(len(self.voices))),
                                      int(self.tick["voices"])), np.int64)
            t = ((b - self.mblock[idx]) * self.block / self.rate).astype(F)[:, None]
            err = float(self.tick["position_error_m"])
            pos = (self.mpos[idx] + self.mvel[idx] * t
                   + self.rng.uniform(-err, err, (len(idx), 3))).astype(F)
            vel = self._walk(self.rng, pos)
            for k, i in enumerate(idx):
                self.voices[i]["handle"].set_motion(pos[k], vel[k], False)
            self.mpos[idx], self.mvel[idx], self.mblock[idx] = pos, vel, b
            inp.move(b, [self.voices[i]["life"] for i in idx], pos, vel)
        for i in self._take("speed", self.of["speed"], int(tr["speed_writes"])):
            v = self.voices[i]
            s = F(self.rng.uniform(*self.cfg["speed"]))
            v["speed"].set_speed(float(s))
            inp.set_speed(b, v["life"], s)
            self.speed_sum += float(s)
            self.speed_calls += 1
        for i in self._take("fader", self.of["fader"], int(tr["fades"])):
            v = self.voices[i]
            _, sig, snd, spd = self._source(self.rng)
            v["fader"].fade_to(sig, float(tr["fade_s"]))
            inp.fade(b, v["life"], snd, spd, tr["fade_s"])
            self.fade_count += 1
        self.scene.sync_prefetch()
        return played

    # -- the harness's protocol --------------------------------------------------------

    def dispatch(self):
        outs = self.renderer.render_frames_device(self.calls * self.block, sync=False)
        self.block_index += self.calls
        return outs

    def keep(self, first, pieces):
        self.kept.append((first, split_blocks(pieces, self.block)))

    def step_keys(self):
        """The block steps made so far, as (kind, (blocks, frames))."""
        return {(str(k[1]), kn) for k, v in self.renderer._steps.items() for kn in v}

    def counts(self):
        return dict(self.renderer.graph_counts, plays=self.plays, fades=self.fade_count)

    def shapes(self):
        """The cell's shapes for the arena steps' work: voices of each kind,
        each kind's mean source step (the bank's rate over the output's,
        times the mean speed the script set) and the mean fading Fader
        voices a block (the script's fades, each ``ceil(fade_s * rate /
        n)`` blocks long)."""
        ratio = float(self.cfg["bank"]["rate"]) / self.rate
        lo, hi = self.cfg["speed"]
        mean_speed = self.speed_sum / self.speed_calls if self.speed_calls else (lo + hi) / 2
        blocks = max(self.block_index, 1)
        fade_blocks = math.ceil(float(self.traffic["fade_s"]) * self.rate / self.block)
        return {"kind": "sampler", "n": self.block,
                "voices": {k: len(self.of[k]) for k in KINDS},
                "ds": {"frames": ratio, "speed": ratio * mean_speed,
                       "fader": ratio * (lo + hi) / 2, "cycle": ratio},
                "fading": self.fade_count * fade_blocks / blocks}

    def free(self):
        self.renderer = self.scene = self.control_half = None
        self.voices = []
        self.frames = []
        gc.collect()

    def check(self, limits, device, round_to=None):
        """The reference over a sample of the window's blocks drawn from the
        seed: the last block, a call's first block (where plays, speeds
        and fades land) and the block after it, a block inside a
        crossfade, and blocks drawn at random: ``({"pcm_err": (value,
        limit)}, blocks over the limit)``.  With ``round_to``, the
        reference computed at that precision stands in the program's
        place."""
        first = self.kept[0][0]
        have = np.concatenate([x for _, x in self.kept])
        total = len(have)
        rng = seed_rng(self.seed, 3)
        calls = [b - first for b in range(first, first + total - 1, self.calls)]
        must = {total - 1}
        if calls:
            t = int(rng.choice(calls))
            must |= {t, t + 1}
            inside = [c + 2 for c in calls if c + 2 < total and c != t]
            if inside:
                must.add(int(rng.choice(inside)))
        rest = np.setdiff1d(np.arange(total), sorted(must))
        k = max(0, min(self.check_blocks - len(must), len(rest)))
        pick = sorted(must | set(rng.choice(rest, k, replace=False).tolist()))
        want = ref.render(self.inputs, [first + i for i in pick], device=device)
        if round_to is None:
            prog = torch.as_tensor(have[pick], device=want.device).to(want.dtype)
        else:
            prog = ref.render(self.inputs, [first + i for i in pick], device=device,
                              round_to=round_to)
        limit = float(limits.get("pcm_err", {}).get("limit", 0.0))
        scale = want.abs().max()
        err = float((prog - want).abs().max() / scale)
        per = ((prog - want).abs().amax(dim=(1, 2)) / scale).tolist()
        return {"pcm_err": (err, limit)}, sum(1 for e in per if e > limit)

    def device_info(self, peak):
        return device_info(self.device, peak)
