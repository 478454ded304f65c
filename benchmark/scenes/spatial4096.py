"""The driver of ``spatial4096``: one SpatialScene of Sine voices, each
played with ``play_buffered`` (delay rings) and rendered by a
``Renderer``, as ``bench.py``'s spatial scene builds it, driven by a
traffic mix of walking voices.

The configuration gives the voices and their spreads of phase and
frequency; the traffic gives the area the voices walk in, their speeds,
the blocks each call renders, and the ticks.  Each voice starts at a point
of the area and walks toward a waypoint of it.  Every ``tick.every_calls``
calls the game reports the next ``tick.voices`` voices in turn
(``set_motion``, no discontinuity): each at the point its motion has
reached, off by up to ``tick.position_error_m`` on each axis (its path
bent since the last report), walking toward a new waypoint.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

import oddio_tpu_torch as pt
from common import device_info, seed_rng, timed_prepare
from reference import spatial as ref

F = np.float32


def split_blocks(pieces, n):
    """A call's outputs, (B, C, k*n) each, as (blocks, C, n)."""
    out = []
    for x in pieces:
        B, C, L = x.shape
        out.append(x.reshape(B, C, L // n, n).transpose(0, 2, 1, 3).reshape(-1, C, n))
    return np.concatenate(out)


def rel_err(prog, want):
    """max |prog - want| over the block set, as a share of max |want|."""
    return float((prog - want).abs().max() / want.abs().max())


class Driver:
    layer = "renderer"

    def __init__(self, config, traffic, seed, device, spans):
        self.seed, self.device, self.spans = seed, device, spans
        self.rate, self.block = int(config["rate"]), int(config["block"])
        self.calls = int(traffic["blocks_per_call"])
        V = int(config["voices"])
        rng = seed_rng(seed, 0)
        phase = rng.uniform(*config["phase"], V)
        freq = rng.uniform(*config["frequency_hz"], V)
        self.area, self.speed = float(traffic["area_m"]), traffic["speed_m_s"]
        pos = rng.uniform(-self.area, self.area, (V, 3)).astype(F)
        vel = self._walk(rng, pos)
        self.inputs = ref.SceneInputs(phase, freq, pos, vel, self.rate, self.block,
                                      config["max_distance"], config["buffer_duration"],
                                      config["radius"])
        control, scene = pt.SpatialScene.new(initial_capacity=V, device=device)
        self.handles = []
        for i in range(V):
            sig = pt.Sine(self.inputs.phase[i], self.inputs.freq_hz[i])
            opts = pt.SpatialOptions(position=self.inputs.pos[i], velocity=self.inputs.vel[i],
                                     radius=config["radius"])
            self.handles.append(control.play_buffered(
                sig, opts, max_distance=config["max_distance"], rate=self.rate,
                buffer_duration=config["buffer_duration"]))
        self.control_half, self.scene = control, scene
        timed_prepare([scene], spans)
        self.renderer = pt.Renderer(scene, self.rate,
                                    scan_buckets=tuple(config["renderer"]["scan_buckets"]))
        self.tick = traffic["tick"]
        self.tick_rng = seed_rng(seed, 1)
        self.next_voice = 0
        # each voice's last motion as set: position, velocity, block
        self.mpos, self.mvel = self.inputs.pos.copy(), self.inputs.vel.copy()
        self.mblock = np.zeros(V, np.int64)
        self.block_index = 0
        self.kept = []  # (first block, (blocks, 2, n))
        self.check_blocks = int(traffic["check_blocks"])

    def control(self, call):
        """The ticks: returns whether this call carries one."""
        if call % int(self.tick["every_calls"]):
            return False
        V, K = len(self.handles), int(self.tick["voices"])
        idx = (self.next_voice + np.arange(K)) % V
        self.next_voice = (self.next_voice + K) % V
        b = self.block_index
        t = ((b - self.mblock[idx]) * self.block / self.rate).astype(F)[:, None]
        err = float(self.tick["position_error_m"])
        pos = (self.mpos[idx] + self.mvel[idx] * t
               + self.tick_rng.uniform(-err, err, (K, 3))).astype(F)
        vel = self._walk(self.tick_rng, pos)
        for k, i in enumerate(idx):
            self.handles[i].set_motion(pos[k], vel[k], False)
        self.mpos[idx], self.mvel[idx], self.mblock[idx] = pos, vel, b
        self.inputs.add_event(b, idx, pos, vel)
        return True

    def _walk(self, rng, pos):
        """Velocities (float32) toward a waypoint of the area drawn for each
        of ``pos``, at a walking speed drawn from the traffic's range."""
        way = rng.uniform(-self.area, self.area, pos.shape)
        speed = rng.uniform(*self.speed, len(pos))
        d = way - pos
        return (d * (speed / np.maximum(np.linalg.norm(d, axis=1), 1e-6))[:, None]).astype(F)

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
        return self.renderer.graph_counts

    def shapes(self):
        return {"kind": "spatial", "voices": len(self.handles), "n": self.block}

    def free(self):
        self.renderer = self.scene = self.control_half = None
        self.handles = []
        gc.collect()

    def check(self, limits, device, round_to=None):
        """The reference over a sample of the window's blocks drawn from the
        seed: the last block, a tick's block and the block after it, and
        blocks drawn at random: ``({"pcm_err": (value, limit)}, blocks over
        the limit)``.  With ``round_to``, the reference computed at that
        precision stands in the program's place."""
        first = self.kept[0][0]
        have = np.concatenate([x for _, x in self.kept])
        total = len(have)
        rng = seed_rng(self.seed, 2)
        ticks = [b - first for b, *_ in self.inputs.events if first <= b < first + total - 1]
        must = {total - 1}
        if ticks:
            t = int(rng.choice(ticks))
            must |= {t, t + 1}
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
        err = rel_err(prog, want)
        scale = want.abs().max()
        per = ((prog - want).abs().amax(dim=(1, 2)) / scale).tolist()
        return {"pcm_err": (err, limit)}, sum(1 for e in per if e > limit)

    def device_info(self, peak):
        return device_info(self.device, peak)
