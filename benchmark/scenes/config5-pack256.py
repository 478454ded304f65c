"""The driver of ``config5-pack256``: BASELINE config 5, a ScenePack of
mono Mixers of ``Adapt(Stream)`` and ``Adapt(Sine)`` voices on a 1 x 1
mesh, as ``bench.py``'s ``_build_pack`` builds it, driven by a traffic mix
of stream writes.

The configuration gives the scenes, the voices and their split, the
streams and the Adapt settings; the traffic gives the blocks each call
renders and the feed: in each scene ``feed.talkers`` of the streamed
voices talk at a time; before each call (after ``drain_calls`` calls that
drain the prefill) every talker's stream is written ``feed.samples``
samples of N(0, 0.1^2), and ``feed.handover`` talkers per scene hand over
to silent voices.  The PCM comes from a bank of ``feed.bank`` chunks made
from the seed in set-up.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

import oddio_tpu_torch as pt
from oddio_tpu_torch.parallel.mesh import make_mesh
from oddio_tpu_torch.parallel.sharded import ScenePack
from common import device_info, seed_rng, timed_prepare
from reference import mixer_agc as ref

F = np.float32


class Driver:
    layer = "pack"

    def __init__(self, config, traffic, seed, device, spans):
        self.seed, self.device, self.spans = seed, device, spans
        self.rate, self.block = int(config["rate"]), int(config["block"])
        self.calls = int(traffic["blocks_per_call"])
        S, V = int(config["scenes"]), int(config["voices_per_scene"])
        ns = int(config["stream_voices_per_scene"])
        self.S, self.V, self.ns = S, V, ns
        st = config["stream"]
        ad = config["adapt"]
        rng = seed_rng(seed, 0)
        phase = rng.uniform(*config["phase"], (S, V - ns))
        freq = rng.uniform(*config["frequency_hz"], (S, V - ns))
        fill = (rng.standard_normal((S, ns, int(st["prefill"]))) * 0.1).astype(F)
        self.checked = sorted(seed_rng(seed, 2).choice(S, min(int(traffic["check_scenes"]), S),
                                                       replace=False).tolist())
        self.inputs = {}
        mixers, self.ctls = [], []
        for s in range(S):
            mixer = pt.Mixer(1, initial_capacity=max(ns, 1), device=device)
            control = pt.MixerControl(mixer)
            opt = dict(tau=ad["tau"], max_gain=ad["max_gain"])
            ctls = []
            for i in range(V):
                if i < ns:
                    stream = pt.Stream(st["rate"], int(st["capacity"]),
                                       max_write_per_block=int(st["max_write_per_block"]))
                    ctls.append(stream.control)
                    control.play(pt.Adapt(stream, ad["initial_rms"], pt.AdaptOptions(**opt)))
                else:
                    control.play(pt.Adapt(pt.Sine(phase[s, i - ns], freq[s, i - ns]),
                                          ad["initial_rms"], pt.AdaptOptions(**opt)))
            for i, c in enumerate(ctls):
                c.write(fill[s, i])
            if s in self.checked:
                inp = ref.MixerInputs(ns, phase[s], freq[s], self.rate, self.block, st["rate"],
                                      st["capacity"], st["max_write_per_block"], ad["tau"],
                                      ad["max_gain"], ad["initial_rms"])
                for i in range(ns):
                    inp.add_write(0, i, fill[s, i])
                self.inputs[s] = inp
            mixers.append(mixer)
            self.ctls.append(ctls)
        mesh = make_mesh(*config["mesh"], [device] * (config["mesh"][0] * config["mesh"][1]))
        self.pack = ScenePack(mixers, self.rate, mesh, scan_unroll=int(config["scan_unroll"]))
        timed_prepare(self.pack.scenes, spans)
        feed = traffic["feed"]
        self.samples = int(feed["samples"])
        self.handover = int(feed["handover"])
        self.drain_calls = int(traffic["drain_calls"])
        self.bank = (seed_rng(seed, 3).standard_normal((int(feed["bank"]), self.samples))
                     * 0.1).astype(F)
        self.feed_rng = seed_rng(seed, 4)
        T = int(feed["talkers"])
        self.talkers = np.stack([self.feed_rng.choice(ns, T, replace=False) for _ in range(S)])
        self.block_index = 0
        self.kept = []  # (first block, (blocks, checked scenes, n))
        self.ds = float(F(F(F(1.0) / F(self.rate)) * F(st["rate"])))

    def control(self, call):
        """The feed: returns whether this call carries writes."""
        if call < self.drain_calls:
            return False
        S, T = self.talkers.shape
        b = self.block_index
        if call > self.drain_calls and self.handover:
            # talkers hand over to silent voices
            for s in range(S):
                silent = np.setdiff1d(np.arange(self.ns), self.talkers[s])
                out = self.feed_rng.choice(T, self.handover, replace=False)
                self.talkers[s, out] = self.feed_rng.choice(silent, self.handover, replace=False)
        chunks = self.feed_rng.integers(0, len(self.bank), (S, T))
        for s in range(S):
            ctls = self.ctls[s]
            inp = self.inputs.get(s)
            for k in range(T):
                v = int(self.talkers[s, k])
                x = self.bank[chunks[s, k]]
                ctls[v].write(x)
                if inp is not None:
                    inp.add_write(b, v, x)
        return True

    def dispatch(self):
        outs = self.pack.render_frames_device(self.calls * self.block)
        self.block_index += self.calls
        return outs

    def keep(self, first, pieces):
        x = np.concatenate(pieces)  # (blocks, S, 1, n)
        self.kept.append((first, x[:, self.checked, 0, :].copy()))

    def step_keys(self):
        """The block steps made so far, as (kind, (blocks, frames))."""
        return {(str(k[1]), kn) for k, v in self.pack._steps.items() for kn in v}

    def counts(self):
        return self.pack.graph_counts

    def shapes(self):
        S, T = self.talkers.shape
        return {"kind": "pack", "scenes": self.S, "voices": self.S * self.V,
                "streams": self.S * self.ns, "n": self.block, "stream_ds": self.ds,
                "written_per_call": S * T * self.samples, "blocks_per_call": self.calls}

    def free(self):
        self.pack = None
        self.ctls = []
        gc.collect()

    def check(self, limits, device, round_to=None):
        """The reference over every window block of the checked scenes:
        ``({"pcm_err": (value, limit)}, blocks over the limit)``.  With
        ``round_to``, the reference computed at that precision stands in the
        program's place."""
        first = self.kept[0][0]
        have = np.concatenate([x for _, x in self.kept])  # (blocks, k, n)
        last = first + len(have) - 1
        limit = float(limits.get("pcm_err", {}).get("limit", 0.0))
        worst, over = 0.0, 0
        for j, s in enumerate(self.checked):
            want = ref.render(self.inputs[s], first, last, device=device)
            if round_to is None:
                prog = torch.as_tensor(have[:, j], device=want.device).to(want.dtype)
            else:
                prog = ref.render(self.inputs[s], first, last, device=device, round_to=round_to)
            scale = want.abs().max()
            per = (prog - want).abs().amax(dim=1) / scale
            worst = max(worst, float(per.max()))
            over += int((per > limit).sum())
        return {"pcm_err": (worst, limit)}, over

    def device_info(self, peak):
        return device_info(self.device, peak)
