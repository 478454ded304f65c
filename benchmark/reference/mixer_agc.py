"""Plain reference of BASELINE config 5's scenes: a mono Mixer of
``Adapt(Stream)`` and ``Adapt(Sine)`` voices (oddio 0.7.4 ``mixer.rs``,
``adapt.rs``, ``stream.rs``, ``sine.rs``), written from those semantics in
NumPy and plain PyTorch.  It imports nothing of the program.

A Stream's cursor is a float32 sample position that each block advances
by ``interval * n * rate`` and then releases whole samples from
(stream.rs:63-69): the reference follows that bookkeeping block by block
in NumPy float32, vectorised over streams.  Each frame reads the stream at
``t + j * ds`` between two buffered samples (zero past the buffered end),
computed in ``dtype``.  Adapt's running mean square
``avg_i = a * s_i^2 + (1 - a) * avg_(i-1)`` is a linear recurrence: the
reference evaluates it in closed form over chunks of frames in float64,
then pulls ``sqrt(2 * avg)`` into ``[low, high]`` by a gain capped at
``max_gain`` (adapt.rs).  The mixer sums its voices (mixer.rs).
"""

from __future__ import annotations

import numpy as np
import torch

F = np.float32
TAU = F(6.283185307179586)
_SQRT2 = np.sqrt(F(2.0), dtype=F)
#: adapt.rs's defaults: the level window the gain pulls the peak into
LOW = F(F(0.1) / _SQRT2)
HIGH = F(F(0.5) / _SQRT2)


class MixerInputs:
    """One mono Mixer: ``ns`` Adapt(Stream) voices first, then Adapt(Sine)
    voices (``phase``, ``freq_hz``), every Adapt with ``tau``, ``max_gain``
    and ``initial_rms``; streams of ``stream_rate`` Hz holding ``size``
    frames at most and shipping ``max_write`` a block.  ``writes`` lists
    ``(block, stream, samples)``: a ``write`` made before that block's
    render, in call order."""

    def __init__(self, ns, phase, freq_hz, rate=48000, block=512, stream_rate=8000.0,
                 size=2528, max_write=2400, tau=0.1, max_gain=4.0, initial_rms=0.1):
        self.ns = int(ns)
        self.phase = np.asarray(phase, F)
        self.freq_hz = np.asarray(freq_hz, F)
        self.rate, self.block = int(rate), int(block)
        self.stream_rate = F(stream_rate)
        self.size, self.max_write = int(size), int(max_write)
        self.tau, self.max_gain, self.initial_rms = F(tau), F(max_gain), F(initial_rms)
        self.writes = []

    def add_write(self, block, stream, samples):
        self.writes.append((int(block), int(stream), np.asarray(samples, F)))


def stream_schedule(inp, nblocks):
    """Follow every stream through ``nblocks`` blocks: the samples each
    ``write`` was granted, and per block the float32 cursor ``t``, the
    buffered length and the absolute index of the first buffered sample.
    Returns ``(content, t, length, start, granted)``: ``content[v]`` the
    stream's accepted samples in order, the rest (nblocks, ns) arrays and
    the granted count of each write."""
    ns, size, mw = inp.ns, inp.size, inp.max_write
    iv = F(F(1.0) / F(inp.rate))
    step = F(F(iv * F(inp.block)) * inp.stream_rate)
    buflen = np.zeros(ns, np.int64)
    t = np.zeros(ns, F)
    start = np.zeros(ns, np.int64)
    pending = [[] for _ in range(ns)]
    content = [[] for _ in range(ns)]
    total = np.zeros(ns, np.int64)  # samples accepted into content so far
    T = np.zeros((nblocks, ns), F)
    L = np.zeros((nblocks, ns), np.int64)
    S = np.zeros((nblocks, ns), np.int64)
    writes = sorted(enumerate(inp.writes), key=lambda w: (w[1][0], w[0]))
    granted = [0] * len(inp.writes)
    wi = 0
    for b in range(nblocks):
        while wi < len(writes) and writes[wi][1][0] <= b:
            k, (_, v, x) = writes[wi]
            free = max(0, size - int(buflen[v]) - sum(len(c) for c in pending[v]))
            take = min(len(x), free)
            if take:
                pending[v].append(x[:take])
            granted[k] = take
            wi += 1
        counts = np.zeros(ns, np.int64)
        for v in range(ns):
            room = mw
            while pending[v] and room > 0:
                c = pending[v][0]
                got = c[:room]
                content[v].append(got)
                counts[v] += len(got)
                room -= len(got)
                if len(c) > len(got):
                    pending[v][0] = c[len(got):]
                else:
                    pending[v].pop(0)
        total += counts
        new_len = buflen + counts
        T[b], L[b], S[b] = t, new_len, start
        nxt = (t + step).astype(F)
        tc = np.minimum(nxt, new_len.astype(F))
        released = np.trunc(tc).astype(np.int64)
        t = (tc - released.astype(F)).astype(F)
        buflen = new_len - released
        start = start + released
    flat = [np.concatenate(c) if c else np.zeros(0, F) for c in content]
    return flat, T, L, S, granted


def render(inp, first, last, device="cpu", dtype=torch.float64, round_to=None, chunk=48):
    """The mixer's mono PCM of blocks ``first`` to ``last`` (inclusive;
    global indices from its first block), (last - first + 1, n) in
    ``dtype`` on ``device``.  Every block from the first is rendered,
    since Adapt's state carries.  ``round_to`` (a torch dtype) rounds
    every per-voice sample, each voice's output and the mix to it: the
    reference at a lower precision, as the benchmark's control."""
    dev = torch.device(device)
    n = inp.block
    nblocks = last + 1
    content, T, L, S, _ = stream_schedule(inp, nblocks)
    ns, nv = inp.ns, inp.ns + len(inp.phase)
    cmax = max([len(c) for c in content] + [1])
    buf = torch.zeros((max(ns, 1), cmax + 2), dtype=dtype, device=dev)
    for v, c in enumerate(content):
        buf[v, : len(c)] = torch.as_tensor(c, device=dev).to(dtype)
    iv = F(F(1.0) / F(inp.rate))
    ds = float(F(iv * inp.stream_rate))
    freq = (inp.freq_hz * TAU).astype(F)
    w_cyc = torch.as_tensor(freq.astype(np.float64) / np.float64(TAU) * np.float64(iv),
                            device=dev).to(dtype)
    ph0 = torch.as_tensor(inp.phase.astype(np.float64) / np.float64(TAU), device=dev).to(dtype)
    alpha = float(F(F(1.0) - np.exp(F(-iv / inp.tau), dtype=F)))
    q = 1.0 - alpha
    avg = torch.full((nv,), float(F(inp.initial_rms * inp.initial_rms)), dtype=torch.float64,
                     device=dev)
    rnd = (lambda x: x.to(round_to).to(dtype)) if round_to is not None else (lambda x: x)
    j = torch.arange(n, dtype=torch.float64, device=dev)
    out = []
    for b0 in range(0, nblocks, chunk):
        b1 = min(nblocks, b0 + chunk)
        nb = b1 - b0
        parts = []
        if ns:
            t = torch.as_tensor(T[b0:b1].T.astype(np.float64), device=dev)  # (ns, nb)
            ln = torch.as_tensor(L[b0:b1].T, device=dev)
            st = torch.as_tensor(S[b0:b1].T, device=dev)
            pos = t[:, :, None] + j * ds  # (ns, nb, n)
            x0 = torch.floor(pos)
            frac = (pos - x0).to(dtype)
            k0 = x0.to(torch.int64)

            def get(k):
                idx = (st[:, :, None] + k).clamp(0, cmax + 1).reshape(ns, -1)
                g = torch.gather(buf, 1, idx).reshape(ns, nb, n)
                return torch.where((k >= 0) & (k < ln[:, :, None]), g,
                                   torch.zeros((), dtype=dtype, device=dev))

            a, bb = get(k0), get(k0 + 1)
            parts.append(rnd(a + frac * (bb - a)).reshape(ns, nb * n))
        if len(inp.phase):
            m = torch.arange(b0 * n, b1 * n, dtype=torch.float64, device=dev)
            cyc = torch.remainder(ph0[:, None].double() + m * w_cyc[:, None].double(), 1.0)
            parts.append(rnd(torch.sin((2 * np.pi) * cyc).float().to(dtype)))
        x = torch.cat(parts).double()  # (nv, nb*n)
        # avg_i = q^(i+1) * (avg_prev + a * sum_{k<=i} q^-(k+1) s_k^2)
        k = torch.arange(1, nb * n + 1, dtype=torch.float64, device=dev)
        lq = np.log(q)
        acc = torch.cumsum(x * x * torch.exp(-lq * k), dim=1)
        avgs = torch.exp(lq * k) * (avg[:, None] + alpha * acc)
        avg = avgs[:, -1]
        peak = torch.sqrt(avgs) * float(_SQRT2)
        gain = torch.where(peak < float(LOW),
                           torch.clamp(float(LOW) / peak, max=float(inp.max_gain)),
                           torch.where(peak > float(HIGH), float(HIGH) / peak,
                                       torch.ones((), dtype=torch.float64, device=dev)))
        y = rnd((x * gain).to(dtype))
        out.append(rnd(y.sum(0)).reshape(nb, n))
    res = torch.cat(out)
    return res[first:]
