"""Streaming audio ingest (counterpart of oddio_tpu/ops/stream.py).

Reference: oddio's src/stream.rs — dynamic audio pushed from outside
(decoder/network) through a wait-free spsc channel; playback lerps between
buffered samples, zero-pads on underrun (stream.rs:37-61), releases
consumed samples back to the sender (stream.rs:63-69), and finishes once
the sender is dropped and the buffer drained (stream.rs:88-91).  Streams
are frame-generic: ``channels=C`` buffers (frame, C) data and renders a
(C, n) block.

As in the JAX package, the spsc ring is a device ring per voice: the
control half appends frames to a host-side queue; each block the queued
chunk ships to the device and is placed into the ring (K4, ``ring_place``),
while the host mirrors the ring's (start, len, t) bookkeeping with the
reference's exact f32 arithmetic.  Consumption is cursor math.  Ingest
bookkeeping is O(active writers): a dirty set tracks which voices have
queued frames.

The ring state keeps the JAX package's rows-native shape ``(V, C*R, 128)``
(``R = size_pad / 128``), so state carries across unchanged; the kernels
see it as ``(V*C, size_pad)`` rows.  Every chunk is placed through K4.
The pool-level read goes through K6 for mono streams whose step fits the
kernel's window, and through the plain per-voice read otherwise (stereo
streams, steps past ``RESAMPLE_DSMAX``): in a device-resident pool the
whole Stream step (the step ``rate*interval``, its split, the read and the
cursor release) is one K6 launch (``stream_step``); a host pool whose
chain is a bare Stream ships its step and reads through K6's ds form
(``ring_resample``, ``render_batched``); a stream under a wrapper in a
host pool reads through the plain per-voice read (``render_host``, the
JAX package's vmapped ``Stream.render``).  The two reads round their
positions differently (split-ds exact positions against ``t + ds*j``), so
this is semantic routing, kept as the JAX package has it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.drctrl import device_param
from ..core.hostmath import f32, full
from ..core.signal import ControlBlock, Signal
from ..utils.profiler import count, recording, span
from .stream_kernels import (
    RESAMPLE_DSMAX,
    RESAMPLE_NMAX,
    RESAMPLE_W,
    release_plain,
    ring_place,
    ring_resample,
    stream_step,
)

__all__ = ["Stream", "StreamControl", "TickGroup"]


def _step(interval, counts, rate):
    """The f32 cursor advance of a block of ``counts`` frames at the
    float32 ``rate``s: interval·count·rate, in the device's order."""
    return np.float32(interval) * counts.astype(np.float32) * rate


def _release(t, buflen, step):
    """One block's release of consumed whole samples (stream.rs:63-69) on
    the (t, buflen) mirrors, the device's f32 math term for term: the
    cursor advanced by ``step``, clamped to the buffered length, its whole
    samples released.  Returns the advanced (t, buflen)."""
    tc = np.minimum((t + step).astype(np.float32, copy=False), buflen.astype(np.float32))
    whole = np.trunc(tc)
    return ((tc - whole).astype(np.float32, copy=False),  # exact: tc's fraction
            (buflen - whole.astype(np.int32)).astype(np.int32, copy=False))


def _ring_start(start, before, after, size_pad):
    """The ring start moved past the samples released, the drop in the
    buffered length from ``before`` to ``after``: one modulus for any
    number of blocks (an integer sum, exact in int64)."""
    moved = before.astype(np.int64) - after
    return ((start + moved) % size_pad).astype(np.int32)


def _replay_ticks(t, buflen, start, rate, debt, size_pad):
    """Replay ``debt`` ([interval, count, times] runs of uniform idle
    ticks) on the mirrors, tick by tick in order; ``rate`` is float32."""
    before = buflen
    for iv, cnt, times in debt:
        step = _step(iv, np.broadcast_to(np.int32(cnt), np.shape(t)), rate)
        for _ in range(times):
            t, buflen = _release(t, buflen, step)
    return t, buflen, _ring_start(start, before, buflen, size_pad)


class TickGroup:
    """Stream leaves whose deferred idle ticks replay together: a
    ScenePack's scenes' leaves of one pool, to which its O(1) idle runs
    give equal debts.  The first flush of any member replays every member
    whose debt, batch and ring modulus equal its own in one pass a tick
    over their stacked mirrors (elementwise and of one dtype each, as
    ``_alloc_host`` makes them, so each leaf's result is its own
    replay's); the others keep their debts."""

    def __init__(self, leaves):
        self.leaves = list(leaves)
        for leaf in self.leaves:
            leaf._tick_group = self

    def flush(self, leaf):
        """Replay ``leaf``'s debt over every member that shares it."""
        debt, batch, size_pad = leaf._tick_debt, leaf.batch, leaf.size_pad
        same = [m for m in self.leaves
                if m._tick_debt == debt and m.batch == batch and m.size_pad == size_pad]
        for m in same:
            m._tick_debt = []
        if len(same) == 1:
            leaf._replay(debt)
            return
        ticks = len(same) * sum(times for _, _, times in debt)
        count("ticks.replayed", ticks)
        count("ticks.batched", ticks)
        col = {f: np.concatenate([getattr(m, f) for m in same]) for f in Stream._host_fields}
        stopping = col["stopping"] | col["closed"]  # stream.rs:76-78
        t, buflen, start = _replay_ticks(col["t"], col["buflen"], col["start"],
                                         col["rate"].astype(np.float32), debt, size_pad)
        rows = [x.reshape(len(same), -1) for x in (t, buflen, start, stopping)]
        for m, mt, mb, ms, mst in zip(same, *rows):
            m.t, m.buflen, m.start, m.stopping = mt, mb, ms, mst


class Stream(Signal):
    _host_fields = ("rate", "t", "buflen", "closed", "stopping", "start")
    #: the write flag and the read flags of ``_arch_extra``
    ARCH_FLAGS = (("_has_write", 3), ("_ds_small", 4), ("_ds_tier", 5))

    def __init__(self, rate, size, max_write_per_block=None, channels=1):
        """``rate``: stream sample rate; ``size``: max buffered frames
        (stream.rs:17-34); ``channels``: frame width.
        ``max_write_per_block`` caps how many new frames ship to the device
        per block (default ``size``)."""
        super().__init__()
        self.size = int(size)
        # internal ring modulus, row-padded like the JAX package's (its
        # strip kernels needed a spare row); capacity checks use ``size``
        self.size_pad = -(-(self.size + 1) // 256) * 256 + 256
        self.max_write = int(max_write_per_block or size)
        self.channels = int(channels)
        self._alloc_host(())
        self.rate[()] = np.float64(rate)
        self._cb = ControlBlock(self)
        # host-side producer queue (list of np (k, C) chunks); aliases the
        # slot queue once played into a pool
        self._cb.pending = self._pending.flat[0]
        self.control = StreamControl(self._cb)

    @classmethod
    def new(cls, rate, size, channels=1):
        sig = cls(rate, size, channels=channels)
        return sig.control, sig

    def _alloc_host(self, batch):
        self.rate = full(batch, 1.0, np.float64)
        self.t = full(batch, 0.0)
        self.buflen = full(batch, 0, np.int32)
        self.closed = np.zeros(batch, dtype=bool)
        self.stopping = np.zeros(batch, dtype=bool)
        self.start = full(batch, 0, np.int32)
        # per-slot producer queues (object array: one list per voice)
        self._pending = np.empty(batch if batch else (1,), dtype=object)
        for i in range(self._pending.size):
            self._pending.flat[i] = []
        # voices with queued frames: ingest cost is O(|dirty|) per block
        self._dirty = set()
        # deferred uniform cursor ticks, [interval, count, times] runs:
        # write-free idle blocks cost O(1) host work and the mirror math
        # replays exactly (the same per-block f32 chain) at the first read
        self._tick_debt = []

    #: the ``TickGroup`` whose members replay their debts with this
    #: leaf's (set by a ScenePack), or None: the leaf replays alone
    _tick_group = None

    def _copy_static_from(self, other):
        self.size = other.size
        self.size_pad = other.size_pad
        self.max_write = other.max_write
        self.channels = other.channels

    def grow_batched(self, new_V):
        self._flush_tick_debt()  # replay at the pre-growth shape
        old = self._pending
        super().grow_batched(new_V)
        pend = np.empty((new_V,), dtype=object)
        pend[: len(old)] = old
        for i in range(len(old), new_V):
            pend[i] = []
        self._pending = pend

    def _arch_extra(self):
        # blocks with no queued producer data ship no chunk (_has_write);
        # the pool-stamped read-path flags select the read
        return (self.size, self.max_write, self.channels,
                getattr(self, "_has_write", False),
                getattr(self, "_ds_small", True),
                getattr(self, "_ds_tier", 4))

    # control-side helpers (called through the ControlBlock)
    def _free_space(self, idx):
        self._flush_tick_debt()
        pend = sum(len(c) for c in self._cb_pending(idx))
        return max(0, self.size - int(self.buflen[idx]) - pend)

    def _flush_tick_debt(self):
        """Replay deferred idle-block cursor ticks (the per-block f32
        release math, in order) before any mirror read or write: with
        the leaves of its tick group that owe the same, else alone."""
        if not self._tick_debt:
            return
        with span("stream.ticks"):
            if self._tick_group is not None:
                self._tick_group.flush(self)
                return
            debt, self._tick_debt = self._tick_debt, []
            self._replay(debt)

    def _replay(self, debt):
        count("ticks.replayed", sum(times for _, _, times in debt))
        self.stopping = self.stopping | self.closed  # stream.rs:76-78
        self.t, self.buflen, self.start = _replay_ticks(
            self.t, self.buflen, self.start, self.rate.astype(np.float32), debt,
            self.size_pad)

    def host_aux_snapshot(self):
        """The producer queues (PCM written but not yet shipped), the dirty
        set and the write flag of the last block: a snapshot between a
        write and the next block keeps the write.  (The tick debt is
        flushed into the mirrors first, utils/checkpoint._host_state.)"""
        return {
            "pending": [[np.copy(c) for c in q] for q in self._pending.flat],
            "dirty": set(self._dirty),
            "has_write": getattr(self, "_has_write", False),
        }

    def host_aux_restore(self, aux):
        # refilled in place: the producers' handles alias these lists
        for q, saved in zip(self._pending.flat, aux["pending"]):
            q[:] = [np.copy(c) for c in saved]
        self._dirty = set(aux["dirty"])
        self._has_write = aux["has_write"]

    def _cb_pending(self, idx):
        if self.batch == ():
            return self._pending.flat[0]
        return self._pending[idx]

    def _mark_dirty(self, idx):
        self._dirty.add(0 if self.batch == () else int(idx))

    @property
    def _rows(self):
        return self.size_pad // 128

    def _own_device_init(self):
        return {
            "ring": torch.zeros(
                self.batch + (self.channels * self._rows, 128),
                dtype=torch.float32, device=self.device,
            )
        }

    def _own_slot_init(self, i):
        return {"ring": np.zeros((self.channels * self._rows, 128), np.float32)}

    def write_slot(self, i, spec, pool, gen):
        super().write_slot(i, spec, pool, gen)
        # the slot adopts the spec's producer queue; the handle keeps
        # writing into the same list
        self._pending[i] = spec._cb.pending
        spec._cb.pending = self._pending[i]
        if self._pending[i]:
            self._dirty.add(int(i))
        else:
            self._dirty.discard(int(i))

    #: where the next ``_drain`` writes: a zeroed (V, C, mw+1) view of a
    #: ScenePack's persistent ingest chunk, set around the pack's prepares
    #: (``parallel/sharded.py``), else None (a chunk of its own)
    _ing_out = None

    def _drain(self, V):
        """Drain the dirty voices' producer queues into a (V, C, mw+1)
        chunk (one spare zero-termination column) and (V,) counts: the
        written spans land in ``_ing_out`` where a pack set it (zero past
        each count already), else in a fresh zero chunk."""
        C = self.channels
        chunk = self._ing_out
        if chunk is None or chunk.shape[0] != V:
            chunk = np.zeros((V, C, self.max_write + 1), np.float32)
        counts = np.zeros(V, np.int32)
        for v in sorted(self._dirty):
            q = self._pending.flat[v]
            room = self.max_write
            k = 0
            while q and room > 0:
                c = q[0]
                if len(c) <= room:
                    q.pop(0)
                else:
                    q[0] = c[room:]
                    c = c[:room]
                chunk[v, :, k:k + len(c)] = c.T  # (k, C) frames
                k += len(c)
                room -= len(c)
            counts[v] = k
        self._dirty = {v for v in self._dirty if self._pending.flat[v]}
        if recording():
            # the written samples this block ships, and the chunk's slots
            count("ingest.samples", C * int(counts.sum()))
            count("ingest.slots", chunk.size)
        return chunk, counts

    def host_prepare(self, interval, n, count=None):
        """Standalone stream: drain the queue into this block's chunk and
        advance the host cursors (stream.rs:24-69)."""
        interval = np.broadcast_to(f32(interval), self.batch).astype(np.float32)
        V = self.batch[0] if self.batch else 1
        self._has_write = bool(self._dirty)
        if self._has_write:
            chunk, counts = self._drain(V)
        else:
            counts = np.zeros(V, np.int32)
        lens = np.atleast_1d(self.buflen).copy()
        write_pos = (np.atleast_1d(self.start) + lens) % np.int32(self.size_pad)
        new_len = lens + counts
        self.stopping = self.stopping | self.closed  # stream.rs:76-78
        ds = (interval * self.rate.astype(np.float32)).astype(np.float32)
        dsmax = float(np.max(ds)) if ds.size else 1.0
        self._ds_small = bool(dsmax <= RESAMPLE_DSMAX)
        self._ds_tier = 1 if dsmax <= 1.0 + 1e-5 else 2 if dsmax <= 2.0 else 4
        params = {
            "t": self.t.copy(),
            "ds": ds,
            "len": new_len.reshape(self.batch).astype(np.int32),
            "start": self.start.copy(),
        }
        if self._has_write:
            params["chunk"] = chunk.reshape(self.batch + chunk.shape[1:])
            params["wcount"] = (counts + 1).reshape(self.batch)
            params["wpos"] = write_pos.reshape(self.batch)
        # advance (stream.rs:63-69): next = t + dt*rate, release whole samples
        cnt = np.broadcast_to(f32(n if count is None else count), self.batch)
        nxt = (self.t + (interval * cnt * self.rate.astype(np.float32))).astype(
            np.float32
        )
        lenf = new_len.reshape(self.batch).astype(np.float32)
        tc = np.minimum(nxt, lenf)
        released = np.trunc(tc).astype(np.int32)
        self.t = (tc - released).astype(np.float32)
        self.buflen = (new_len.reshape(self.batch) - released).astype(np.int32)
        self.start = ((self.start + released) % np.int32(self.size_pad)).astype(np.int32)
        return params

    def host_is_finished(self):
        """stream.rs:88-91: stopping && t == len (all drained)."""
        self._flush_tick_debt()
        return self.stopping & (self.t == self.buflen.astype(np.float32))

    # -- ring write and reads ----------------------------------------------

    def _flat(self, ring):
        """(V, C*R, 128) ring state as (V*C, size_pad) rows (a view)."""
        return ring.view(-1, self.size_pad)

    def _write(self, ring, chunk, wpos, wcount):
        """Receiver::update for a batch of voices: chunk (V, C, mw) placed at
        each voice's write cursor through K4, in place.  wpos and wcount
        are (V,) int32 tensors, which K4 maps to the voice's C channel
        rows itself; wcount includes the zero-termination column."""
        C = self.channels
        V = ring.shape[0]
        ring_place(self._flat(ring), chunk.reshape(V * C, chunk.shape[-1]), wpos, wcount,
                   channels=C)
        return ring

    def _read_plain(self, ring, t, ds, len_, start, n):
        """The per-voice lerp read with zero padding (stream.rs:37-61), the
        JAX package's ``Stream.render`` written batched: (V, C, n)."""
        V = ring.shape[0]
        size = self.size_pad
        flat = ring.view(V, self.channels, size)
        s = t[:, None] + ds[:, None] * torch.arange(n, dtype=torch.float32, device=ring.device)
        x0 = torch.trunc(s).to(torch.int64)
        ln = len_.to(torch.int64)[:, None]
        st = start.to(torch.int64)[:, None]

        def get(k):
            valid = (k >= 0) & (k < ln)
            kk = torch.remainder(st + k.clamp(0, size - 1), size)
            g = torch.gather(flat, 2, kk[:, None, :].expand(V, self.channels, n))
            return torch.where(valid[:, None, :], g, 0.0)

        a = get(x0)
        b = get(x0 + 1)
        return a + (s - torch.trunc(s))[:, None, :] * (b - a)

    def _placed(self, ring, params):
        """Params as tensors on the ring's device (``device_param``: a
        block step's views of its row), with a host pool's shipped chunk
        (Receiver::update) placed first through K4."""
        dev = ring.device
        p = {k: device_param(v, dev) for k, v in params.items()}
        if "chunk" in p:
            self._write(ring, p["chunk"], p["wpos"].to(torch.int32),
                        p["wcount"].to(torch.int32))
        return p

    def render_host(self, dstate, ddata, params, n):
        """The JAX package's per-voice ``Stream.render``, batched: the
        shipped chunk placed, then the plain lerp read.  (V, C, n)."""
        ring = dstate["ring"]
        p = self._placed(ring, params)
        out = self._read_plain(ring, p["t"], p["ds"], p["len"], p["start"], n)
        return {"ring": ring}, out

    def _kernel_ok(self, n):
        """True when this block's read goes through K6: a mono stream whose
        step and block fit the kernel's window."""
        # window sized for the tightest step bound available: the spec's own
        # tier (standalone prepare) or the pool-stamped one (DR pools)
        tiers = [
            t for t in (getattr(self, "_ds_tier", None),
                        getattr(self, "_pool_ds_tier", None))
            if t is not None
        ]
        DS = min(tiers) if tiers else int(RESAMPLE_DSMAX)
        S_req = max(
            ((256 + max(n - 128, 0) * DS) // 128) * 128 + RESAMPLE_W,
            256 + n * DS + 3,
        )
        return (
            self.channels == 1
            and n <= RESAMPLE_NMAX
            and S_req <= self.size_pad
            and bool(getattr(self, "_ds_small", True))
            and bool(getattr(self, "_pool_ds_small", True))
        )

    def render_batched(self, dstate, ddata, params, n):
        """Pool-level render of every voice's ring (``t``, ``ds``, ``len``,
        ``start`` of shape (V,), tensors or a host pool's numpy params,
        whose chunk is placed first).  Mono streams whose step and block
        fit the kernel's window read through K6; the rest take the plain
        per-voice read.  Returns ``({"ring"}, (V, C, n))``."""
        ring = dstate["ring"]
        params = self._placed(ring, params)
        t, ds, len_, start = params["t"], params["ds"], params["len"], params["start"]
        if not self._kernel_ok(n):
            return {"ring": ring}, self._read_plain(ring, t, ds, len_, start, n)
        samp = ring_resample(self._flat(ring), t, ds, start, len_, n)
        return {"ring": ring}, samp[:, None, :]

    # -- device-resident mode --------------------------------------------------
    # The ring and its (t, len, start) cursors live on the device; the host
    # keeps f32-exact mirrors (dr_host_tick repeats the device's release
    # math term for term) for StreamControl.free()'s backpressure
    # (stream.rs:99-101).  Producer PCM ships only on blocks with queued
    # writes; the write position derives from the DEVICE cursors.  The ring
    # is not part of dr_slot_row: a fresh row's len=0 gates every read, and
    # each ingest chunk is zero-terminated so the boundary lerp cell never
    # holds a previous tenant's data.

    _dr_ctrl_fields = ("closed",)

    def dr_supported(self):
        return True

    def dr_needs_ingest(self):
        return True

    def host_ds_bound(self, interval):
        r = np.max(self.rate) if getattr(self.rate, "ndim", 0) else self.rate
        return float(np.float32(interval) * np.float32(r))

    def dr_state_init(self, V):
        return {
            "ring": np.zeros((V, self.channels * self._rows, 128), np.float32),
            "t": np.zeros(V, np.float32),
            "len": np.zeros(V, np.int32),
            "start": np.zeros(V, np.int32),
            "closed": np.zeros(V, np.float32),
            "rate": np.ones(V, np.float32),
        }

    def dr_slot_row(self, interval):
        return {
            "t": np.float32(self.t[()]),
            "len": np.int32(self.buflen[()]),
            "start": np.int32(self.start[()]),
            "closed": np.float32(bool(self.closed[()]) or bool(self.stopping[()])),
            "rate": np.float32(self.rate[()]),
        }

    def dr_default_row(self, interval):
        return {
            "t": np.float32(0.0),
            "len": np.int32(0),
            "start": np.int32(0),
            "closed": np.float32(1.0),
            "rate": np.float32(1.0),
        }

    def dr_bind_slot(self, i, spec, pool, gen):
        """Adopt a played spec's mirrors and producer queue into this
        BATCHED proto (the pool's host shadow); the spec's ControlBlock
        reads and writes these columns from now on."""
        self._flush_tick_debt()
        for f in self._host_fields:
            getattr(self, f)[i] = getattr(spec, f)[()]
        cb = getattr(spec, "_cb", None)
        if cb is not None:
            cb.rebind(self, i, pool, gen)
        self._pending[i] = spec._cb.pending
        if self._pending[i]:
            self._dirty.add(int(i))
        else:
            self._dirty.discard(int(i))

    def dr_ingest_params(self):
        """This block's ingest chunk (numpy ``chunk`` (V, C, mw+1) and
        ``wcount`` (V,)), or None on write-free blocks.  Advances the host
        ``buflen`` mirrors by the shipped counts."""
        self._flush_tick_debt()
        self._has_write = bool(self._dirty)
        if not self._has_write:
            return None
        chunk, counts = self._drain(self.batch[0])
        self.buflen = (self.buflen + counts).astype(np.int32)
        return {"chunk": chunk, "wcount": counts}

    def dr_host_tick(self, interval, counts):
        """Advance the (t, buflen, start) mirrors by ``counts`` frames, the
        host shadow of dr_render's release.  A scalar ``counts`` marks a
        uniform write-free idle tick, deferred and replayed at the first
        mirror read."""
        if np.ndim(counts) == 0:
            self.tick_debt_add(interval, counts, 1)
            return
        self._flush_tick_debt()
        self._tick_math(interval, counts)

    def tick_debt_add(self, interval, count, times):
        """Queue ``times`` deferred uniform ticks (bulk idle runs)."""
        iv, cnt = float(interval), int(count)
        debt = self._tick_debt
        if debt and debt[-1][0] == iv and debt[-1][1] == cnt:
            debt[-1][2] += times
        else:
            debt.append([iv, cnt, times])

    def _tick_math(self, interval, counts):
        self.stopping = self.stopping | self.closed  # stream.rs:76-78
        before = self.buflen
        self.t, self.buflen = _release(
            self.t, self.buflen, _step(interval, counts, self.rate.astype(np.float32)))
        self.start = _ring_start(self.start, before, self.buflen, self.size_pad)

    def dr_ingest(self, state, ing):
        """Receiver::update on the device: place each voice's shipped chunk
        at its DEVICE write cursor (start + len) and grow len.  In a block
        step the chunk and counts are views of the step's row."""
        dev = state["ring"].device
        chunk = device_param(ing["chunk"], dev)
        wcount = device_param(ing["wcount"], dev)
        wpos = torch.remainder(state["len"] + state["start"], self.size_pad)
        out = dict(state)
        out["ring"] = self._write(state["ring"], chunk, wpos.to(torch.int32),
                                  (wcount + 1).to(torch.int32))
        out["len"] = state["len"] + wcount
        return out

    def dr_render(self, state, ddata, interval, n, count):
        """The read and the release of consumed whole samples
        (stream.rs:63-69, mirrored by dr_host_tick on the host): one K6
        launch where the read routes to the kernel."""
        out = dict(state)
        ring, t, rate, len_, start = (state[k] for k in ("ring", "t", "rate", "len", "start"))
        if self._kernel_ok(n):
            samp, out["t"], out["len"], out["start"] = stream_step(
                self._flat(ring), t, rate, interval, count, start, len_, n)
            return out, samp
        samp = self._read_plain(ring, t, rate * float(np.float32(interval)), len_, start, n)
        out["t"], out["len"], out["start"] = release_plain(
            t, rate, interval, count, start, len_, self.size_pad)
        return out, samp[:, 0, :] if self.channels == 1 else samp

    def dr_is_finished(self, state):
        """stream.rs:88-91: closed && drained."""
        return (state["closed"] > 0.5) & (state["t"] >= state["len"].to(torch.float32))


class StreamControl:
    """Control half of a Stream (stream.rs:96-112)."""

    def __init__(self, cb):
        self._cb = cb

    def free(self):
        """Lower bound on frames the next write will consume (stream.rs:99-101)."""
        if not self._cb.live():
            return 0
        return self._cb.sig._free_space(self._cb.idx)

    def write(self, samples):
        """Add frames; returns the number consumed (stream.rs:103-110).
        Accepts (k,) mono or (k, C) frame arrays."""
        if not self._cb.live():
            return 0
        sig = self._cb.sig
        samples = f32(np.atleast_1d(samples))
        if samples.ndim == 1:
            samples = samples[:, None]
        if samples.shape[1] != sig.channels:
            raise ValueError(
                f"stream carries {sig.channels}-channel frames, "
                f"got {samples.shape[1]}"
            )
        take = min(len(samples), self.free())
        if take:
            q = sig._cb_pending(self._cb.idx)
            q.append(np.array(samples[:take], np.float32))
            sig._mark_dirty(self._cb.idx)
        return take

    def close(self):
        """No further samples will arrive (the sender drop of
        stream.rs:76-78); playback finishes once the buffer drains."""
        self._cb.set("closed", True)
