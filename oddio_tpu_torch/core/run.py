"""Block renderers (counterpart of oddio_tpu/core/run.py).

Reference: oddio's src/lib.rs:90-93 — ``run(signal, rate, out)``
pulls one block from the signal graph.  A ``Renderer`` walks the graph on
the host once per block (advancing host state, producing per-block
parameters) and renders the block on the signal's device: an engine's own,
or for a standalone signal the Renderer's (the CUDA card unless the caller
passes ``device``).

The JAX package groups runs of blocks with equal archetype into jitted
``lax.scan`` dispatches; here a dispatch is a Python loop over the same
blocks, eager, with the same block boundaries, the same structure-event
flushes and the same fused multi-block groups on idle runs (the buffered
pool's superwindow read).  Parameters stay numpy on the host and pools
upload what they use.  ``scan_unroll`` and ``scan_buckets`` shape the JAX
package's compiled-program set only; they are accepted and ignored.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.tree import tree_leaves
from .hostmath import f32
from .signal import default_device, same_device

__all__ = ["Renderer", "run"]

#: minimum idle-run length before the fused multi-block dispatch engages
MULTI_MIN_BLOCKS = 16


def _engine_device(signal):
    """The device of the first engine (Mixer, SpatialScene) inside a chain
    of wrappers, or None: ``Tanh(Reinhard(scene))`` renders where the
    scene lives."""
    stack = [signal]
    while stack:
        node = stack.pop()
        if node.device is not None:
            return node.device
        stack.extend(node.children().values())
    return None


class Renderer:
    def __init__(self, signal, rate, sync_every=16, scan_unroll=1,
                 scan_buckets=None, device=None):
        if signal._moved:
            raise RuntimeError("signal was moved into an engine; render the engine")
        own = signal.device
        if own is None:
            own = _engine_device(signal)
        if own is None:
            # a standalone signal renders on the Renderer's device
            signal._set_device(default_device(device))
        else:
            if device is not None and not same_device(device, own):
                raise ValueError(f"the signal renders on {own}, not on {device}")
            if signal.device is None:
                # a wrapper chain around an engine renders on the engine's
                signal._set_device(own)
        self.signal = signal
        self.rate = int(rate)
        # lib.rs:91: interval = 1.0 / sample_rate as f32
        self.interval = np.float32(1.0) / np.float32(self.rate)
        #: device-resident engines sync handle-visible state (is_finished,
        #: slot reclamation) every `sync_every` render_block calls; the copy
        #: is prefetched one block early
        self.sync_every = int(sync_every)
        self._since_sync = 0
        #: dispatches by kind ("single", "scan", ("multi", nb)) — the
        #: counterpart of the JAX Renderer's compiled-step keys
        self.dispatch_counts = {}

    def _count(self, kind, k=1):
        self.dispatch_counts[kind] = self.dispatch_counts.get(kind, 0) + k

    def render_block(self, n, interval=None):
        """Render one block of ``n`` frames; returns float32 numpy (n, C)."""
        sig = self.signal
        params = sig.host_prepare(self.interval if interval is None else f32(interval), n)
        self._count("single")
        d2, block = sig.render(sig.device_collect(), sig.device_data(), params, n)
        sig.device_store(d2)
        sync = getattr(sig, "sync", None)
        if sync is not None and self.sync_every > 0:
            self._since_sync += 1
            if self._since_sync == self.sync_every - 1:
                prefetch = getattr(sig, "sync_prefetch", None)
                if prefetch is not None:
                    prefetch()
            elif self._since_sync >= self.sync_every:
                sync()
                self._since_sync = 0
        return block.cpu().numpy().T

    def _dispatch(self, pend, block_size, consume):
        """Render a run of prepared blocks of equal archetype: idle runs of
        at least MULTI_MIN_BLOCKS go as fused nb-block groups where the
        signal allows (``host_multiblock``), the rest block by block."""
        sig = self.signal
        mb = getattr(sig, "host_multiblock", None)
        if (
            mb is not None and len(pend) >= MULTI_MIN_BLOCKS
            and not tree_leaves(pend[0])
        ):
            nb = mb(self.interval, block_size)
            if nb >= 2 and len(pend) >= nb:
                groups = len(pend) // nb
                d, dd = sig.device_collect(), sig.device_data()
                blocks = []
                for _ in range(groups):
                    d, blk = sig.render_multi(d, dd, block_size, nb)
                    blocks.append(blk)
                sig.device_store(d)
                self._count(("multi", nb), groups)
                consume(torch.stack(blocks))  # (groups, C, nb*block_size)
                pend = pend[groups * nb :]
                if not pend:
                    return
        d, dd = sig.device_collect(), sig.device_data()
        blocks = []
        for p in pend:
            d, blk = sig.render(d, dd, p, block_size)
            blocks.append(blk)
        sig.device_store(d)
        self._count("single" if len(pend) == 1 else "scan")
        consume(torch.stack(blocks))

    def _run_blocks(self, nblocks, block_size, consume):
        """Prepare + dispatch ``nblocks`` blocks, grouping runs of equal
        archetype.  A run is dispatched BEFORE any prepare that will apply
        state eagerly (``host_structure_event``), so every block renders
        against the state that produced its parameters."""
        sig = self.signal
        pend = []
        pend_arch = None

        def flush():
            nonlocal pend, pend_arch
            if pend:
                seg = pend
                pend, pend_arch = [], None
                self._dispatch(seg, block_size, consume)

        event = getattr(sig, "host_structure_event", None)
        bulk = getattr(sig, "host_idle_bulk", None)
        for bi in range(nblocks):
            if pend and event is not None and event():
                flush()
            p = sig.host_prepare(self.interval, block_size)
            a = sig.archetype()
            if pend and a != pend_arch:
                flush()
            pend.append(p)
            pend_arch = a
            # run-length idle path: a block that prepared EMPTY params on an
            # engine whose pools all pass the idle gate proves every
            # remaining block of this call is the same (the host is
            # single-threaded: no control traffic arrives mid-call), so
            # their host_prepare is skipped; they still render one by one
            remaining = nblocks - bi - 1
            if (remaining and bulk is not None and not tree_leaves(p)
                    and bulk(self.interval, block_size, remaining)):
                pend.extend([p] * remaining)
                break
        flush()

    def render_frames(self, total, block_size=512):
        """Offline render of ``total`` frames in fixed blocks; returns
        float32 numpy (total, C)."""
        nblocks, rem = divmod(total, block_size)
        pieces = []

        def consume(blocks):
            out = blocks.cpu().numpy()  # (B, C, n), n may be nb*block_size
            pieces.append(
                np.moveaxis(out, 1, 2).reshape(
                    out.shape[0] * out.shape[2], out.shape[1]
                )
            )

        if nblocks:
            self._run_blocks(nblocks, block_size, consume)
        if rem:
            pieces.append(self.render_block(rem))
        # device-resident engines sync handle-visible state once per batch
        sync = getattr(self.signal, "sync", None)
        if sync is not None:
            sync()
            self._since_sync = 0
        return pieces[0] if len(pieces) == 1 else np.concatenate(pieces)

    def render_frames_device(self, total, block_size=512, sync=True):
        """Offline render of ``total`` frames (a multiple of ``block_size``)
        that keeps the audio on the device: returns a list of (B, C, n)
        tensors, one per dispatch, without any host transfer or wait.

        ``sync=True`` starts the handle-state readback asynchronously; the
        next ``signal.sync()`` or handle query applies it (freed slots are
        reclaimed then, not here).  ``sync=False`` skips it."""
        nblocks, rem = divmod(total, block_size)
        if rem:
            raise ValueError("total must be a multiple of block_size")
        out = []
        self._run_blocks(nblocks, block_size, out.append)
        if sync:
            prefetch = getattr(self.signal, "sync_prefetch", None)
            if prefetch is not None:
                prefetch()
                self._since_sync = 0
        return out


def run(signal, sample_rate, n, device=None):
    """Populate and return an (n, C) float32 block from ``signal``
    (oddio::run, lib.rs:90-93), rendered on ``device`` (the CUDA card
    unless given; an engine renders on its own); keeps a Renderer cached on
    the signal so repeated calls stream correctly."""
    key = "_renderer_%d" % int(sample_rate)
    r = getattr(signal, key, None)
    if r is None:
        r = Renderer(signal, sample_rate, device=device)
        setattr(signal, key, r)
    return r.render_block(n)
