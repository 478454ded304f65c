"""Channel-count adapters: MonoToStereo and Downmix (counterpart of
oddio_tpu/ops/channels.py).

Reference: oddio's src/signal.rs:61-91 (MonoToStereo duplicates the mono
channel) and src/downmix.rs (Downmix sums all channels).

As in the JAX package, Downmix advances its inner signal by exactly ``n``
frames; the reference stages 256-frame chunks (downmix.rs:23-33), which
agrees whenever ``n`` is a multiple of 256.
"""

from __future__ import annotations

import contextlib

import torch

from ..core.signal import Signal, render_as

__all__ = ["MonoToStereo", "Downmix"]


class _Wrapper(Signal):
    """A one-child wrapper passing the block's interval and count through
    unchanged (so a pool routes a stream's ingest channel through it).

    Standalone (a Renderer's root, a submix's voice) it renders its inner
    signal directly (``render``: the params as they come, tensors or
    numpy) and maps the ``(C, n)`` block as a batch of one (so the block
    equals ``render_host``'s, a pack's path); it captures as a CUDA graph
    when its inner signal does (``graph_capture``, ``GRAPH_INPLACE`` and
    ``render_archetype`` forwarded, as the JAX Renderer compiles a wrapper
    chain around an engine).  It forwards no idle-run or sync hook: the
    JAX Renderer finds none on such a root either."""

    _dr_ingest_transparent = True

    def __init__(self, signal):
        super().__init__()
        self.inner = signal
        self.seekable = signal.seekable

    def children(self):
        return {"inner": self.inner}

    def _alloc_host(self, batch):
        pass

    def _copy_static_from(self, other):
        self.seekable = other.seekable
        self.channels = other.channels

    def host_prepare(self, interval, n, count=None):
        return {"inner": self.inner.host_prepare(interval, n, count)}

    def host_params_at(self, tshift, interval, n):
        return {"inner": self.inner.host_params_at(tshift, interval, n)}

    def host_seek(self, seconds):
        self.inner.host_seek(seconds)

    def host_is_finished(self):
        return self.inner.host_is_finished()

    # -- standalone render and its block step (core/run.py) -------------------

    @property
    def graph_capture(self):
        return getattr(self.inner, "graph_capture", False)

    @property
    def GRAPH_INPLACE(self):
        return getattr(self.inner, "GRAPH_INPLACE", ())

    @contextlib.contextmanager
    def render_archetype(self, arch):
        """Render as of ``arch``: the inner signal's, as of its entry of
        the key (``Signal.archetype`` nests it under "inner")."""
        with render_as(self.inner, dict(arch[3])["inner"]):
            yield

    def _inner_render(self, dstate, ddata, params, n):
        d2, block = self.inner.render(
            dstate.get("inner", {}), ddata.get("inner", {}), params["inner"], n
        )
        out = dict(dstate)
        out["inner"] = d2
        return out, block

    def render(self, dstate, ddata, params, n):
        d2, block = self._inner_render(dstate, ddata, params, n)
        return d2, self._map(block[None])[0]

    def _map(self, block):
        """The wrapper's transform of a block (V, C, n) or samples (V[, E
        or C], n)."""
        raise NotImplementedError

    def render_host(self, dstate, ddata, params, n):
        d2, block = self.inner.render_host(
            dstate.get("inner", {}), ddata.get("inner", {}), params["inner"], n
        )
        out = dict(dstate)
        out["inner"] = d2
        return out, self._map(block)

    # -- device-resident plumbing for stateless mono wrappers --------------------
    # Elementwise subclasses (Reinhard, Tanh) opt in with ``_dr_elementwise``;
    # mono-only in the seek pool, like every seek chain.

    _dr_elementwise = False

    def dr_supported(self):
        return self._dr_elementwise and self.inner.dr_supported()

    def dr_state_init(self, V):
        return {"inner": self.inner.dr_state_init(V)}

    def dr_slot_row(self, interval):
        return {"inner": self.inner.dr_slot_row(interval)}

    def dr_render(self, state, ddata, interval, n, count):
        d2, samples = self.inner.dr_render(
            state["inner"], ddata.get("inner", {}), interval, n, count
        )
        return {"inner": d2}, self._dr_map(samples)

    def _dr_map(self, samples):
        return self._map(samples)

    def dr_is_finished(self, state):
        return self.inner.dr_is_finished(state["inner"])

    def dr_seek_supported(self):
        return (
            self._dr_elementwise
            and self.channels == 1
            and self.seekable
            and self.inner.dr_seek_supported()
        )

    def dr_warp_render(self, state, ddata, t0, dt, n):
        samples = self.inner.dr_warp_render(
            state["inner"], ddata.get("inner", {}), t0, dt, n
        )
        return self._map(samples)

    def dr_advance(self, state, seconds):
        return {"inner": self.inner.dr_advance(state["inner"], seconds)}


class MonoToStereo(_Wrapper):
    """signal.rs:61-91 — duplicate a mono signal into both stereo channels."""

    def __init__(self, signal):
        if signal.channels != 1:
            raise ValueError("MonoToStereo requires a mono inner signal")
        super().__init__(signal)
        self.channels = 2

    def _map(self, block):
        return block.expand(block.shape[0], 2, block.shape[-1])

    def dr_supported(self):
        return self.inner.dr_supported()

    def _dr_map(self, samples):
        return samples[:, None, :].expand(samples.shape[0], 2, samples.shape[-1])


class Downmix(_Wrapper):
    """downmix.rs — sum all channels to mono."""

    def __init__(self, signal):
        super().__init__(signal)
        self.channels = 1

    def _map(self, block):
        return torch.sum(block, dim=1, keepdim=True)

    def dr_supported(self):
        return self.inner.dr_supported()

    def _dr_map(self, samples):
        return torch.sum(samples, dim=1) if samples.dim() == 3 else samples
