"""Constant-power crossfade between dynamically supplied signals
(counterpart of oddio_tpu/ops/fader.py).

Reference: oddio's src/fader.rs — ``Fader`` wraps an inner signal;
``FaderControl::fade_to(signal, duration)`` delivers a replacement through
a swap channel (fader.rs:86-93).  A fade must complete before the next
begins (a newer waiting command replaces the older, fader.rs:38-47); while
fading, ``out = sqrt(1-p)*old + sqrt(p)*new`` per frame (fader.rs:52-65),
and on completion the new signal replaces the old (fader.rs:66-70).

Three forms, as in the JAX package:

* **standalone** — a fade is a structure event: idle renders one child,
  fading renders both with the closed-form progress ramp; targets may have
  any structure.
* **host pool** (a Fader voice in a host pool) — the batched template keeps
  TWO same-archetype child banks and renders both every block; fade starts
  and completion swaps ride per-block params (device rows reset or
  exchanged by ``where``).  Pooled fade targets must share the current
  child's archetype.
* **device-resident pool** — two same-archetype banks and a per-voice
  active-bank bit (``flip``): a fade writes the target into the inactive
  bank through the pool's fade lanes (core/drctrl.py ``_fade_apply``) and
  completion flips the bit, so no state moves between banks and handles
  bound into either bank stay valid.  Both banks render through
  ``self.a.dr_render``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.drctrl import device_param
from ..core.hostmath import f32, full
from ..core.signal import ControlBlock, Signal
from ..utils.tree import tree_map
from . import stream_kernels as SK
from .speed import arena_chain, chain_operands, chain_state
from .stream_kernels import _voice_mask, fade_ramp

__all__ = ["Fader", "FaderControl"]


def _host_defaults_into(node, i, fresh):
    """Reset ``node``'s host-state slot ``i`` to the class defaults of a
    fresh single-slot template."""
    for f in node._host_fields:
        getattr(node, f)[i] = getattr(fresh, f)[0]
    for c, fc in zip(node.children().values(), fresh.children().values()):
        _host_defaults_into(c, i, fc)


class Fader(Signal):
    _host_fields = ("progress", "duration", "fading")

    def __init__(self, inner):
        super().__init__()
        self.a = inner
        self.channels = inner.channels
        self.b = None  # standalone: the active fade target
        self._alloc_host(())
        self._pending = None  # standalone: (signal, duration), last-wins
        self._swap_next = False
        self._pool_mode = False
        self._cb = ControlBlock(self)
        self.control = FaderControl(self._cb)

    @classmethod
    def new(cls, inner):
        sig = cls(inner)
        return sig.control, sig

    def _alloc_host(self, batch):
        self.progress = full(batch, 1.0)
        self.duration = full(batch, 1.0)
        self.fading = np.zeros(batch, dtype=bool)

    def children(self):
        if self._pool_mode:
            return {"a": self.a, "b": self.b}
        kids = {"a": self.a}
        if self.b is not None:
            kids["b"] = self.b
        return kids

    def _arch_extra(self):
        if self._pool_mode:
            return ("pooled",)
        return ("fading" if self.b is not None else "idle",)

    def _set_device(self, device):
        super()._set_device(device)
        if self._pool_mode:
            self._fresh._set_device(device)

    # -- host pool form ------------------------------------------------------------

    def clone_batched(self, V):
        new = object.__new__(type(self))
        Signal.__init__(new)
        new.batch = (V,)
        new.device = self.device
        new.channels = self.channels
        new._pool_mode = True
        new._alloc_host((V,))
        new.a = self.a.clone_batched(V)
        new.b = self.a.clone_batched(V)  # same-archetype shadow bank
        new._fresh = self.a.clone_batched(1)  # default-state rows
        new._b_dev_default = None  # lazy (device leaves)
        new._pending_fades = {}  # slot -> (spec, duration); last-wins
        new._pending_breset = set()  # slots whose b bank resets next block
        new._pool = None
        new._slot_gen = np.zeros(V, np.int64)
        new._pending = None
        new._swap_next = False
        new.control = None
        return new

    def grow_batched(self, new_V):
        old_V = self.batch[0]
        super().grow_batched(new_V)
        self._slot_gen = np.concatenate([self._slot_gen, np.zeros(new_V - old_V, np.int64)])

    def write_slot(self, i, spec, pool, gen):
        if spec._moved:
            raise RuntimeError("signal was already played (moved); construct a new one")
        spec._moved = True
        self.progress[i] = spec.progress[()]
        self.duration[i] = spec.duration[()]
        self.fading[i] = spec.b is not None
        cb = getattr(spec, "_cb", None)
        if cb is not None:
            cb.rebind(self, i, pool, gen)
        self._pool = pool
        self._slot_gen[i] = gen
        self.a.write_slot(i, spec.a, pool, gen)
        if spec.b is not None:
            if spec.b.archetype() != spec.a.archetype():
                raise ValueError("pooled fade targets must share the inner archetype")
            self.b.write_slot(i, spec.b, pool, gen)
        else:
            _host_defaults_into(self.b, i, self._fresh)

    def queue_fade(self, idx, signal, duration):
        """Route a control-side fade_to to wherever this fader lives."""
        if self._pool_mode:
            self._pending_fades[idx] = (signal, float(duration))
        else:
            self._pending = (signal, float(duration))

    def host_aux_snapshot(self):
        """Queued control events are engine state: a snapshot taken between
        fade_to() and the next block must not lose the fade (the checkpoint
        analogue of the DR pools' pending plays).  The slots' play
        generations go with them (a released fade binds its target's
        handles at the generation its voice was played with)."""
        if not self._pool_mode:
            return None
        return {
            "pending_fades": dict(self._pending_fades),
            "pending_breset": set(self._pending_breset),
            "slot_gen": self._slot_gen.copy(),
        }

    def host_aux_restore(self, aux):
        if not self._pool_mode or aux is None:
            return
        self._pending_fades = dict(aux["pending_fades"])
        self._pending_breset = set(aux["pending_breset"])
        self._slot_gen = aux["slot_gen"].copy()
        # a restored command has not been carried out: its target is not
        # moved into the pool yet (a release after the snapshot moved it)
        for spec, _ in self._pending_fades.values():
            stack = [spec]
            while stack:
                node = stack.pop()
                node._moved = False
                stack.extend(node.children().values())

    def _b_defaults(self):
        """Default per-slot device rows of the b bank (tensor tree)."""
        if self._b_dev_default is None:
            self._b_dev_default = tree_map(lambda x: x[0], self._fresh.device_collect())
        return self._b_dev_default

    # -- host per-block protocol ---------------------------------------------------

    def _host_prepare_pooled(self, interval, n, count):
        # completion swaps from the previous block (fader.rs:66-70): host
        # rows exchange here, device rows in the render (the swap param)
        done = self.fading & (self.progress >= 1.0)
        if done.any():
            self._swap_host_rows(self.a, self.b, done)
            self.fading = self.fading & ~done

        # start pending fades on idle voices (fader.rs:38-47)
        breset = self._pending_breset
        self._pending_breset = set()
        for slot, (spec, dur) in list(self._pending_fades.items()):
            if self.fading[slot]:
                continue  # waits; a newer command replaced any older waiter
            del self._pending_fades[slot]
            if spec.archetype() != self._fresh.archetype():
                raise ValueError("pooled fade targets must share the inner archetype")
            self.b.write_slot(slot, spec, self._pool, int(self._slot_gen[slot]))
            self.duration[slot] = np.float32(dur)
            self.progress[slot] = np.float32(0.0)
            self.fading[slot] = True
            breset.add(slot)

        # a duration <= one interval (0 included) completes within the first
        # frame, like the reference's per-frame progress.min(1.0)
        # (fader.rs:52-63); the clamp also keeps 0*inf out of the ramp
        inc = (interval / np.maximum(self.duration, interval)).astype(np.float32)
        breset_mask = np.zeros(self.batch[0], dtype=bool)
        breset_mask[sorted(breset)] = True
        params = {
            "swap": done,
            "breset": breset_mask,
            "fading": self.fading.copy(),
            "progress0": self.progress.copy(),
            "inc": inc,
            "a": self.a.host_prepare(interval, n, count),
            "b": self.b.host_prepare(interval, n, count),
        }
        cnt = np.broadcast_to(f32(n if count is None else count), self.batch)
        self.progress = np.where(
            self.fading,
            np.minimum((self.progress + cnt * inc).astype(np.float32), np.float32(1.0)),
            self.progress,
        ).astype(np.float32)
        return params

    @staticmethod
    def _swap_host_rows(a, b, mask):
        for f in a._host_fields:
            fa, fb = getattr(a, f), getattr(b, f)
            tmp = fa[mask].copy()
            fa[mask] = fb[mask]
            fb[mask] = tmp
        for ca, cb in zip(a.children().values(), b.children().values()):
            Fader._swap_host_rows(ca, cb, mask)

    def host_prepare(self, interval, n, count=None):
        interval = np.broadcast_to(f32(interval), self.batch).astype(np.float32)
        if self._pool_mode:
            return self._host_prepare_pooled(interval, n, count)
        if self._swap_next:
            # fader.rs:66-70 at the block boundary: the new signal (and its
            # device state, owned by the node) moves into place
            self.a, self.b = self.b, None
            self._swap_next = False
        # fader.rs:38-47: a pending fade starts only once idle
        if self.progress >= 1.0 and self._pending is not None:
            sig, dur = self._pending
            self._pending = None
            if sig._moved:
                raise RuntimeError("fade target was already played (moved)")
            sig._moved = True
            if self.device is not None:
                sig._set_device(self.device)
            self.b = sig
            self.duration[()] = np.float32(dur)
            self.progress[()] = np.float32(0.0)

        if self.b is None:
            return {"a": self.a.host_prepare(interval, n, count)}

        inc = (interval / np.maximum(self.duration, interval)).astype(np.float32)
        params = {
            "progress0": np.asarray(self.progress, np.float32),
            "inc": inc,
            "a": self.a.host_prepare(interval, n, count),
            "b": self.b.host_prepare(interval, n, count),
        }
        cnt = np.broadcast_to(f32(n if count is None else count), self.batch)
        self.progress = np.asarray(
            np.minimum((self.progress + cnt * inc).astype(np.float32), np.float32(1.0)),
            dtype=np.float32,
        )
        if self.progress >= 1.0:
            self._swap_next = True
        return params

    def host_is_finished(self):
        return np.zeros(self.batch, dtype=bool)  # fader.rs:74-77

    def host_structure_event(self):
        if not self._pool_mode:
            # the next prepare swaps children or starts a structural fade
            if self._swap_next or (
                self._pending is not None and float(self.progress) >= 1.0
            ):
                return True
        # pooled fades are parameter events, not structure events
        return any(c.host_structure_event() for c in self.children().values())

    def render_host(self, dstate, ddata, params, n):
        if self._pool_mode:
            return self._render_pooled(dstate, ddata, params, n)
        d2a, old = self.a.render_host(dstate.get("a", {}), ddata.get("a", {}), params["a"], n)
        out = dict(dstate)
        out["a"] = d2a
        if self.b is None:
            return out, old
        d2b, new = self.b.render_host(dstate.get("b", {}), ddata.get("b", {}), params["b"], n)
        out["b"] = d2b
        dev = old.device
        p = fade_ramp(device_param(params["progress0"], dev, torch.float32),
                      device_param(params["inc"], dev, torch.float32), n)[:, None, :]
        return out, old * torch.sqrt(1.0 - p) + new * torch.sqrt(p)

    def _render_pooled(self, dstate, ddata, params, n):
        dev = self.device
        swap = device_param(params["swap"], dev, torch.bool)
        breset = device_param(params["breset"], dev, torch.bool)
        da, db = dstate["a"], dstate["b"]
        da, db = (
            tree_map(lambda x, y: torch.where(_voice_mask(swap, x), y, x), da, db),
            tree_map(lambda x, y: torch.where(_voice_mask(swap, x), y, x), db, da),
        )
        # fade starts: the b bank's device rows reset to their defaults
        db = tree_map(lambda x, d: torch.where(_voice_mask(breset, x), d, x),
                      db, self._b_defaults())
        dda = ddata.get("a", {})
        d2a, old = self.a.render_host(da, dda, params["a"], n)
        d2b, new = self.b.render_host(db, dda, params["b"], n)
        fading = device_param(params["fading"], dev, torch.bool)[:, None]
        p = fade_ramp(device_param(params["progress0"], dev, torch.float32),
                      device_param(params["inc"], dev, torch.float32), n)
        wa = torch.where(fading, torch.sqrt(1.0 - p), 1.0)
        wb = torch.where(fading, torch.sqrt(p), 0.0)
        out = dict(dstate)
        out["a"], out["b"] = d2a, d2b
        return out, old * wa[:, None, :] + new * wb[:, None, :]

    def device_data(self):
        # a pool's banks share the a side's read-only data (one archetype)
        d = dict(self._own_device_data())
        for k, c in (self.children() if not self._pool_mode else {"a": self.a}).items():
            sub = c.device_data()
            if sub:
                d[k] = sub
        return d

    # -- device-resident mode ------------------------------------------------

    def dr_fade_capable(self):
        return True

    def dr_ctrl_children(self):
        """Both banks' control fields are addressable in the DR state tree
        (a fade target's handles bind to the bank it lands in)."""
        return {"a": self.a, "b": self.a}

    def dr_supported(self):
        return (
            not self._pool_mode
            and self.a.dr_supported()
            and (self.b is None or self.b.dr_supported())
        )

    def dr_state_init(self, V):
        return {
            "prog": np.ones(V, np.float32),
            "inc": np.zeros(V, np.float32),
            "fading": np.zeros(V, bool),
            "flip": np.zeros(V, bool),
            "a": self.a.dr_state_init(V),
            "b": self.a.dr_state_init(V),
        }

    def dr_slot_row(self, interval):
        iv = np.float32(interval)
        if self.b is not None:
            if self.b.archetype() != self.a.archetype():
                raise ValueError("pooled fade targets must share the inner archetype")
            inc = np.float32(iv / max(np.float32(self.duration[()]), iv))
            brow = self.b.dr_slot_row(interval)
            prog = np.float32(self.progress[()])
        else:
            inc = np.float32(0.0)
            brow = tree_map(lambda x: np.asarray(x[0]), self.a.dr_state_init(1))
            prog = np.float32(1.0)
        return {
            "prog": prog, "inc": inc, "fading": self.b is not None, "flip": False,
            "a": self.a.dr_slot_row(interval), "b": brow,
        }

    def dr_render(self, state, ddata, interval, n, count):
        dda = ddata.get("a", {})
        chain = arena_chain(self.a)
        if chain is not None:
            # Speeds over a FramesSignal or a Cycle on the arena route: both
            # banks (each with its own speeds) and the crossfade in one launch
            k, leaf = chain
            la, ld, iva, spa = chain_operands(k, state["a"], dda, interval)
            lb, _, ivb, spb = chain_operands(k, state["b"], dda, interval)
            core, a2, b2, samples = SK.fader_step(
                ld["garena"], leaf.arena_kind, state, (la, lb), (iva, ivb), n, count,
                channels=leaf.channels, speeds=(spa, spb))
            return dict(core, a=chain_state(k, state["a"], a2),
                        b=chain_state(k, state["b"], b2)), samples
        # any other inner: both banks render, then the crossfade (the
        # completion check at block start, fader.rs:66-70, flips the bit;
        # nothing moves)
        a2, sa = self.a.dr_render(state["a"], dda, interval, n, count)
        b2, sb = self.a.dr_render(state["b"], dda, interval, n, count)
        core, samples = SK.fade_mix_plain(state, sa, sb, n, count)
        return dict(core, a=a2, b=b2), samples

    def dr_is_finished(self, state):
        # a fader never finishes on its own (fader.rs:74-77)
        p = state["prog"]
        return torch.zeros(p.shape, dtype=torch.bool, device=p.device)


class FaderControl:
    """fader.rs:81-93: crossfade to ``signal`` over ``duration`` seconds; a
    command given during a fade waits (and replaces any waiter)."""

    def __init__(self, cb):
        self._cb = cb

    def fade_to(self, signal, duration):
        fader = self._cb.sig
        if signal.channels != fader.channels:
            raise ValueError("fade target must match channel count")
        if self._cb._dr is not None:
            # device-resident voice: the fade rides the pool's fade lanes
            pool, slot, gen, path = self._cb._dr
            if pool.slot_gen[slot] == gen:
                pool.push_fade(path, slot, gen, signal, duration)
            return
        if self._cb.live():
            fader.queue_fade(self._cb.idx, signal, duration)
