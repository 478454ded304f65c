"""Render-time context for packed scenes (counterpart of
oddio_tpu/parallel/context.py).

The JAX package renders a ScenePack under ``shard_map`` with a voice mesh
axis, and ``localize_index`` maps global slot numbers to shard-local rows
inside the traced step.  This package stacks a pack's scenes along the
voice axis and renders the stack cell by cell of the (scene, voice) mesh,
each cell on its own device: the pack maps a scene's slot indices to the
cell's stacked rows on the host (``stack_index``; an index whose slot
another voice shard holds becomes a padding lane, which the pools'
scatters drop) before the pools see them, so ``localize_index`` is the
identity here.  ``scene_stack`` tells the pools' renders how many scenes
their rows hold (and which of the pack's scenes they are), so that they
mix each scene apart; ``mesh_cell`` names the cell being rendered and its device,
which every pool's and signal's ``device`` (``RenderDevice``) then reads,
so a cell on another device than its scenes' allocates and uploads there.
``block_step`` marks a render inside a block step (``core/run.py``), which
a CUDA graph may replay: there no per-block value may come from the host.
The context is per thread (a realtime driver renders on its own thread).
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

__all__ = [
    "localize_index",
    "current_scenes",
    "scene_offset",
    "scene_stack",
    "stack_index",
    "mesh_cell",
    "current_cell",
    "RenderDevice",
    "voice_partials",
    "partial_sums",
    "add_block",
    "block_step",
    "in_block_step",
]

_CTX = threading.local()


def localize_index(idx, v_local):
    """Map global slot indices to shard-local rows: the identity, since a
    pack maps them on the host (``stack_index``).  Indices equal to
    ``v_local`` are padding lanes, which callers filter out on the host
    before any scatter."""
    return idx


def current_scenes():
    """How many scenes the pool rows of the render in progress hold
    (stacked along the voice axis by a ScenePack), or None outside a
    pack."""
    st = getattr(_CTX, "scenes", None)
    return None if st is None else st[0]


def scene_offset():
    """The pack index of the first scene the render in progress holds (a
    scene group of a mesh starts past the groups before it); 0 outside a
    pack."""
    st = getattr(_CTX, "scenes", None)
    return 0 if st is None else st[1]


@contextlib.contextmanager
def scene_stack(S, first=0):
    """Render ``S`` scenes stacked along the voice axis, the pack's scenes
    ``first .. first + S - 1``: pools mix each scene's rows apart into a
    leading scene axis."""
    prev = getattr(_CTX, "scenes", None)
    _CTX.scenes = (int(S), int(first))
    try:
        yield
    finally:
        _CTX.scenes = prev


@contextlib.contextmanager
def voice_partials(parts):
    """Render one voice shard of a sharded mesh cell: inside, an engine's
    pools hand their blocks to ``parts`` (pool name -> block) instead of
    adding them up (``add_block``), and the float64 voice sums stay in
    float64 (``partial_sums``), so that a ScenePack sums each pool's
    shards before it rounds and adds the pools in the order a 1 x 1 pack
    adds them.  ``parts`` None renders whole blocks again (a submix inside
    the shard: it lives on one shard, whole)."""
    prev = getattr(_CTX, "partials", None)
    _CTX.partials = parts
    try:
        yield
    finally:
        _CTX.partials = prev


def partial_sums():
    """Whether the voice sums of the render in progress are one voice
    shard's partial sums (``voice_partials``)."""
    return getattr(_CTX, "partials", None) is not None


def add_block(out, block, key):
    """An engine's mix ``out`` plus pool ``key``'s ``block``; in a voice
    shard's render (``voice_partials``) the block is kept apart for the
    pack instead, and ``out`` returned as it is."""
    parts = getattr(_CTX, "partials", None)
    if parts is None:
        return out + block
    parts[key] = block
    return out


@contextlib.contextmanager
def block_step():
    """Render inside a block step: a CUDA graph may capture the render and
    replay it, so every per-block value must come from the step's params
    or state; code that would read one from the host raises instead
    (``in_block_step``)."""
    prev = getattr(_CTX, "step", False)
    _CTX.step = True
    try:
        yield
    finally:
        _CTX.step = prev


def in_block_step():
    """Whether the render in progress is a block step's (``block_step``)."""
    return getattr(_CTX, "step", False)


def current_cell():
    """``(key, device)`` of the mesh cell being rendered, or None."""
    return getattr(_CTX, "cell", None)


@contextlib.contextmanager
def mesh_cell(key, device):
    """Render one cell of a pack's mesh: inside, every ``RenderDevice``
    attribute reads ``device``, and a CUDA device is the current one."""
    device = torch.device(device)
    prev = getattr(_CTX, "cell", None)
    _CTX.cell = (key, device)
    guard = (torch.cuda.device(device) if device.type == "cuda" and device.index is not None
             else contextlib.nullcontext())
    try:
        with guard:
            yield
    finally:
        _CTX.cell = prev


class RenderDevice:
    """The ``device`` attribute of pools, signals and upload rings: the
    device they were placed on, or inside ``mesh_cell`` the cell's, where
    the render in progress allocates and uploads.  The placed device is
    kept in the instance dict under the attribute's own name."""

    def __set_name__(self, owner, name):
        self.name = name

    def __get__(self, obj, owner=None):
        if obj is None:
            return self
        cell = getattr(_CTX, "cell", None)
        if cell is not None:
            return cell[1]
        return obj.__dict__.get(self.name)

    def __set__(self, obj, value):
        obj.__dict__[self.name] = value


def stack_index(idx, s, V, S, shard=0, shards=1):
    """Scene ``s``'s padded slot indices (padding lanes hold ``V``, the
    per-scene capacity) as rows of the stacked pool of ``S`` scenes: on one
    voice shard ``s*V + slot``, padding at ``S*V``; on voice shard
    ``shard`` of ``shards``, which holds each scene's slots ``shard*V/shards
    ..`` as its ``V/shards`` rows, ``s*V/shards + local`` for the slots it
    holds and padding (``S*V/shards``) for the rest."""
    idx = np.asarray(idx)
    if shards == 1:
        return np.where(idx < V, idx + s * V, S * V).astype(idx.dtype)
    Vb = V // shards
    local = idx - shard * Vb
    held = (idx < V) & (local >= 0) & (local < Vb)
    return np.where(held, local + s * Vb, S * Vb).astype(idx.dtype)
