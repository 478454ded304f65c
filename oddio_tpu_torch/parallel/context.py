"""Render-time context for packed scenes (counterpart of
oddio_tpu/parallel/context.py).

The JAX package renders a ScenePack under ``shard_map`` with a voice mesh
axis, and ``localize_index`` maps global slot numbers to shard-local rows.
This package packs scenes on one card, stacking them along the voice
axis, so there is no voice mesh axis to shard over (``localize_index``
is the identity; the JAX package's ``voice_axis`` context has no reader
here until a pack spans several cards, ROADMAP PK2) and a pack's slot
indices are mapped to stacked rows on the host
(``stack_index``) before the pools see them.  ``scene_stack`` tells the
pools' renders how many scenes their rows hold, so that they mix each
scene apart.
"""

from __future__ import annotations

import contextlib

import numpy as np

__all__ = [
    "localize_index",
    "current_scenes",
    "scene_stack",
    "stack_index",
]

_SCENES = None


def localize_index(idx, v_local):
    """Map global slot indices to shard-local rows: the identity, since no
    voice axis is sharded.  Indices equal to ``v_local`` are padding lanes,
    which callers filter out on the host before any scatter."""
    return idx


def current_scenes():
    """How many scenes the pool rows of the render in progress hold
    (stacked along the voice axis by a ScenePack), or None outside a
    pack."""
    return _SCENES


@contextlib.contextmanager
def scene_stack(S):
    """Render ``S`` scenes stacked along the voice axis: pools mix each
    scene's rows apart into a leading scene axis."""
    global _SCENES
    prev = _SCENES
    _SCENES = int(S)
    try:
        yield
    finally:
        _SCENES = prev


def stack_index(idx, s, V, S):
    """Scene ``s``'s padded slot indices (padding lanes hold ``V``, the
    per-scene capacity) as rows of the stacked pool: ``s*V + slot``, with
    padding at ``S*V``."""
    idx = np.asarray(idx)
    return np.where(idx < V, idx + s * V, S * V).astype(idx.dtype)
