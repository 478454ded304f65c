"""Voice-axis index localization (counterpart of oddio_tpu/parallel/context.py).

This package shards nothing yet (ScenePack is ROADMAP P3), so the voice
axis is never set and global slot indices are already local rows.  The
hook stays so the pools' delta scatters read the same as the reference's.
"""

from __future__ import annotations


def localize_index(idx, v_local):
    """Map global slot indices to shard-local rows: the identity while no
    voice axis is set.  Indices equal to ``v_local`` are padding lanes,
    which callers filter out on the host before any scatter."""
    return idx
