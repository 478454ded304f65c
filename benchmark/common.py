"""Helpers the configurations' drivers share."""

from __future__ import annotations

import numpy as np
import torch


def seed_rng(seed, *stream):
    """A generator for one stream of draws of the run's seed."""
    return np.random.default_rng([int(seed) & (2**64 - 1), *stream])


def timed_prepare(scenes, spans):
    """Time each scene's ``host_prepare`` as the span "host_prepare"; only
    where ``spans`` are enabled (the traced run), so that the untraced
    runs time the bare program."""
    if not spans.enabled:
        return
    for scene in scenes:
        inner = scene.host_prepare

        def host_prepare(*a, _inner=inner, **kw):
            with spans.span("host_prepare"):
                return _inner(*a, **kw)

        scene.host_prepare = host_prepare


def device_info(device, peak):
    """The result line's ``device`` of a one-card run."""
    if torch.device(device).type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
                "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": int(peak)}
