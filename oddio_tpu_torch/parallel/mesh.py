"""The (scene, voice) layout a ScenePack renders on (counterpart of
oddio_tpu/parallel/mesh.py).

The JAX package lays scenes and voices over a mesh of TPU chips: the
scene axis is data parallel, the voice axis shards one scene's voices
and closes the mix with a ``psum``.  This package packs scenes on one
card, so it accepts the 1 x 1 layout only; the multi-card form over
``torch.distributed`` (the voice-axis ``all_reduce``) is ROADMAP PK2.
"""

from __future__ import annotations

import torch

__all__ = ["Mesh", "make_mesh", "SCENE_AXIS", "VOICE_AXIS"]

SCENE_AXIS = "scene"
VOICE_AXIS = "voice"


class Mesh:
    """A (scene, voice) layout of torch devices.  ``devices`` None means
    the device the packed scenes render on (each scene names its own: the
    CUDA card unless built with ``device=``)."""

    axis_names = (SCENE_AXIS, VOICE_AXIS)

    def __init__(self, scene, voice, devices=None):
        self.shape = {SCENE_AXIS: int(scene), VOICE_AXIS: int(voice)}
        self.devices = devices

    def __repr__(self):
        return f"Mesh({self.shape}, devices={self.devices})"


def make_mesh(scene=1, voice=1, devices=None):
    """Build a (scene, voice) layout over ``devices`` (one torch device, or
    None for the scenes' own).  Only 1 x 1 is accepted: larger meshes
    raise ``ValueError``."""
    if (int(scene), int(voice)) != (1, 1):
        raise ValueError(
            f"mesh {scene}x{voice}: oddio_tpu_torch packs scenes on one card "
            "(make_mesh(1, 1)); the multi-card form over torch.distributed is "
            "ROADMAP PK2"
        )
    if devices is not None:
        devices = list(devices)
        if len(devices) != 1:
            raise ValueError(f"a 1x1 mesh takes one device, got {len(devices)}")
        devices = [torch.device(devices[0])]
    return Mesh(1, 1, devices)
