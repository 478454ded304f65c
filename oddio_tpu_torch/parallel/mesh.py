"""The (scene, voice) layout a ScenePack renders on (counterpart of
oddio_tpu/parallel/mesh.py).

The scene axis splits a pack's scenes into groups, pure data parallelism;
the voice axis splits each pool's slots into shards, whose partial mixes
sum into the group's block (the JAX package's ``psum``).  One process
drives every device of the mesh, as the JAX package's one controller does.
A device list may repeat a device: a logical mesh, whose cells render in
turn on it (the counterpart of the JAX tests' virtual 8-device CPU mesh).
"""

from __future__ import annotations

import torch

__all__ = ["Mesh", "make_mesh", "SCENE_AXIS", "VOICE_AXIS"]

SCENE_AXIS = "scene"
VOICE_AXIS = "voice"


class Mesh:
    """A (scene, voice) grid of torch devices: ``devices[g][k]`` renders
    voice shard ``k`` of scene group ``g``."""

    axis_names = (SCENE_AXIS, VOICE_AXIS)

    def __init__(self, devices):
        self.devices = [[torch.device(d) for d in row] for row in devices]
        if not self.devices or not self.devices[0] or len(
                {len(row) for row in self.devices}) != 1:
            raise ValueError("a mesh is a non-empty grid of devices")
        self.shape = {SCENE_AXIS: len(self.devices), VOICE_AXIS: len(self.devices[0])}

    @property
    def first(self):
        """The device a pack's output gathers on."""
        return self.devices[0][0]

    def __repr__(self):
        return f"Mesh({self.shape}, devices={self.devices})"


def make_mesh(scene=1, voice=1, devices=None):
    """Build a (scene, voice) mesh over ``devices``: a list of at least
    ``scene * voice`` torch devices (repeats allowed), laid out in order,
    or None for every CUDA card.  Too few devices raise ``ValueError``; so
    does ``devices=None`` on a machine without a card."""
    scene, voice = int(scene), int(voice)
    if scene < 1 or voice < 1:
        raise ValueError(f"mesh {scene}x{voice}: both axes need at least one device")
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [torch.device(d) for d in devices]
    need = scene * voice
    if need > len(devices):
        raise ValueError(f"mesh {scene}x{voice} needs {need} devices, have {len(devices)}")
    return Mesh([devices[g * voice:(g + 1) * voice] for g in range(scene)])
