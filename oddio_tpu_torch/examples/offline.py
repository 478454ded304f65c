"""Offline spatial render to WAV — mirrors the reference's examples/offline.rs:
a 500 Hz boop flying past the listener at 50 m/s, 3 s @ 44.1 kHz stereo
(twin of examples/offline.py)."""

import numpy as np

import oddio_tpu_torch as pt
from oddio_tpu_torch.utils.wav import write_wav

DURATION_SECS = 3
RATE = 44100
BLOCK_SIZE = 512
SPEED = 50.0


def main(device=None):
    t = np.arange(RATE * DURATION_SECS, dtype=np.float32) / np.float32(RATE)
    boop = np.sin(t * np.float32(500.0 * 2.0 * np.pi)) * np.float32(80.0)

    scene_handle, scene = pt.SpatialScene.new(device=device)
    scene_handle.play(
        pt.FramesSignal(pt.Frames.from_slice(RATE, boop)),
        pt.SpatialOptions(
            position=[-SPEED, 10.0, 0.0], velocity=[SPEED, 0.0, 0.0], radius=0.1
        ),
    )

    r = pt.Renderer(scene, RATE)
    total = (RATE * DURATION_SECS // BLOCK_SIZE) * BLOCK_SIZE
    out = r.render_frames(total, block_size=BLOCK_SIZE)
    write_wav("offline.wav", out, RATE)
    print(f"wrote offline.wav ({total} frames, peak {np.abs(out).max():.3f})")


if __name__ == "__main__":
    main()
