"""Automatic gain control over a changing mix — mirrors the reference's
examples/adapt.rs: a quiet sine, then a loud one added, then removed, with
Adapt keeping the RMS level in range (twin of examples/adapt_agc.py)."""

import numpy as np

import oddio_tpu_torch as pt
from oddio_tpu_torch.utils.wav import write_wav

DURATION_SECS = 2
RATE = 44100
BLOCK_SIZE = 512


def main(device=None):
    mixer, signal = pt.Mixer.new(channels=1, device=device)
    chain = pt.Adapt(
        signal,
        1e-3 / np.sqrt(2.0),
        pt.AdaptOptions(
            tau=0.1, max_gain=1e6, low=0.1 / np.sqrt(2.0), high=0.5 / np.sqrt(2.0)
        ),
    )
    r = pt.Renderer(chain, RATE)
    total = (RATE * DURATION_SECS // BLOCK_SIZE) * BLOCK_SIZE

    quiet = pt.FixedGain(pt.Sine(0.0, 5e2), -60.0)
    loud = pt.FixedGain(pt.Sine(0.0, 4e2), -2.0)

    pieces = []
    mixer.play(quiet)
    pieces.append(r.render_frames(total))
    handle = mixer.play(loud)
    pieces.append(r.render_frames(total))
    handle.stop()
    pieces.append(r.render_frames(total))

    out = np.concatenate(pieces)
    write_wav("adapt.wav", out, RATE)
    for name, seg in zip(("quiet", "loud", "quiet again"), pieces):
        print(f"{name}: rms {np.sqrt((seg**2).mean()):.3f}")


if __name__ == "__main__":
    main()
