"""Crossfading stereo music beds inside a device-resident mixer pool (twin
of examples/crossfade_beds.py).

The reference's analogue: a `Mixer<[Sample; 2]>` of `Fader`s whose
`fade_to` swaps in replacement beds (fader.rs:81-93).  Here the whole
thing — stereo sample playback (frame.rs:67-79 frame-generic), the
constant-power fade ramps (fader.rs:52-63), and voice mixing — runs
device-resident; `fade_to` ships through the pool's fade lanes.

Run: python3 -m oddio_tpu_torch.examples.crossfade_beds   (writes crossfade_beds.wav)
"""

import numpy as np

import oddio_tpu_torch as pt
from oddio_tpu_torch.utils.wav import write_wav

RATE = 48000


def bed(freqs, pan):
    """A little stereo chord loop as a (n, 2) sample bed."""
    t = np.arange(2 * RATE) / RATE
    mono = sum(np.sin(2 * np.pi * f * t) for f in freqs) / len(freqs)
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 0.5 * t - np.pi / 2)
    left = mono * env * (1.0 - pan)
    right = mono * env * pan
    return pt.Frames.from_slice(RATE, np.stack([left, right], -1).astype(np.float32))


def main(device=None):
    control, mixer = pt.Mixer.new(channels=2, device=device)
    fade_ctl, fader = pt.Fader.new(pt.FramesSignal(bed([220.0, 277.2, 329.6], 0.35), 0.0))
    control.play(fader)

    r = pt.Renderer(mixer, RATE)
    pieces = [r.render_frames(RATE)]
    # crossfade to a darker bed over 0.75 s; the waiting-command rule
    # (fader.rs:38-47) means rapid-fire fade_to calls last-wins
    fade_ctl.fade_to(pt.FramesSignal(bed([174.6, 220.0, 261.6], 0.65), 0.0), 0.75)
    pieces.append(r.render_frames(RATE))
    fade_ctl.fade_to(pt.FramesSignal(bed([146.8, 185.0, 220.0], 0.5), 0.0), 0.4)
    pieces.append(r.render_frames(RATE))

    audio = np.concatenate(pieces)
    write_wav("crossfade_beds.wav", audio, RATE)
    print(f"wrote crossfade_beds.wav ({audio.shape[0] / RATE:.1f}s stereo)")


if __name__ == "__main__":
    main()
