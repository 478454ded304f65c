"""WAV playback with resampling — mirrors the reference's examples/wav.rs:
load a stereo WAV at its source rate, play it through a mixer at the output
device rate (FramesSignal resamples via its fractional cursor), with a Speed
control for pitch/rate scaling (twin of examples/wav_playback.py)."""

import sys

import numpy as np

import oddio_tpu_torch as pt
from oddio_tpu_torch.utils.wav import read_wav, write_wav


def main(device=None):
    if len(sys.argv) > 1:
        samples, source_rate = read_wav(sys.argv[1])
        if samples.ndim == 1:
            samples = np.stack([samples, samples], axis=1)
    else:  # synthesize a test clip like examples/wav/stereo-test.wav
        source_rate = 22050
        t = np.arange(source_rate * 2, dtype=np.float32) / source_rate
        left = np.sin(t * 2 * np.pi * 330).astype(np.float32)
        right = np.sin(t * 2 * np.pi * 440).astype(np.float32)
        samples = np.stack([left, right], axis=1) * 0.5

    device_rate = 48000
    frames = pt.Frames.from_slice(source_rate, samples)

    mixer_handle, mixer = pt.Mixer.new(channels=2, device=device)
    speed_control, sped = pt.Speed.new(pt.FramesSignal(frames))
    speed_control.set_speed(1.0)
    mixer_handle.play(sped)

    r = pt.Renderer(mixer, device_rate)
    length = int(len(frames) / source_rate * device_rate)
    out = r.render_frames(length // 512 * 512)
    write_wav("wav_playback.wav", out, device_rate)
    print(f"resampled {source_rate} -> {device_rate} Hz, wrote wav_playback.wav")


if __name__ == "__main__":
    main()
