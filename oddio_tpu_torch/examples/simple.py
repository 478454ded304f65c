"""A minimal dynamic real-time mixer — mirrors the reference's
examples/simple.rs, with the RealtimeDriver standing in for the cpal output
stream (its `read` is what an audio callback would call); twin of
examples/simple.py, whose fixed pull count and warm-up are the module
constants here."""

import time

import numpy as np

import oddio_tpu_torch as pt
from oddio_tpu_torch.control.realtime import RealtimeDriver

#: seconds the "output stream" waits before its first pull
WARMUP_SECS = 0.5
#: 512-frame pulls of the emulated audio callback
PULLS = 90


def main(device=None):
    sample_rate = 48000
    mixer_handle, mixer = pt.Mixer.new(channels=2, device=device)

    # the "output stream": a render thread feeding a wait-free ring
    driver = RealtimeDriver(mixer, sample_rate, block_size=512).start()

    # Start a 400 Hz sine. We can do this as many times as we like, whenever
    # we like, with different types of signals as needed.
    mixer_handle.play(pt.MonoToStereo(pt.Sine(0.0, 400.0)))

    # emulate an audio callback pulling for a second
    time.sleep(WARMUP_SECS)
    frames = []
    for _ in range(PULLS):
        frames.append(driver.read(512))
        time.sleep(512 / sample_rate * 0.5)
    driver.stop()
    out = np.concatenate(frames)
    print(
        f"pulled {len(out)} frames, peak {np.abs(out).max():.3f}, "
        f"underruns {driver.underruns}"
    )
    return driver


if __name__ == "__main__":
    main()
