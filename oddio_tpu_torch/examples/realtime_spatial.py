"""Real-time spatial scene with live motion — mirrors the reference's
examples/realtime.rs: a source orbiting the listener, motion updated from
the control thread each tick, audio pulled by the callback side (twin of
examples/realtime_spatial.py, whose rendered length is the module constant
here)."""

import time

import numpy as np

import oddio_tpu_torch as pt
from oddio_tpu_torch.control.realtime import RealtimeDriver

RATE = 48000
#: seconds of orbit pulled after the warm-up
RENDERED_SECS = 1.5


def main(device=None):
    scene_handle, scene = pt.SpatialScene.new(device=device)
    driver = RealtimeDriver(scene, RATE, block_size=512).start()

    handle = scene_handle.play_buffered(
        pt.Sine(0.0, 440.0),
        pt.SpatialOptions(position=[5.0, 0.0, 0.0]),
        max_distance=30.0,
        rate=RATE,
        buffer_duration=0.1,
    )

    # warm up: wait for the render thread to build its kernels and start
    # producing audio
    handle.set_motion([5.0, 0.0, 0.0], [0.0, 0.0, 0.0], False)
    for _ in range(1200):
        if np.abs(driver.read(512)).max() > 0:
            break
        time.sleep(0.05)
    driver.underruns = 0

    # orbit at 1 rev / 2 s, radius 5 m; motion is paced by *rendered* time so
    # the demo is correct on any machine (on the card the loop runs in real
    # time; on a CPU it may render slower than the wall clock)
    frames = []
    rendered = 0.0
    while rendered < RENDERED_SECS:
        ang = rendered * np.pi
        pos = [5 * np.cos(ang), 0.0, -5 * np.sin(ang)]
        vel = [-5 * np.pi * np.sin(ang), 0.0, -5 * np.pi * np.cos(ang)]
        handle.set_motion(pos, vel, False)
        while driver._ring.readable() < 512 * 2:
            if not driver.alive():
                raise RuntimeError("the render thread ended") from driver.error
            time.sleep(0.002)
        frames.append(driver.read(512))
        rendered += 512 / RATE
    driver.stop()
    scene.sync()
    out = np.concatenate(frames)
    n3 = len(out) // 3
    for i, name in enumerate(("start", "mid", "end")):
        seg = out[i * n3 : (i + 1) * n3]
        l, rr = np.sqrt((seg**2).mean(axis=0))
        print(f"{name}: L {l:.4f}  R {rr:.4f}")
    print(f"underruns: {driver.underruns}, finished: {handle.is_finished()}")
    return driver, out


if __name__ == "__main__":
    main()
