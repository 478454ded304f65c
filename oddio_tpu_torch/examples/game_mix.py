"""A game-style mix: many gain-automated sound effects, a music bed that
crossfades between tracks (a pooled Fader voice), and a one-shot sample —
all inside one Mixer, every control event a sparse delta (twin of
examples/game_mix.py).

Mirrors the reference's composition freedom (mixer.rs:18-26 boxes any
Signal, fader.rs crossfades): here the Gain/Fader voices ride the
device-resident pools.
"""

import numpy as np

import oddio_tpu_torch as pt


def main(device=None):
    rate = 48000
    rng = np.random.default_rng(0)
    control, mixer = pt.Mixer.new(channels=1, device=device)

    # a bed of gain-automated effects (device-resident Gain ramps)
    effects = []
    for _ in range(64):
        gc, g = pt.Gain.new(pt.Sine(rng.uniform(0, 6), rng.uniform(100, 3000)))
        gc.set_gain(rng.uniform(-30, -12))
        effects.append(gc)
        control.play(g)

    # music: a Fader voice crossfading between two "tracks"
    fade, music = pt.Fader.new(pt.FixedGain(pt.Sine(0.0, 220.0), -6.0))
    control.play(music)

    # a one-shot sample
    click = pt.Frames.from_slice(
        rate, (np.hanning(480) * np.sin(np.linspace(0, 60, 480))).astype(np.float32)
    )
    control.play(pt.FramesSignal(click, 0.0))

    r = pt.Renderer(mixer, rate)
    out = [r.render_frames(rate // 2)]

    # duck half the effects and crossfade the music (0.5 s, constant power)
    for gc in effects[::2]:
        gc.set_gain(-60.0)
    fade.fade_to(pt.FixedGain(pt.Sine(0.0, 330.0), -6.0), 0.5)
    out.append(r.render_frames(rate))

    audio = np.concatenate(out)
    print(f"rendered {len(audio)} frames, peak {np.abs(audio).max():.3f}")
    spec = np.abs(np.fft.rfft(audio[-rate // 2 :, 0]))
    print(f"music now at ~{np.argmax(spec[:2000]) * rate / (rate // 2):.0f} Hz")


if __name__ == "__main__":
    main()
