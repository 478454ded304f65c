"""Minimal WAV I/O (the reference's examples use `hound` for this;
dev-dependency territory, reference Cargo.toml:21-23)."""

from __future__ import annotations

import wave

import numpy as np

__all__ = ["read_wav", "write_wav"]


def read_wav(path):
    """Read a WAV file into (float32 samples (n,) or (n, C), rate)."""
    with wave.open(path, "rb") as w:
        rate = w.getframerate()
        channels = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32767.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483647.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 127.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if channels > 1:
        data = data.reshape(-1, channels)
    return data, rate


def write_wav(path, samples, rate):
    """Write float32 samples ((n,) mono or (n, C)) as 16-bit PCM."""
    samples = np.asarray(samples, np.float32)
    channels = 1 if samples.ndim == 1 else samples.shape[1]
    pcm = (np.clip(samples, -1.0, 1.0) * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(int(rate))
        w.writeframes(pcm.tobytes())
