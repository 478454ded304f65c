"""The port's example twins (oddio_tpu_torch/examples/) against the repo's
JAX examples (examples/*.py), each run in its own temporary directory on
the CPU.  The offline twins write the same WAV files as their JAX twins,
within one LSB of 16 bits, and print the same lines; game_mix writes
none, and prints the same peak and frequency.  Where a JAX example is slow
at its own constants, both runs shorten it through the same module
constant.  The real-time twins print their JAX twins' lines (their values
depend on timing: underruns, and where the orbit stands per pulled block)
with audio that is there and sane."""

import importlib
import importlib.util
import re
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from oddio_tpu_torch.utils.wav import read_wav  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
#: example -> (the WAV it writes or None, module constants shortened in both runs)
OFFLINE = {
    "offline": ("offline.wav", {"DURATION_SECS": 1}),
    "wav_playback": ("wav_playback.wav", {}),
    "adapt_agc": ("adapt.wav", {"DURATION_SECS": 1}),
    "crossfade_beds": ("crossfade_beds.wav", {}),
    "game_mix": (None, {}),
}


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(f"_jax_example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(mod, where, monkeypatch, capsys, consts, **kw):
    where.mkdir()
    monkeypatch.chdir(where)
    for k, v in consts.items():
        monkeypatch.setattr(mod, k, v)
    mod.main(**kw)
    return capsys.readouterr().out.splitlines()


def _pcm(path):
    import wave

    with wave.open(str(path), "rb") as w:
        return (np.frombuffer(w.readframes(w.getnframes()), "<i2").astype(np.int32),
                w.getnchannels(), w.getframerate())


@pytest.mark.parametrize("name", sorted(OFFLINE))
def test_torch_example_twin_matches_jax(name, tmp_path, monkeypatch, capsys):
    wav, consts = OFFLINE[name]
    monkeypatch.setattr(sys, "argv", [sys.argv[0]])  # wav_playback reads argv[1]
    jout = _run(_jax_example(name), tmp_path / "jax", monkeypatch, capsys, consts)
    pout = _run(importlib.import_module(f"oddio_tpu_torch.examples.{name}"),
                tmp_path / "port", monkeypatch, capsys, consts, device="cpu")
    assert pout == jout and pout
    if wav is None:
        return
    (a, ca, ra), (b, cb, rb) = _pcm(tmp_path / "jax" / wav), _pcm(tmp_path / "port" / wav)
    assert (ca, ra, a.shape) == (cb, rb, b.shape)
    assert np.abs(a - b).max() <= 1
    assert np.abs(b).max() > 1000
    data, rate = read_wav(str(tmp_path / "port" / wav))
    assert rate == rb and np.isfinite(data).all()


def _line_format(line):
    return re.sub(r"-?\d+(\.\d+)?", "#", line)


def test_torch_example_twin_simple(tmp_path, monkeypatch, capsys):
    """examples/simple.py's lines: the 400 Hz sine comes through the
    driver at full scale."""
    from oddio_tpu_torch.examples import simple

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(simple, "WARMUP_SECS", 0.3)
    monkeypatch.setattr(simple, "PULLS", 40)
    drv = simple.main(device="cpu")
    (line,) = capsys.readouterr().out.splitlines()
    assert _line_format(line) == "pulled # frames, peak #, underruns #"
    assert line.startswith(f"pulled {40 * 512} frames, peak 1.000")
    assert drv.error is None and drv.blocks > 0 and not drv.alive()


def test_torch_example_twin_realtime_spatial(tmp_path, monkeypatch, capsys):
    """examples/realtime_spatial.py's lines: the orbiting source moves from
    the right ear (+x) across the front to the left."""
    from oddio_tpu_torch.examples import realtime_spatial

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(realtime_spatial, "RENDERED_SECS", 0.75)
    drv, out = realtime_spatial.main(device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert [_line_format(x) for x in lines] == [
        "start: L #  R #", "mid: L #  R #", "end: L #  R #",
        "underruns: #, finished: False"]
    assert np.isfinite(out).all() and np.abs(out).max() > 1e-3
    start = np.sqrt((out[: len(out) // 3] ** 2).mean(axis=0))
    assert start[1] > start[0]  # a source at +x: right ear louder
    assert drv.error is None and drv.blocks > 0
