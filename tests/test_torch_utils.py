"""The port's host utilities against the JAX package's: WAV I/O
(oddio_tpu_torch/utils/wav.py), the xRT meter and the trace
(utils/profiler.py), the public names, and the carry of a host-pool
Fader mid-fade with fades queued (utils/convert.py)."""

import json
import os
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import oddio_tpu as ot  # noqa: E402
import oddio_tpu_torch as pt  # noqa: E402
from oddio_tpu.utils import wav as owav  # noqa: E402
from oddio_tpu_torch.utils import profiler as pprof  # noqa: E402
from oddio_tpu_torch.utils import wav as pwav  # noqa: E402
from oddio_tpu_torch.utils.convert import carry_mixer  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-5


@pytest.mark.parametrize("shape", [(1000,), (700, 2), (333, 3)])
def test_torch_write_wav_bytes_equal_jax(tmp_path, shape):
    x = np.random.default_rng(0).uniform(-1.3, 1.3, shape).astype(np.float32)
    pj, pp = tmp_path / "j.wav", tmp_path / "p.wav"
    owav.write_wav(str(pj), x, 44100)
    pwav.write_wav(str(pp), x, 44100)
    assert pj.read_bytes() == pp.read_bytes()


def test_torch_read_wav_round_trips(tmp_path):
    x = np.random.default_rng(1).uniform(-1, 1, (500, 2)).astype(np.float32)
    path = str(tmp_path / "x.wav")
    pt.write_wav(path, x, 22050)
    y, rate = pt.read_wav(path)
    assert rate == 22050 and y.shape == x.shape and y.dtype == np.float32
    assert np.abs(y - x).max() <= 1.0 / 32767.0
    yj, _ = ot.read_wav(path)
    np.testing.assert_array_equal(y, yj)
    pt.write_wav(path, x[:, 0], 8000)
    y1, _ = pt.read_wav(path)
    assert y1.shape == (500,)


def test_torch_public_names_match_jax():
    assert set(pt.__all__) == set(ot.__all__)
    for name in pt.__all__:
        assert getattr(pt, name) is not None
    xs = np.arange(8, dtype=np.float32)
    np.testing.assert_array_equal(pt.frame_stereo(xs), ot.frame_stereo(xs))
    np.testing.assert_array_equal(pt.flatten_stereo(pt.frame_stereo(xs)), xs)
    assert pt.Sample is float


def test_torch_xrt_meter_counts_audio_and_wall_time():
    meter = pt.XrtMeter(48000, device="cpu")
    assert meter.xrt() == float("inf")
    _, mixer = pt.Mixer.new(channels=1, device="cpu")
    r = pt.Renderer(mixer, 48000)
    for _ in range(3):
        with meter.block(480):
            r.render_block(480)
            time.sleep(0.001)
    assert meter.frames == 1440 and meter.audio_seconds() == pytest.approx(0.03)
    assert meter.wall >= 0.003 and meter.xrt() == pytest.approx(0.03 / meter.wall)
    meter.reset()
    assert meter.frames == 0 and meter.wall == 0.0


def test_torch_device_trace_writes_a_trace_on_the_cpu(tmp_path):
    control, mixer = pt.Mixer.new(channels=1, device="cpu")
    control.play(pt.Sine(0.0, 440.0))
    r = pt.Renderer(mixer, 8000)
    with pprof.device_trace(str(tmp_path / "trace")) as prof:
        r.render_frames(1024)
    path = tmp_path / "trace" / "trace.json"
    assert path.exists() and os.path.getsize(path) > 0
    assert len(prof.key_averages()) > 0
    # the program's spans ride in the file, on the timeline of its events
    events = json.loads(path.read_text())["traceEvents"]
    calls = [e for e in events if e.get("cat") == "oddio_tpu_torch" and e["name"] == "render.call"]
    assert len(calls) == 1
    a, b = calls[0]["ts"], calls[0]["ts"] + calls[0]["dur"]
    ops = [e for e in events if e.get("cat") == "cpu_op" and e.get("ph") == "X"]
    assert ops and all(a <= e["ts"] <= e["ts"] + e["dur"] <= b for e in ops)


def _host_sine(m):
    class HostSine(m.Sine):
        """A Sine kept off the device-resident pools: a Fader over it takes
        the host pool's two-bank form (one class name in both packages:
        the carry pairs chains by node type)."""

        def dr_supported(self):
            return False

    return HostSine


def test_torch_carry_host_pool_fader_mid_fade_with_fades_queued():
    """A JAX host-pool Fader with a fade in flight, a fade waiting behind it
    and a fade released since its script issued it carries into the port's
    mixer built by the same script; both then render the same blocks."""
    def script(m):
        rng = np.random.default_rng(2)
        kw = {"device": "cpu"} if m is pt else {}
        control, mixer = m.Mixer.new(channels=1, **kw)
        fcs = []
        for _ in range(3):
            fc, f = m.Fader.new(_host_sine(m)(rng.uniform(0, 6), rng.uniform(100, 900)))
            control.play(f)
            fcs.append(fc)
        return mixer, fcs

    jm, jf = script(ot)
    pm, pf = script(pt)
    assert [type(p).__name__ for p in pm._pools.values()] == ["Pool"]
    rj = ot.Renderer(jm, 8000)
    rj.render_frames(512)
    for fcs, m in ((jf, ot), (pf, pt)):
        fcs[0].fade_to(_host_sine(m)(0.1, 250.0), 0.2)  # in flight at the carry
        fcs[1].fade_to(_host_sine(m)(0.2, 330.0), 0.01)  # released and done
    rj.render_frames(512)
    for fcs, m in ((jf, ot), (pf, pt)):
        fcs[0].fade_to(_host_sine(m)(0.3, 700.0), 0.05)  # waits
    carry_mixer(jm, pm)
    rp = pt.Renderer(pm, 8000)
    a = rj.render_frames(512 * 8)
    b = rp.render_frames(512 * 8)
    assert np.abs(a).max() > 0.1
    assert np.abs(a - b).max() <= TOL, np.abs(a - b).max()
    pool = next(iter(pm._pools.values()))
    assert not pool.sig._pending_fades  # the waiting fade was released
