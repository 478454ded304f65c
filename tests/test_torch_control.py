"""The port's native control plane (oddio_tpu_torch/control/native.py)
and RealtimeDriver (control/realtime.py): twins of tests/test_native.py's
ring, swap, stress and driver tests over the port's bindings, the library
build's location and process safety, and the driver's exactness: the
blocks the callback side reads equal a Renderer's, bit for bit."""

import multiprocessing as mp
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import oddio_tpu_torch as pt
from oddio_tpu_torch.control import native
from oddio_tpu_torch.control.native import SpscRing, Swap
from oddio_tpu_torch.control.realtime import RealtimeDriver

torch.set_num_threads(1)


def test_torch_ring_fill_and_wrap():
    """spsc.rs wrap/fill/excess semantics: partial writes, ordered reads."""
    r = SpscRing(4)
    assert r.write([1.0, 2.0, 3.0]) == 3
    assert r.write([4.0, 5.0]) == 1  # partial: only one slot free
    np.testing.assert_array_equal(r.read(2), [1.0, 2.0])
    assert r.write([6.0, 7.0]) == 2
    np.testing.assert_array_equal(r.read(10), [3.0, 4.0, 6.0, 7.0])
    assert r.readable() == 0
    assert r.writable() == 4


def test_torch_swap_freshness():
    """swap.rs:86-104: the receiver sees the latest flushed value; refresh
    reports freshness exactly once per publish."""
    s = Swap(np.float32([1.0, 2.0, 3.0]))
    fresh, v = s.refresh()
    assert not fresh
    np.testing.assert_array_equal(v, [1.0, 2.0, 3.0])
    s.publish(np.float32([4.0, 5.0, 6.0]))
    s.publish(np.float32([7.0, 8.0, 9.0]))  # last wins
    fresh, v = s.refresh()
    assert fresh
    np.testing.assert_array_equal(v, [7.0, 8.0, 9.0])
    fresh, v = s.refresh()
    assert not fresh
    with pytest.raises(ValueError):
        s.publish(np.float32([1.0, 2.0]))


def test_torch_ring_cross_thread_stress():
    """Producer/consumer on separate threads move 200k samples intact."""
    r = SpscRing(1024)
    N = 200_000
    src = np.arange(N, dtype=np.float32)
    got = []

    def produce():
        i = 0
        while i < N:
            i += r.write(src[i : i + 256])

    def consume():
        total = 0
        while total < N:
            chunk = r.read(256)
            if len(chunk):
                got.append(chunk)
                total += len(chunk)

    t1 = threading.Thread(target=produce)
    t2 = threading.Thread(target=consume)
    t1.start(); t2.start()
    t1.join(timeout=30); t2.join(timeout=30)
    np.testing.assert_array_equal(np.concatenate(got), src)


def _load_in_child(q, build_dir):
    native.BUILD_DIR = Path(build_dir)
    native.load()
    q.put(str(native.library_path()))


def test_torch_library_builds_under_the_package_once_per_source(tmp_path):
    """The library lives under oddio_tpu_torch/_build/, named by the
    source's hash; processes building at once each load a whole library
    (a temporary file moved into place)."""
    so = native.library_path()
    assert so.parent.name == "_build" and so.parent.parent.name == "oddio_tpu_torch"
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_load_in_child, args=(q, str(tmp_path))) for _ in range(3)]
    for p in procs:
        p.start()
    paths = {q.get(timeout=120) for _ in procs}  # drained before the joins
    for p in procs:
        p.join(timeout=60)
        assert p.exitcode == 0
    assert len(paths) == 1 and paths.pop() == str(tmp_path / so.name)
    assert [p.name for p in tmp_path.iterdir()] == [so.name]


def test_torch_play_between_prepare_and_render_waits_a_block():
    """A play from another thread can land between a block's host_prepare
    and its render (the driver's render thread): the new pool sits that
    block out and plays from the next, in both engines."""
    def mixer():
        control, eng = pt.Mixer.new(channels=1, device="cpu")
        control.play(pt.Sine(0.0, 300.0))
        return eng, lambda: control.play(pt.Speed.new(pt.Sine(0.0, 500.0))[1])

    def scene():
        control, eng = pt.SpatialScene.new(device="cpu")
        control.play(pt.Sine(0.0, 300.0), pt.SpatialOptions())
        return eng, lambda: control.play_buffered(pt.Sine(0.0, 500.0), pt.SpatialOptions())

    for make in (mixer, scene):
        eng, play_new_pool = make()
        params = eng.host_prepare(np.float32(1 / 8000), 64)
        play_new_pool()
        d2, block = eng.render(eng.device_collect(), eng.device_data(), params, 64)
        eng.device_store(d2)
        assert torch.isfinite(block).all()
        r = pt.Renderer(eng, 8000)
        assert np.abs(r.render_block(64)).max() > 0


def test_torch_realtime_driver_roundtrip():
    """The render thread keeps the output ring fed; the callback side reads
    a continuous sine; controls apply at block granularity."""
    control, mixer = pt.Mixer.new(channels=2, device="cpu")
    h = control.play(pt.MonoToStereo(pt.Sine(0.0, 440.0)))
    drv = RealtimeDriver(mixer, 8000, block_size=256, lead_blocks=4).start()
    try:
        deadline = time.time() + 60
        while time.time() < deadline:
            if np.abs(drv.read(128)).max() > 0:
                break
            time.sleep(0.01)
        chunks = []
        for _ in range(16):
            while drv._ring.readable() < 128 * 2:
                time.sleep(0.001)
            chunks.append(drv.read(128))
        out = np.concatenate(chunks)
        tail = out[-1024:, 0]
        assert np.abs(tail).max() > 0.9
        spec = np.abs(np.fft.rfft(tail * np.hanning(len(tail))))
        assert np.argmax(spec) * 8000 / len(tail) == pytest.approx(440.0, abs=16)
        h.stop()
        time.sleep(0.2)
        drv.read(4096)  # drain
        time.sleep(0.05)
        drv.read(4096)
        assert np.abs(drv.read(256)).max() == 0.0
        assert drv.alive() and drv.error is None and drv.blocks > 0
        assert drv.meter.frames == drv.blocks * 256
    finally:
        drv.stop()
    assert not drv.alive()


def test_torch_realtime_driver_matches_a_renderer_bit_for_bit():
    """``test_torch_cuda.py``'s driver test at 64 voices: the config-5 mixer, its
    PCM fed before start(); the callback side reads 512 frames whenever
    512*C are readable, 32 blocks in all; their concatenation is a second,
    identically built mixer's render_block loop."""
    from oddio_tpu_torch.utils.scene_profile import build_mixer_agc

    _, mixer, _, _ = build_mixer_agc(64, "cpu")
    _, twin, _, _ = build_mixer_agc(64, "cpu")
    drv = RealtimeDriver(mixer, 48000, block_size=512, lead_blocks=4).start()
    got = []
    try:
        deadline = time.time() + 60
        while len(got) < 32 and time.time() < deadline:
            if drv._ring.readable() >= 512 * drv.channels:
                got.append(drv.read(512))
            else:
                time.sleep(0.0005)
        assert drv.alive() and drv.error is None
        assert drv.blocks >= 32 and len(got) == 32
    finally:
        drv.stop()
    r = pt.Renderer(twin, 48000)
    want = np.concatenate([r.render_block(512) for _ in range(32)])
    np.testing.assert_array_equal(np.concatenate(got), want)


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_torch_realtime_driver_reports_a_dead_render_thread():
    """A render thread that raises ends, and says why: a caller tells that
    from silence."""

    class Broken(pt.Sine):
        def host_prepare(self, interval, n, count=None):
            raise RuntimeError("planted")

    drv = RealtimeDriver(Broken(0.0, 1.0), 8000, device="cpu")
    drv.start()
    drv._thread.join(timeout=10)
    assert not drv.alive() and isinstance(drv.error, RuntimeError)
