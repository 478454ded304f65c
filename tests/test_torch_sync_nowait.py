"""``SpatialScene.sync()`` after ``sync_prefetch()``: the handle-state sync
reclaims from the newest prefetched digest instead of reading, and
waiting for, the current state.  On the CPU: a stale digest never frees a
slot played after it was taken, a finish shows at most one call later than
with no prefetch and never before the voice stopped, a sync with no digest
prefetched reads the current state, and a pool that does not count its
plays (the mixer's) reads past a stale digest.  (On the card,
``tests/test_torch_cuda.py`` holds that it leaves the call in flight
alone.)  Needs no JAX."""

import numpy as np
import pytest
import torch

import oddio_tpu_torch as pt

torch.set_num_threads(1)

F = np.float32
SR, RATE, BLOCK = 44100, 48000, 512


def _scene(capacity=2):
    control, scene = pt.SpatialScene.new(initial_capacity=capacity, device="cpu")
    return control, scene, pt.Renderer(scene, RATE)


def _sound(seconds, f=440.0):
    t = np.arange(int(seconds * SR)) / SR
    return pt.Frames.from_slice(SR, (0.5 * np.sin(2 * np.pi * f * t)).astype(F))


def _play(control, frames, pos=(1.0, 0.0, 0.0)):
    return control.play_buffered(pt.FramesSignal(frames, 0.0), pt.SpatialOptions(position=pos),
                                 max_distance=100.0, rate=RATE, buffer_duration=0.1)


def _pool(scene):
    (pool,) = scene._buffered_pools.values()
    return pool


def test_a_stale_digest_never_frees_a_slot_played_after_it():
    control, scene, r = _scene()
    short = _sound(0.05)
    a = _play(control, short)
    r.render_frames_device(12 * BLOCK, sync=False)  # a ends, lingers, stops
    scene.sync_prefetch()
    scene.sync()
    assert a.is_finished()
    pool = _pool(scene)
    slot = a._slot
    b = _play(control, _sound(1.0, 660.0))
    assert b._slot == slot  # the freed slot, played again
    # a digest taken while b's play is queued: it still shows a's stop
    scene.sync_prefetch()
    out = r.render_frames_device(4 * BLOCK, sync=False)
    scene.sync()
    assert not b.is_finished() and pool.mask_host[slot]
    assert slot not in pool._free
    # b plays on: the next blocks carry it
    out = torch.cat(r.render_frames_device(8 * BLOCK, sync=False))
    assert float(out.abs().max()) > 1e-3
    scene.sync()
    assert not b.is_finished()


def test_the_guard_is_what_keeps_the_slot():
    """The same digest applied without its play counts frees the new voice:
    the guard, not chance, keeps it."""
    control, scene, r = _scene()
    a = _play(control, _sound(0.05))
    r.render_frames_device(12 * BLOCK, sync=False)
    scene.sync()
    assert a.is_finished()
    pool = _pool(scene)
    b = _play(control, _sound(1.0, 660.0))
    pool._sync_start()
    key, packed, event, epochs, V = pool._sync_pack
    pool._sync_pack = None
    r.render_frames_device(2 * BLOCK, sync=False)
    bits = np.unpackbits(packed.numpy())
    mask, stopped = bits[:V].astype(bool), bits[V:2 * V].astype(bool)
    pool._sync_apply(mask, stopped, epochs)
    assert not b.is_finished()
    pool._sync_apply(mask, stopped)
    assert b.is_finished()


def _finishes(prefetch, calls=14, per=4):
    """The call at which each of a few one-shots' handles first shows it
    finished, syncing before every call (with ``prefetch``, prefetching
    after the sync), and the rendered PCM."""
    control, scene, r = _scene(capacity=4)
    hs = [_play(control, _sound(s, f), pos) for s, f, pos in
          ((0.1, 300.0, (2.0, 0.0, 0.0)), (0.2, 500.0, (0.0, 5.0, 1.0)),
           (0.15, 700.0, (-8.0, 0.0, 3.0)), (0.3, 900.0, (0.0, 0.0, -12.0)))]
    seen, out = {}, []
    for call in range(calls):
        scene.sync()
        for i, h in enumerate(hs):
            if i not in seen and h.is_finished():
                seen[i] = call
        if prefetch:
            scene.sync_prefetch()
        out += r.render_frames_device(per * BLOCK, sync=False)
    return seen, torch.cat(out)


def test_a_finish_shows_at_most_one_call_late():
    now, pcm_now = _finishes(False)
    late, pcm_late = _finishes(True)
    assert set(now) == set(late) == {0, 1, 2, 3}
    for i in now:
        assert now[i] <= late[i] <= now[i] + 1, (i, now[i], late[i])
    assert any(late[i] == now[i] + 1 for i in now)
    # the audio does not depend on when the host learns of a finish
    assert torch.equal(pcm_now, pcm_late)


@pytest.mark.parametrize("how", ["scene", "handle"])
def test_without_a_prefetch_sync_reads_the_current_state(how):
    """``scene.sync()``, or the sync a handle query makes itself."""
    control, scene, r = _scene()
    a = _play(control, _sound(0.05))
    r.render_frames_device(12 * BLOCK, sync=False)
    assert getattr(_pool(scene), "_sync_pack", None) is None
    if how == "scene":
        scene.sync()
    assert a.is_finished()


def test_the_plain_sync_reads_past_a_stale_prefetch():
    """A pool that does not count its plays (a mixer's device-resident
    pool) cannot guard a stale digest, so it reads the current state;
    a scene's pool reclaims from the stale digest, and its next sync,
    with none prefetched, from the current state."""
    control, mixer = pt.Mixer.new(channels=1, device="cpu")
    r = pt.Renderer(mixer, RATE)
    h = control.play(pt.FramesSignal(_sound(0.02), 0.0))
    r.render_frames_device(BLOCK, sync=False)
    mixer.sync_prefetch()  # taken after the first block: the voice plays
    r.render_frames_device(4 * BLOCK, sync=False)
    mixer.sync()
    assert h.is_stopped()
    control, scene, r = _scene()
    a = _play(control, _sound(0.05))
    r.render_frames_device(BLOCK, sync=False)
    scene.sync_prefetch()
    assert _pool(scene)._sync_pack is not None
    r.render_frames_device(11 * BLOCK, sync=False)
    scene.sync()
    assert not a.is_finished()
    scene.sync()
    assert a.is_finished()


def test_a_digest_taken_before_growth_frees_only_its_own_rows():
    control, scene, r = _scene(capacity=2)
    a = _play(control, _sound(0.05))
    r.render_frames_device(12 * BLOCK, sync=False)
    scene.sync_prefetch()  # two rows: a's stop
    more = [_play(control, _sound(1.0, 300.0 + 100 * k)) for k in range(3)]
    pool = _pool(scene)
    assert pool.capacity == 4
    r.render_frames_device(2 * BLOCK, sync=False)
    scene.sync()
    assert a.is_finished() and not any(h.is_finished() for h in more)
    assert int(pool.mask_host.sum()) == 3
