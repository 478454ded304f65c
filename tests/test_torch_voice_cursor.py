"""The device-resident buffered pool's read cursor against the reference's
delay-ring arithmetic (ring.rs:18-79, tests/reference_impl.py ``ORing``).

The reference keeps one f32 write cursor per voice, advanced modulo the
voice's own ring capacity, and reads each ear at ``(cursor + t*rate)
rem_euclid capacity`` in f32.  The pool's rings share one modulus (16384
at 48 kHz); reading from its shared cursor rounds the same sums at another
magnitude, which moves a read by up to ~1e-3 samples and, summed over 64
voices for 8 s, put the port 1.28e-5 from the exact oracle (ROADMAP Q3.1).
These tests hold the operands the read kernel receives (an int32 pool
index and an f32 fraction per voice and ear) to the reference's cursor,
exactly, with the pool cursor crossing its modulus and reads within a few
samples of it.
"""

import numpy as np
import pytest
import torch

import oddio_tpu_torch as pt
from oddio_tpu_torch import spatial as SP
from oddio_tpu_torch.ops import walk as WALK

torch.set_num_threads(1)

F = np.float32
RATE, BLOCK, CAP = 48000, 512, 16384


def _reference_reads(w0, n_v, t_blocks, adv):
    """The reference ring's reads, block by block: (pool index base, frac)
    per block, voice and ear.  ``w0`` (V,) the voices' cursors after their
    pre-delay, ``n_v`` their capacities, ``t_blocks`` (B, V, 2) each ear's
    read offset in seconds; the pool wrote sample 0 of every voice at
    index 0 (all played before the first block)."""
    w = w0.astype(F).copy()
    lap = -np.ceil(w0).astype(np.int64)  # pool index of voice index 0
    out = []
    for t in t_blocks:
        un = (w + F(adv)).astype(F)
        w = np.fmod(un, n_v.astype(F)).astype(F)
        lap += np.where(un >= n_v, n_v, 0)
        x = (w[:, None] + (t * F(RATE)).astype(F)).astype(F)
        off = np.remainder(x, n_v.astype(F)[:, None]).astype(F)
        fl = np.floor(off)
        base = (lap[:, None] - np.where(x < 0, n_v[:, None], 0) + fl.astype(np.int64)) % CAP
        out.append((base, (off - fl).astype(F)))
    return out


def _record_reads(monkeypatch, scene, pool, nblocks):
    """Render ``nblocks`` single blocks; per block the ears' offsets the
    pool computed (``ear_states_c`` on the previous positions) and the
    (base, frac) operands its read received."""
    offs, reads = [], []
    ear_states = WALK.ear_states_c

    def spy_ears(p3, radius):
        o, g = ear_states(p3, radius)
        offs.append([x.clone() for x in o])
        return o, g

    ring_read = pool._ring_read

    def spy_read(ring, ro, *a, **kw):
        reads.append(([b.clone() for b in ro["base_c"]], [f.clone() for f in ro["frac_c"]]))
        return ring_read(ring, ro, *a, **kw)

    monkeypatch.setattr(WALK, "ear_states_c", spy_ears)
    monkeypatch.setattr(pool, "_ring_read", spy_read)
    r = pt.Renderer(scene, RATE)
    out = np.concatenate([r.render_block(BLOCK) for _ in range(nblocks)])
    assert len(offs) == 2 * nblocks  # the previous and next positions
    return out, offs[0::2], reads


@pytest.mark.parametrize("dist", [0.12, 6.0])
def test_read_cursor_matches_the_reference_ring(monkeypatch, dist):
    """Eight still voices (so each block's ear offsets are the previous
    block's) from ``dist`` m on the right ear's axis outward, 36 blocks:
    the pool cursor passes its 16384 modulus at block 32; at 0.12 m the
    first voice's right ear reads within two samples of it.  Every read
    operand equals the reference ring's."""
    V, NB = 8, 36
    control, scene = pt.SpatialScene.new(device="cpu")
    pos = np.array([[dist + 0.37 * k, 0.0, 0.1 * k] for k in range(V)], F)
    md = F(F(50.0) / SP.SPEED_OF_SOUND + F(0.1))
    for k in range(V):
        control.play_buffered(pt.Sine(0.1 * k, 300.0 + 50.0 * k),
                              pt.SpatialOptions(position=pos[k]), max_distance=50.0,
                              rate=RATE, buffer_duration=0.1)
    pool = next(iter(scene._buffered_pools.values()))
    out, offs, reads = _record_reads(monkeypatch, scene, pool, NB)
    assert len(reads) == NB and np.abs(out).max() > 1e-3

    d = np.minimum(SP.v3_norm(pos) / SP.SPEED_OF_SOUND, md).astype(F)
    w0 = (F(RATE) * d).astype(F)
    n_v = np.full(V, int(np.ceil(md * F(RATE))) + 1, np.int64)
    elapsed = F(F(F(1.0) / F(RATE)) * F(BLOCK))
    adv = F(elapsed * F(RATE))
    t_blocks = [np.maximum((np.stack([o.numpy()[:V] for o in ob], -1) - elapsed).astype(F), -md)
                for ob in offs]
    want = _reference_reads(w0, n_v, t_blocks, adv)
    near = 0
    for b, ((base_c, frac_c), (base, frac)) in enumerate(zip(reads, want)):
        for e in range(2):
            np.testing.assert_array_equal(base_c[e].numpy()[:V].astype(np.int64), base[:, e],
                                          err_msg=f"block {b} ear {e}")
            np.testing.assert_array_equal(frac_c[e].numpy()[:V], frac[:, e],
                                          err_msg=f"block {b} ear {e}")
        near += int((np.minimum(base, CAP - base) < 8).sum())
    assert (near > 0) == (dist < 1.0)  # reads within a few samples of the modulus


def test_voice_read_cursors_wrap_and_previous_lap():
    """``voice_cursor_advance`` and ``voice_reads`` alone at the edges: a
    cursor that wraps its capacity this block, reads that fall in the
    previous lap, and a lap base that wraps the pool modulus."""
    md = F(F(50.0) / SP.SPEED_OF_SOUND + F(0.1))
    c = F(np.ceil(md * F(RATE)) + 1)
    ci = int(c)
    vcur = torch.tensor([c - F(100.25), F(3.5), F(11000.0)])
    vbase = torch.tensor([CAP - ci + 3, 5, 7], dtype=torch.int32)
    t = torch.tensor([F(-0.001), F(-0.02), F(-0.2)])
    vc, vb, cv, _ = WALK.voice_cursor_advance(vcur, vbase, torch.full((3,), md), 512.0, RATE,
                                            CAP)
    reads = WALK.voice_reads(vc, vb, cv, [t], RATE, CAP)
    un = (vcur.numpy() + F(512)).astype(F)
    np.testing.assert_array_equal(vc.numpy(), np.fmod(un, c))
    lap = (np.array([CAP - ci + 3, 5, 7]) + np.where(un >= c, ci, 0)) % CAP
    np.testing.assert_array_equal(vb.numpy(), lap)
    x = (vc.numpy() + (t.numpy() * F(RATE)).astype(F)).astype(F)
    off = np.remainder(x, c).astype(F)
    base, frac = reads[0]
    np.testing.assert_array_equal(frac.numpy(), (off - np.floor(off)).astype(F))
    want = (lap - np.where(x < 0, ci, 0) + np.floor(off).astype(np.int64)) % CAP
    np.testing.assert_array_equal(base.numpy(), want)
    assert (x < 0).any() and (un >= c).any() and (lap < 10).any()


def test_voice_write_counts_follow_the_reference_cursor():
    """``voice_write_count`` (and its host twin) against
    ``ORing``'s ``ceil(end) - ceil(start)`` over 40 blocks of 20000
    cursors, 100 m and 0.1 s as the sampler plays them: 512 a block, 511
    once in the voices whose first-lap cursor rounds to a whole sample;
    the pool's lag (512 a block less the count, summed) is 1 in every
    block after that one."""
    md = F(F(100.0) / SP.SPEED_OF_SOUND + F(0.1))
    c = F(np.ceil(md * F(RATE)) + 1)
    rng = np.random.default_rng(2)
    w = np.fmod((F(RATE) * rng.uniform(0, 0.29, 20000).astype(F)).astype(F), c).astype(F)
    vcur, vbase, hc = torch.as_tensor(w), torch.zeros(len(w), dtype=torch.int32), w.copy()
    maxd = torch.full((len(w),), md)
    lag = torch.zeros(len(w), dtype=torch.int32)
    short = np.zeros(len(w), np.int64)
    for _ in range(40):
        np.testing.assert_array_equal(lag.numpy(), (short > 0).astype(np.int32))
        vc0 = vcur
        vcur, vbase, _, un = WALK.voice_cursor_advance(vc0, vbase, maxd, 512.0, RATE, CAP)
        cnt = WALK.voice_write_count(vc0, vcur, un)
        un = (w + F(512)).astype(F)
        end = np.fmod(un, c).astype(F)
        want = (np.ceil(end) - np.ceil(w)).astype(np.int64) + np.where(un >= c, int(c), 0)
        np.testing.assert_array_equal(cnt.numpy(), want)
        np.testing.assert_array_equal(vcur.numpy(), end)
        h, hc = SP._host_write_counts(hc, np.full(len(w), md, F), 512.0, RATE)
        np.testing.assert_array_equal(h, want)
        lag = lag + 512 - cnt
        short += want == 511
        w = end
    assert set(np.unique(short)) == {0, 1} and 5 < short.sum() < 100


@pytest.mark.parametrize("start", [0, 100 * 128, 3 * 128])
def test_write_before_lands_one_sample_before_the_cursor(start):
    """``_write_before``: a late voice's first sample lands at the pool
    index before the write cursor, primary and (inside the mirror's
    width) mirror, wrapping the modulus at 0; every other leg, and the
    other voices' rows, land in the dump slack past the mirror."""
    control, scene = pt.SpatialScene.new(initial_capacity=4, device="cpu")
    control.play_buffered(pt.Sine(0.0, 440.0), pt.SpatialOptions(position=[1.0, 0.0, 0.0]))
    (pool,) = scene._buffered_pools.values()
    V, FP, cap, M = 4, pool.W_CHUNK, pool.cap_pool, pool.M_PAD
    ring = torch.zeros(pool._ring_shape(V))
    col = torch.arange(1.0, V + 1.0)[:, None]
    late = torch.tensor([True, False, True, False])
    pool._write_before(ring, col, late, torch.tensor([start], dtype=torch.int32), FP, cap, M)
    flat = ring.view(V, pool.rowlen)
    p = (start - 1) % cap
    for v in range(V):
        hit = torch.nonzero(flat[v]).flatten().tolist()
        if late[v]:
            want = [FP + p, FP + p + cap if p < M else FP + cap + M]
            assert hit == want and flat[v, hit].eq(v + 1.0).all()
        else:
            assert hit == [FP + cap + M]


@pytest.mark.parametrize("chain,own", [
    ("sine", False), ("cycle", False), ("fixed_sine", False),
    ("frames", True), ("speed", True), ("fader", True), ("fixed_frames", True)])
def test_only_blockwise_chains_advance_by_their_own_counts(chain, own):
    """A pool's sources advance by their own ring cursors' counts where
    what they render can depend on where a block starts (a control, a
    fade, a FramesSignal's end); a seekable chain that never finishes
    keeps the pool's count and skips that work."""
    fr = pt.Frames.from_slice(44100, np.zeros(1000, F))
    sig = {"sine": lambda: pt.Sine(0.0, 440.0),
           "cycle": lambda: pt.Cycle(fr),
           "fixed_sine": lambda: pt.FixedGain(pt.Sine(0.0, 440.0), -6.0),
           "frames": lambda: pt.FramesSignal(fr, 0.0),
           "speed": lambda: pt.Speed.new(pt.FramesSignal(fr, 0.0))[1],
           "fader": lambda: pt.Fader.new(pt.Speed.new(pt.FramesSignal(fr, 0.0))[1])[1],
           "fixed_frames": lambda: pt.FixedGain(pt.FramesSignal(fr, 0.0), -6.0)}[chain]()
    control, scene = pt.SpatialScene.new(initial_capacity=2, device="cpu")
    control.play_buffered(sig, pt.SpatialOptions(position=[1.0, 0.0, 0.0]))
    (pool,) = scene._buffered_pools.values()
    assert pool._own_counts is own
