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
    ear_states = SP.ear_states_c

    def spy_ears(p3, radius):
        o, g = ear_states(p3, radius)
        offs.append([x.clone() for x in o])
        return o, g

    ring_read = pool._ring_read

    def spy_read(ring, ro, *a, **kw):
        reads.append(([b.clone() for b in ro["base_c"]], [f.clone() for f in ro["frac_c"]]))
        return ring_read(ring, ro, *a, **kw)

    monkeypatch.setattr(SP, "ear_states_c", spy_ears)
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
    """``voice_read_cursors`` alone at the edges: a cursor that wraps its
    capacity this block, reads that fall in the previous lap, and a lap
    base that wraps the pool modulus."""
    md = F(F(50.0) / SP.SPEED_OF_SOUND + F(0.1))
    c = F(np.ceil(md * F(RATE)) + 1)
    ci = int(c)
    vcur = torch.tensor([c - F(100.25), F(3.5), F(11000.0)])
    vbase = torch.tensor([CAP - ci + 3, 5, 7], dtype=torch.int32)
    t = torch.tensor([F(-0.001), F(-0.02), F(-0.2)])
    vc, vb, reads = SP.voice_read_cursors(vcur, vbase, torch.full((3,), md), 512.0, [t],
                                          RATE, CAP)
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
