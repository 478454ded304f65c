"""K2/K3 read straight from the ring (``ring_kernels.ring_select_ears``,
``ring_select_multi``), on the CPU, against the read the buffered pool
made before it and against the JAX package.

* The ring-direct plain versions equal, bit for bit, the window gather the
  pool used to make (``_parent_ears``: ``_windows_read``'s granule gather
  fed to ``window_select_ears_plain``; ``_parent_multi``: ``render_multi``'s
  superwindow fed to ``window_select_multi_plain``): the main pass with
  and without ``tight``, the sub-pass list, the scene axis, frozen voices,
  reads that end in the mirror, several read chunks, and K3 groups whose
  superwindow wraps the ring's modulus or whose coarse shift clamps.
* The ring form is within 1e-6 of the JAX package's own read
  (``_BufferedPoolDR._windows_read`` over the interpreted Pallas kernel)
  and of the interpreted ``window_select_tiles_multi`` on the superwindow.
* Whole renders (a buffered scene with fused idle groups, a sub-pass
  scene, a 4-scene spatial pack) are bit-equal with the pool's read
  swapped back to the gather form.
* The wrappers refuse operands the kernel does not take.

The CUDA kernel is held to these plain versions in test_torch_cuda.py.
"""

import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import oddio_tpu_torch as pt  # noqa: E402
import oddio_tpu_torch.spatial as SP  # noqa: E402
from oddio_tpu import spatial as JSP  # noqa: E402
from oddio_tpu.ops import pallas_ring as PR  # noqa: E402
from oddio_tpu_torch.ops import ring_kernels as RK  # noqa: E402
from oddio_tpu_torch.ops._dev import device_advance, device_split_ds  # noqa: E402
from oddio_tpu_torch.utils.scene_profile import build_spatial, build_spatial_pack  # noqa: E402

torch.set_num_threads(1)

#: a buffered pool's row at a small modulus: front pad, ring, mirror, slack
FP, CAP, M = 1024, 4096, 1024
RPV = (FP + CAP + M + 1024) // 128
DMAX = 33  # the inter-ear stagger bound at 48 kHz (the pool's emax2)
GEOM = dict(DMAX=DMAX, FP=FP, cap=CAP)


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


# --- the parent's read: gather the windows, then the wide-window plain K2/K3 ---


def _parent_ear_starts(base_c, cap, DMAX, K, FP):
    ob0 = torch.remainder(base_c[0], cap)
    ob1 = torch.remainder(base_c[1], cap)
    dlr = torch.remainder(ob0 - ob1, cap)
    l_ahead = dlr <= DMAX
    cm = torch.where(l_ahead, ob1, ob0)
    dstart = [
        torch.where(l_ahead, dlr, 0).clamp(0, DMAX),
        torch.where(l_ahead, 0, cap - dlr).clamp(0, DMAX),
    ]
    return torch.remainder(cm - K, cap) + FP, dstart


def _parent_ears(ring, ro, *, n, K, R, DMAX, FP, cap, tight=None, sub_idx=None,
                 sub_on=None, scenes=None):
    """The pool's read before the ring-direct kernel: per chunk, each voice's
    window gathered off whole 1024-column granules, then K2's wide form."""
    V, rpv = ring.shape[:2]
    PW, GW = 128, 1024
    rows8 = ring.view(V * (rpv // 8), 8, PW)
    base_c, frac_c = list(ro["base_c"]), list(ro["frac_c"])
    split_c, p_gain_c, d_gain_c = ro["split_c"], ro["p_gain_c"], ro["d_gain_c"]
    maskf = ro["maskf"]
    if sub_idx is None:
        vbase = torch.arange(V, dtype=torch.int32) * (rpv // 8)
        frz_c = [f[:, None] for f in ro["frz_c"]]
        if tight is not None:
            maskf = maskf * tight
    else:
        si = sub_idx.to(torch.int64)
        vbase = sub_idx * (rpv // 8)
        base_c = [b[si] for b in base_c]
        frac_c = [f[si] for f in frac_c]
        split_c = [tuple(x[si] for x in s) for s in split_c]
        p_gain_c = [g[si] for g in p_gain_c]
        d_gain_c = [g[si] for g in d_gain_c]
        maskf = maskf[si] * sub_on
        frz_c = None
    emax2r = PW - 1 + DMAX
    Vr = base_c[0].shape[0]
    parts = []
    for j0 in range(0, n, R):
        n_c = min(R, n - j0)
        rstart, dstart = _parent_ear_starts(base_c, cap, DMAX, K, FP)
        ngr = -(-(GW - 1 + RK.select_window(n_c, emax2r, K)) // GW)
        r0 = _fdiv(rstart, GW)
        ridx = (vbase[:, None] + r0[:, None]
                + torch.arange(ngr, dtype=torch.int32)[None, :]).reshape(-1).to(torch.int64)
        wide = rows8.index_select(0, ridx).reshape(Vr, ngr * GW)
        rowshift = _fdiv(rstart - r0 * GW, PW)
        exr = torch.remainder(rstart, PW)
        scal01, g01, e01 = [], [], []
        for e in range(2):
            ds_e, fh_e, fl_e = split_c[e]
            scal01.append(torch.stack([frac_c[e], fh_e, fl_e, ds_e.to(torch.float32)], dim=-1))
            g0_e = (p_gain_c[e] + float(j0) * d_gain_c[e]) * maskf
            g01.append(torch.stack([g0_e, d_gain_c[e] * maskf], dim=-1))
            e01.append((exr + dstart[e]).to(torch.int32)[:, None])
        parts.append(RK.window_select_ears_plain(
            wide, rowshift, scal01, g01, e01, n=n_c, K=K, emax2=emax2r, hmax=GW // PW,
            frz01=frz_c, scenes=scenes))
        if j0 + n_c < n:
            for e in range(2):
                base_c[e], frac_c[e] = device_advance(base_c[e], frac_c[e], n_c, *split_c[e])
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def _parent_multi(ring, ros, *, n, K, DMAX, FP, cap, row0s, hs):
    """``render_multi``'s read before the ring-direct kernel: one
    superwindow per voice, whole granules wrapped modulo cap/1024, then
    K3's wide form."""
    V, rpv = ring.shape[:2]
    nb = len(ros)
    PW, GW = 128, 1024
    FPG, capg = FP // GW, cap // GW
    rows8 = ring.view(V * (rpv // 8), 8, PW)
    vb8 = torch.arange(V, dtype=torch.int32) * (rpv // 8)
    emax2r = PW - 1 + DMAX
    WIN = RK.select_window(n, emax2r, K)
    rsh, scal01, g01, e01, f01 = [], ([], []), ([], []), ([], []), ([], [])
    for b, ro in enumerate(ros):
        rstart, dstart = _parent_ear_starts(ro["base_c"], cap, DMAX, K, FP)
        if b == 0:
            rstart0 = rstart
            r0g = _fdiv(rstart0, GW)
            base_col = r0g * GW
        rel = torch.remainder(rstart - rstart0, cap)
        rsh.append(_fdiv(rstart0 - base_col + rel, PW) - row0s[b])
        exr = torch.remainder(rstart, PW)
        for e in range(2):
            ds_e, fh_e, fl_e = ro["split_c"][e]
            scal01[e].append(torch.stack([ro["frac_c"][e], fh_e, fl_e, ds_e.to(torch.float32)],
                                         dim=-1))
            g01[e].append(torch.stack([ro["p_gain_c"][e] * ro["maskf"],
                                       ro["d_gain_c"][e] * ro["maskf"]], dim=-1))
            e01[e].append((exr + dstart[e]).to(torch.int32))
            f01[e].append(ro["frz_c"][e])
    ngr_s = -(-max(128 * (r + h - 1) + WIN for r, h in zip(row0s, hs)) // GW)
    kg = FPG + torch.remainder(
        r0g[:, None] - FPG + torch.arange(ngr_s, dtype=torch.int32)[None, :], capg)
    ridx = (vb8[:, None] + kg).reshape(-1).to(torch.int64)
    wide = rows8.index_select(0, ridx).reshape(V, ngr_s * GW)
    return RK.window_select_multi_plain(
        wide, torch.stack(rsh, dim=-1),
        tuple(torch.cat(scal01[e], dim=-1) for e in range(2)),
        tuple(torch.cat(g01[e], dim=-1) for e in range(2)),
        tuple(torch.stack(e01[e], dim=-1) for e in range(2)),
        tuple(torch.stack(f01[e], dim=-1) for e in range(2)),
        n=n, K=K, emax2=emax2r, nb=nb, row0s=row0s, hs=hs)


# --- operands ---------------------------------------------------------------------


def _t(x, dtype=np.float32):
    return torch.tensor(np.asarray(x, dtype))


def _ro(rng, V, K, R, base0, frozen=0.0, spread=1.0):
    """One block's read operands in ``_advance_block``'s layout: ear 0's
    cursor ``base0`` (V,), ear 1's within a few DMAX of it, steps with
    ``|ds - 1|*R <= spread*K``, fractions, gains, frozen flags (share
    ``frozen``) and a 0/1 mask."""
    base1 = base0 + rng.integers(-DMAX - 8, DMAX + 8, V)
    ds = 1.0 + rng.uniform(-1.0, 1.0, (2, V)) * spread * K / R
    ro = {"base_c": [_t(base0, np.int32), _t(base1, np.int32)],
          "frac_c": [_t(rng.uniform(0, 1, V)) for _ in range(2)],
          "split_c": [device_split_ds(_t(ds[e])) for e in range(2)],
          "p_gain_c": [_t(rng.uniform(0, 0.5, V)) for _ in range(2)],
          "d_gain_c": [_t(rng.uniform(-1e-3, 1e-3, V)) for _ in range(2)],
          "frz_c": [_t(rng.uniform(0, 1, V) < frozen) for _ in range(2)],
          "maskf": _t(rng.uniform(0, 1, V) > 0.2)}
    return ro


def _ring(rng, V, cap=CAP):
    return _t(rng.standard_normal((V, (FP + cap + M + 1024) // 128, 128)))


#: K2 cases: (voices, n, (R_CHUNK, K), scenes, what the call adds)
EARS_CASES = {
    "main": (24, 512, (512, 64), None, {}),
    "main_k32_partial_block": (17, 300, (512, 32), None, {}),
    "tight": (24, 512, (512, 128), None, {"tight": True}),
    "sub_pass": (24, 512, (256, 256), None, {"sub": True}),
    "sub_pass_k192": (24, 512, (128, 192), None, {"sub": True}),
    "scenes": (32, 512, (512, 64), 4, {}),
    "frozen": (24, 512, (512, 64), None, {"frozen": 0.5}),
    "mirror_end": (24, 512, (512, 128), None, {"end": True}),
    "chunks": (20, 1536, (512, 64), None, {"frozen": 0.3}),
}


def _ears_call(case):
    V, n, (R, K), scenes, extra = EARS_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    base0 = rng.integers(-CAP, 2 * CAP, V)
    if extra.get("end"):
        base0[::2] = CAP + K - rng.integers(1, 64, (V + 1) // 2)  # read into the mirror
    ro = _ro(rng, V, K, R, base0, extra.get("frozen", 0.0))
    kw = dict(n=n, K=K, R=R, scenes=scenes, **GEOM)
    if extra.get("tight"):
        kw["tight"] = _t(rng.uniform(0, 1, V) > 0.3)
    if extra.get("sub"):
        idx = np.zeros(RK_SUBCAP, np.int32)
        idx[:9] = rng.choice(V, 9, replace=False)
        kw["sub_idx"] = _t(idx, np.int32)
        kw["sub_on"] = _t(np.arange(RK_SUBCAP) < 9)
    return _ring(rng, V), ro, kw


RK_SUBCAP = 256  # the pool's sub-pass list length (SUBCAP)


def _read_cols(ring, ro, kw):
    """Ring columns the main pass reads: (smallest, largest) over voices."""
    R, K = kw["R"], kw["K"]
    rstart, dstart = _parent_ear_starts(ro["base_c"], CAP, DMAX, K, FP)
    return int(rstart.min()), int((rstart + max(int(d.max()) for d in dstart)).max()) + R + 2 * K


@pytest.mark.parametrize("case", sorted(EARS_CASES))
def test_ring_select_ears_plain_equals_the_gather(case):
    """The ring-direct plain K2 equals, bit for bit, the pool's former
    granule gather fed to the wide-window plain version; the CPU wrapper
    runs it and counts no launch."""
    ring, ro, kw = _ears_call(case)
    want = _parent_ears(ring, ro, **kw)
    before = dict(RK.LAUNCHES)
    got = RK.ring_select_ears(ring, ro, **kw)
    assert RK.LAUNCHES == before
    assert torch.equal(got, want) and got.shape == want.shape
    assert float(got.abs().max()) > 1e-2
    assert torch.equal(RK.ring_select_ears_plain(ring, ro, **kw), want)
    if case == "mirror_end":
        assert _read_cols(ring, ro, kw)[1] > FP + CAP  # past the ring's end
    if case == "scenes":
        assert got.shape == (4, 2, kw["n"])
    tol = RK.ring_select_ears_tolerance(ring, ro, **kw)
    assert tol.shape == got.shape and bool((tol > 0).all())


def _group(rng, V, n, K, nb, base0, adv, walk=0.9):
    """nb consecutive blocks' operands: block b's cursors ``b*adv`` past
    block 0's, give or take ``walk*b*K`` (past 1.0: out of contract)."""
    ros = []
    for b in range(nb):
        base = base0 + b * adv + np.round(rng.uniform(-walk, walk, base0.shape) * b * K).astype(int)
        ros.append(_ro(rng, V, K, n, base, frozen=0.2))
    return (ros,) + RK.multi_rows(adv, K, nb)


#: K3 cases: (K, walk, whether the group starts near the ring's end, so
#: that its superwindow wraps the modulus)
MULTI_CASES = {"group": (64, 0.9, False), "k32": (32, 0.9, False), "wrap": (64, 0.9, True),
               "clamped": (64, 8.0, False)}
#: K3's ring modulus: room for a whole group's superwindow
CAP3 = 8192


@pytest.mark.parametrize("case", sorted(MULTI_CASES))
def test_ring_select_multi_plain_equals_the_superwindow(case):
    """The ring-direct plain K3 equals, bit for bit, ``render_multi``'s
    former superwindow gather fed to ``window_select_multi_plain``: a group
    inside the ring, one that wraps its modulus, one whose coarse shifts
    leave the contract and clamp."""
    K, walk, wrap = MULTI_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    V, n, nb = 24, 512, 4
    base0 = CAP3 - rng.integers(200, 900, V) if wrap else rng.integers(K + 100, K + 1000, V)
    ros, row0s, hs = _group(rng, V, n, K, nb, base0, n, walk)
    ring = _ring(rng, V, CAP3)
    kw = dict(n=n, K=K, row0s=row0s, hs=hs, DMAX=DMAX, FP=FP, cap=CAP3)
    want = _parent_multi(ring, ros, **kw)
    before = dict(RK.LAUNCHES)
    got = RK.ring_select_multi(ring, ros, **kw)
    assert RK.LAUNCHES == before
    assert got.shape == (2, nb * n) and torch.equal(got, want)
    assert float(got.abs().max()) > 1e-2
    rstart0, _ = _parent_ear_starts(ros[0]["base_c"], CAP3, DMAX, K, FP)
    if wrap:  # every voice's last block starts past the modulus
        assert int((rstart0 - FP).min()) + (nb - 1) * (n - K) >= CAP3
    else:  # no read reaches it
        assert int((rstart0 - FP).max()) + 1023 + (nb - 1) * (n + K) + 1024 <= CAP3
    if case == "clamped":
        r, _ = _parent_ear_starts(ros[-1]["base_c"], CAP3, DMAX, K, FP)
        X = _fdiv(rstart0 - _fdiv(rstart0, 1024) * 1024 + torch.remainder(r - rstart0, CAP3), 128)
        assert bool(((X - row0s[-1] < 0) | (X - row0s[-1] >= hs[-1])).any())
    tol = RK.ring_select_multi_tolerance(ring, ros, **kw)
    assert tol.shape == got.shape and bool((tol > 0).all())


# --- against the JAX package ------------------------------------------------------


def _jax_read(ring, ro, n, R, K, sub_idx=None, sub_on=None):
    """The JAX package's ``_BufferedPoolDR._windows_read``, interpreted."""
    V = ring.shape[0]
    J = lambda x: jnp.asarray(x.numpy())  # noqa: E731
    rows8 = J(ring).reshape(V * (RPV // 8), 8, 128)
    pool = types.SimpleNamespace(emax2=DMAX)
    if sub_idx is None:
        si, maskf, vbase = np.arange(V), J(ro["maskf"]), jnp.arange(V, dtype=jnp.int32) * (RPV // 8)
        frz = [J(f)[:, None] for f in ro["frz_c"]]
    else:
        si = sub_idx.numpy().astype(np.int64)
        maskf, vbase, frz = J(ro["maskf"])[si] * J(sub_on), J(sub_idx) * (RPV // 8), None
    args = ([J(b)[si] for b in ro["base_c"]], [J(f)[si] for f in ro["frac_c"]],
            [tuple(J(x)[si] for x in s) for s in ro["split_c"]],
            [J(g)[si] for g in ro["p_gain_c"]], [J(g)[si] for g in ro["d_gain_c"]])
    return np.asarray(JSP._BufferedPoolDR._windows_read(
        pool, rows8, vbase, *args, maskf, (R, K), n, CAP, FP, True, frz))


@pytest.mark.parametrize("case", ["frozen", "sub_pass", "chunks", "mirror_end"])
def test_ring_select_ears_matches_jax_read(case):
    """The ring form against the JAX package's whole read (its granule
    gather, its cursor advance between chunks and the interpreted
    ``window_select_tiles_ears``): <= 1e-6 abs, the voice-sum order and
    XLA's fused multiply-adds apart."""
    ring, ro, kw = _ears_call(case)
    got = RK.ring_select_ears(ring, ro, **kw).numpy()
    ref = _jax_read(ring, ro, kw["n"], kw["R"], kw["K"], kw.get("sub_idx"), kw.get("sub_on"))
    assert got.shape == ref.shape and np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_ring_select_multi_matches_pallas():
    """The ring form of K3 against the interpreted
    ``window_select_tiles_multi`` on the wrapped superwindow: <= 1e-6."""
    rng = np.random.default_rng(77)
    V, n, nb, K = 16, 512, 4, 64
    ros, row0s, hs = _group(rng, V, n, K, nb, CAP3 - rng.integers(200, 900, V), n)
    ring = _ring(rng, V, CAP3)
    kw = dict(n=n, K=K, row0s=row0s, hs=hs, DMAX=DMAX, FP=FP, cap=CAP3)
    got = RK.ring_select_multi(ring, ros, **kw).numpy()
    captured = {}
    plain = RK.window_select_multi_plain

    def spy(wide, rowshift, scal01, g01, e01, frz01, **k):
        captured["args"] = (wide, rowshift, scal01, g01, e01, frz01)
        return plain(wide, rowshift, scal01, g01, e01, frz01, **k)

    mp = pytest.MonkeyPatch()
    mp.setattr(RK, "window_select_multi_plain", spy)
    try:
        _parent_multi(ring, ros, **kw)
    finally:
        mp.undo()
    wide, rowshift, scal01, g01, e01, frz01 = captured["args"]
    J = lambda x: jnp.asarray(x.numpy())  # noqa: E731
    ref = np.asarray(PR.window_select_tiles_multi(
        J(wide), J(rowshift), [J(s) for s in scal01], [J(g) for g in g01],
        [J(e) for e in e01], [J(f) for f in frz01], n=n, K=K, emax2=127 + DMAX, nb=nb,
        row0s=row0s, hs=hs, interpret=True))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


# --- whole renders with the read swapped back -------------------------------------


def _subpass_scene():
    """Four voices at 8 kHz, two of them walking wide enough for the
    family sub-pass (``test_subpass_scene_on_card_matches_cpu``'s)."""
    control, scene = pt.SpatialScene.new(device="cpu")
    voices = [([5.0, 2.0, 0.0], [2.0, 0.0, 0.0]), ([60.0, 5.0, 0.0], [0.0, 0.0, 0.0]),
              ([4.0, 0.0, 0.0], [100.0, 0.0, 0.0]), ([43.8, 0.0, 0.0], [2.0, 0.0, 0.0])]
    for k, (p, v) in enumerate(voices):
        control.play_buffered(pt.Sine(0.1 * k, 300.0 + 70.0 * k),
                              pt.SpatialOptions(position=p, velocity=v),
                              max_distance=10.0, rate=8000, buffer_duration=0.1)
    return scene


def _render(kind):
    if kind == "buffered":
        _, scene = build_spatial(True, 40, "cpu")  # fused groups from block ~4
        return pt.Renderer(scene, 48000).render_frames(512 * 40)
    if kind == "subpass":
        r = pt.Renderer(_subpass_scene(), 8000)
        return np.concatenate([r.render_block(512) for _ in range(10)])
    pack = build_spatial_pack(4, "cpu", 16, 8)
    return np.concatenate([pack.render_block(512) for _ in range(10)], axis=1)


@pytest.mark.parametrize("kind", ["buffered", "subpass", "spatial_pack"])
def test_renders_equal_with_the_gather_read(kind, monkeypatch):
    """A buffered scene with fused idle groups (K3), a scene with the
    family sub-pass and a 4-scene spatial pack render bit for bit as with
    the pool's former window gathers."""
    calls = {"ears": [], "multi": 0}
    ears, multi = SP.ring_select_ears, SP.ring_select_multi

    def ears_spy(ring, ro, **kw):
        calls["ears"].append(kw.get("sub_idx") is not None)
        return ears(ring, ro, **kw)

    def multi_spy(ring, ros, **kw):
        calls["multi"] += 1
        return multi(ring, ros, **kw)

    monkeypatch.setattr(SP, "ring_select_ears", ears_spy)
    monkeypatch.setattr(SP, "ring_select_multi", multi_spy)
    now = _render(kind)
    assert calls["ears"] and np.abs(now).max() > 1e-3
    assert (calls["multi"] > 0) == (kind == "buffered")
    assert any(calls["ears"]) == (kind == "subpass")
    monkeypatch.setattr(SP, "ring_select_ears", _parent_ears)
    monkeypatch.setattr(SP, "ring_select_multi", _parent_multi)
    np.testing.assert_array_equal(now, _render(kind))


# --- refusals -----------------------------------------------------------------------


def _bad(case):
    ring, ro, kw = _ears_call("main")
    V = ring.shape[0]
    if case == "ring_2d":
        return lambda: RK.ring_select_ears(ring.view(V, -1), ro, **kw), ValueError
    if case == "ring_dtype":
        return lambda: RK.ring_select_ears(ring.double(), ro, **kw), TypeError
    if case == "base_dtype":
        ro["base_c"][0] = ro["base_c"][0].float()
        return lambda: RK.ring_select_ears(ring, ro, **kw), TypeError
    if case == "gain_shape":
        ro["p_gain_c"][1] = ro["p_gain_c"][1][:-1]
        return lambda: RK.ring_select_ears(ring, ro, **kw), ValueError
    if case == "chunk":
        return lambda: RK.ring_select_ears(ring, ro, **{**kw, "R": 200}), ValueError
    if case == "past_the_mirror":
        return lambda: RK.ring_select_ears(ring, ro, **{**kw, "cap": CAP + 2048}), ValueError
    if case == "scene_count":
        return lambda: RK.ring_select_ears(ring, ro, **{**kw, "scenes": 5}), ValueError
    if case == "sub_with_scenes":
        idx = torch.zeros(8, dtype=torch.int32)
        return lambda: RK.ring_select_ears(ring, ro, **{**kw, "scenes": 2, "sub_idx": idx,
                                                        "sub_on": torch.ones(8)}), ValueError
    assert case == "multi_nb"
    return lambda: RK.ring_select_multi(ring, [ro] * 9, n=512, K=64, row0s=[0] * 9,
                                        hs=[8] * 9, **GEOM), ValueError


@pytest.mark.parametrize("case", ["ring_2d", "ring_dtype", "base_dtype", "gain_shape",
                                  "chunk", "past_the_mirror", "scene_count",
                                  "sub_with_scenes", "multi_nb"])
def test_ring_select_wrappers_reject_bad_operands(case):
    call, err = _bad(case)
    with pytest.raises(err):
        call()
