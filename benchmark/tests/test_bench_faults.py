"""A run with its timed path broken underneath comes out not correct: the
state left unchanged by a step, half of the voices left out and the rest
scaled to stand for them, and an answer altered where it is produced.
(Every cell is on one card: no exchange between cards to leave out.)  And
the spatial cells' ticks reach the motion smoothing: a reference that
smooths over another time reads their runs as not correct."""

import pytest

from helpers import TINY, run_tiny, tiny_cell


def _frozen(drv):
    """A step that returns its state unchanged: the engine's render hands
    back the state it was given, with the block it rendered."""
    sig = drv.renderer.signal if hasattr(drv, "renderer") else drv.pack.scenes[0]
    for meth in ("render", "render_multi"):
        fn = getattr(sig, meth, None)
        if fn is None:
            continue

        def frozen(dstate, *a, _fn=fn, **kw):
            _, out = _fn(dstate, *a, **kw)
            return dstate, out

        setattr(sig, meth, frozen)


def _altered(drv):
    """One sample of every block's PCM changed where the call produces it."""
    dispatch = drv.dispatch

    def altered():
        outs = dispatch()
        for x in outs:
            x[..., 0] += 0.05 * float(x.abs().max() + 1e-3)
        return outs

    drv.dispatch = altered



@pytest.mark.parametrize("name", sorted(TINY))
@pytest.mark.parametrize("fault", ["frozen", "altered", "half"])
def test_fault_is_caught(name, fault, monkeypatch):
    cell = tiny_cell(name)
    Driver = cell.driver_mod.Driver

    class Broken(Driver):
        def __init__(self, *a, **kw):
            if fault == "half":
                _half_voices(monkeypatch)
            super().__init__(*a, **kw)
            if fault == "frozen":
                _frozen(self)
            elif fault == "altered":
                _altered(self)

        def dispatch(self):
            outs = super().dispatch()
            if fault == "half":
                outs = [2 * x for x in outs]
            return outs

    monkeypatch.setattr(cell.driver_mod, "Driver", Broken)
    r = run_tiny(cell)
    assert r["correct"] is False, r["checks"]


def _half_voices(monkeypatch):
    """Every second voice played silent in the program's scenes."""
    import oddio_tpu_torch as pt

    count = [0]

    def wrap(cls, meth):
        fn = getattr(cls, meth)

        def play(self, sig, *a, **kw):
            count[0] += 1
            if count[0] % 2 == 0:
                sig = pt.Constant(0.0)
            return fn(self, sig, *a, **kw)

        monkeypatch.setattr(cls, meth, play)

    wrap(pt.SpatialSceneControl, "play_buffered")
    wrap(pt.MixerControl, "play")


@pytest.mark.parametrize("name", [n for n in sorted(TINY) if n.startswith("spatial")])
def test_smoothing_is_compared(name, monkeypatch):
    from reference import spatial

    monkeypatch.setattr(spatial, "POS_SMOOTH", spatial.F(0.25))
    r = run_tiny(tiny_cell(name))
    assert r["correct"] is False, r["checks"]
