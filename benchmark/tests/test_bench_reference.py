"""Each cell's scene and traffic, at a tiny size on the CPU, render
through the port and agree with the plain reference; the reference at a
lower precision (the control) does not; the frozen byte counts equal
values worked out by hand."""

import numpy as np
import pytest
import torch

import yardstick
from helpers import TINY, run_tiny, tiny_cell
from reference import mixer_agc, spatial


@pytest.mark.parametrize("name", sorted(TINY))
def test_cell_agrees_with_reference(name):
    cell = tiny_cell(name)
    r = run_tiny(cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert 0 <= r["checks"]["pcm_err"]["value"] <= cell.limits["pcm_err"]["limit"]
    assert set(r["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert list(r)[-1] == "checks"


def _spatial_inputs(V=24, seed=3):
    rng = np.random.default_rng(seed)
    inp = spatial.SceneInputs(rng.uniform(0, 6, V), rng.uniform(100, 2000, V),
                              rng.uniform(-15, 15, (V, 3)), rng.uniform(-1.5, 1.5, (V, 3)))
    idx = np.arange(4)
    inp.add_event(3, idx, rng.uniform(-15, 15, (4, 3)), rng.uniform(-1.5, 1.5, (4, 3)))
    return inp


def test_spatial_control_is_caught():
    """The reference in bfloat16 in the program's place fails the limit."""
    from helpers import SPEC
    import harness

    limit = harness.Cell(SPEC, "spatial4096-buffered-steer-offline").limits["pcm_err"]["limit"]
    inp = _spatial_inputs()
    blocks = [0, 5, 9, 20]
    want = spatial.render(inp, blocks)
    ctl = spatial.render(inp, blocks, round_to=torch.bfloat16)
    err = float((ctl - want).abs().max() / want.abs().max())
    assert err > limit


def test_mixer_control_is_caught():
    from helpers import SPEC
    import harness

    limit = harness.Cell(SPEC, "c5pack256-offline").limits["pcm_err"]["limit"]
    rng = np.random.default_rng(4)
    inp = mixer_agc.MixerInputs(2, rng.uniform(0, 6, 14), rng.uniform(50, 2000, 14))
    for v in range(2):
        inp.add_write(0, v, rng.standard_normal(2400) * 0.1)
    inp.add_write(30, 0, rng.standard_normal(2048) * 0.1)
    want = mixer_agc.render(inp, 0, 40)
    ctl = mixer_agc.render(inp, 0, 40, round_to=torch.bfloat16)
    assert float((ctl - want).abs().max() / want.abs().max()) > limit


def test_stream_schedule_grants_and_underruns():
    """A stream granted what its capacity leaves, read to its end, then
    silent (stream.rs's graceful underrun)."""
    inp = mixer_agc.MixerInputs(1, [], [], size=2528, max_write=2400)
    inp.add_write(0, 0, np.ones(2400))
    inp.add_write(0, 0, np.ones(500))  # 128 fit
    content, T, L, S, granted = mixer_agc.stream_schedule(inp, 40)
    assert granted == [2400, 128]
    assert len(content[0]) == 2528
    assert L[0, 0] == 2400 and L[1, 0] == 2528 - 85  # the rest shipped next block
    assert L[-1, 0] == 0 and T[-1, 0] == 0  # drained
    out = mixer_agc.render(inp, 35, 39)
    assert float(out.abs().max()) == 0.0


def test_ring_bytes_by_hand():
    # 4096 voices, 512 frames: 4096 * (4*512 + 68) + 8*512
    assert yardstick.ring_read_work(4096, 512)[0] == 4096 * 2116 + 4096
    assert yardstick.ring_read_work(4096, 512)[1] == 4096 * 2 * 512 * 8
    # a block's least time is its bytes over 3.35 TB/s
    b, f = yardstick.ring_read_work(4096, 512)
    assert yardstick.least_seconds(b, f) == pytest.approx(8671232 / 3.35e12)


def test_pack_bytes_by_hand():
    # 256 x 32 streams at 8 kHz under 48 kHz: span ceil(512/6) + 2 = 88
    ds = float(np.float32(np.float32(1 / np.float32(48000)) * np.float32(8000)))
    assert yardstick.stream_step_work(8192, 512, ds)[0] == 8192 * (4 * 88 + 2048 + 40)
    # 65,536 Adapt voices: 8 bytes a frame and 28 of state each
    assert yardstick.agc_work(65536, 512)[0] == 65536 * (8 * 512 + 28)
    # 1024 talkers of 2048 samples placed into 8192 rings
    assert yardstick.place_work(1024 * 2048, 8192)[0] == 8 * 2097152 + 12 * 8192
    assert yardstick.hand_kernel("void agc_step_kernel<1>(AgcArgs)") == "K7"
    assert yardstick.hand_kernel("ring_select_kernel(float const*, ...)") == "K2/K3"
    assert yardstick.hand_kernel("elementwise_kernel<128, 2>") is None


def test_spatial_check_covers_a_tick(monkeypatch):
    """The sample always holds a tick's block and the block after it."""
    cell = tiny_cell("spatial4096-buffered-steer-offline")
    cell.traffic["check_blocks"] = 3
    seen = []
    render = spatial.render

    def spy(inp, blocks, **kw):
        seen.append(list(blocks))
        return render(inp, blocks, **kw)

    monkeypatch.setattr(spatial, "render", spy)
    r = run_tiny(cell)
    assert r["correct"], r["checks"]
    per = cell.traffic["blocks_per_call"]  # a tick lands on each call's first block
    assert any(b % per == 0 and b + 1 in seen[0] for b in seen[0]), seen
