"""The work of a block of K6's arena steps (``stream_kernels.arena_step``
and its Fader form): the bytes and float32 operations each sampler voice's
step needs, from a cell's shapes, counted as ``yardstick`` counts them
(each input byte once, each output byte once, per block of the cell).

A voice reads the ``ceil(n * ds) + 1`` arena samples its source step
``ds`` covers; a Fader voice whose fade runs reads both banks.  Each voice
reads and writes its state words, and writes ``n`` float32 samples.
"""

from __future__ import annotations

import math

#: state words of a voice's step, read and written: a FramesSignal's
#: cursor (t as 8 bytes; base, frac, off, goff, length, rate, r_hi and the
#: step split, 4 each), a Speed's factor, a Fader's progress, step, flags
#: and both banks, a Cycle's cursor and region
STATE_BYTES = {"frames": 48, "speed": 52, "fader": 2 * 52 + 10, "cycle": 40}
#: float32 operations per sample a bank reads: position, lerp (and the
#: crossfade's gains where both banks run)
ARENA_FLOPS = 4


def arena_step_work(shapes):
    """(bytes, flops) of one block of the cell's arena steps: ``shapes``
    gives ``n``, the voices of each kind, each kind's mean source step
    ``ds`` and ``fading``, the mean Fader voices fading a block."""
    n = shapes["n"]
    nbytes = flops = 0
    for kind, V in shapes["voices"].items():
        reads = V + (shapes["fading"] if kind == "fader" else 0)
        span = math.ceil(n * shapes["ds"][kind]) + 1
        nbytes += reads * 4 * span + V * 2 * STATE_BYTES[kind] + V * 4 * n
        flops += reads * n * ARENA_FLOPS
    return nbytes, flops
