"""The yardstick: the card's peaks, the port's hand-kernel names and the
bytes and float32 operations a layer's work needs, from a cell's shapes.

The byte counts are those of the port's kernel benchmarks, frozen here:
each input byte counted once and each output byte once, whatever a kernel
reads again, so a roofline share reads the same work whatever implements
it.  Work is counted per block of the cell, not per launch.
"""

from __future__ import annotations

import math

#: NVIDIA H100 SXM data sheet: HBM3 bandwidth and float32 outside the
#: tensor cores, at the full 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12

#: the port's hand-written CUDA kernels, by the names the profiler gives
#: their launches: K1/K9, K2/K3, K5, K4, K6 (both forms), K7, K8/K10
HAND_KERNELS = {
    "slab_append_kernel": "K1",
    "ring_select_kernel": "K2/K3",
    "strip_select_kernel": "K5",
    "ring_place_kernel": "K4",
    "ring_resample_kernel": "K6",
    "arena_resample_kernel": "K6",
    "arena_step_kernel": "K6",
    "agc_step_kernel": "K7",
    "flat_select_kernel": "K8/K10",
}


def hand_kernel(name):
    """The hand kernel a profiler kernel name belongs to, or None."""
    for key, tag in HAND_KERNELS.items():
        if key in name:
            return tag
    return None


def least_seconds(nbytes, flops):
    """The least time the card could take: bytes over HBM bandwidth, or
    float32 operations over the float32 peak where that is larger."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_PER_S)


# --- ring reads (K2, K3): a buffered pool's two-ear fractional read ------------------

#: operand words a voice's read needs (positions, steps, gains, ramps)
RING_OPERAND_BYTES = 68
#: float32 operations per voice, ear and frame: position, lerp, gain ramp,
#: accumulate
RING_FLOPS = 8


def ring_read_work(voices, n):
    """(bytes, flops) of one block's read of ``voices`` buffered voices of
    ``n`` frames: each voice's n ring samples, its operands, the (2, n)
    float32 output."""
    nbytes = voices * (4 * n + RING_OPERAND_BYTES) + 8 * n
    return nbytes, voices * 2 * n * RING_FLOPS


# --- stream ingest (K4), the Stream step (K6), Adapt (K7) -----------------------------

#: float32 operations per stream frame (position, lerp) and per Adapt frame
#: (square, running mean, root, compare, gain, scale)
STREAM_FLOPS = 4
AGC_FLOPS = 12


def place_work(samples, streams):
    """(bytes, flops) of placing ``samples`` written frames into the rings of
    ``streams`` streams: each frame in and out, 12 bytes of cursors each."""
    return 8 * samples + 12 * streams, 0


def stream_step_work(streams, n, ds):
    """(bytes, flops) of one block's Stream step: each stream's read span of
    ``ceil(n * ds) + 2`` samples, its (n,) output, 40 bytes of cursors."""
    span = math.ceil(n * ds) + 2
    return streams * (4 * span + 4 * n + 40), streams * n * STREAM_FLOPS


def agc_work(voices, n):
    """(bytes, flops) of one block's Adapt step: the inner's samples in, the
    output out, 28 bytes of per-voice state and parameters."""
    return voices * (8 * n + 28), voices * n * AGC_FLOPS
