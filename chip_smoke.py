"""Smoke run of oddio_tpu_torch on one CUDA card: builds every kernel and
the native control plane, checks each kernel against its plain PyTorch
version at its path's shapes, drives the SpatialScene render path, the
AGC mixer path (BASELINE config 5's scene) and the host-pool path at 4096
voices, the dense mix (config 4), the sampler (config 2), the wavetable
and a seek sampler at 1024, checkpoints and resumes four of them, drives
the RealtimeDriver and the example twins, renders ScenePacks on (scene,
voice) meshes against their 1 x 1 packs and, replaying graphs per cell,
against their own op-by-op render, and times them.

    python3 chip_smoke.py

Phases (each prints one or more lines; any failure exits non-zero):
 1. the card: name and power limit (nvidia-smi);
 2. the kernel build (one nvcc per csrc/*.cu, all at once, sm_90a) and
    the control-plane library's (g++, ``control/native.py``);
 3. K1 (both row forms and the cursor form) against its plain version at
    V = 4096, n = 512; K2/K3, reading straight from the ring, against
    theirs on the 4096-voice buffered scene's own read operands (captured
    blocks and a fused group), with frozen ears, windows ending in the
    mirror, ``tight``, the family sub-pass list, three read chunks and a
    group that wraps the ring's modulus;
 4. the 4096-voice buffered and seek scenes through render_frames and
    render_frames_device, counting kernel launches on that run (K1's all
    through its cursor form); at the end of the run (a profiled session
    slows every later host call), the device kernels per buffered block,
    and one device kernel for one pool read alone, a delta block's read
    and an idle fused group's (``render`` less ``_advance_block``);
 5. a 256-voice buffered scene on the card against the CPU (plain) render;
 6. real-time factors of both 4096-voice scenes;
 7. K4 against its plain version at the mixer path's shapes (and
    through its channel map) and at the host pool's (through its record
    form); K6 exactly in its DR form (the whole Stream step: read and
    cursor release) and its ds form at V = 512, 4096 and 1, ds = 1/6, 1
    and 4; K7 (the whole Adapt step) within ``agc.agc_tolerance`` at V =
    512, 3584, 4096 and 1, n = 512, 513, 128 and 100, one and two
    channels, a host and a per-voice interval, counts below n, tau 0.1 s
    and near the gate; both timed warm and cold;
 8. the 4096-voice config-5 mixer (512 Adapt(Stream), 3584 Adapt(Sine))
    through render_frames and render_frames_device with new stream PCM
    between them, counting kernel launches on that run (per block too);
 9. the 256-voice config-5 mixer on the card against the CPU render;
10. the real-time factor of the 4096-voice mixer;
11. K5 against its plain version at the host pool's shapes (4096 voices,
    the singleton, 17 voices, and near the gate where its walk clamp
    binds; windows across the ring's end), through its record form and
    its tensor form, the record form twice and bit-equal;
12. the 4096-voice host-pool scene (4096 Speed(Stream) voices in the host
    buffered pool, 512 Adapt(Stream) in the device-resident one, a
    256-voice config-5 submix) through render_frames and
    render_frames_device with new stream PCM and set_speed changes
    between them, counting kernel launches on that run (its three
    513-frame Adapt pools: K7 three times a block);
13. the same scene at 256 / 32 / 64 voices on the card against the CPU;
14. the real-time factor of the 4096-voice host-pool scene;
15. K8, K9 (three page forms, W = 512 and 1024) and K10 against their
    plain versions at V = 4096, n = 512 (no path calls them: their
    launches, counted on every path run of phases 4, 8, 12 and 17, must
    be 0);
16. K1 (row and cursor forms) and K2 with a ScenePack's scene axis (16
    scenes of 256 voices; K2 on a 4096-row ring);
17. the config-5 ScenePack at 16 and 64 scenes of 256 voices through
    render_block and render_frames_device with new stream PCM between,
    counting K4/K6/K7 launches per block (equal at both sizes), and the
    16-scene spatial pack counting K1/K2;
    at the end of the run, phases 8, 12 and 17's profiles: device
    kernels per block of each path, and for each Adapt pool of the
    paths the device kernels of its step (its whole render less its
    inner's) and of its Stream step, each exactly one;
18. a 4 x 64-voice config-5 pack and a 4-scene spatial pack on the card
    against the same packs on the CPU and per-scene Renderers on the card;
19. real-time factors per scene of the config-5 pack at 16, 64 and 256
    scenes (256: replaying graphs, then under ``core.run.eager()``) and
    of the 16-scene spatial pack; phases 17-19's packs replay graphs
    (the 1 x 1 pack's default on the card);
20. (run right after the build, so that a fault in it shows within
    seconds) K6's arena form, the sampler reads of FramesSignal, Cycle
    and the seek pool, exactly against its plain version at 1024, 4096, 1
    and 17 rows, n = 512, 513, 128 and 100, steps in the tiers 1/2/4 and
    at 44.1 -> 48 kHz x 1.2, mono, stereo and looped regions, cursors
    before, past and far outside a sound; two runs bit-equal; exactly
    again on every operand set at the sampler's, wavetable's and seek
    pool's shapes, and timed there warm and cold on the paths' own
    operands;
21. BASELINE config 4's dense mix (1024 Gain(Sine) voices under
    Tanh(Reinhard(mixer))) through render_frames and render_frames_device
    with set_gain on 64 voices between, no K6 launch; its xRT;
22. config 2 at a sampler's width (1024 Fader(Speed(FramesSignal)) voices
    over 8 stereo 10 s sounds at 44.1 kHz, speed writes on 64 voices and
    fades on 64 others every 8 blocks): one K6 ``arena_step`` launch a
    block (both fader banks and the crossfade), no ``arena_resample``,
    fades released on the device (its bank bits equal the host mirrors
    and have flipped); its xRT;
23. bench.py's wavetable (1024 Speed(Cycle) voices): one ``arena_step``
    launch a block; its xRT;
24. the four sampler-path scenes (21-23, 26) at 64-256 voices on the card
    against the CPU; at the end of the run, phases 21-23 and 26's
    profiles (device kernels per block);
25. (run right after phase 20) K6's arena form as whole steps
    (``arena_step``: a FramesSignal or Cycle step, a seek pool's warped
    read, a whole Fader) exactly against their plain versions (the torch
    chains they replace; the Fader's output but for the sign of an exact
    zero): mono and stereo FramesSignal, Cycle, seek E = 2, the Fader with
    fading, done, flipped and idle voices; n = 512, 513, 128 and 100; a
    static interval and speeds in the tiers 1/2/4; edges, count < n and
    0; and at the paths' shapes; two runs bit-equal, one launch each;
26. a seek sampler (1024 mono FramesSignal voices in a SpatialScene's seek
    pool, set_motion on 64 between runs): one ``arena_step`` launch a
    block (both ears); its xRT;
27. (before 21) the whole steps on the three paths' captured states
    (``kernel_bench.arena_states``), exact on every captured block, timed
    warm and cold beside the plain version and the byte bound; at the end
    of the run, one device kernel per step (the profiler's count);
28. (after 19) K5's scene form (``strip_select_record(..., scenes=S)``)
    against its plain version at the host-pool pack's 16 scenes x 256,
    at one scene of 4096 and at 3 scenes of 17 (a scene boundary inside
    a block of 32 voices), with steps up to the strip gate, windows across
    the ring's end and frozen voices; one launch a call, two runs
    bit-equal, one scene equal to the (2, n) form; timed warm and cold
    beside the (2, n) form on the same rows;
29. (after 26) config 2 per session: the sampler pack
    (``build_sampler_pack``) at 4 and 16 scenes of 64
    Fader(Speed(FramesSignal)) voices, each scene on its own script,
    through render_block and render_frames_device: one ``arena_step``
    launch a block at both sizes, fades released on the device in every
    scene; xRT per scene;
30. (after 28) every buffered pool kind per session: the host-pool pack
    (``build_host_pools_pack``) at 4 and 16 scenes of 256 Speed(Stream)
    host voices, 32 Adapt(Stream) device-resident ones and a 64-voice
    config-5 submix, with stream writes and set_speed between runs: K5's
    scene form twice a block, every kernel's launches per block equal at
    both sizes; xRT per scene;
31. the host-pool pack (4 x 32), the sampler pack (4 x 64) and a pack of
    Mixers with host-pool voices and a Mixer-in-Mixer submix on the card
    against the CPU and against per-scene Renderers on the card.
32. (after 29) checkpoints (``utils/checkpoint.py``) of four scenes on the
    card at full width, built by ``scene_profile.build_checkpoint_scene``
    with control events queued at the snapshot: the 4096-voice buffered
    scene (a ``play_buffered`` and a ``set_motion``; 64 blocks through
    render_frames, so that the idle run after the motion's transition
    reaches K3), the 4096-voice config-5 mixer (PCM written, not
    ingested), the 4096-voice host-pool scene (a ``set_speed`` and PCM)
    and the 1024-voice sampler (fades in flight, fades queued behind
    them; 16 blocks each): the blocks after a restore, and after a second
    restore of the same snapshot, equal those after the snapshot bit for
    bit (an exact zero's sign aside), with every kernel's launches
    unchanged; the snapshot's size, snapshot and restore ms; then each
    scene's 256-voice snapshot saved on the card loads into the same
    scene built on the CPU: 8 blocks within TOL;
33. the RealtimeDriver (``control/realtime.py``, over the native ring
    built from ``native/control_plane.cpp`` with g++ in phase 2): (a) the
    4096-voice config-5 mixer, its PCM fed before start(), 32 blocks read
    whenever 512 frames are readable equal a second mixer's render_block
    loop bit for bit, the render thread alive with >= 32 blocks; (b) the
    4096-voice buffered scene and the config-5 mixer pulled at a real-time
    pace for 3 s after the first non-silent read: underruns, blocks
    rendered and the render thread's xRT (printed, not asserted);
34. the seven example twins (``oddio_tpu_torch.examples``) on the card,
    each in a temporary directory at its own constants: wall time, peak
    and, for the real-time ones, underruns; a non-finite or silent output
    fails;
35. (after 34) ScenePacks on (scene, voice) meshes, each against its 1 x 1
    pack with launches per block and xRT per scene: (a) the dry-run twin
    (``parallel/dryrun.py``) on 8 logical devices of the card, 2 x 4,
    within its TOL of per-scene Renderers; (b) BASELINE config 5 at 256 x
    256 on a logical 2 x 2 mesh within 2e-6 and every kernel's launches
    4x; (c) the host-pool pack 16 x 256 (K5's scene form once per cell,
    the submix once per scene group) and the sampler pack 16 x 64 (fade
    bits gathered from the shards) on 2 x 2, within 2e-6; (d) the spatial
    and config-5 packs on a 1 x 2 mesh over [card, CPU] within 2e-6, and
    (a) and (b) over distinct cards where the machine has them; (b)'s
    1 x 1 pack and its 2 x 2 pack both replay graphs, every cell of the
    2 x 2 its own (replays >= 0.9 of the calls, no recapture; xRT over
    752 blocks).
36. (after 6) the Renderer's block steps as CUDA graphs (``core/run.py``):
    bench.py's four SpatialScenes of 4096 Sine voices (seek, buffered,
    buffered_mixed, subpass) with its dispatch buckets, each twice from
    one seed, once under ``core.run.eager()`` (op by op) and once
    replaying graphs, through one script (24 blocks, four ticks of 64
    set_motion deltas and 47 blocks, a listener rotation and 47 blocks):
    graph vs eager max|diff| (bit-equal), every kernel's launches equal,
    the rings where they were, ``graph_counts`` (replays >= 90% of the
    calls of the phase's graph runs, no recapture); then 188 idle blocks
    each way: dispatch host ms a block (the render's host time less
    ``host_prepare``'s, no wait for the card), host_prepare ms a block and
    xRT; at the end of the run, device kernels per block of each way.
    Phases 4-6 and 33 run graphs too (the Renderer's default on the card).
37. (after 10) the Renderer's block steps as CUDA graphs on BASELINE
    config 5's Mixer: the 4096-voice mixer (512 Adapt(Stream), 3584
    Adapt(Sine)) with bench.py's dispatch buckets, twice from one seed,
    once under ``core.run.eager()`` and once replaying graphs, through
    one script (24 blocks; four ticks of 1024 new samples on 64 streams,
    8 plays, 8 stops and 16 stream closes, each followed by 47 blocks;
    188 idle blocks): graph vs eager max|diff| (bit-equal), every
    kernel's launches equal (K4, K6 and K7 launched, no ring kernel), the
    rings where they were, ``graph_counts`` (replays >= 90% of the calls,
    no recapture); then 188 idle blocks each way (dispatch host ms a
    block, host_prepare ms a block, xRT) and 10 ingest blocks (the median
    dispatch host ms of one); at the end of the run, device kernels per
    block of each way.  Phases 8-10 and 33's mixers replay graphs too;
    phase 8's step capture runs under ``eager()``.
38. (after 19) the ScenePack's block steps as CUDA graphs: the config-5
    pack at 16 and 64 scenes of 256 voices and the 16-scene spatial pack,
    each twice from one seed, once under ``core.run.eager()`` and once
    replaying graphs, through one script (render_block and
    render_frames_device; on the config-5 packs a 1024-sample feed to
    every stream, a play in every scene, then its stop and a stream close
    in every scene; on the spatial pack a move and a listener rotation in
    one scene; 188 idle blocks): bit-equal, every kernel's launches equal
    (K4, K6, K7; or K1, K2, no other ring kernel), the rings where they
    were, no recapture, replays >= 90% of the phase's calls; then 188
    idle blocks each way (dispatch host ms a block, host_prepare ms,
    xRT per scene) and, on the config-5 packs, 10 ingest blocks; at the
    end of the run, device kernels per block of each way.
39. (after 21-24 and 26) the Renderer's block steps as CUDA graphs on BASELINE
    config 4's dense mix (1024 Gain(Sine) voices under
    Tanh(Reinhard(mixer)), bench.py's dispatch: ``scan_unroll`` 4 and its
    buckets) and bench.py's wavetable (1024 Speed(Cycle) voices, its
    buckets; K6's arena form inside the graphs), each twice from one
    seed, once under ``core.run.eager()`` and once replaying graphs,
    through one script (24 blocks; four ticks of set_gain or set_speed on
    64 voices, one into the step tier 4, and 8 plays, each followed by 47
    blocks; on the wavetable 8 voices of a new table, which rebuilds the
    sample arena; 188 blocks; the pools have room: no growth): graph vs
    eager max|diff| (bit-equal), every kernel's launches equal (one
    ``arena_step`` a block on the wavetable, no kernel on the dense mix,
    no ring or AGC kernel), ``graph_counts`` (replays >= 90% of each
    scene's calls, recaptures only after the new table); then 188 idle
    blocks each way (dispatch host ms a block, host_prepare ms a block,
    xRT); at the end of the run, device kernels per block of each way.
    Phases 21-24's dense mix and wavetable replay graphs too.
40. (after 26 and 29) the Renderer's and the pack's block steps as CUDA
    graphs on the samplers: BASELINE config 2's sampler (1024
    Fader(Speed(FramesSignal)) voices; ``fader_step`` inside the graphs,
    the fade lanes and the float64 cursors in the packed row), the seek
    sampler (1024 mono FramesSignal voices in a seek pool; ``arena_warp``)
    and the sampler pack 16 x 64 (``fader_step`` over the stack), each
    twice from one seed, once under ``core.run.eager()`` and once
    replaying graphs, through one script of 12 periods of 8 blocks (each
    period's control first: the sampler's speed writes on 64 voices and
    0.05 s fades on 64 others, every pack scene's on 8 and 8, or
    set_motion on 64 seek voices): bit-equal, every kernel's launches
    equal (one ``arena_step`` a block, no other kernel), ``graph_counts``
    (replays >= 90% of each scene's calls, no recapture: no leaf is
    replaced); then 188 idle blocks and 6 control periods each way
    (dispatch host ms a block, host_prepare ms a block, the control's ms
    a period, xRT); at the end of the run, device kernels per block of
    each way.  Phases 22, 26 and 29's scenes replay graphs too.
41. (after 14 and 30) the Renderer's and the pack's block steps as CUDA
    graphs on the host pools: the 4096-voice host-pool scene (4096
    Speed(Stream) voices in the host buffered pool: K4/K5's operand
    record in the packed row; 512 Adapt(Stream) in the device-resident
    buffered pool: K1, K2, K6, K7; a 256-voice config-5 submix played as
    a singleton), the host-pool pack 16 x 256 (K5's scene form) and a
    Mixer of 4096 Speed(Stream) voices in its host ``Pool`` with a
    256-voice config-5 submix, each twice from one seed, once under
    ``core.run.eager()`` and once replaying graphs, through one script of
    6 periods of 16 blocks (before each, ``set_speed`` on 64 voices,
    discontinuous ``set_motion`` on 64 and 1024 samples of PCM on every
    stream, so each period opens with an ingest block; one fly-by voice,
    in scene 0 of the pack, whose pool leaves K5's strip gate, takes it
    and leaves it again inside single calls, and stops 11 m out after
    the script): bit-equal, every kernel's
    launches equal (the kernels line's entries of K1, K2, K4, K5, its
    scene form, K6 and K7 gain ``graph_launches`` a block),
    ``graph_counts`` (replays >= 90% of each engine's calls, no
    recapture: nothing grows); then 188 idle blocks each way (dispatch
    host ms a block, host_prepare ms a block, xRT, per scene for the
    pack) and the dispatch host ms of a control block and of an ingest
    block (median of 10); at the end of the run, device kernels per block
    of each way.
42. (after 35) the ScenePack's block steps on meshes of the card's
    logical devices, each cell replaying CUDA graphs of its own and the
    voice shards' partial mixes summed after the replays: BASELINE config
    5 at 256 scenes x 256 voices on 2 x 2 (phase 38's script: ingest,
    plays and stops, stream closes, idle runs), the host-pool pack 16 x
    256 on 2 x 2 (4 periods of phase 41's script, no fly-by), the sampler pack
    16 x 64 on 2 x 2 (phase 40's) and the dry-run twin on 2 x 4 (its
    plays and moves, then 48 idle blocks), each twice from one seed, once
    under ``core.run.eager()`` and once replaying graphs: bit-equal, every
    kernel's launches equal (the kernels line's K1, K2, K4, K5 and its
    scene form, K6, its arena form and K7 gain ``mesh_graph_launches`` a
    block), every cell captured, replays >= 90% of each pack's calls, no
    recapture; then 188 idle blocks (94 on the host-pool pack, 47 on the
    dry run), 5 control blocks and 5 ingest blocks each way (dispatch
    host ms a block, host_prepare ms a block, xRT per scene, beside the
    same idle blocks' xRT per scene of the pack on a 1 x 1 mesh, replaying
    graphs); the config-5 pack 4 x 64 on [card, CPU] graph against eager,
    the card cell replaying; at the end of the run each graph pack's
    device ms a block over its untraced wall ms a block on 8 idle blocks,
    the device's busy share.
43. (after 42) the Renderer's and the pack's block steps as CUDA graphs
    on the last two built-in spatial pools: the spatial sampler (4096
    voices played with ``play_buffered``: 2048 FramesSignal, 1024
    Speed(FramesSignal), 512 Fader(Speed(FramesSignal)) and 512 Cycle
    voices in device-resident buffered pools; K1, K2, K3, ``arena_step``
    and ``fader_step`` inside the graphs), the seek chains (4096 voices
    played with ``play``: 2048 Cycle, 1024 FixedGain(FramesSignal), 1024
    Tanh(FixedGain(Sine)) in device-resident seek pools; ``arena_warp``)
    and a 1 x 1 pack of 16 spatial samplers of 256 voices, each twice
    from one seed, once under ``core.run.eager()`` and once replaying
    graphs, through one script (every 4 blocks ``set_motion`` on 64
    voices, one a discontinuity; every 8 blocks ``set_speed`` on 64 Speed
    voices and ``fade_to`` on 64 Fader voices; one speed past
    ``RESAMPLE_DSMAX`` and back; 64 plays that grow a full pool; a new
    ``Frames`` between two runs; then 64 blocks; the pack 20 blocks):
    bit-equal (-0.0 as 0.0), every kernel's launches equal over the script
    and the timed runs (the kernels line's K1, K2, K3 and K6's arena form
    gain ``graph_launches`` a block), the arena step's forms captured
    inside the graphs, handles' ``is_finished`` equal, rings unmoved after
    the script, recaptures > 0 and no more than the graphs held at the
    growth and at the new arena, replays >= 90% of the calls; then 188
    idle blocks each way and the dispatch host ms of a block after 64
    moves and after 64 speed writes and fades (median of 10), xRT; at the
    end of the run each graph engine's device ms and kernels a block over
    its untraced wall ms on 8 idle blocks, the device's busy share.
Phases 28-35 count launches with the wrappers' counters, never a tracer
session; the packs' block profiles (phases 29 and 30) only print.
The profiles run at the end in this order: the one-kernel checks
(phase 4's reads, the Adapt and Stream steps of 8, 12 and 17, phase 27's
arena steps) before any path's block profile (4, 8, 12, 17, 21-23, 26),
the heavy sessions after which the tracer has come back empty.  The
tracer also loses single records now and then (ROADMAP Q3.6), so each
one-kernel count is one that two consecutive profiled sessions agree on
(``kernel_bench.device_profile(..., exact=True)``), a block profile is
taken again until two consecutive sessions agree within 10% (up to 8,
else the line says UNSETTLED), and a kernel's ``device_ms`` stands only
where two consecutive sessions count the same kernels and agree within
10%, else it reads "not measured".
Each kernel's bound is the larger of the bytes it must move over the
card's 3.35 TB/s and its float32 operations over 67 TFLOP/s (the
published H100 SXM peaks), from the timed case's own inputs.  Each
kernel and library yardstick is timed three ways over 50 back-to-back
calls (``timed``): ``ms`` with CUDA events (host issue included),
``device_ms`` the device work the calls launched (torch.profiler) and
``host_ms`` the host's issue time.  K1, K4, K5 and K9, whose operands
(or read spans) fit in the card's 50 MB L2, are timed again cold, each
call on the next of several operand sets whose bytes pass the L2
(``utils/kernel_bench.py``; ``cold``, ``library_cold``); K2 and K3 are
timed cold over 8 captured blocks and groups.  The
line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

import contextlib
import json
import sys
import time
import types

import numpy as np
import torch

VOICES = 4096
RATE = 48000
BLOCK = 512
TOL = 1e-5  # PARITY.md contract, port on the card vs port on the CPU
HBM_BPS = 3.35e12  # H100 SXM device memory, bytes/s
F32_OPS = 67e12  # H100 SXM float32 outside the tensor cores, FLOP/s


def bound(nbytes, nops):
    """(ms, "bytes" or "operations"): the least time the card could take."""
    tb, to = 1e3 * nbytes / HBM_BPS, 1e3 * nops / F32_OPS
    return (tb, "bytes") if tb >= to else (to, "operations")


def span_bytes(idx):
    """Bytes a gather must read: per row of the (R, ...) int index tensor,
    the span from its smallest index to its largest plus the lerp's next
    sample."""
    flat = idx.reshape(idx.shape[0], -1)
    return 4 * int((flat.max(dim=1).values - flat.min(dim=1).values + 2).sum())


#: K8-K10's LAUNCHES keys and their names in the kernels line
FLAT_KERNELS = {"window_select": "window_select", "flat_append": "flat_append_aligned",
                "dma_window_select": "dma_window_select"}
#: K8-K10's launches summed over the path runs (they belong to no path)
FLAT_PATH_LAUNCHES = dict.fromkeys(FLAT_KERNELS, 0)


#: (phase, label, proto, args) of captured Adapt-pool steps
#: (``step_kernel_counts``) and (phase, label, render, blocks) of path
#: renders (``block_profiles``), profiled at the end of the run
STEPS, BLOCK_PROFILES = [], []


def capture_path_steps(phase, engine, render):
    """Render through ``render()`` under ``core.run.eager()`` with every
    device-resident pool of ``engine`` spied on, and keep each Adapt
    pool's last step for ``step_kernel_counts`` (op by op: a replayed
    graph calls no render, and a capture would hand the spy tensors of
    the graph's pool)."""
    from oddio_tpu_torch.utils import kernel_bench as KB

    caps = KB.capture_steps(KB.dr_pools(engine), render)
    for p, calls in caps.items():
        if calls and type(p.proto).__name__ == "Adapt":
            STEPS.append((phase, f"{type(p.proto.inner).__name__} V={p.capacity} "
                                 f"n={calls[-1][3]}", p.proto, calls[-1]))


#: the tracer loses records now and then (ROADMAP Q3.6): a profile is taken
#: again until two consecutive sessions agree within SETTLE_REL, up to
#: SETTLE_TRIES sessions (``kernel_bench.device_profile(..., exact=True)``'s
#: rule, with a tolerance for figures that are not exact counts)
SETTLE_TRIES, SETTLE_REL = 8, 0.10


def _agree(a, b):
    return a > 0 and b > 0 and abs(a - b) <= SETTLE_REL * max(a, b)


def block_profiles(tag):
    """Phases 4, 8, 12, 17, 21-23 and 26's path profiles, run after every
    one-kernel check (these sessions are the heavy ones): device kernels
    per block of each path."""
    from oddio_tpu_torch.utils import kernel_bench as KB

    for phase, label, render, nblk in BLOCK_PROFILES:
        seen = []
        for _ in range(SETTLE_TRIES):
            seen.append(KB.device_profile(render, reps=1)[1] / nblk)
            if len(seen) > 1 and _agree(seen[-2], seen[-1]):
                break
        if len(seen) > 1 and _agree(seen[-2], seen[-1]):
            note = f"{len(seen)} sessions, the last two within {100 * SETTLE_REL:g}%"
        else:
            note = (f"UNSETTLED: no two consecutive of {len(seen)} sessions within "
                    f"{100 * SETTLE_REL:g}%: {[round(x, 1) for x in seen]}")
        print(f"phase {phase} profile: {seen[-1]:.1f} device kernels per block of {label} "
              f"({nblk} blocks; {note}) {tag}")


def step_kernel_counts(tag):
    """Phases 8, 12 and 17's step profiles, run at the end (a profiled
    session slows every later host call) and before the path profiles:
    device kernels of each captured Adapt pool's step (its whole render
    less its inner's): exactly one where the step routes to K7, and of its
    Stream step exactly one where the read routes to K6."""
    from oddio_tpu_torch.ops import agc as A
    from oddio_tpu_torch.utils import kernel_bench as KB

    bad = []
    for phase, label, proto, args in STEPS:
        k_adapt, k_stream = KB.step_kernels(proto, args)
        samples_n = args[3]
        k7 = bool(getattr(proto, "_pool_ema_fast", False)) and samples_n <= A.AGC_NMAX
        k6 = k_stream is not None and proto.inner._kernel_ok(samples_n)
        print(f"phase {phase} profile: Adapt({label}) pool: Adapt step {k_adapt:g} device "
              f"kernels (K7 route: {k7})" + ("" if k_stream is None else
                                             f", Stream step {k_stream:g} (K6 route: {k6})")
              + f" {tag}")
        if (k7 and k_adapt != 1) or (k6 and k_stream != 1) or not k7:
            bad.append((phase, label, k_adapt, k_stream, k7, k6))
    if bad:
        raise AssertionError(f"a device-resident step is not one device kernel (or an Adapt "
                             f"pool of a path left K7): {bad}")


def reset_launches():
    """Every kernel's launch count to 0, just before a path's run."""
    from oddio_tpu_torch.ops import agc, flat_kernels, ring_kernels, stream_kernels

    for m in (ring_kernels, stream_kernels, agc, flat_kernels):
        m.reset_launches()


def read_flat_launches(label):
    """Add K8-K10's launches on the path run just made to
    ``FLAT_PATH_LAUNCHES``; none of the package's paths calls them, so a
    launch fails the run."""
    from oddio_tpu_torch.ops import flat_kernels as FK

    for k, v in FK.LAUNCHES.items():
        FLAT_PATH_LAUNCHES[k] += v
    if any(FK.LAUNCHES.values()):
        raise AssertionError(f"{label} launched K8-K10: {FK.LAUNCHES}")


#: K6's arena-form launch counters: the read-only entry, which no path
#: calls, and the whole steps of the sampler paths
ARENA_KEYS = ("arena_resample", "arena_step")


def stream_launches(SK, label):
    """K4's and K6's stream-ring launches on a path run just made, which
    holds no sampler voice: K6's arena form must not have launched."""
    if any(SK.LAUNCHES[k] for k in ARENA_KEYS):
        raise AssertionError(f"{label} launched K6's arena form: "
                             f"{[SK.LAUNCHES[k] for k in ARENA_KEYS]}")
    return {k: v for k, v in SK.LAUNCHES.items() if k not in ARENA_KEYS}


def time_ms(fn, reps=50):
    """Time per call of ``reps`` back-to-back calls, host issue included:
    CUDA events recorded before and after the calls (after a warm-up
    call), so where the host issues a call more slowly than the device
    runs it, this is the host's time."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


#: (label, fn, reps, result) of every ``timed`` call, whose device_ms
#: ``profile_device`` fills in at the end of the run
DEFERRED = []


def timed(label, fn, reps=50):
    """``{"ms", "device_ms", "host_ms"}`` per call of ``fn``, each over
    ``reps`` back-to-back calls: ``ms`` as ``time_ms``; ``host_ms`` the
    wall clock of the calls with no synchronise, the host's issue time;
    ``device_ms`` (None until ``profile_device`` runs) the summed duration
    of every device activity the calls launch.  The profiler runs last:
    after a ``torch.profiler`` run every later CUDA call cost the host
    more, and with it every later host time and xRT of the run; ``fn`` is
    kept with its free variables' values of now, as loops rebind them."""
    ms = time_ms(fn, reps)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = 1e3 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    if fn.__closure__:
        cells = tuple(types.CellType(c.cell_contents) for c in fn.__closure__)
        fn = types.FunctionType(fn.__code__, fn.__globals__, closure=cells)
    result = {"ms": ms, "device_ms": None, "host_ms": host}
    DEFERRED.append((label, fn, reps, result))
    return result


def profile_device(tag):
    """Fill in device_ms of every ``timed`` call from ``torch.profiler``
    over the same number of calls, and print them.  The tracer loses
    records now and then (ROADMAP Q3.6), so a figure stands only where two
    consecutive sessions, neither holding a stale record, count the same
    kernels and sum device times within SETTLE_REL of each other, within
    SETTLE_TRIES sessions; else it is "not measured" (None), never a low
    number."""
    from oddio_tpu_torch.utils import kernel_bench as KB

    for label, fn, reps, result in DEFERRED:
        seen = []
        for _ in range(SETTLE_TRIES):
            split, kernels, stale = KB._session(fn, reps)
            seen.append((sum(split.values()), kernels, stale))
            if (len(seen) > 1 and not seen[-1][2] and not seen[-2][2]
                    and seen[-1][1] == seen[-2][1] and _agree(seen[-2][0], seen[-1][0])):
                break
        else:
            seen.append(None)
        settled = seen[-1] is not None
        result["device_ms"] = seen[-1][0] if settled else None
        dev = (f"{result['device_ms']:.4f}" if settled else
               f"not measured (no two consecutive of {SETTLE_TRIES} sessions agreed: "
               f"{[(round(x[0], 4), x[1], x[2]) for x in seen[:-1]]})")
        print(f"device time {label}: {dev} ms per call (ms {result['ms']:.4f}, host issue "
              f"{result['host_ms']:.4f}; {len(seen) - (not settled)} sessions) {tag}")
    DEFERRED.clear()


def times_str(t):
    """A ``timed`` result as text (device_ms follows at the run's end)."""
    return f"{t['ms']:.4f} ms (host issue {t['host_ms']:.4f})"


def record(replaces, source, err, t, plain_ms, bound_ms, bound_by, library=None):
    """One kernel's entry of the kernels line; ``t`` and ``library`` are
    ``timed`` results, kept by reference until ``profile_device`` has
    filled in their device_ms (``library`` None where no one PyTorch call
    computes the function)."""
    return dict(replaces=replaces, source=source, err=err, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, times=t, library=library or {})


def kernel_line(name, k):
    """A kernel's entry of the kernels JSON line (K1 and K9 add ``timed``
    results: their other form's under "other_form", their cold times
    under "cold" and "library_cold")."""
    t, lib = k["times"], k["library"]
    line = {"name": name, "route": "cuda", "source": k["source"], "replaces": k["replaces"],
            "launches": k.get("launches"), "max_abs_err": k["err"], "ms": t["ms"],
            "device_ms": t["device_ms"], "host_ms": t["host_ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": lib.get("ms"), "library_device_ms": lib.get("device_ms"),
            "library_host_ms": lib.get("host_ms")}
    return {**line, **{key: k[key] for key in ("other_form", "cold", "library_cold", "host_pool",
                                               "pack_launches", "graph_launches",
                                               "mesh_launches", "mesh_graph_launches",
                                               "resume_launches", "realtime_launches",
                                               "shapes")
                     if key in k}}


#: the buffered pool's ring geometry at 48 kHz: front pad, ring modulus,
#: mirror (spatial.py W_CHUNK, cap_pool, M_PAD) and 1024 floats of slack
FP, CAP, MPAD = 1024, 16384, 1024
RPV_MAIN = (FP + CAP + MPAD + 1024) // 128


def rows_append_check(dev, tag):
    """Phase 3, K1 at the buffered pool's shapes: a 4096-voice ring of
    ``RPV_MAIN`` rows, the 512-frame slab cut from the pool's 513-frame
    render (row stride 513, not 16-byte aligned) and its contiguous copy,
    exact against the plain versions with the rows as device int32
    scalars and as host ints, and through the cursor form at write
    cursors 0, M - 128, M, 5120 and cap - 512.  Timed with device rows and
    through the cursor form on the stride-513 slab, the main path's call,
    beside one ``index_copy_`` of both legs, warm (the same operands every
    call) and, the cursor form and ``index_copy_``, cold.  Returns K1's
    record: the cursor form's times, the row form's under "other_form"."""
    from oddio_tpu_torch.ops import ring_kernels as RK
    from oddio_tpu_torch.utils import kernel_bench as AB

    V, W = VOICES, BLOCK
    ring = torch.randn((V, RPV_MAIN, 128), device=dev)
    slab = torch.randn((V, W + 1), device=dev)[:, :W]
    rows = torch.tensor([48, 144], dtype=torch.int32, device=dev)
    starts = [0, MPAD - 128, MPAD, 5120, CAP - W]
    err = 0.0
    for src in (slab, slab.contiguous()):
        plain = RK.rows_append_plain(ring.clone(), src, 48, 144)
        for form in ((rows[0], rows[1]), (48, 144)):
            got = RK.rows_append(ring.clone(), src, *form)
            torch.cuda.synchronize()
            err = max(err, float((got - plain).abs().max()))
        for st in starts:
            start = torch.tensor([st], dtype=torch.int32, device=dev)
            plain = RK.rows_append_cursor_plain(ring.clone(), src, start, FP, CAP, MPAD)
            got = RK.rows_append_cursor(ring.clone(), src, start, FP, CAP, MPAD)
            torch.cuda.synchronize()
            err = max(err, float((got - plain).abs().max()))
    if err != 0.0:
        raise AssertionError(f"rows_append differs from its plain version by {err}")
    start = torch.tensor([5120], dtype=torch.int32, device=dev)  # rows 48 and 144
    trows = timed("K1 rows_append, device rows",
                  lambda: RK.rows_append(ring, slab, rows[0], rows[1]))
    tk = timed("K1 rows_append_cursor",
               lambda: RK.rows_append_cursor(ring, slab, start, FP, CAP, MPAD))
    pms = time_ms(lambda: RK.rows_append_plain(ring, slab, rows[0], rows[1]))
    # the library yardstick: one index_copy_ of both legs (index and the
    # doubled slab prepared outside the timed call)
    both = torch.cat([torch.arange(4, device=dev) + 48, torch.arange(4, device=dev) + 144])
    slab2 = torch.cat([slab.reshape(V, 4, 128)] * 2, dim=1)
    lt = timed("index_copy_ (K1)", lambda: ring.index_copy_(1, both, slab2))
    sets = AB.k1_sets(dev, AB.SETS)
    tc = timed("K1 rows_append_cursor, cold", AB.cycling(
        sets, lambda r, s, _: RK.rows_append_cursor(r, s, start, FP, CAP, MPAD)))
    lc = timed("index_copy_ (K1), cold", AB.cycling(
        sets, lambda r, _, s2: r.index_copy_(1, both, s2)))
    bms, by = bound(3 * V * W * 4 + 8, 0)
    print(f"K1 rows_append V={V} W={W} (slab stride {slab.stride(0)}): max|diff| {err} "
          f"(tolerance 0, exact; device rows, host ints, cursor form at {len(starts)} "
          f"cursors); device rows {times_str(trows)}; cursor form {times_str(tk)}, cold "
          f"{times_str(tc)}; plain {pms:.4f} ms, index_copy_ {times_str(lt)}, cold "
          f"{times_str(lc)}; bound {bms:.4f} ms ({by}) {tag}")
    rec = record("oddio_tpu/ops/pallas_ring.py:932", "oddio_tpu_torch/csrc/ring_kernels.cu",
                 err, tk, pms, bms, by, lt)
    rec.update(other_form=trows, cold=tc, library_cold=lc)
    return rec


def read_geometry(pool):
    """The pool's ring geometry as the K2/K3 wrappers take it."""
    return dict(DMAX=pool.emax2, FP=pool.W_CHUNK, cap=pool.cap_pool)


def held(M, key, label, call, plain, tol):
    """Two calls of a K2/K3 or K8/K10 wrapper (``M`` its module, ``key``
    its ``LAUNCHES`` entry): one launch each, bit-equal, the cluster sum's
    tickets left zeroed, within ``tol`` of ``plain``; returns (max |diff|,
    share of the tolerance)."""
    from oddio_tpu_torch.ops import ring_kernels as RK

    before = M.LAUNCHES[key]
    got = call()
    again = call()
    torch.cuda.synchronize()
    if M.LAUNCHES[key] != before + 2:
        raise AssertionError(f"{label}: {M.LAUNCHES[key] - before} launches for 2 calls")
    if not torch.equal(got, again):
        raise AssertionError(f"{label}: two runs differ")
    ticket = RK._CLUSTER_SCRATCH.get(got.device, (None, None))[1]
    if ticket is not None and bool(ticket.any()):
        raise AssertionError(f"{label}: a cluster ticket left set")
    if not float(plain.abs().max()) > 1e-3:
        raise AssertionError(f"{label}: a silent read")
    return within(got, plain, tol, label)


def ring_read_checks(dev, tag):
    """Phase 3, K2 and K3 against their plain versions, on the operands of
    the 4096-voice buffered scene itself (its pool's ``render`` and
    ``render_multi`` arguments captured through a Renderer, their read
    operands from ``_advance_block``): an idle block's read, the delta
    block's, the same with frozen ears, with every window ending in the
    mirror, the main pass with ``tight`` at K = 128, the family sub-pass
    (a 256-entry list) at the two sub-pass tiers, three 512-frame chunks;
    a captured fused group and a synthetic one that wraps the ring's
    modulus.  Elementwise within ``mix_tolerance``; two runs bit-equal;
    one launch per call.  Timed warm and cold (each call on the next of 8
    captured blocks or groups).  Returns (K2 record, K3 record, the
    captured scene's (pool, delta, singles, groups) for phase 4)."""
    from oddio_tpu_torch.ops import ring_kernels as RK
    from oddio_tpu_torch.utils import kernel_bench as KB
    from oddio_tpu_torch.utils.scene_profile import build_spatial

    rng = np.random.default_rng(3)
    t0 = time.perf_counter()
    captured = KB.capture_states(build_spatial(True, VOICES, dev)[1])
    pool, delta, singles, groups = captured
    geo = read_geometry(pool)
    R, K = pool._read_cfg
    n = BLOCK
    S, ros = KB.block_reads(pool, *singles[0])
    ring, ro = S["ring"], ros[0]
    print(f"K2/K3 operands: {VOICES}-voice buffered scene, tier (R, K) = ({R}, {K}), captured "
          f"in {time.perf_counter() - t0:.2f} s {tag}")

    def k2(label, ro_, n_=n, **kw):
        kw = {**dict(n=n_, K=K, R=R, **geo), **kw}
        plain = RK.ring_select_ears_plain(ring, ro_, **kw)
        err, share = held(RK, "select_ears", f"ring_select_ears {label}",
                          lambda: RK.ring_select_ears(ring, ro_, **kw), plain,
                          RK.ring_select_ears_tolerance(ring, ro_, **kw))
        print(f"K2 ring_select_ears {label} (R, K) = ({kw['R']}, {kw['K']}) n={n_}: max|diff| "
              f"{err:.3e} ({share:.3f} of its tolerance), one launch, two runs bit-equal {tag}")
        return err

    errs = [k2("idle block", ro), k2("delta block", KB.block_reads(pool, *delta)[1][0])]
    frz = dict(ro, frz_c=[torch.tensor(rng.uniform(0, 1, VOICES) < 0.3, device=dev).float()
                          for _ in range(2)])
    errs.append(k2("frozen ears", frz))
    end = geo["cap"] + K - torch.tensor(rng.integers(1, 48, VOICES), dtype=torch.int32, device=dev)
    shift = end - ro["base_c"][0]
    errs.append(k2("windows ending in the mirror", dict(ro, base_c=[b + shift for b in ro["base_c"]])))
    syn = KB.read_operands(dev, rng, VOICES, 128, 512, frozen=0.3)
    tight = torch.tensor(rng.uniform(0, 1, VOICES) > 0.1, device=dev).float()
    errs.append(k2("tight", syn, K=128, tight=tight))
    idx = np.zeros(256, np.int32)
    idx[:200] = rng.choice(VOICES, 200, replace=False)
    sub = dict(sub_idx=torch.tensor(idx, device=dev), sub_on=torch.tensor(
        (np.arange(256) < 200).astype(np.float32), device=dev))
    for r_, k_ in ((256, 256), (128, 192)):
        errs.append(k2("sub-pass", KB.read_operands(dev, rng, VOICES, k_, r_), K=k_, R=r_, **sub))
    errs.append(k2("three chunks", KB.read_operands(dev, rng, VOICES, 64, 512), n_=3 * n, K=64))

    kw2 = dict(n=n, K=K, R=R, **geo)
    reads = [(S_["ring"], ros_[0]) for S_, ros_ in (KB.block_reads(pool, *s) for s in singles)]
    tk = timed("K2 ring_select_ears, idle block", lambda: RK.ring_select_ears(ring, ro, **kw2))
    tc = timed("K2 ring_select_ears, idle block, cold", KB.cycling(
        reads, lambda r_, o_: RK.ring_select_ears(r_, o_, **kw2)))
    pms = time_ms(lambda: RK.ring_select_ears_plain(ring, ro, **kw2))
    bms, by = bound(KB.read_bytes([ro], n), 21 * VOICES * 2 * n)
    print(f"K2 ring_select_ears idle block V={VOICES}: {times_str(tk)}, cold {times_str(tc)} vs "
          f"plain {pms:.4f} ms, bound {bms:.4f} ms ({by}) {tag}")
    rec2 = record("oddio_tpu/ops/pallas_ring.py:724", "oddio_tpu_torch/csrc/ring_kernels.cu",
                  max(errs), tk, pms, bms, by)
    rec2["cold"] = tc

    nb = groups[0][4]
    row0s, hs = RK.multi_rows(pool._prep_inv[2], K, nb)
    kw3 = dict(n=n, K=K, row0s=row0s, hs=hs, **geo)
    gros = [KB.block_reads(pool, *g)[1] for g in groups]
    errs = []
    wrap_ros, w0s, whs = KB.group_operands(
        dev, rng, VOICES, 64, n, geo["cap"] - rng.integers(200, 900, VOICES), nb=nb)
    for label, ros_, kw in (("captured group", gros[0], kw3),
                            ("group across the modulus", wrap_ros,
                             dict(kw3, K=64, row0s=w0s, hs=whs))):
        plain = RK.ring_select_multi_plain(ring, ros_, **kw)
        err, share = held(RK, "select_multi", f"ring_select_multi {label}",
                          lambda: RK.ring_select_multi(ring, ros_, **kw), plain,
                          RK.ring_select_multi_tolerance(ring, ros_, **kw))
        errs.append(err)
        print(f"K3 ring_select_multi {label} nb={nb} K={kw['K']}: max|diff| {err:.3e} "
              f"({share:.3f} of its tolerance), one launch, two runs bit-equal {tag}")
    tk = timed(f"K3 ring_select_multi nb={nb}", lambda: RK.ring_select_multi(ring, gros[0], **kw3))
    tc = timed(f"K3 ring_select_multi nb={nb}, cold", KB.cycling(
        [(g,) for g in gros], lambda ros_: RK.ring_select_multi(ring, ros_, **kw3)))
    pms = time_ms(lambda: RK.ring_select_multi_plain(ring, gros[0], **kw3))
    bms, by = bound(KB.read_bytes(gros[0], n), 21 * VOICES * 2 * n * nb)
    print(f"K3 ring_select_multi nb={nb} V={VOICES}: {times_str(tk)}, cold {times_str(tc)} vs "
          f"plain {pms:.4f} ms, bound {bms:.4f} ms ({by}) {tag}")
    rec3 = record("oddio_tpu/ops/pallas_ring.py:843", "oddio_tpu_torch/csrc/ring_kernels.cu",
                  max(errs), tk, pms, bms, by)
    rec3["cold"] = tc
    return rec2, rec3, captured


def read_kernel_counts(captured, tag):
    """Phase 4's read profile, the run's first profiled sessions (a
    profiled session slows every later host call): the device kernels of
    one pool read alone and of the reads of a delta block and of an idle
    fused group (``render`` less ``_advance_block`` on the same captured
    state), each exactly one."""
    from oddio_tpu_torch.ops import ring_kernels as RK
    from oddio_tpu_torch.utils import kernel_bench as KB

    pool, delta, singles, groups = captured
    S, ros = KB.block_reads(pool, *singles[0])
    R, K = pool._read_cfg
    kw = dict(n=BLOCK, K=K, R=R, **read_geometry(pool))
    counts = {"one pool read alone": KB.device_profile(
        lambda: RK.ring_select_ears(S["ring"], ros[0], **kw), reps=1, exact=True)[1]}
    for label, state, whole in (("a delta block's read", delta, pool.render),
                                ("an idle block's read", singles[1], pool.render),
                                ("an idle group's read", groups[1], pool.render_multi)):
        counts[label] = (KB.device_profile(lambda: whole(*state), reps=1, exact=True)[1]
                         - KB.device_profile(lambda: KB.block_reads(pool, *state), reps=1,
                                             exact=True)[1])
    print(f"phase 4 profile: device kernels {counts} {tag}")
    if any(v != 1 for v in counts.values()):
        raise AssertionError(f"a pool read is not one device kernel: {counts}")


def place_timed(label, warm, cold_sets, call, lib_call):
    """K4 and ``index_put_`` timed warm (``warm``) and cold (each call on the
    next of ``cold_sets``): (kernel, library, kernel cold, library cold)."""
    from oddio_tpu_torch.utils import kernel_bench as KB

    return (timed(f"K4 {label}", lambda: call(*warm)),
            timed(f"index_put_ (K4 {label})", lambda: lib_call(*warm)),
            timed(f"K4 {label}, cold", KB.cycling(cold_sets, call)),
            timed(f"index_put_ (K4 {label}), cold", KB.cycling(cold_sets, lib_call)))


def ring_place_checks(dev, tag):
    """K4 exact against its plain version: at the mixer's shape (512 rows of
    2816, mw = 2401 and 128, every other write wrapping, counts uniform in
    [0, mw]), through the channel map with two rows per voice, and at the
    host pool's shape (4096 rings of 16384, 513-frame chunks, n_write 512
    or 513) through the record form; one launch per call.  Timed warm and
    cold beside one ``index_put_`` of the written lanes.  Returns K4's
    record (the mixer shape at mw = 2401, as PRs 2-5 kept it; the host
    pool's under "host_pool")."""
    from oddio_tpu_torch.ops import ring_kernels as RK
    from oddio_tpu_torch.ops import stream_kernels as SK
    from oddio_tpu_torch.utils import kernel_bench as KB

    rng = np.random.default_rng(7)
    rows, size, mws = KB.PLACE_MIXER
    rec = None

    def exact(got, plain, label):
        torch.cuda.synchronize()
        err = float((got - plain).abs().max())
        if err != 0.0:
            raise AssertionError(f"ring_place ({label}) differs from its plain version by {err}")

    def launched(before, k, label):
        if SK.LAUNCHES["ring_place"] != before + k:
            raise AssertionError(f"ring_place ({label}): {SK.LAUNCHES['ring_place'] - before} "
                                 f"launches for {k} calls")

    for mw in mws:
        sets = []
        for _ in range(KB.PLACE_RINGS):
            ring = torch.randn((rows, size), device=dev)
            ops = KB.place_operands(dev, rng, rows, size, mw, False)
            sets.append((ring,) + ops + KB.place_library(ring, *ops))
        ring, chunk, wpos, wcount = sets[0][:4]
        before = SK.LAUNCHES["ring_place"]
        exact(SK.ring_place(ring.clone(), chunk, wpos, wcount),
              SK.ring_place_plain(ring.clone(), chunk, wpos, wcount), f"mw={mw}")
        # two channel rows per voice: voice r // 2's cursor and count
        half = slice(0, rows // 2)
        exact(SK.ring_place(ring.clone(), chunk, wpos[half], wcount[half], channels=2),
              SK.ring_place_plain(ring.clone(), chunk, wpos[half], wcount[half], channels=2),
              f"mw={mw}, 2 channels")
        launched(before, 2, f"mw={mw}")
        tk, lt, tc, lc = place_timed(
            f"ring_place mixer mw={mw}", sets[0], sets,
            lambda r, c, p, k, *_: SK.ring_place(r, c, p, k),
            lambda r, c, p, k, fi, vals: r.view(-1).index_put_((fi,), vals))
        pms = time_ms(lambda: SK.ring_place_plain(ring, chunk, wpos, wcount))
        bms, by = bound(8 * int(wcount.sum()) + 8 * rows, 0)
        print(f"K4 ring_place V={rows} mw={mw}: max|diff| 0.0 (tolerance 0, exact; one and two "
              f"channels); {times_str(tk)}, cold {times_str(tc)} vs plain {pms:.4f} ms, "
              f"index_put_ {times_str(lt)}, cold {times_str(lc)}, bound {bms:.4f} ms ({by}) {tag}")
        if mw == 2401:
            rec = record("oddio_tpu/ops/pallas_ring.py:148", "oddio_tpu_torch/csrc/stream_kernels.cu",
                         0.0, tk, pms, bms, by, lt)
            rec.update(cold=tc, library_cold=lc)
        del sets

    rows, size, mw = KB.PLACE_HOST
    ring = torch.randn((rows, size), device=dev)
    sets = []
    for _ in range(KB.SETS):
        ops = KB.place_operands(dev, rng, rows, size, mw, True)
        sets.append((ring,) + ops + (KB.place_record(RK, ops[1], ops[2]),)
                    + KB.place_library(ring, *ops))
    _, chunk, wpos, wcount, vrec = sets[0][:5]
    before = SK.LAUNCHES["ring_place"]
    plain = SK.ring_place_plain(ring.clone(), chunk, wpos, wcount)
    exact(SK.ring_place_record(ring.clone(), chunk, vrec), plain, "host pool, record form")
    exact(SK.ring_place(ring.clone(), chunk, wpos, wcount), plain, "host pool")
    launched(before, 2, "host pool")
    tk, lt, tc, lc = place_timed(
        f"ring_place_record host-pool mw={mw}", sets[0], sets,
        lambda r, c, p, k, rc, *_: SK.ring_place_record(r, c, rc),
        lambda r, c, p, k, rc, fi, vals: r.view(-1).index_put_((fi,), vals))
    pms = time_ms(lambda: SK.ring_place_record_plain(ring, chunk, vrec))
    bms, by = bound(8 * int(wcount.sum()) + 12 * rows, 0)
    print(f"K4 ring_place_record V={rows} L={size} mw={mw} (host pool): max|diff| 0.0 "
          f"(tolerance 0, exact); {times_str(tk)}, cold {times_str(tc)} vs plain {pms:.4f} ms, "
          f"index_put_ {times_str(lt)}, cold {times_str(lc)}, bound {bms:.4f} ms ({by}) {tag}")
    rec["host_pool"] = dict(shape=[rows, size, mw], times=tk, cold=tc, plain_ms=pms,
                            bound_ms=bms, bound_by=by, library=lt, library_cold=lc)
    return rec


def stream_agc_kernels(dev, kern, tag):
    """Phase 7: K4, K6 and K7 against their plain versions at the shapes the
    pools give them: K4 as ``ring_place_checks``; K6 exactly, in its DR
    form (read and release) and its ds form, at V in {512, 4096, 1} (the
    config-5 stream pool, the host pool, one voice) and ds in {1/6, 1, 4},
    ring 2816 floats per stream, n = 512; K7 within ``agc.agc_tolerance``
    at V in {512, 3584, 4096, 1} (the mixer's pools, one voice), n in
    {512, 513, 128, 100}, one and two channels, a host and a per-voice
    interval, counts below n on half the voices, tau 0.1 s and one within
    1% of the closed form's gate at that n.  Each call one launch; each
    kernel timed warm and cold at its main shape."""
    from oddio_tpu_torch.ops import agc as A
    from oddio_tpu_torch.ops import stream_kernels as SK
    from oddio_tpu_torch.utils import kernel_bench as KB

    rng = np.random.default_rng(7)
    SIZE, n = 2816, BLOCK
    iv = float(np.float32(1.0 / RATE))

    def t(x, dtype=np.float32):
        return torch.tensor(np.asarray(x, dtype), device=dev)

    def launched(mod, key, before, k, label):
        if mod.LAUNCHES[key] != before + k:
            raise AssertionError(f"{label}: {mod.LAUNCHES[key] - before} launches for {k} calls")

    # K4: a 2401-wide prefill chunk and a 128-wide steady one, half wrapping
    # (the mixer's shape), then the host pool's through the record form
    kern["ring_place"] = ring_place_checks(dev, tag)

    # K6: the DR form (read and release) and the ds form, exact
    def k6_operands(V, ds, ring):
        rate = t(np.float32(ds * RATE) * rng.uniform(0.9, 1.0, V))
        cnt = t(rng.integers(n - 1, n + 1, V), np.int32)
        # read offsets in [-0.99, 1): the truncate-toward-zero branch runs
        return (ring, t(rng.uniform(-0.99, 1.0, V)), rate, iv, cnt,
                t(rng.integers(0, SIZE, V), np.int32),
                t(rng.integers(0, int(n * ds) + 3, V), np.int32), n)

    worst = 0.0
    for V in (512, 4096, 1):
        ring = torch.randn((V, SIZE), device=dev)
        for ds in (8000.0 / 48000.0, 1.0, 4.0):
            ops = k6_operands(V, ds, ring)
            dsv = ops[2] * iv
            before = SK.LAUNCHES["ring_resample"]
            got = SK.stream_step(*ops)
            plain = SK.stream_step_plain(*ops)
            got_ds = SK.ring_resample(ring, ops[1], dsv, ops[5], ops[6], n)
            plain_ds = SK.ring_resample_plain(ring, ops[1], dsv, ops[5], ops[6], n)
            torch.cuda.synchronize()
            launched(SK, "ring_resample", before, 2, f"ring_resample V={V} ds={ds:.4f}")
            for label, g, w in zip(("samples", "t'", "len'", "start'", "ds-form samples"),
                                   got + (got_ds,), plain + (plain_ds,)):
                if g.dtype != w.dtype or not torch.equal(g, w):
                    err = float((g.double() - w.double()).abs().max())
                    raise AssertionError(f"ring_resample V={V} ds={ds:.4f}: {label} differ "
                                         f"from the plain version's by {err}")
            print(f"K6 ring_resample V={V} ds={ds:.4f}: DR form (read and release) and ds form "
                  f"equal to their plain versions (tolerance 0, exact), one launch each {tag}")
            if V == 512 and ds < 1.0:
                main = ops
        if V == 512:
            cold_sets = [main] + [k6_operands(512, 8000.0 / 48000.0, torch.randn((512, SIZE),
                                                                               device=dev))
                                  for _ in range(KB.PLACE_RINGS - 1)]
    tk = timed("K6 ring_resample DR form V=512 ds=1/6", lambda: SK.stream_step(*main))
    tc = timed("K6 ring_resample DR form V=512 ds=1/6, cold",
               KB.cycling(cold_sets, SK.stream_step))
    pms = time_ms(lambda: SK.stream_step_plain(*main))
    bms, by = bound(KB.resample_bytes(SK, {"t": main[1], "rate": main[2]}, n), 30 * 512 * n)
    print(f"K6 ring_resample DR form V=512 ds=1/6 (the config-5 stream pool): "
          f"{times_str(tk)}, cold {times_str(tc)} vs plain {pms:.4f} ms, bound {bms:.4f} ms "
          f"({by}) {tag}")
    kern["ring_resample"] = record("oddio_tpu/ops/pallas_ring.py:1203",
                                   "oddio_tpu_torch/csrc/stream_kernels.cu", worst, tk, pms,
                                   bms, by)
    kern["ring_resample"]["cold"] = tc
    del cold_sets

    # K7: the whole Adapt step
    def k7_operands(V, n_, C, per_voice, tau):
        shape = (V, n_) if C == 1 else (V, C, n_)
        amp = rng.choice([0.01, 0.1, 0.5, 1.0], (V,) + (1,) * (len(shape) - 1))
        cnt = np.where(np.arange(V) < V // 2, n_, rng.integers(0, n_ + 1, V))
        ivv = t(rng.uniform(0.8, 1.25, V) * iv) if per_voice else iv
        return (t(rng.standard_normal(shape) * amp), t(rng.uniform(1e-3, 0.3, V)),
                t(np.full(V, np.float32(tau))), ivv, t(cnt, np.int32),
                t(np.full(V, 0.1 / np.sqrt(2))), t(np.full(V, 0.5 / np.sqrt(2))),
                t(np.full(V, 4.0)), n_)

    worst, share = 0.0, 0.0
    for iV, V in enumerate((512, 3584, 4096, 1)):
        for i_n, n_ in enumerate((512, 513, 128, 100)):
            C = 1 + (iV + i_n) % 2
            per_voice = (iV // 2 + i_n) % 2 == 1
            # tau 0.1 s and one within 1% of the gate at this n (per-voice
            # intervals reach 1.25x the scalar one)
            for tau in (0.1, n_ * iv * (1.25 if per_voice else 1.0) / (0.99 * A.EMA_GATE)):
                ops = k7_operands(V, n_, C, per_voice, tau)
                before = A.LAUNCHES["agc_gains"]
                out, carry = A.agc_step(*ops)
                pout, pcarry = A.agc_step_plain(*ops)
                torch.cuda.synchronize()
                launched(A, "agc_gains", before, 1, f"agc_step V={V} n={n_}")
                tol_x, tol_c = A.agc_tolerance(*ops)
                dx = (out - pout).abs().double()
                dc = (carry - pcarry).abs().double()
                ratio = max(float((dx / tol_x.clamp_min(1e-300)).max()),
                            float((dc / tol_c.clamp_min(1e-300)).max()))
                err = max(float(dx.max()), float(dc.max()))
                if not ratio <= 1.0 or not bool(torch.isfinite(out).all()):
                    raise AssertionError(
                        f"agc_step V={V} n={n_} C={C} per_voice={per_voice} tau={tau:.3g}: "
                        f"kernel disagrees with its plain version: max|diff| {err:.3e}, "
                        f"{ratio:.1f}x its tolerance")
                worst, share = max(worst, err), max(share, ratio)
            print(f"K7 agc_step V={V} n={n_} C={C} interval {'per voice' if per_voice else 'host'}"
                  f", tau 0.1 s and near the gate: within tolerance {tag}")
    ops = k7_operands(4096, n, 1, False, 0.1)
    cold_sets = [ops[:-1]] + [k7_operands(4096, n, 1, False, 0.1)[:-1]
                              for _ in range(KB.SETS - 1)]
    tk = timed("K7 agc_step V=4096 n=512", lambda: A.agc_step(*ops))
    tc = timed("K7 agc_step V=4096 n=512, cold",
               KB.cycling(cold_sets, lambda *o: A.agc_step(*o, n)))
    ops513 = k7_operands(512, 513, 1, False, 0.1)
    t513 = timed("K7 agc_step V=512 n=513", lambda: A.agc_step(*ops513))
    pms = time_ms(lambda: A.agc_step_plain(*ops))
    # samples in, output out, 24 bytes of columns in and the carry out;
    # ~20 f32 operations per frame (square, prefix sum, exp, sqrt, clamps)
    bms, by = bound(8 * 4096 * n + 28 * 4096, 20 * 4096 * n)
    print(f"K7 agc_step V=4096 n={n}: max|diff| {worst:.3e} over every case ({share:.3f} of its "
          f"tolerance); {times_str(tk)}, cold {times_str(tc)}; V=512 n=513 {times_str(t513)}; "
          f"vs plain {pms:.4f} ms, bound {bms:.4f} ms ({by}) {tag}")
    kern["agc_gains"] = record("oddio_tpu/ops/pallas_agc.py:155",
                               "oddio_tpu_torch/csrc/agc_kernel.cu", worst, tk, pms, bms, by)
    kern["agc_gains"]["cold"] = tc


def mixer_path(pt, dev, kern, tag):
    """Phases 8-10: the config-5 mixer at 4096 voices (launch counts), at
    256 voices card vs CPU, and its real-time factor."""
    from oddio_tpu_torch.ops import agc as A
    from oddio_tpu_torch.ops import ring_kernels as RK
    from oddio_tpu_torch.ops import stream_kernels as SK
    from oddio_tpu_torch.utils.scene_profile import build_mixer_agc, feed

    t0 = time.perf_counter()
    _, mixer, ctls, rng = build_mixer_agc(VOICES, dev)
    r = pt.Renderer(mixer, RATE)
    print(f"mixer: {VOICES} voices ({len(ctls)} Adapt(Stream), {VOICES - len(ctls)} "
          f"Adapt(Sine)) built in {time.perf_counter() - t0:.2f} s {tag}")
    reset_launches()
    a = r.render_frames(RATE)
    feed(ctls, rng, 1024)
    dev_out = r.render_frames_device(BLOCK * 94)
    torch.cuda.synchronize()
    launches = {**stream_launches(SK, "the mixer path"), **A.LAUNCHES}
    ring_launches = dict(RK.LAUNCHES)
    read_flat_launches("the mixer path")
    mixer.sync()
    b = torch.cat([o.permute(0, 2, 1).reshape(-1, 1) for o in dev_out]).cpu().numpy()
    for name, x in (("mixer render_frames", a), ("mixer render_frames_device", b)):
        if not np.isfinite(x).all() or np.abs(x).max() <= 1e-3:
            raise AssertionError(f"{name}: non-finite or silent output")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the mixer path never launched: {launches}")
    if any(ring_launches.values()):
        raise AssertionError(f"the mixer path launched ring kernels: {ring_launches}")
    for name in launches:
        kern[name]["launches"] = launches[name]
    print(f"mixer path: 1 s + {BLOCK * 94 / RATE:.3f} s, peak |out| {np.abs(a).max():.4f}/"
          f"{np.abs(b).max():.4f}; launches {launches}, per block "
          f"{ {k: v / (-(-RATE // BLOCK) + 94) for k, v in launches.items()} } {tag}")
    capture_path_steps(8, mixer, lambda: r.render_frames(BLOCK * 2))
    BLOCK_PROFILES.append((8, f"the {VOICES}-voice config-5 mixer",
                           lambda: r.render_frames_device(BLOCK * 8, sync=False), 8))

    # -- 9. 256 voices on the card vs the CPU ----------------------------------
    outs = []
    for device in (dev, "cpu"):
        _, m256, c256, rng256 = build_mixer_agc(256, device)
        r256 = pt.Renderer(m256, RATE)
        x = r256.render_frames(BLOCK * 24)
        feed(c256, rng256, 1024)
        outs.append(np.concatenate([x, r256.render_frames(BLOCK * 24)]))
    err = float(np.abs(outs[0] - outs[1]).max())
    if not err <= TOL:
        raise AssertionError(f"256-voice mixer card render differs from the CPU render by {err}")
    print(f"reference: 256-voice mixer, card vs CPU plain, 48 blocks, max|diff| {err:.3e} "
          f"(<= {TOL}) {tag}")

    # -- 10. real-time factor ---------------------------------------------------
    r.render_frames_device(BLOCK * 94, sync=False)
    feed(ctls, rng, 1024)  # the timed run starts with an ingest block
    torch.cuda.synchronize()
    nblk = 188
    t0 = time.perf_counter()
    r.render_frames_device(BLOCK * nblk, sync=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"xRT mixer {VOICES} voices: {(nblk * BLOCK / RATE) / wall:.2f}x "
          f"({nblk} blocks in {wall:.3f} s) {tag}")


def strip_select_kernel(dev, kern, tag):
    """Phase 11: K5 against its plain version at the host pool's shapes
    (V = 4096, n = 512, L = 16384, K = 64, read windows within emax =
    128 + 33 of their row at 48 kHz), at V = 1 (the singleton), at V = 17
    (a partial voice chunk) and near the strip gate (|ds - 1| in [0.119,
    0.125]), where its SELECT_R walk clamp binds, elementwise within
    ``ring_kernels.strip_tolerance``; every other voice's read windows
    cross the ring's end.  Through the record form (the pool's call) and
    the tensor form, one launch each; the record form twice, bit-equal.
    Timed through the record form, and cold at 4096 voices (each call
    reads at the next of ``kernel_bench.SETS`` read-row sets)."""
    from oddio_tpu_torch.ops import ring_kernels as RK
    from oddio_tpu_torch.utils import kernel_bench as KB

    rng = np.random.default_rng(11)
    n, K = KB.SELECT_N, KB.SELECT_K
    kw = dict(n=n, K=K)
    cases = KB.SELECT_CASES[:2] + (("partial", 17, 2048, 0.0, 0.09),) + KB.SELECT_CASES[2:]
    for label, V, L, lo, hi in cases:
        ops = list(KB.select_operands(dev, rng, V, L, lo, hi))
        ops[1][::2] = L // 128 - 1  # windows across the ring's end
        rec = RK.voice_record(*ops[1:])
        plain = RK.strip_select_plain(*ops, **kw)
        tol = RK.strip_tolerance(*ops, **kw).clamp_min(1e-300)
        before = RK.LAUNCHES["strip_select"]
        got = RK.strip_select_record(ops[0], rec, **kw)
        again = RK.strip_select_record(ops[0], rec, **kw)
        tensor_form = RK.strip_select(*ops, **kw)
        torch.cuda.synchronize()
        if RK.LAUNCHES["strip_select"] != before + 3:
            raise AssertionError(f"strip_select ({label}): {RK.LAUNCHES['strip_select'] - before} "
                                 f"launches for 3 calls")
        if not torch.equal(got, again):
            raise AssertionError(f"strip_select ({label}): two runs differ")
        err, share = 0.0, 0.0
        for out in (got, tensor_form):
            diff = (out - plain).abs().double()
            err, share = max(err, float(diff.max())), max(share, float((diff / tol).max()))
        if not share <= 1.0:
            raise AssertionError(f"strip_select ({label}): kernel disagrees with its plain version: "
                                 f"max|diff| {err:.3e}, {share:.1f}x its tolerance")
        binds = 0
        for e in range(2):
            off, _ = RK.strip_positions(ops[3][:, e], n, K)
            kk, _ = RK._positions(ops[3][:, e], n, K)
            binds += int((off != kk.long()).sum())
        if (binds > 0) != (label == "near-gate"):
            raise AssertionError(f"strip_select ({label}): the SELECT_R clamp binds on {binds} reads")
        tk = timed(f"K5 strip_select_record {label}",
                   lambda: RK.strip_select_record(ops[0], rec, **kw))
        tt = timed(f"K5 strip_select {label}", lambda: RK.strip_select(*ops, **kw))
        pms = time_ms(lambda: RK.strip_select_plain(*ops, **kw))
        cold = ""
        if label == "main":
            sets = [(ops[0], rec)] + [
                (ops[0], RK.voice_record(*KB.select_operands(dev, rng, V, L, lo, hi, ops[0])[1:]))
                for _ in range(KB.SETS - 1)]
            tc = timed("K5 strip_select_record main, cold", KB.cycling(
                sets, lambda r, rc: RK.strip_select_record(r, rc, **kw)))
            cold = f", cold {times_str(tc)}"
        print(f"K5 strip_select {label} V={V} L={L}: max|diff| {err:.3e} ({share:.3f} of its "
              f"tolerance; record and tensor forms, one launch each, two runs bit-equal); clamp "
              f"binds on {binds} reads; record form {times_str(tk)}{cold}, tensor form "
              f"{times_str(tt)} vs plain {pms:.4f} ms {tag}")
        if label == "main":
            # spans, 44 bytes of operands per voice, the (2, n) output;
            # 22 f32 operations per (voice, ear, frame)
            bms, by = bound(KB.select_bytes(RK, ops), 22 * V * 2 * n)
            kern["strip_select"] = record("oddio_tpu/ops/pallas_ring.py:392",
                                          "oddio_tpu_torch/csrc/select_kernel.cu",
                                          err, tk, pms, bms, by)
            kern["strip_select"].update(cold=tc, other_form=tt)
        kern["strip_select"]["err"] = max(kern["strip_select"]["err"], err)


def host_pool_path(pt, dev, kern, tag):
    """Phases 12-14: the host-pool scene at 4096 voices (launch counts), at
    256 voices card vs CPU, and its real-time factor."""
    from oddio_tpu_torch.ops import agc as A
    from oddio_tpu_torch.ops import ring_kernels as RK
    from oddio_tpu_torch.ops import stream_kernels as SK
    from oddio_tpu_torch.utils.scene_profile import build_host_pools, feed

    t0 = time.perf_counter()
    _, scene, ctls, speeds, rng = build_host_pools(VOICES, dev)
    r = pt.Renderer(scene, RATE)
    kinds = {p.name: f"{type(p).__name__}({p.capacity})" for p in scene._buffered_pools.values()}
    print(f"host pools: {VOICES} Speed(Stream) + {VOICES // 8} Adapt(Stream) + a "
          f"{max(VOICES // 16, 64)}-voice submix built in {time.perf_counter() - t0:.2f} s; "
          f"pools {kinds} {tag}")
    reset_launches()
    a = r.render_frames(RATE)
    feed(ctls, rng, 1024)
    for sc in speeds[:64]:
        sc.set_speed(float(rng.uniform(0.8, 1.25)))
    dev_out = r.render_frames_device(BLOCK * 94)
    torch.cuda.synchronize()
    launches = {**RK.LAUNCHES, **stream_launches(SK, "the host-pool path"), **A.LAUNCHES}
    read_flat_launches("the host-pool path")
    scene.sync()
    b = torch.cat([o.permute(0, 2, 1).reshape(-1, 2) for o in dev_out]).cpu().numpy()
    for name, x in (("host pools render_frames", a), ("host pools render_frames_device", b)):
        if not np.isfinite(x).all() or np.abs(x).max() <= 1e-3:
            raise AssertionError(f"{name}: non-finite or silent output")
    # the kernels of this path; K3 needs an all-device-resident scene (the
    # JAX package's gate), so it launches on its own path.  K7 runs the
    # three Adapt pools' 513-frame steps (the DR Adapt(Stream) pool, the
    # submix's two pools)
    path = ("append", "select_ears", "strip_select", "ring_place", "ring_resample", "agc_gains")
    if min(launches[k] for k in path) < 1:
        raise AssertionError(f"a kernel of the host-pool path never launched: {launches}")
    kern["strip_select"]["launches"] = launches["strip_select"]
    kern["ring_place"]["host_pool"]["launches"] = launches["ring_place"]
    nblk = -(-RATE // BLOCK) + 94
    if launches["agc_gains"] != 3 * nblk:
        raise AssertionError(f"the host-pool path's three 513-frame Adapt pools launched K7 "
                             f"{launches['agc_gains']} times in {nblk} blocks")
    print(f"host-pool path: 1 s + {BLOCK * 94 / RATE:.3f} s, peak |out| {np.abs(a).max():.4f}/"
          f"{np.abs(b).max():.4f}; launches {launches}, per block "
          f"{ {k: v / nblk for k, v in launches.items()} } {tag}")
    capture_path_steps(12, scene, lambda: r.render_frames(BLOCK * 2))
    BLOCK_PROFILES.append((12, f"the {VOICES}-voice host-pool scene",
                           lambda: r.render_frames_device(BLOCK * 8, sync=False), 8))

    # -- 13. 256 voices on the card vs the CPU -------------------------------------
    outs = []
    for device in (dev, "cpu"):
        _, s256, c256, sp256, rng256 = build_host_pools(256, device, dr_voices=32,
                                                        submix_voices=64)
        r256 = pt.Renderer(s256, RATE)
        x = r256.render_frames(BLOCK * 24)
        feed(c256, rng256, 1024)
        for sc in sp256[:16]:
            sc.set_speed(1.1)
        outs.append(np.concatenate([x, r256.render_frames(BLOCK * 24)]))
    err = float(np.abs(outs[0] - outs[1]).max())
    if not err <= TOL:
        raise AssertionError(f"256-voice host-pool scene card render differs from the CPU by {err}")
    print(f"reference: host-pool scene 256/32/64 voices, card vs CPU plain, 48 blocks, max|diff| "
          f"{err:.3e} (<= {TOL}) {tag}")

    # -- 14. real-time factor ----------------------------------------------------
    r.render_frames_device(BLOCK * 94, sync=False)
    feed(ctls, rng, 1024)  # the timed run starts with an ingest block
    torch.cuda.synchronize()
    nblk = 188
    t0 = time.perf_counter()
    r.render_frames_device(BLOCK * nblk, sync=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"xRT host pools {VOICES} voices: {(nblk * BLOCK / RATE) / wall:.2f}x "
          f"({nblk} blocks in {wall:.3f} s) {tag}")


def within(got, plain, tol, label):
    """Max |kernel - plain| and its largest share of the elementwise
    tolerance ``tol``; raises past it."""
    diff = (got - plain).abs().double()
    share = float((diff / tol.clamp_min(1e-300)).max())
    err = float(diff.max())
    if not share <= 1.0:
        raise AssertionError(f"{label}: kernel disagrees with its plain version: "
                             f"max|diff| {err:.3e}, {share:.1f}x its tolerance")
    return err, share


def flat_read_span(RK, base, scal, extra, n, K):
    """Bytes K8/K10 must read: each voice's span over both ears' reads
    from ``base`` (V,) plus the lerp's next sample."""
    j = torch.arange(n, device=scal.device)
    idx = []
    for e in range(2):
        kk, _ = RK._positions(scal[:, e], n, K)
        idx.append((base + extra[:, e].long())[:, None] + j + kk.long())
    return span_bytes(torch.stack(idx, 1))


def flat_append_check(dev, tag):
    """K9 exact against its plain version in every page form (host ints, a
    (2,) device pair, int32 scalar tensors) at W = 512 and 1024, timed at
    V = 4096, W = 512 with the pair (a device-resident cursor's form) and
    host ints, beside one ``index_copy_`` of both legs, warm and, the pair
    and ``index_copy_``, cold.  Returns K9's record: the pair's times, with
    the host ints' under "other_form"."""
    from oddio_tpu_torch.ops import flat_kernels as FK
    from oddio_tpu_torch.utils import kernel_bench as AB

    V, rowlen = VOICES, 4096
    ring = torch.randn((V, rowlen), device=dev)
    pages = torch.tensor([2, 6], dtype=torch.int32, device=dev)
    err = 0.0
    for W in (BLOCK, 2 * BLOCK):
        slab = torch.randn((V, W), device=dev)
        plain = FK.flat_append_aligned_plain(ring.clone(), slab, 2, 6)
        for form in ((2, 6), (pages,), (pages[0], pages[1])):
            got = FK.flat_append_aligned(ring.clone(), slab, *form)
            torch.cuda.synchronize()
            err = max(err, float((got - plain).abs().max()))
    if err != 0.0:
        raise AssertionError(f"flat_append_aligned differs from its plain version by {err}")
    W = BLOCK
    slab = torch.randn((V, W), device=dev)
    tk = timed("K9 flat_append_aligned, device pair",
               lambda: FK.flat_append_aligned(ring, slab, pages))
    ti = timed("K9 flat_append_aligned, host ints",
               lambda: FK.flat_append_aligned(ring, slab, 2, 6))
    pms = time_ms(lambda: FK.flat_append_aligned_plain(ring, slab, 2, 6))
    # the library yardstick: one index_copy_ of both legs (index and the
    # doubled slab prepared outside the timed call)
    cols = torch.cat([torch.arange(W, device=dev) + 2 * FK.APPEND_PW,
                      torch.arange(W, device=dev) + 6 * FK.APPEND_PW])
    slab2 = torch.cat([slab, slab], dim=1)
    lt = timed("index_copy_ (K9)", lambda: ring.index_copy_(1, cols, slab2))
    sets = AB.k9_sets(dev, AB.SETS)
    tc = timed("K9 flat_append_aligned, device pair, cold", AB.cycling(
        sets, lambda r, s, _: FK.flat_append_aligned(r, s, pages)))
    lc = timed("index_copy_ (K9), cold", AB.cycling(
        sets, lambda r, _, s2: r.index_copy_(1, cols, s2)))
    bms, by = bound(12 * V * W + 8, 0)
    print(f"K9 flat_append_aligned V={V} W={W}: max|diff| {err} (tolerance 0, exact, W = 512 "
          f"and 1024, three page forms); device page pair {times_str(tk)}, cold "
          f"{times_str(tc)}; host ints {times_str(ti)}; plain {pms:.4f} ms, index_copy_ "
          f"{times_str(lt)}, cold {times_str(lc)}; bound {bms:.4f} ms ({by}); launches: no "
          f"path {tag}")
    rec = record("oddio_tpu/ops/pallas_ring.py:209", "oddio_tpu_torch/csrc/flat_kernels.cu",
                 err, tk, pms, bms, by, lt)
    rec.update(other_form=ti, cold=tc, library_cold=lc)
    return rec


#: K8's and K10's figures before their redesign (PERF.md §6, chip_smoke.py
#: on an NVIDIA H100 80GB HBM3 at 700 W): per call ms and device ms
FLAT_BEFORE = {"window_select": "ms 0.1451-0.2321, device 0.0397-0.0406",
               "dma_window_select": "ms 0.1640-0.1916, device 0.0283-0.0284"}
#: (label, call) of phase 15's K8 and K10 calls, each one device kernel
#: (``one_kernel``)
FLAT_ONE = []


def flat_kernels(dev, kern, tag):
    """Phase 15: K8, K9 and K10 against their plain versions at V = 4096,
    n = 512.  K8 and K10 take operands that are not contiguous (read in
    place); two calls bit-equal with one launch each and the cluster
    tickets left zeroed (``held``); one device kernel a call (the
    profiler's count, ``one_kernel`` at the run's end); timed warm and
    cold (each call on the next of 8 operand sets: K8's windows 12.6-14.7
    MB each, K10's read starts over one 268 MB ring), beside their figures
    before the redesign.  No path of the package calls them (nor of the
    JAX package: K2's test reference, a superseded append, a probe): their
    launches are those counted on the path runs (``read_flat_launches``),
    not these."""
    from oddio_tpu_torch.ops import flat_kernels as FK
    from oddio_tpu_torch.ops import ring_kernels as RK
    from oddio_tpu_torch.utils import kernel_bench as KB

    rng = np.random.default_rng(15)
    V, n, K = VOICES, BLOCK, 64
    zero = torch.zeros(V, dtype=torch.int64, device=dev)

    # K8 at both table widths test_ops.py holds the TPU kernel at
    errs = []
    for emax2 in (36, 163):
        win = torch.randn((V, RK.select_window(n, emax2, K)), device=dev)
        ops = (win,) + KB.flat_operands(dev, rng, V, n, K, emax2, strided=True)
        kw = dict(n=n, K=K, emax2=emax2)
        label = f"K8 window_select emax2={emax2}"
        err, share = held(FK, "window_select", label, lambda: FK.window_select(*ops, **kw),
                          FK.window_select_plain(*ops, **kw),
                          FK.window_select_tolerance(*ops, n=n, K=K))
        errs.append(err)
        FLAT_ONE.append((label, lambda ops=ops, kw=kw: FK.window_select(*ops, **kw)))
        tk = timed(label, lambda: FK.window_select(*ops, **kw))
        tc = timed(f"{label}, cold", KB.cycling(KB.k8_sets(dev, rng, KB.SETS, K, emax2),
                                                lambda *o, kw=kw: FK.window_select(*o, **kw)))
        pms = time_ms(lambda: FK.window_select_plain(*ops, **kw))
        # read spans, 60 bytes of operands per voice, the (2, n) output;
        # 21 f32 operations per (voice, ear, frame), as K2
        bms, by = bound(flat_read_span(RK, zero, ops[1], ops[5], n, K) + 60 * V + 8 * n,
                        21 * V * 2 * n)
        print(f"{label} V={V} n={n} K={K}: max|diff| {err:.3e} ({share:.3f} of its "
              f"tolerance), operands not contiguous, one launch, two runs bit-equal, tickets "
              f"zero; {times_str(tk)}, cold {times_str(tc)} [before the redesign: "
              f"{FLAT_BEFORE['window_select']}] vs plain {pms:.4f} ms, bound {bms:.4f} ms "
              f"({by}); launches: no path {tag}")
    kern["window_select"] = record("oddio_tpu/ops/pallas_ring.py:604",
                                   "oddio_tpu_torch/csrc/ring_kernels.cu", max(errs), tk, pms,
                                   bms, by)
    kern["window_select"]["cold"] = tc

    kern["flat_append_aligned"] = flat_append_check(dev, tag)

    # K10: windows anywhere in a 4096-float row, some past its end (they read
    # the next row, as the TPU's fetch from the flat ring does)
    emax2, rowlen = 36, 4096
    ring = torch.randn((V, rowlen), device=dev)
    rstart = KB.flat_rstart(dev, rng, V, rowlen)
    ops = (ring, torch.stack([rstart, rstart], dim=1)[:, 0]) + KB.flat_operands(
        dev, rng, V, n, K, emax2, strided=True)
    kw = dict(n=n, K=K, emax2=emax2)
    label = "K10 dma_window_select"
    err, share = held(FK, "dma_window_select", label, lambda: FK.dma_window_select(*ops, **kw),
                      FK.dma_window_select_plain(*ops, **kw),
                      FK.dma_tolerance(*ops, n=n, K=K))
    FLAT_ONE.append((label, lambda: FK.dma_window_select(*ops, **kw)))
    tk = timed(label, lambda: FK.dma_window_select(*ops, **kw))
    cring, csets = KB.k10_sets(dev, rng, KB.SETS, K, emax2)
    tc = timed(f"{label}, cold", KB.cycling(
        csets, lambda *o, kw=kw: FK.dma_window_select(cring, *o, **kw)))
    pms = time_ms(lambda: FK.dma_window_select_plain(*ops, **kw))
    base = torch.arange(V, device=dev) * rowlen + rstart.long()
    # read spans, 64 bytes of operands per voice, the (2, n) output; 23 f32
    # operations per (voice, ear, frame)
    bms, by = bound(flat_read_span(RK, base, ops[2], ops[6], n, K) + 64 * V + 8 * n,
                    23 * V * 2 * n)
    kern["dma_window_select"] = record("oddio_tpu/ops/pallas_ring.py:1039",
                                       "oddio_tpu_torch/csrc/flat_kernels.cu", err, tk, pms, bms, by)
    kern["dma_window_select"]["cold"] = tc
    print(f"{label} V={V} n={n} K={K} emax2={emax2}: max|diff| {err:.3e} ({share:.3f} of its "
          f"tolerance), operands not contiguous, windows past their row end, one launch, two "
          f"runs bit-equal, tickets zero; {times_str(tk)}, cold {times_str(tc)} [before the "
          f"redesign: {FLAT_BEFORE['dma_window_select']}] vs plain {pms:.4f} ms, bound "
          f"{bms:.4f} ms ({by}); launches: no path {tag}")


def scene_axis_kernels(dev, tag):
    """Phase 16: K1 and K2 with a ScenePack's scene axis, S = 16 scenes of
    V = 256 voices, against their plain versions (K1 exact, K2 reading a
    4096-row ring within ``mix_tolerance`` per scene), one launch per
    call."""
    from oddio_tpu_torch.ops import ring_kernels as RK
    from oddio_tpu_torch.utils import kernel_bench as KB

    rng = np.random.default_rng(16)
    S, Vs, n, K = 16, 256, BLOCK, 32
    V = S * Vs
    RPV = RPV_MAIN
    ring = torch.randn((V, RPV, 128), device=dev)
    slab = torch.randn((V, 512), device=dev)
    r0 = torch.tensor(rng.integers(0, RPV - 4, S).astype(np.int32), device=dev)
    rm = torch.tensor(rng.integers(0, RPV - 4, S).astype(np.int32), device=dev)
    plain = RK.rows_append_plain(ring.clone(), slab, r0, rm)
    before = RK.LAUNCHES["append"]
    got = RK.rows_append(ring.clone(), slab, r0, rm)
    torch.cuda.synchronize()
    err = float((got - plain).abs().max())
    if err != 0.0 or RK.LAUNCHES["append"] != before + 1:
        raise AssertionError(f"rows_append with {S} scenes: max|diff| {err}, "
                             f"{RK.LAUNCHES['append'] - before} launches")
    tk = timed(f"K1 rows_append S={S}", lambda: RK.rows_append(ring, slab, r0, rm))
    pms = time_ms(lambda: RK.rows_append_plain(ring, slab, r0, rm))
    # the cursor form with one write cursor per scene, as the spatial pack
    # calls it
    start = torch.tensor(rng.integers(0, CAP - 512, S).astype(np.int32), device=dev)
    plain = RK.rows_append_cursor_plain(ring.clone(), slab, start, FP, CAP, MPAD)
    before = RK.LAUNCHES["append_cursor"]
    got = RK.rows_append_cursor(ring.clone(), slab, start, FP, CAP, MPAD)
    torch.cuda.synchronize()
    cerr = float((got - plain).abs().max())
    if cerr != 0.0 or RK.LAUNCHES["append_cursor"] != before + 1:
        raise AssertionError(f"rows_append_cursor with {S} scenes: max|diff| {cerr}, "
                             f"{RK.LAUNCHES['append_cursor'] - before} launches")
    ctk = timed(f"K1 rows_append_cursor S={S}",
                lambda: RK.rows_append_cursor(ring, slab, start, FP, CAP, MPAD))
    print(f"K1 rows_append S={S} x V={Vs}: max|diff| {err} (exact), one launch; {times_str(tk)} "
          f"vs plain {pms:.4f} ms; cursor form max|diff| {cerr} (exact), one launch; "
          f"{times_str(ctk)} {tag}")
    del ring, slab

    ring = KB.read_ring(dev, V, seed=16)
    ro = KB.read_operands(dev, rng, V, K, n)
    kw = dict(n=n, K=K, R=n, DMAX=KB.READ_DMAX, FP=KB.READ_FP, cap=KB.READ_CAP, scenes=S)
    plain = RK.ring_select_ears_plain(ring, ro, **kw)
    before = RK.LAUNCHES["select_ears"]
    got = RK.ring_select_ears(ring, ro, **kw)
    torch.cuda.synchronize()
    if got.shape != (S, 2, n) or RK.LAUNCHES["select_ears"] != before + 1:
        raise AssertionError(f"ring_select_ears with {S} scenes: shape {tuple(got.shape)}, "
                             f"{RK.LAUNCHES['select_ears'] - before} launches")
    err, share = within(got, plain, RK.ring_select_ears_tolerance(ring, ro, **kw),
                        f"ring_select_ears S={S}")
    tk = timed(f"K2 ring_select_ears S={S}", lambda: RK.ring_select_ears(ring, ro, **kw))
    pms = time_ms(lambda: RK.ring_select_ears_plain(ring, ro, **kw))
    print(f"K2 ring_select_ears S={S} x V={Vs}: max|diff| {err:.3e} ({share:.3f} of its "
          f"per-scene tolerance), one launch; {times_str(tk)} vs plain {pms:.4f} ms {tag}")


def drain(batches):
    """A pack's ``render_frames_device`` list of (B, S, C, n) tensors as
    numpy (S, B*n, C)."""
    x = torch.cat(list(batches)).cpu().numpy()  # (B, S, C, n)
    B, S, C, n = x.shape
    return x.transpose(1, 0, 3, 2).reshape(S, B * n, C)


def config5_pack_run(pack, ctls, pcm, nb0=4, nb1=60):
    """``nb0`` blocks through ``render_block``, one write of ``pcm`` (one
    row per stream), ``nb1`` blocks through ``render_frames_device``:
    (S, (nb0 + nb1)*n, C) numpy."""
    a = np.concatenate([pack.render_block(BLOCK) for _ in range(nb0)], axis=1)
    for c, x in zip(ctls, pcm):
        c.write(x)
    return np.concatenate([a, drain(pack.render_frames_device(BLOCK * nb1))], axis=1)


def pack_path(pt, dev, tag):
    """Phase 17: the config-5 pack (S Mixers of 256 voices) at S = 16 and 64
    through render_block and render_frames_device with new stream PCM
    between them, counting K4/K6/K7 launches (equal per block at both S:
    one launch per pool per block, whatever S is); the 16-scene spatial
    pack the same way with K1/K2.  Returns the built packs for phase 19."""
    from oddio_tpu_torch.ops import agc as A
    from oddio_tpu_torch.ops import ring_kernels as RK
    from oddio_tpu_torch.ops import stream_kernels as SK
    from oddio_tpu_torch.utils.scene_profile import build_config5_pack, build_spatial_pack

    nb0, nb1 = 4, 60
    packs, per_block = {}, {}
    for S in (16, 64):
        t0 = time.perf_counter()
        pack, ctls, rng = build_config5_pack(S, dev)
        built = time.perf_counter() - t0
        pcm = (rng.standard_normal((len(ctls), 1024)) * 0.1).astype(np.float32)
        reset_launches()
        out = config5_pack_run(pack, ctls, pcm, nb0, nb1)
        torch.cuda.synchronize()
        launches = {**stream_launches(SK, f"the config-5 pack path (S={S})"), **A.LAUNCHES}
        read_flat_launches(f"the config-5 pack path (S={S})")
        if any(RK.LAUNCHES.values()):
            raise AssertionError(f"the config-5 pack launched ring kernels: {RK.LAUNCHES}")
        if out.shape != (S, (nb0 + nb1) * BLOCK, 1) or not np.isfinite(out).all():
            raise AssertionError(f"config-5 pack S={S}: shape {out.shape} or non-finite output")
        if np.abs(out).max(axis=(1, 2)).min() <= 1e-3:
            raise AssertionError(f"config-5 pack S={S}: a silent scene")
        if min(launches.values()) < 1:
            raise AssertionError(f"a kernel of the pack path never launched: {launches}")
        per_block[S] = {k: v / (nb0 + nb1) for k, v in launches.items()}
        packs[S] = (pack, ctls, rng)
        if S == 16:
            capture_path_steps(17, pack.scenes[0], lambda: pack.render_block(BLOCK))
            BLOCK_PROFILES.append((17, "the 16-scene config-5 pack",
                                   lambda: pack.render_frames_device(BLOCK * 8), 8))
        print(f"config-5 pack S={S} x 256 voices (built in {built:.2f} s): {nb0} blocks "
              f"render_block + {nb1} render_frames_device, a 1024-sample write between; peak "
              f"|out| {np.abs(out).max():.4f}; launches {launches}, per block "
              f"{per_block[S]} {tag}")
    if per_block[16] != per_block[64]:
        raise AssertionError(f"launches per block differ: S=16 {per_block[16]}, S=64 {per_block[64]}")

    t0 = time.perf_counter()
    sp = build_spatial_pack(16, dev)
    built = time.perf_counter() - t0
    reset_launches()
    a = np.concatenate([sp.render_block(BLOCK) for _ in range(nb0)], axis=1)
    out = np.concatenate([a, drain(sp.render_frames_device(BLOCK * nb1))], axis=1)
    torch.cuda.synchronize()
    launches = dict(RK.LAUNCHES)
    read_flat_launches("the spatial pack path")
    if not np.isfinite(out).all() or np.abs(out).max(axis=(1, 2)).min() <= 1e-3:
        raise AssertionError("spatial pack: non-finite output or a silent scene")
    if launches["append"] < 1 or launches["select_ears"] < 1:
        raise AssertionError(f"a kernel of the spatial pack path never launched: {launches}")
    print(f"spatial pack S=16 x (64 buffered + 192 seek) (built in {built:.2f} s): "
          f"{nb0 + nb1} blocks, peak |out| {np.abs(out).max():.4f}; launches {launches}, per "
          f"block { {k: v / (nb0 + nb1) for k, v in launches.items()} } {tag}")
    packs["spatial"] = sp
    return packs


def pack_reference(pt, dev, tag):
    """Phase 18: a 4-scene x 64-voice config-5 pack and a 4-scene spatial
    pack on the card against the same packs on the CPU and against
    per-scene Renderers on the card, each within TOL."""
    from oddio_tpu_torch.utils.scene_profile import (build_config5_pack, build_mixer_agc,
                                                     build_pack_scene, build_spatial_pack)

    S, nb0, nb1 = 4, 12, 12
    pcm = None
    outs = []
    for device in (dev, "cpu"):
        pack, ctls, rng = build_config5_pack(S, device, voices=64)
        if pcm is None:
            pcm = (rng.standard_normal((len(ctls), 1024)) * 0.1).astype(np.float32)
        outs.append(config5_pack_run(pack, ctls, pcm, nb0, nb1))
    singles = []
    for s in range(S):
        _, mixer, ctls, _ = build_mixer_agc(64, dev, s)
        r = pt.Renderer(mixer, RATE)
        a = np.stack([r.render_block(BLOCK) for _ in range(nb0)])
        for c, x in zip(ctls, pcm[len(ctls) * s:]):
            c.write(x)
        b = r.render_frames(BLOCK * nb1)
        singles.append(np.concatenate([a.reshape(-1, a.shape[-1]), b]))
    errs = (float(np.abs(outs[0] - outs[1]).max()), float(np.abs(outs[0] - np.stack(singles)).max()))
    if not max(errs) <= TOL or np.abs(outs[1]).max() <= 1e-2:
        raise AssertionError(f"config-5 pack 4 x 64: card vs CPU {errs[0]}, vs per-scene "
                             f"Renderers {errs[1]}")
    print(f"reference: config-5 pack 4 x 64 voices, {nb0 + nb1} blocks with a write: card vs "
          f"CPU plain max|diff| {errs[0]:.3e}, vs per-scene Renderers on the card "
          f"{errs[1]:.3e} (<= {TOL}) {tag}")

    outs = []
    for device in (dev, "cpu"):
        pack = build_spatial_pack(S, device)
        outs.append(np.concatenate([pack.render_block(BLOCK) for _ in range(nb0)]
                                   + [drain(pack.render_frames_device(BLOCK * nb1))], axis=1))
    singles = []
    for s in range(S):
        r = pt.Renderer(build_pack_scene(dev, s), RATE)
        singles.append(np.concatenate([r.render_block(BLOCK) for _ in range(nb0 + nb1)]))
    errs = (float(np.abs(outs[0] - outs[1]).max()), float(np.abs(outs[0] - np.stack(singles)).max()))
    if not max(errs) <= TOL or np.abs(outs[1]).max() <= 1e-2:
        raise AssertionError(f"spatial pack 4 scenes: card vs CPU {errs[0]}, vs per-scene "
                             f"Renderers {errs[1]}")
    print(f"reference: spatial pack 4 x (64 buffered + 192 seek), {nb0 + nb1} blocks: card vs "
          f"CPU plain max|diff| {errs[0]:.3e}, vs per-scene Renderers on the card "
          f"{errs[1]:.3e} (<= {TOL}) {tag}")


def pack_xrt(packs, dev, tag):
    """Phase 19: real-time factor per scene (one scene's audio seconds per
    wall second, as bench.py counts a pack) of the config-5 pack at S = 16,
    64 and 256 (BASELINE config 5's 256 x 256, built once and timed
    replaying graphs, then under ``eager()``) and of the 16-scene spatial
    pack, 188 blocks each after a warm-up of 8 blocks and one of the timed
    run's blocks; each config-5 run starts with a 1024-sample write to
    every stream."""
    from oddio_tpu_torch.utils.scene_profile import build_config5_pack, feed

    nblk = 188
    runs = [(S, packs[S]) for S in (16, 64)]
    t0 = time.perf_counter()
    runs.append((256, build_config5_pack(256, dev)))
    print(f"config-5 pack S=256 x 256 voices (65,536) built in {time.perf_counter() - t0:.2f} s "
          f"{tag}")
    runs.append(("spatial 16", (packs["spatial"], None, None)))
    for label, (pack, ctls, rng) in runs:
        # S = 256 graph vs eager; the others replay graphs (the default)
        for mode in ("graph", "eager") if label == 256 else ("graph",):
            with _mode(mode):
                pack.render_frames_device(BLOCK * 8)
                for _ in range(2):  # a warm run on the timed run's keys, then the timed run
                    if ctls is not None:
                        feed(ctls, rng, 1024)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = pack.render_frames_device(BLOCK * nblk)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
            if not bool(torch.isfinite(out[-1]).all()):
                raise AssertionError(f"pack {label}: non-finite output")
            kind = "spatial pack" if ctls is None else "config-5 pack"
            print(f"xRT per scene {kind} S={label if ctls is not None else 16} {mode}: "
                  f"{(nblk * BLOCK / RATE) / wall:.2f}x ({nblk} blocks in {wall:.3f} s, "
                  f"{1e3 * wall / nblk:.3f} ms per block; graph_counts {pack.graph_counts}) "
                  f"{tag}")


def arena_kernel(dev, kern, tag):
    """Phase 20: K6's arena form's read (``stream_kernels.arena_resample``,
    which the whole steps of phase 25 compose; no path launches it) against its plain
    version, exactly (the same f32 operations, each rounded once), at 1024,
    4096, 1 and 17 rows, n = 512, 513, 128 and 100, steps in the tiers
    (0.2, 1), (1, 2) and (2, 4) and 44.1/48 kHz at speed 1.2, over mono
    guarded regions (cursors before, past and far outside a sound, where
    the clamp binds; negative fractions), stereo ones (channel-row pairs)
    and a looped table; the seek form's two ear rows per voice are two
    mono rows.  Each call one launch; two runs bit-equal.  At the three
    paths' shapes (``kernel_bench.ARENA_SHAPES``: the sampler's fader bank
    of 2048 rows, the wavetable's 1024, the seek pool's 2048) exact again
    on every operand set, the paths' own (no edge cases) and one with the
    edge cases, then timed warm and cold on the paths' own."""
    from oddio_tpu_torch.ops import stream_kernels as SK
    from oddio_tpu_torch.utils import kernel_bench as KB

    host, regions = KB.arena_setup()
    garena = torch.tensor(host, device=dev)
    rng = np.random.default_rng(20)
    ds12 = float(np.float32(44100.0) / np.float32(48000.0) * np.float32(1.2))
    cases = 0
    for rows in (1024, 4096, 1, 17):
        for n in (512, 513, 128, 100):
            for dsr in ((0.2, 1.0), (1.0, 2.0), (2.0, 4.0), (ds12, ds12)):
                for kind in ("mono", "stereo", "looped"):
                    ops = KB.arena_operands(dev, rng, regions, rows, kind, dsr)
                    before = SK.LAUNCHES["arena_resample"]
                    got = SK.arena_resample(garena, *ops, n)
                    again = SK.arena_resample(garena, *ops, n)
                    plain = SK.arena_resample_plain(garena, *ops, n)
                    torch.cuda.synchronize()
                    if SK.LAUNCHES["arena_resample"] != before + 2:
                        k = SK.LAUNCHES["arena_resample"] - before
                        raise AssertionError(f"arena_resample: {k} launches for 2 calls")
                    if not (torch.equal(got, plain) and torch.equal(got, again)):
                        err = float((got.double() - plain.double()).abs().max())
                        raise AssertionError(
                            f"arena_resample rows={rows} n={n} ds {dsr} {kind}: kernel differs "
                            f"from its plain version by {err} (or from its own second run)")
                    cases += 1
    print(f"K6 arena_resample: {cases} cases (rows 1024/4096/1/17, n 512/513/128/100, ds tiers "
          f"1/2/4 and 44.1->48 kHz x1.2, mono/stereo/looped regions, edges and the clamp) equal "
          f"to the plain version (tolerance 0, exact), two runs bit-equal, one launch each {tag}")
    entry = None
    for label, rows, kind, dsr in KB.ARENA_SHAPES:
        sets = [KB.arena_operands(dev, rng, regions, rows, kind, dsr, edges=False)
                for _ in range(KB.ARENA_SETS)]
        edged = KB.arena_operands(dev, rng, regions, rows, kind, dsr)
        for i, ops in enumerate(sets + [edged]):
            got = SK.arena_resample(garena, *ops, KB.ARENA_N)
            plain = SK.arena_resample_plain(garena, *ops, KB.ARENA_N)
            if not torch.equal(got, plain):
                err = float((got.double() - plain.double()).abs().max())
                raise AssertionError(f"arena_resample {label} shape ({rows} rows, {kind}), "
                                     f"operand set {i}: kernel differs from its plain version "
                                     f"by {err}")
        ops0 = sets[0]
        tk = timed(f"K6 arena_resample {label} {rows} rows n=512",
                   lambda: SK.arena_resample(garena, *ops0, KB.ARENA_N))
        tc = timed(f"K6 arena_resample {label} {rows} rows n=512, cold",
                   KB.cycling(sets, lambda *o: SK.arena_resample(garena, *o, KB.ARENA_N)))
        pms = time_ms(lambda: SK.arena_resample_plain(garena, *ops0, KB.ARENA_N))
        bms, by = bound(KB.arena_bytes(SK, ops0, KB.ARENA_N), 14 * rows * KB.ARENA_N)
        print(f"K6 arena_resample {label} shape ({rows} rows, {kind}, n=512): equal to the plain "
              f"version on {len(sets) + 1} operand sets (tolerance 0); {times_str(tk)}, cold "
              f"{times_str(tc)} vs plain {pms:.4f} ms, bound {bms:.4f} ms ({by}) {tag}")
        if entry is None:  # the sampler's fader bank: the main shape
            entry = record("oddio_tpu/ops/pallas_ring.py:1203",
                           "oddio_tpu_torch/csrc/stream_kernels.cu", 0.0, tk, pms, bms, by)
            entry["cold"] = tc
        else:
            entry.setdefault("shapes", {})[label] = {"rows": rows, "times": tk, "cold": tc,
                                                     "plain_ms": pms, "bound_ms": bms}
    kern["arena_resample"] = entry


def _bits(x):
    """Bit patterns with -0.0 read as +0.0."""
    return torch.where(x == 0, torch.zeros_like(x), x).view(torch.int32)


def _same(got, want, signed_zero=True):
    """Two step results (tensors, or dicts and tuples of them) equal: bit
    for bit, or with ``signed_zero`` False equal values whose bits differ
    at most in the sign of an exact zero."""
    if isinstance(got, dict):
        return got.keys() == want.keys() and all(_same(got[k], want[k]) for k in got)
    if isinstance(got, tuple):
        return all(_same(g, w, signed_zero) for g, w in zip(got, want))
    if got.dtype != want.dtype or got.shape != want.shape or not torch.equal(got, want):
        return False
    if got.dtype != torch.float32:
        return True
    if signed_zero:
        return torch.equal(got.view(torch.int32), want.view(torch.int32))
    return torch.equal(_bits(got), _bits(want))


def step_kernel(dev, tag):
    """Phase 25: K6's arena form as whole steps (``stream_kernels.arena_step``,
    ``arena_warp``, ``fader_step``) against their plain versions (the torch
    chains of the FramesSignal, Cycle, Speed and Fader renders and the seek
    reads): mono and stereo FramesSignal, Cycle, the seek read with E = 2
    and the Fader with fading, done, flipped and idle voices mixed; n = 512,
    513, 128 and 100; a static interval and per-voice Speed factors in the
    step tiers 1, 2 and 4; negative fractions, cursors before, past and
    far outside a sound, count < n and count = 0; then at the paths'
    shapes (1024 stereo Fader voices, 2 x 2048 rows; 1024 Cycle voices;
    2048 seek rows).  Exact (the Fader's output but for the sign of an
    exact zero), two runs bit-equal, one launch a call."""
    from oddio_tpu_torch.ops import stream_kernels as SK
    from oddio_tpu_torch.utils import kernel_bench as KB

    host, regions = KB.arena_setup()
    garena = torch.tensor(host, device=dev)
    rng = np.random.default_rng(25)
    iv2 = (KB.STEP_IV, KB.STEP_IV)

    def held(label, call, plain, signed_zero=True):
        before = SK.LAUNCHES["arena_step"]
        got, again = call(), call()
        want = plain()
        torch.cuda.synchronize()
        if SK.LAUNCHES["arena_step"] != before + 2:
            raise AssertionError(f"arena_step {label}: "
                                 f"{SK.LAUNCHES['arena_step'] - before} launches for 2 calls")
        if not (_same(got, want, signed_zero) and _same(got, again)):
            raise AssertionError(f"arena_step {label}: differs from its plain version or from "
                                 f"its own second run")

    cases = 0
    V = 300
    for n in (512, 513, 128, 100):
        for mode in ("static", 1, 2, 4):
            for kind, C in (("frames", 1), ("frames", 2), ("cycle", 1)):
                st = KB.step_leaf(dev, rng, regions, V, kind, C)
                st_b = KB.step_leaf(dev, rng, regions, V, kind, C)
                sp = None if mode == "static" else KB.step_speeds(dev, rng, V, mode)
                sp2 = (sp, None if sp is None else KB.step_speeds(dev, rng, V, mode))
                cnt = KB.step_count(dev, rng, V, n)
                fs = KB.fade_columns(dev, rng, V)
                held(f"{kind} C={C} n={n} {mode}",
                     lambda: SK.arena_step(garena, kind, st, KB.STEP_IV, n, cnt, C, sp),
                     lambda: SK.arena_step_plain(garena, kind, st, KB.STEP_IV, n, cnt, C, sp))
                held(f"Fader over {kind} C={C} n={n} {mode}",
                     lambda: SK.fader_step(garena, kind, fs, (st, st_b), iv2, n, cnt, C, sp2),
                     lambda: SK.fader_step_plain(garena, kind, fs, (st, st_b), iv2, n, cnt, C,
                                                 sp2), signed_zero=False)
                cases += 2
        for kind in ("frames", "cycle"):
            st = KB.step_leaf(dev, rng, regions, V, kind)
            t0, dt = KB.seek_offsets(dev, rng, V)
            held(f"seek {kind} n={n}", lambda: SK.arena_warp(garena, kind, st, t0, dt, n),
                 lambda: SK.arena_warp_plain(garena, kind, st, t0, dt, n))
            cases += 1
    # the paths' shapes: the sampler's 1024 stereo Fader voices (speeds
    # 0.8-1.25, a few voices fading), the wavetable's 1024 Cycle voices, the
    # seek pool's 1024 voices x 2 ears
    V = 1024
    st = KB.step_leaf(dev, rng, regions, V, "frames", 2)
    st_b = KB.step_leaf(dev, rng, regions, V, "frames", 2)
    sp2 = tuple(torch.tensor(rng.uniform(0.8, 1.25, V).astype(np.float32), device=dev)
                for _ in range(2))
    fs = KB.fade_columns(dev, rng, V, frac_fading=0.06)
    cnt = KB.step_count(dev, rng, V, BLOCK, full=True)
    held("sampler shape", lambda: SK.fader_step(garena, "frames", fs, (st, st_b), iv2, BLOCK,
                                                cnt, 2, sp2),
         lambda: SK.fader_step_plain(garena, "frames", fs, (st, st_b), iv2, BLOCK, cnt, 2, sp2),
         signed_zero=False)
    st = KB.step_leaf(dev, rng, regions, V, "cycle")
    sp = torch.tensor(rng.uniform(0.8, 1.25, V).astype(np.float32), device=dev)
    held("wavetable shape", lambda: SK.arena_step(garena, "cycle", st, KB.STEP_IV, BLOCK, cnt,
                                                  1, sp),
         lambda: SK.arena_step_plain(garena, "cycle", st, KB.STEP_IV, BLOCK, cnt, 1, sp))
    st = KB.step_leaf(dev, rng, regions, V, "frames", edges=False)
    t0, dt = KB.seek_offsets(dev, rng, V)
    held("seek shape", lambda: SK.arena_warp(garena, "frames", st, t0, dt, BLOCK),
         lambda: SK.arena_warp_plain(garena, "frames", st, t0, dt, BLOCK))
    print(f"K6 arena_step: {cases} cases (FramesSignal mono/stereo, Cycle, the Fader over "
          f"each, seek reads E=2; n 512/513/128/100; a static interval and speeds in the tiers "
          f"1/2/4; edges, count < n and 0) and the three paths' shapes (1024 stereo Fader "
          f"voices, 1024 Cycle, 2048 seek rows) equal to the plain versions (tolerance 0; the "
          f"Fader's output but for the sign of an exact zero), two runs bit-equal, one launch "
          f"each {tag}")


def step_paths(dev, kern, tag):
    """Phase 27: the whole steps on the three paths' captured states
    (``kernel_bench.arena_states``: the 1024-voice sampler's Fader pool, the
    wavetable's Speed(Cycle) pool, the seek sampler's seek pool; 10 blocks
    each): exact against their plain versions on every block, then timed
    warm and cold beside the plain version and the byte bound.  The
    sampler's fused Fader step is the kernels line's main entry."""
    from oddio_tpu_torch.utils import kernel_bench as KB

    entry = None
    for label, proto, method, kind, C, calls in KB.arena_states(dev):
        for i, args in enumerate(calls):
            got = KB.step_call(proto, method, kind, C, args)()
            want = KB.step_call(proto, method, kind, C, args, plain=True)()
            if not _same(got, want, signed_zero=method != "dr_render" or "prog" not in args[0]):
                raise AssertionError(f"arena_step on {label}, block {i}: differs from its "
                                     f"plain version")
        warm = KB.step_call(proto, method, kind, C, calls[0])
        STEP_ONE.append((label, warm))
        tk = timed(f"K6 arena_step {label}, warm", warm)
        tc = timed(f"K6 arena_step {label}, cold",
                   KB.cycling([(KB.step_call(proto, method, kind, C, a),) for a in calls[1:]],
                              lambda f: f()))
        pms = time_ms(KB.step_call(proto, method, kind, C, calls[0], plain=True))
        bms, by = bound(KB.step_bytes(method, kind, C, calls[0]), 0)
        print(f"K6 arena_step {label}: equal to the plain version on {len(calls)} captured "
              f"blocks; {times_str(tk)}, cold {times_str(tc)} vs plain {pms:.4f} ms, bound "
              f"{bms:.4f} ms ({by}) {tag}")
        if entry is None:  # the sampler's fused Fader step: the main shape
            entry = record("oddio_tpu/ops/pallas_ring.py:1203",
                           "oddio_tpu_torch/csrc/stream_kernels.cu", 0.0, tk, pms, bms, by)
            entry["cold"] = tc
        else:
            entry.setdefault("shapes", {})[label] = {"times": tk, "cold": tc, "plain_ms": pms,
                                                     "bound_ms": bms}
    kern["arena_step"] = entry


#: (label, call) of one captured whole step per path, each one device
#: kernel (``one_kernel``)
STEP_ONE = []


def one_kernel(phase, what, calls, tag):
    """One device kernel for each ``(label, call)`` of ``calls`` (the
    profiler's count, beside the launch counts): phase 27's whole arena
    steps on their captured states, phase 15's K8 and K10 calls."""
    from oddio_tpu_torch.utils import kernel_bench as KB

    counts = {label: KB.device_profile(fn, reps=1, exact=True)[1] for label, fn in calls}
    print(f"phase {phase} profile: device kernels per {what} {counts} {tag}")
    if any(k != 1 for k in counts.values()):
        raise AssertionError(f"a {what} is not one device kernel: {counts}")


def _sampler_launches(SK, label, nblk):
    """K6 arena-form launches of a sampler path run just made: one whole
    step a block (a Fader's both banks in it), and no read-only
    ``arena_resample`` launch."""
    k = SK.LAUNCHES["arena_step"]
    if k != nblk or SK.LAUNCHES["arena_resample"]:
        raise AssertionError(f"{label}: {k} arena_step launches in {nblk} blocks (one a block "
                             f"expected), {SK.LAUNCHES['arena_resample']} arena_resample")
    return k


def sampler_paths(pt, dev, kern, tag):
    """Phases 21-24 and 26: BASELINE config 4's dense mix (1024 Gain(Sine)
    voices under Tanh(Reinhard(mixer)), set_gain on 64 voices between its
    runs), config 2 at a sampler's width (1024 Fader(Speed(FramesSignal))
    voices over 8 stereo 10 s sounds at 44.1 kHz, a speed write on 64
    voices and a fade on 64 others every 8 blocks), the wavetable line
    (1024 Speed(Cycle) voices) and a seek sampler (1024 FramesSignal
    voices in a seek pool), each through render_frames and
    render_frames_device with launches counted (no K6 on the dense mix;
    one whole ``arena_step`` a block on the others, the sampler's both
    fader banks in it, and no ``arena_resample``; fades released on the
    device: the device's bank bits follow the host mirrors and have
    flipped), their real-time factors; then each scene at 64-256 voices
    on the card against the CPU render."""
    from oddio_tpu_torch.core.drctrl import _state_at
    from oddio_tpu_torch.ops import agc as A
    from oddio_tpu_torch.ops import ring_kernels as RK
    from oddio_tpu_torch.ops import stream_kernels as SK
    from oddio_tpu_torch.utils import kernel_bench as KB
    from oddio_tpu_torch.utils.scene_profile import (build_densemix, build_sampler,
                                                     build_seek_sampler,
                                                     build_wavetable)

    nb1 = 94
    nblk = -(-RATE // BLOCK) + nb1
    sampler_total = 0

    def check(name, x, C):
        if not np.isfinite(x).all() or np.abs(x).max() <= 1e-3 or x.shape[1] != C:
            raise AssertionError(f"{name}: non-finite, silent or misshapen output {x.shape}")

    def flat(outs, C):
        return torch.cat([o.permute(0, 2, 1).reshape(-1, C) for o in outs]).cpu().numpy()

    def xrt(label, render):
        render(32)
        torch.cuda.synchronize()
        n = 188
        t0 = time.perf_counter()
        render(n)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(f"xRT {label}: {(n * BLOCK / RATE) / wall:.2f}x ({n} blocks in {wall:.3f} s, "
              f"{1e3 * wall / n:.3f} ms per block) {tag}")

    def other_kernels(label):
        if any(RK.LAUNCHES.values()) or any(A.LAUNCHES.values()):
            raise AssertionError(f"{label} launched ring or AGC kernels: {RK.LAUNCHES} "
                                 f"{A.LAUNCHES}")
        read_flat_launches(label)

    # -- 21. config 4: the dense mix ---------------------------------------------
    t0 = time.perf_counter()
    chain, mixer, gcs, rng = build_densemix(1024, dev)
    r = pt.Renderer(chain, RATE)
    print(f"dense mix: 1024 Gain(Sine) voices under Tanh(Reinhard(mixer)) built in "
          f"{time.perf_counter() - t0:.2f} s {tag}")
    reset_launches()
    a = r.render_frames(RATE)
    for gc in gcs[:64]:
        gc.set_gain(float(rng.uniform(-20, 0)))
    b = flat(r.render_frames_device(BLOCK * nb1), 1)
    torch.cuda.synchronize()
    other_kernels("the dense-mix path")
    if any(SK.LAUNCHES.values()):
        raise AssertionError(f"the dense-mix path launched stream kernels: {SK.LAUNCHES}")
    check("dense mix render_frames", a, 1)
    check("dense mix render_frames_device", b, 1)
    if np.abs(b).max() > np.tanh(1.0) + 1e-6:
        raise AssertionError("dense mix: the limiters let a sample past tanh(1)")
    print(f"dense-mix path: 1 s + {BLOCK * nb1 / RATE:.3f} s, set_gain on 64 voices between; "
          f"peak |out| {np.abs(a).max():.4f}/{np.abs(b).max():.4f}; no kernel of this slice "
          f"(K6 arena 0 launches) {tag}")
    xrt("dense mix 1024 voices", lambda k: r.render_frames_device(BLOCK * k, sync=False))
    BLOCK_PROFILES.append((21, "the 1024-voice dense mix",
                           lambda r=r: r.render_frames_device(BLOCK * 8, sync=False), 8))

    # -- 22. config 2: the sampler --------------------------------------------
    t0 = time.perf_counter()
    drv = build_sampler(1024, dev)
    r = pt.Renderer(drv.mixer, RATE)
    mb = sum(f.data.nbytes for f in drv.frames) / 1e6
    print(f"sampler: 1024 Fader(Speed(FramesSignal)) voices over 8 stereo 10 s sounds at "
          f"44.1 kHz ({mb:.1f} MB of samples, twice that in the two arenas) built in "
          f"{time.perf_counter() - t0:.2f} s {tag}")
    reset_launches()
    a = np.concatenate(drv.render(r, -(-RATE // BLOCK), device_out=False))
    b = flat(drv.render(r, nb1), 2)
    torch.cuda.synchronize()
    other_kernels("the sampler path")
    k = _sampler_launches(SK, "the sampler path", nblk)
    sampler_total += k
    check("sampler render_frames", a, 2)
    check("sampler render_frames_device", b, 2)
    pool = next(iter(drv.mixer._pools.values()))
    path = pool.fade_paths[0]
    dev_state = _state_at(pool.state["inner"], path)
    flips = dev_state["flip"].cpu().numpy()
    if not pool.is_dr or not np.array_equal(flips, pool._fade_flip[path]) or flips.sum() == 0:
        raise AssertionError(f"sampler: fades not released on the device (flips {flips.sum()}, "
                             f"mirrors {pool._fade_flip[path].sum()})")
    print(f"sampler path: 1 s + {BLOCK * nb1 / RATE:.3f} s, {drv.fades} fades queued, "
          f"{int(flips.sum())} voices on their other bank (device bits = host mirrors); peak "
          f"|out| {np.abs(a).max():.4f}/{np.abs(b).max():.4f}; K6 arena_step launches {k} "
          f"({k / nblk:.2f} per block: both fader banks in one), arena_resample 0 {tag}")
    xrt("sampler 1024 voices", lambda k: drv.render(r, k))
    BLOCK_PROFILES.append((22, "the 1024-voice sampler (its control script every 8 blocks)",
                           lambda r=r, drv=drv: drv.render(r, 8), 8))
    del a, b

    # -- 23. the wavetable ---------------------------------------------------------
    mixer, scs, rng = build_wavetable(1024, dev)
    r = pt.Renderer(mixer, RATE)
    reset_launches()
    a = r.render_frames(RATE)
    for sc in scs[:64]:
        sc.set_speed(float(rng.uniform(0.8, 1.25)))
    b = flat(r.render_frames_device(BLOCK * nb1), 1)
    torch.cuda.synchronize()
    other_kernels("the wavetable path")
    k = _sampler_launches(SK, "the wavetable path", nblk)
    sampler_total += k
    check("wavetable render_frames", a, 1)
    check("wavetable render_frames_device", b, 1)
    print(f"wavetable path: 1024 Speed(Cycle) voices, 1 s + {BLOCK * nb1 / RATE:.3f} s, "
          f"set_speed on 64 between; peak |out| {np.abs(a).max():.4f}/{np.abs(b).max():.4f}; "
          f"K6 arena_step launches {k} ({k / nblk:.2f} per block), arena_resample 0 {tag}")
    xrt("wavetable 1024 voices", lambda k: r.render_frames_device(BLOCK * k, sync=False))
    BLOCK_PROFILES.append((23, "the 1024-voice wavetable",
                           lambda r=r: r.render_frames_device(BLOCK * 8, sync=False), 8))

    # -- 26. the seek sampler ------------------------------------------------------
    t0 = time.perf_counter()
    _, scene, hs, rng = build_seek_sampler(1024, dev)
    r = pt.Renderer(scene, RATE)
    print(f"seek sampler: 1024 mono FramesSignal voices over 8 10 s sounds in a SpatialScene's "
          f"seek pool built in {time.perf_counter() - t0:.2f} s {tag}")
    reset_launches()
    a = r.render_frames(RATE)
    for h in hs[:64]:
        h.set_motion(rng.uniform(-15, 15, 3), rng.uniform(-5, 5, 3), False)
    b = flat(r.render_frames_device(BLOCK * nb1), 2)
    torch.cuda.synchronize()
    other_kernels("the seek-sampler path")
    k = _sampler_launches(SK, "the seek-sampler path", nblk)
    sampler_total += k
    check("seek sampler render_frames", a, 2)
    check("seek sampler render_frames_device", b, 2)
    print(f"seek-sampler path: 1 s + {BLOCK * nb1 / RATE:.3f} s, set_motion on 64 between; "
          f"peak |out| {np.abs(a).max():.4f}/{np.abs(b).max():.4f}; K6 arena_step launches {k} "
          f"({k / nblk:.2f} per block: both ears in one), arena_resample 0 {tag}")
    xrt("seek sampler 1024 voices", lambda k: r.render_frames_device(BLOCK * k, sync=False))
    BLOCK_PROFILES.append((26, "the 1024-voice seek sampler",
                           lambda r=r: r.render_frames_device(BLOCK * 8, sync=False), 8))
    kern["arena_step"]["launches"] = sampler_total
    kern["arena_resample"]["launches"] = 0  # no path reads through it now

    # -- 24. card vs CPU ------------------------------------------------------------
    for label, V in (("dense mix", 256), ("sampler", 128), ("wavetable", 256),
                     ("seek sampler", 128)):
        outs = []
        for device in (dev, "cpu"):
            if label == "dense mix":
                chain, _, gcs, rng = build_densemix(V, device)
                r = pt.Renderer(chain, RATE)
                x = r.render_frames(BLOCK * 12)
                for gc in gcs[:16]:
                    gc.set_gain(-30.0)
                outs.append(np.concatenate([x, r.render_frames(BLOCK * 12)]))
            elif label == "sampler":
                drv = build_sampler(V, device, sounds=2, seconds=2.0)
                r = pt.Renderer(drv.mixer, RATE)
                outs.append(np.concatenate(drv.render(r, 24, device_out=False)))
            elif label == "seek sampler":
                _, scene, hs, rng = build_seek_sampler(V, device, sounds=2, seconds=2.0)
                r = pt.Renderer(scene, RATE)
                x = r.render_frames(BLOCK * 12)
                for h in hs[:16]:
                    h.set_motion(rng.uniform(-15, 15, 3), rng.uniform(-5, 5, 3), False)
                outs.append(np.concatenate([x, r.render_frames(BLOCK * 12)]))
            else:
                mixer, scs, rng = build_wavetable(V, device)
                r = pt.Renderer(mixer, RATE)
                x = r.render_frames(BLOCK * 12)
                for sc in scs[:16]:
                    sc.set_speed(1.2)
                outs.append(np.concatenate([x, r.render_frames(BLOCK * 12)]))
        err = float(np.abs(outs[0] - outs[1]).max())
        if not err <= TOL or np.abs(outs[1]).max() <= 1e-2:
            raise AssertionError(f"{V}-voice {label}: card render differs from the CPU by {err}")
        print(f"reference: {label} {V} voices, card vs CPU plain, 24 blocks with control "
              f"writes, max|diff| {err:.3e} (<= {TOL}) {tag}")


def strip_select_scene_kernel(dev, kern, tag):
    """Phase 28: K5's scene form against its plain version
    (``strip_select_record(..., scenes=S)``, each scene's rows mixed
    apart) at the host-pool pack's 16 scenes x 256 voices, at one scene of
    4096 and at 3 scenes of 17 (a scene boundary inside a block of 32
    voices): steps up to the strip gate (the SELECT_R clamp binds), read
    windows across the ring's end, frozen voices; each scene elementwise
    within ``ring_kernels.strip_record_tolerance``; one launch a call, two
    runs bit-equal, one scene equal to the (2, n) form.  Timed warm and,
    at the pack's shape, cold, beside the (2, n) form on the same rows."""
    from oddio_tpu_torch.ops import ring_kernels as RK
    from oddio_tpu_torch.utils import kernel_bench as KB

    rng = np.random.default_rng(28)
    n, K = KB.SELECT_N, KB.SELECT_K
    kw = dict(n=n, K=K)
    for label, S, vps, L in KB.SELECT_SCENES:
        V = S * vps
        ops = KB.select_scene_operands(dev, rng, V, L)
        rec = RK.voice_record(*ops[1:])
        plain = RK.strip_select_record_plain(ops[0], rec, scenes=S, **kw)
        tol = RK.strip_record_tolerance(ops[0], rec, scenes=S, **kw).clamp_min(1e-300)
        before = RK.LAUNCHES["strip_select_scenes"]
        got = RK.strip_select_record(ops[0], rec, scenes=S, **kw)
        again = RK.strip_select_record(ops[0], rec, scenes=S, **kw)
        torch.cuda.synchronize()
        if RK.LAUNCHES["strip_select_scenes"] != before + 2:
            raise AssertionError(f"K5 scene form ({label}): "
                                 f"{RK.LAUNCHES['strip_select_scenes'] - before} launches for 2")
        if got.shape != (S, 2, n) or not torch.equal(got, again):
            raise AssertionError(f"K5 scene form ({label}): shape {tuple(got.shape)} or two "
                                 f"runs differ")
        diff = (got - plain).abs().double()
        err, share = float(diff.max()), float((diff / tol).max())
        if not share <= 1.0:
            raise AssertionError(f"K5 scene form ({label}): kernel disagrees with its plain "
                                 f"version: max|diff| {err:.3e}, {share:.1f}x its tolerance")
        if S == 1 and not torch.equal(got[0], RK.strip_select_record(ops[0], rec, **kw)):
            raise AssertionError("K5 scene form with one scene differs from the (2, n) form")
        ts = timed(f"K5 scene form {label}", lambda: RK.strip_select_record(
            ops[0], rec, scenes=S, **kw))
        t1 = timed(f"K5 (2, n) form on the {label} rows",
                   lambda: RK.strip_select_record(ops[0], rec, **kw))
        pms = time_ms(lambda: RK.strip_select_record_plain(ops[0], rec, scenes=S, **kw))
        cold = ""
        if label == "pack":
            sets = [(ops[0], rec)] + [
                (ops[0], RK.voice_record(*KB.select_scene_operands(dev, rng, V, L, ops[0])[1:]))
                for _ in range(KB.SETS - 1)]
            tc = timed("K5 scene form pack, cold", KB.cycling(
                sets, lambda r, rc, S=S: RK.strip_select_record(r, rc, scenes=S, **kw)))
            tc1 = timed("K5 (2, n) form on the pack rows, cold", KB.cycling(
                sets, lambda r, rc: RK.strip_select_record(r, rc, **kw)))
            cold = f", cold {times_str(tc)} ((2, n) form cold {times_str(tc1)})"
            bms, by = bound(KB.select_bytes(RK, ops, scenes=S), 22 * V * 2 * n)
            kern["strip_select_scenes"] = record(
                "oddio_tpu/ops/pallas_ring.py:392", "oddio_tpu_torch/csrc/select_kernel.cu",
                err, ts, pms, bms, by)
            kern["strip_select_scenes"].update(cold=tc, other_form=t1, shapes=f"{S} x {vps}")
        kern["strip_select_scenes"]["err"] = max(kern["strip_select_scenes"]["err"], err)
        print(f"K5 scene form {label} S={S} x {vps} L={L}: max|diff| {err:.3e} ({share:.3f} of "
              f"its tolerance; one launch a call, two runs bit-equal); scene form "
              f"{times_str(ts)}, (2, n) form on the same rows {times_str(t1)}{cold} vs plain "
              f"{pms:.4f} ms {tag}")


def _pack_fade_bits(pack):
    """(scenes whose device bank bits equal their host fade mirrors,
    scenes with a flipped voice) of a sampler pack, after ``sync``."""
    from oddio_tpu_torch.core.drctrl import _state_at

    pack.sync()
    same = flipped = 0
    for scene in pack.scenes:
        pool = next(iter(scene._pools.values()))
        path = pool.fade_paths[0]
        bits = _state_at(pool.state["inner"], path)["flip"].cpu().numpy()
        same += int(np.array_equal(bits, pool._fade_flip[path]))
        flipped += int(bits.any())
    return same, flipped


def sampler_pack_path(pt, dev, kern, tag):
    """Phase 29: BASELINE config 2 per session, ``build_sampler_pack(S,
    64)`` at S = 4 and 16 (1024 Fader(Speed(FramesSignal)) rows at 16),
    each scene on its own script (speed writes on 8 voices and 0.05 s
    fades on 8 others every 8 blocks), through render_block and
    render_frames_device: one ``arena_step`` launch a block for the whole
    pack at both S (launch counters), fades released on the device (each
    scene's bank bits equal its host mirrors and have flipped); xRT per
    scene at 16."""
    from oddio_tpu_torch.ops import agc as A
    from oddio_tpu_torch.ops import ring_kernels as RK
    from oddio_tpu_torch.ops import stream_kernels as SK
    from oddio_tpu_torch.utils.scene_profile import build_sampler_pack

    # 6 periods of 8 blocks: each scene's script takes 16 of its 64 voices a
    # period, so a voice faded in periods 0-1 is faded again in 4-5 (back
    # to its first bank) and one faded in periods 2-3 stays flipped
    nb0, nb1 = 8, 40
    per_block = {}
    for S in (4, 16):
        t0 = time.perf_counter()
        drv = build_sampler_pack(S, 64, dev)
        built = time.perf_counter() - t0
        reset_launches()
        a = np.concatenate(drv.render(nb0, device_out=False), axis=1)
        b = drain(drv.render(nb1))
        torch.cuda.synchronize()
        if any(RK.LAUNCHES.values()) or any(A.LAUNCHES.values()):
            raise AssertionError(f"the sampler pack launched ring or AGC kernels: {RK.LAUNCHES} "
                                 f"{A.LAUNCHES}")
        read_flat_launches("the sampler pack path")
        k = _sampler_launches(SK, f"the sampler pack (S={S})", nb0 + nb1)
        per_block[S] = k / (nb0 + nb1)
        for name, x in (("render_block", a), ("render_frames_device", b)):
            if (x.shape[0], x.shape[2]) != (S, 2) or not np.isfinite(x).all() \
                    or np.abs(x).max(axis=(1, 2)).min() <= 1e-3:
                raise AssertionError(f"sampler pack S={S} {name}: non-finite, silent or "
                                     f"misshapen output {x.shape}")
        same, flipped = _pack_fade_bits(drv.pack)
        if same != S or flipped != S:
            raise AssertionError(f"sampler pack S={S}: fades not released on the device (bank "
                                 f"bits = host mirrors in {same} scenes, flipped in {flipped})")
        print(f"sampler pack S={S} x 64 voices (built in {built:.2f} s): {nb0} blocks "
              f"render_block + {nb1} render_frames_device, {sum(d.fades for d in drv.drivers)} "
              f"fades queued; bank bits = host mirrors and flipped in all {S} scenes; K6 "
              f"arena_step launches {k} ({per_block[S]:.2f} per block), arena_resample 0 {tag}")
        if S == 16:
            kern["arena_step"]["pack_launches"] = k
            drv.render(16)
            torch.cuda.synchronize()
            nblk = 96
            t0 = time.perf_counter()
            drv.render(nblk)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            print(f"xRT per scene sampler pack S=16 x 64: {(nblk * BLOCK / RATE) / wall:.2f}x "
                  f"({nblk} blocks in {wall:.3f} s, {1e3 * wall / nblk:.3f} ms per block) {tag}")
            BLOCK_PROFILES.append((29, "the 16 x 64 sampler pack (its scripts every 8 blocks)",
                                   lambda drv=drv: drv.render(8), 8))
    if not per_block[4] == per_block[16] == 1.0:
        raise AssertionError(f"sampler pack: arena_step per block {per_block}")


def host_pools_pack_path(pt, dev, kern, tag):
    """Phase 30: every buffered pool kind per session,
    ``build_host_pools_pack(S, 256)`` at S = 4 and 16 (at 16: 4096
    Speed(Stream) host rows, 512 Adapt(Stream) device-resident rows, 16
    config-5 submixes of 64 voices), through render_block and
    render_frames_device with new stream PCM and set_speed on 64 voices
    between them: K5's scene form twice a block (the host pool's rows and
    the submixes' singleton rows), and every kernel's launches per block
    equal at both S (launch counters); xRT per scene at 16."""
    from oddio_tpu_torch.ops import agc as A
    from oddio_tpu_torch.ops import ring_kernels as RK
    from oddio_tpu_torch.ops import stream_kernels as SK
    from oddio_tpu_torch.utils.scene_profile import build_host_pools_pack, feed

    nb0, nb1 = 8, 24
    nblk = nb0 + nb1
    per_block = {}
    for S in (4, 16):
        t0 = time.perf_counter()
        pack, ctls, speeds, rng = build_host_pools_pack(S, 256, dev)
        built = time.perf_counter() - t0
        reset_launches()
        a = np.concatenate([pack.render_block(BLOCK) for _ in range(nb0)], axis=1)
        feed(ctls, rng, 1024)
        for sc in speeds[:64]:
            sc.set_speed(float(rng.uniform(0.8, 1.25)))
        b = drain(pack.render_frames_device(BLOCK * nb1))
        torch.cuda.synchronize()
        launches = {**RK.LAUNCHES, **stream_launches(SK, f"the host-pool pack (S={S})"),
                    **A.LAUNCHES}
        read_flat_launches(f"the host-pool pack (S={S})")
        for name, x in (("render_block", a), ("render_frames_device", b)):
            if (x.shape[0], x.shape[2]) != (S, 2) or not np.isfinite(x).all() \
                    or np.abs(x).max(axis=(1, 2)).min() <= 1e-3:
                raise AssertionError(f"host-pool pack S={S} {name}: non-finite, silent or "
                                     f"misshapen output {x.shape}")
        path = ("append", "select_ears", "strip_select", "strip_select_scenes", "ring_place",
                "ring_resample", "agc_gains")
        if min(launches[k] for k in path) < 1:
            raise AssertionError(f"a kernel of the host-pool pack path never launched: {launches}")
        if not launches["strip_select"] == launches["strip_select_scenes"] == 2 * nblk:
            raise AssertionError(f"host-pool pack S={S}: K5 launched {launches['strip_select']} "
                                 f"times ({launches['strip_select_scenes']} scene form) in "
                                 f"{nblk} blocks, 2 a block expected")
        per_block[S] = {k: v / nblk for k, v in launches.items()}
        kinds = [f"{type(p).__name__}({p.capacity})" for p in pack.scenes[0]._all_pools()]
        print(f"host-pool pack S={S} x (256 Speed(Stream) + 32 Adapt(Stream) + a 64-voice "
              f"submix), pools {kinds} per scene (built in {built:.2f} s): {nb0} blocks "
              f"render_block + {nb1} render_frames_device, a write and 64 set_speed between; "
              f"launches per block {per_block[S]} {tag}")
        if S == 16:
            kern["strip_select_scenes"]["launches"] = launches["strip_select_scenes"]
            for key, name in (("ring_place", "ring_place"), ("agc_gains", "agc_gains"),
                              ("ring_resample", "ring_resample"),
                              ("append", "rows_append"),
                              ("select_ears", "window_select_ears")):
                if name in kern:
                    kern[name]["pack_launches"] = launches[key]
            pack.render_frames_device(BLOCK * 8)
            feed(ctls, rng, 1024)
            torch.cuda.synchronize()
            n_x = 96
            t0 = time.perf_counter()
            pack.render_frames_device(BLOCK * n_x)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            print(f"xRT per scene host-pool pack S=16 x 256: {(n_x * BLOCK / RATE) / wall:.2f}x "
                  f"({n_x} blocks in {wall:.3f} s, {1e3 * wall / n_x:.3f} ms per block) {tag}")
            BLOCK_PROFILES.append((30, "the 16 x 256 host-pool pack",
                                   lambda pack=pack: pack.render_frames_device(BLOCK * 8), 8))
        del pack
    if per_block[4] != per_block[16]:
        raise AssertionError(f"host-pool pack: launches per block differ: S=4 {per_block[4]}, "
                             f"S=16 {per_block[16]}")


def _mixer_host_scene(pt, device, seed):
    """A Mixer of 8 Speed(Stream) host-pool voices, a Sine and a submix
    Mixer (a Speed(Stream) and a Sine) at 48 kHz, its streams prefilled
    from ``seed``; returns (mixer, stream controls)."""
    rng = np.random.default_rng(seed)
    control, mixer = pt.Mixer.new(channels=1, device=device)
    ctls = []
    for _ in range(8):
        st = pt.Stream(8000, 4096)
        sc, sp = pt.Speed.new(st)
        sc.set_speed(float(rng.uniform(0.7, 1.3)))
        control.play(sp)
        ctls.append(st.control)
    control.play(pt.Sine(0.2, 330.0 + 20 * seed))
    ic, inner = pt.Mixer.new(channels=1, device=device)
    st = pt.Stream(8000, 4096)
    ic.play(pt.Speed(st))
    ic.play(pt.Sine(0.0, 520.0))
    ctls.append(st.control)
    control.play(inner)
    for c in ctls:
        c.write((np.sin(np.arange(3000) * rng.uniform(0.01, 0.1)) * 0.5).astype(np.float32))
    return mixer


def new_pack_reference(pt, dev, tag):
    """Phase 31: the host-pool pack (4 x 32 voices), the sampler pack (4 x
    64) and a pack of 4 Mixers with host-pool voices and a Mixer-in-Mixer
    submix, on the card against the same packs on the CPU and against
    per-scene Renderers on the card, each within TOL."""
    from oddio_tpu_torch.parallel.mesh import make_mesh
    from oddio_tpu_torch.parallel.sharded import ScenePack
    from oddio_tpu_torch.utils.scene_profile import build_host_pools_pack, build_sampler_pack

    S, nblk = 4, 16

    def host_pack(device):
        return build_host_pools_pack(S, 32, device)[0]

    def mixer_pack(device):
        return ScenePack([_mixer_host_scene(pt, device, s) for s in range(S)], RATE,
                         make_mesh(1, 1, [device]))

    def blocks(pack):
        return np.concatenate([pack.render_block(BLOCK) for _ in range(nblk)], axis=1)

    def singles(pack):
        rs = [pt.Renderer(s, RATE) for s in pack.scenes]
        return np.concatenate([np.stack([r.render_block(BLOCK) for r in rs])
                               for _ in range(nblk)], axis=1)

    def sampler(device, per_scene):
        drv = build_sampler_pack(S, 64, device, sounds=2, seconds=2.0)
        if not per_scene:
            return np.concatenate(drv.render(nblk, device_out=False), axis=1)
        return np.stack([np.concatenate(d.render(pt.Renderer(d.mixer, RATE), nblk,
                                                 device_out=False)) for d in drv.drivers])

    cases = (("host-pool pack 4 x 32", lambda d: blocks(host_pack(d)),
              lambda: singles(host_pack(dev))),
             ("sampler pack 4 x 64", lambda d: sampler(d, False), lambda: sampler(dev, True)),
             ("Mixer pack of host-pool voices and a submix", lambda d: blocks(mixer_pack(d)),
              lambda: singles(mixer_pack(dev))))
    for label, run, per_scene in cases:
        card, cpu, own = run(dev), run("cpu"), per_scene()
        errs = (float(np.abs(card - cpu).max()), float(np.abs(card - own).max()))
        if not max(errs) <= TOL or np.abs(cpu).max() <= 1e-2:
            raise AssertionError(f"{label}: card vs CPU {errs[0]}, vs per-scene Renderers "
                                 f"{errs[1]}")
        print(f"reference: {label}, {nblk} blocks: card vs CPU plain max|diff| {errs[0]:.3e}, "
              f"vs per-scene Renderers on the card {errs[1]:.3e} (<= {TOL}) {tag}")


def path_launches():
    """Every kernel's launches since ``reset_launches``, by its name in the
    kernels line."""
    from oddio_tpu_torch.ops import agc as A
    from oddio_tpu_torch.ops import flat_kernels as FK
    from oddio_tpu_torch.ops import ring_kernels as RK
    from oddio_tpu_torch.ops import stream_kernels as SK

    return {"rows_append": RK.LAUNCHES["append"],
            "window_select_ears": RK.LAUNCHES["select_ears"],
            "window_select_multi": RK.LAUNCHES["select_multi"],
            "strip_select": RK.LAUNCHES["strip_select"],
            "strip_select_scenes": RK.LAUNCHES["strip_select_scenes"],
            **{k: SK.LAUNCHES[k] for k in ("ring_place", "ring_resample", "arena_resample",
                                          "arena_step")},
            "agc_gains": A.LAUNCHES["agc_gains"],
            **{name: FK.LAUNCHES[k] for k, name in FLAT_KERNELS.items()}}


def _same_np(got, want):
    """Two renders equal bit for bit, an exact zero's sign aside (ROADMAP
    Q3.7)."""
    def bits(x):
        return np.where(x == 0, np.float32(0.0), x).astype(np.float32).view(np.int32)

    return got.shape == want.shape and np.array_equal(bits(got), bits(want))


def _audible(label, x):
    if not np.isfinite(x).all() or np.abs(x).max() <= 1e-3:
        raise AssertionError(f"{label}: non-finite or silent output")


#: phase 32's scenes: kind -> (voices, blocks rendered after the snapshot,
#: the kernels that must launch there).  The buffered scene renders 64
#: blocks through render_frames: the queued motion keeps its first blocks
#: delta blocks, and the idle run after them reaches K3's fused groups
CHECKPOINT_PATHS = {
    "buffered": (VOICES, 64, ("rows_append", "window_select_ears", "window_select_multi")),
    "mixer": (VOICES, 16, ("ring_place", "ring_resample", "agc_gains")),
    "hostpools": (VOICES, 16, ("rows_append", "window_select_ears", "strip_select",
                               "ring_place", "ring_resample", "agc_gains")),
    "sampler": (1024, 16, ("arena_step",)),
}


def checkpoint_paths(pt, dev, kern, tag):
    """Phase 32: checkpoints of the four scenes at full width, their
    control events queued at the snapshot (``build_checkpoint_scene``):
    snapshot, render (a), restore, render (b), restore, render (c); b and
    c equal a bit for bit, and every kernel launches as often after a
    restore as before it.  Then each scene's 256-voice snapshot, taken on
    the card and saved to a file, loads into the same scene built on the
    CPU: 8 blocks on both agree within TOL."""
    import os
    import pickle
    import tempfile

    from oddio_tpu_torch.utils import checkpoint as CK
    from oddio_tpu_torch.utils.scene_profile import build_checkpoint_scene

    for kind, (voices, nblk, path) in CHECKPOINT_PATHS.items():
        t0 = time.perf_counter()
        eng, r = build_checkpoint_scene(kind, voices, dev)
        torch.cuda.synchronize()
        built = time.perf_counter() - t0
        t0 = time.perf_counter()
        snap = CK.snapshot(eng)
        snap_ms = 1e3 * (time.perf_counter() - t0)
        mb = len(pickle.dumps(snap, protocol=pickle.HIGHEST_PROTOCOL)) / 1e6
        outs, counts, restore_ms = [], [], []
        for i in range(3):
            if i:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                CK.restore(eng, snap)
                torch.cuda.synchronize()
                restore_ms.append(1e3 * (time.perf_counter() - t0))
            reset_launches()
            outs.append(r.render_frames(BLOCK * nblk))
            torch.cuda.synchronize()
            counts.append(path_launches())
            read_flat_launches(f"the resumed {kind} scene")
        _audible(f"the resumed {kind} scene", outs[0])
        for i, x in enumerate(outs[1:], 1):
            if not _same_np(x, outs[0]):
                raise AssertionError(f"{kind}: render {i} after a restore differs from the "
                                     f"render after the snapshot by "
                                     f"{float(np.abs(x - outs[0]).max())}")
            if counts[i] != counts[0]:
                raise AssertionError(f"{kind}: launches after restore {i} {counts[i]} differ "
                                     f"from those after the snapshot {counts[0]}")
        missing = [k for k in path if counts[0][k] < 1]
        if missing:
            raise AssertionError(f"the resumed {kind} scene never launched {missing}: "
                                 f"{counts[0]}")
        per_block = {k: v / nblk for k, v in counts[0].items() if v}
        for k, v in per_block.items():
            kern[k].setdefault("resume_launches", {})[kind] = v
        print(f"phase 32 checkpoint: {kind} {voices} voices (built in {built:.2f} s): "
              f"snapshot {mb:.2f} MB in {snap_ms:.1f} ms, restore "
              f"{' / '.join(f'{t:.1f}' for t in restore_ms)} ms; {nblk} blocks after the "
              f"snapshot and after two restores bit-equal, launches per block {per_block} "
              f"equal {tag}")
        del eng, r, snap, outs

    # card -> file -> CPU, 256 voices
    with tempfile.TemporaryDirectory() as td:
        for kind in CHECKPOINT_PATHS:
            path = os.path.join(td, f"{kind}.pkl")
            got = []
            for device in (dev, "cpu"):
                eng, r = build_checkpoint_scene(kind, 256, device)
                if device == dev:
                    CK.save(eng, path)
                else:
                    CK.load(eng, path)
                got.append(r.render_frames(BLOCK * 8))
            err = float(np.abs(got[0] - got[1]).max())
            _audible(f"the {kind} scene loaded on the CPU", got[1])
            if not err <= TOL:
                raise AssertionError(f"{kind}: the snapshot saved on the card renders on the "
                                     f"CPU {err} apart")
            print(f"phase 32 checkpoint: {kind} 256 voices saved on the card "
                  f"({os.path.getsize(path) / 1e6:.2f} MB), loaded on the CPU: 8 blocks, "
                  f"max|diff| {err:.3e} (<= {TOL}) {tag}")


def _drain_blocks(drv, k, timeout):
    """The callback side of phase 33(a): read ``drv.block_size`` frames
    only when that many are readable, until ``k`` blocks."""
    got = []
    need = drv.block_size * drv.channels
    deadline = time.perf_counter() + timeout
    while len(got) < k:
        if not drv.alive():
            raise AssertionError(f"the render thread ended after {drv.blocks} blocks") \
                from drv.error
        if time.perf_counter() > deadline:
            raise AssertionError(f"{len(got)} of {k} blocks in {timeout} s")
        if drv._ring.readable() >= need:
            got.append(drv.read(drv.block_size))
        else:
            time.sleep(0.0002)
    return np.concatenate(got)


def realtime_paths(pt, dev, kern, tag):
    """Phase 33: the RealtimeDriver on the card.  (a) The 4096-voice
    config-5 mixer, its PCM fed before start(): 32 blocks read by the
    callback side equal a second mixer's render_block loop bit for bit,
    and the render thread is alive with at least 32 blocks rendered.
    (b) The 4096-voice buffered scene and the config-5 mixer pulled at a
    real-time pace for 3 s after the first non-silent read: underruns,
    blocks rendered and the render thread's xRT, printed."""
    from oddio_tpu_torch.control.realtime import RealtimeDriver
    from oddio_tpu_torch.utils.scene_profile import build_mixer_agc, build_spatial

    _, mixer, _, _ = build_mixer_agc(VOICES, dev)
    _, twin, _, _ = build_mixer_agc(VOICES, dev)
    reset_launches()
    drv = RealtimeDriver(mixer, RATE, block_size=BLOCK, lead_blocks=4).start()
    try:
        got = _drain_blocks(drv, 32, 300)
        if not drv.alive() or drv.error is not None or drv.blocks < 32:
            raise AssertionError(f"render thread alive {drv.alive()}, {drv.blocks} blocks, "
                                 f"error {drv.error!r}")
    finally:
        drv.stop()
    counts = path_launches()
    read_flat_launches("the realtime mixer")
    blocks = drv.blocks
    r = pt.Renderer(twin, RATE)
    want = np.concatenate([r.render_block(BLOCK) for _ in range(32)])
    _audible("the realtime mixer", got)
    if not _same_np(got, want):
        raise AssertionError(f"the driver's 32 blocks differ from the Renderer's by "
                             f"{float(np.abs(got - want).max())}")
    per_block = {k: v / blocks for k, v in counts.items() if v}
    for k in ("ring_place", "ring_resample", "agc_gains"):
        if counts[k] < 1:
            raise AssertionError(f"the realtime mixer never launched {k}: {counts}")
    print(f"phase 33 realtime: {VOICES}-voice config-5 mixer, 32 blocks read through the "
          f"driver equal a Renderer's bit for bit; render thread alive, {blocks} blocks; "
          f"launches per block {per_block} {tag}")
    del mixer, twin, drv

    period = BLOCK / RATE
    for label, build in (("buffered", lambda: build_spatial(True, VOICES, dev)[1]),
                         ("mixer", lambda: build_mixer_agc(VOICES, dev)[1])):
        eng = build()
        reset_launches()
        drv = RealtimeDriver(eng, RATE, block_size=BLOCK, lead_blocks=4).start()
        try:
            t0 = time.perf_counter()
            while np.abs(drv.read(BLOCK)).max() == 0:
                if not drv.alive() or time.perf_counter() - t0 > 300:
                    raise AssertionError(f"{label}: no audio from the driver "
                                         f"(alive {drv.alive()})") from drv.error
                time.sleep(0.005)
            warm = time.perf_counter() - t0
            drv.underruns = 0
            drv.meter.reset()
            b0 = drv.blocks
            pulls, peak = int(3.0 / period), 0.0
            t_next = time.perf_counter()
            for _ in range(pulls):
                t_next += period
                peak = max(peak, float(np.abs(drv.read(BLOCK)).max()))
                time.sleep(max(0.0, t_next - time.perf_counter()))
            if not drv.alive():
                raise AssertionError(f"{label}: the render thread ended") from drv.error
            rendered = drv.blocks - b0
            xrt = drv.meter.xrt()
        finally:
            drv.stop()
        counts = path_launches()
        read_flat_launches(f"the realtime {label} run")
        per_block = {k: v / drv.blocks for k, v in counts.items() if v}
        for k, v in per_block.items():
            kern[k].setdefault("realtime_launches", {})[label] = v
        print(f"phase 33 realtime: {label} {VOICES} voices, first audio after {warm:.2f} s; "
              f"{pulls} pulls over 3 s at 48 kHz, 512-frame blocks, lead 4: underruns "
              f"{drv.underruns}, {rendered} blocks rendered, render thread xRT {xrt:.2f}x, "
              f"peak {peak:.4f}; launches per block {per_block} {tag}")
        del eng, drv


EXAMPLES = ("offline", "wav_playback", "adapt_agc", "crossfade_beds", "game_mix", "simple",
            "realtime_spatial")
#: the WAV each offline twin writes (game_mix writes none and prints its peak)
EXAMPLE_WAVS = {"offline": "offline.wav", "wav_playback": "wav_playback.wav",
                "adapt_agc": "adapt.wav", "crossfade_beds": "crossfade_beds.wav"}


#: max |mesh pack - 1 x 1 pack| (phase 35): the float32 roundings of the
#: voice shards' partial mixes
MESH_TOL = 2e-6
#: the wrappers' counter keys a mesh phase reads, and their kernels-line names
MESH_KERNELS = {"append": "rows_append", "select_ears": "window_select_ears",
                "strip_select_scenes": "strip_select_scenes", "ring_place": "ring_place",
                "ring_resample": "ring_resample", "arena_step": "arena_step",
                "agc_gains": "agc_gains"}


def _mesh_launches(label, nblk):
    """The launches per block of the run just made, by counter key, for
    ``label`` (K8-K10 and K6's read-only arena form must not launch)."""
    from oddio_tpu_torch.ops import agc as A
    from oddio_tpu_torch.ops import ring_kernels as RK
    from oddio_tpu_torch.ops import stream_kernels as SK

    read_flat_launches(label)
    if SK.LAUNCHES["arena_resample"]:
        raise AssertionError(f"{label} launched arena_resample")
    every = {**RK.LAUNCHES, **SK.LAUNCHES, **A.LAUNCHES}
    return {k: every[k] / nblk for k in MESH_KERNELS if every[k]}


def _mesh_xrt(render, nblk=96):
    """Per-scene xRT of ``nblk`` blocks through ``render(n)`` after a warm-up."""
    render(8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    render(nblk)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (nblk * BLOCK / RATE) / wall, 1e3 * wall / nblk


def _mesh_compare(label, one, mesh, tag, factor=None):
    """(out, launches per block, xRT, ms per block) of the 1 x 1 and the
    mesh run of ``label``: outputs within MESH_TOL, and with ``factor``
    every kernel's launches on the mesh that many times the 1 x 1's."""
    err = float(np.abs(one[0] - mesh[0]).max())
    bit = "bit-equal" if err == 0.0 else f"max|diff| {err:.3e}"
    print(f"phase 35 {label}: mesh vs 1 x 1 {bit} (<= {MESH_TOL}); launches per block "
          f"1 x 1 {one[1]}, mesh {mesh[1]}; xRT per scene 1 x 1 {one[2]:.2f}x "
          f"({one[3]:.3f} ms a block), mesh {mesh[2]:.2f}x ({mesh[3]:.3f} ms a block) {tag}")
    if not err <= MESH_TOL or np.abs(one[0]).max() <= 1e-3 or not np.isfinite(mesh[0]).all():
        raise AssertionError(f"{label}: mesh vs 1 x 1 max|diff| {err} (or silent/non-finite)")
    if factor is not None and mesh[1] != {k: factor * v for k, v in one[1].items()}:
        raise AssertionError(f"{label}: launches per block {mesh[1]}, {factor}x {one[1]} expected")
    return err


def _mesh_dryrun(devices, label, tag):
    """Phase 35(a): the dry-run twin (``parallel/dryrun.py``) over
    ``devices``; returns the pack's launches per block."""
    from oddio_tpu_torch.parallel.dryrun import TOL as DRY_TOL
    from oddio_tpu_torch.parallel.dryrun import dryrun_multichip

    t0 = time.perf_counter()
    reset_launches()
    d = dryrun_multichip(len(devices), devices)
    read_flat_launches("the dry run")
    per = {k: v / 3 for k, v in d["pack_launches"].items()}
    print(f"phase 35(a) dry run {label}: mesh {d['mesh']}, {d['scenes']} scenes x "
          f"{d['voices_per_scene']} voices ({d['voices_per_shard']} a shard), 3 blocks of 256 "
          f"with 16 + 1 plays a scene and motion mid-run: max|diff| vs per-scene Renderers "
          f"{d['max_abs_diff']:.3e} (<= {DRY_TOL}), checksum {d['checksum']:.6f}, pack "
          f"launches per block {per} ({time.perf_counter() - t0:.2f} s) {tag}")
    if min(per.get("append", 0), per.get("select_ears", 0)) <= 0:
        raise AssertionError(f"the dry run's pack launched no K1 or K2: {per}")
    return per


def _mesh_config5(dev, mesh, nb0=4, nb1=28):
    """Phase 35(b)'s run: BASELINE config 5 at full width (256 scenes x 256
    voices) on ``mesh`` (None: 1 x 1), 1024 new samples per stream before
    the run and another 1024 after ``nb0`` blocks; returns (out, launches
    per block, xRT per scene over 752 blocks, ms a block, build seconds,
    (graph_capture, step keys, graph_counts, every cell captured))."""
    from oddio_tpu_torch.utils.scene_profile import build_config5_pack, feed

    t0 = time.perf_counter()
    pack, ctls, _ = build_config5_pack(256, dev, mesh=mesh)
    built = time.perf_counter() - t0
    rng = np.random.default_rng(35)
    feed(ctls, rng, 1024)
    pcm = (rng.standard_normal((len(ctls), 1024)) * 0.1).astype(np.float32)
    reset_launches()
    out = config5_pack_run(pack, ctls, pcm, nb0, nb1)
    torch.cuda.synchronize()
    per = _mesh_launches("the config-5 pack", nb0 + nb1)
    feed(ctls, rng, 1024)
    xrt = _mesh_xrt(lambda k: pack.render_frames_device(BLOCK * k), 752)
    steps = (pack.graph_capture, len(pack._steps), dict(pack.graph_counts),
             _cells_captured(pack) == set(pack._cells))
    del pack
    torch.cuda.empty_cache()
    return (out, per, *xrt, built, steps)


def _mesh_host(dev, mesh, nb=4):
    """Phase 35(c)'s host-pool run: ``build_host_pools_pack(16, 256)`` on
    ``mesh``, twice 1024 new samples per stream and 16 set_speed, then
    ``nb`` blocks through render_block and ``nb`` through
    render_frames_device; returns (out, launches per block, xRT per scene,
    ms a block, (host buffered pools, submix pools) per scene)."""
    from oddio_tpu_torch.utils.scene_profile import build_host_pools_pack, feed

    pack, ctls, speeds, rng = build_host_pools_pack(16, 256, dev, mesh=mesh)
    reset_launches()
    outs = []
    for k in range(2):
        feed(ctls, rng, 1024)
        for sc in speeds[64 * k:64 * k + 64:4]:
            sc.set_speed(float(rng.uniform(0.8, 1.25)))
        outs.append(np.concatenate([pack.render_block(BLOCK) for _ in range(nb)]
                                   + [drain(pack.render_frames_device(BLOCK * nb))], axis=1))
    torch.cuda.synchronize()
    per = _mesh_launches("the host-pool pack", 4 * nb)
    kinds = [type(p).__name__ for p in pack.scenes[0]._all_pools()]
    feed(ctls, rng, 1024)
    xrt = _mesh_xrt(lambda k: pack.render_frames_device(BLOCK * k), 48)
    return (np.concatenate(outs, axis=1), per, *xrt,
            (kinds.count("_BufferedPool"), kinds.count("_BufferedPoolSingleton")))


def _mesh_sampler(dev, mesh, nblk=32):
    """Phase 35(c)'s sampler run: ``build_sampler_pack(16, 64)`` on
    ``mesh``, each scene on its script of speed writes and fades; after
    ``sync`` every scene's bank bits (gathered from its shards) must equal
    its host mirrors and have flipped.  Returns (out, launches per block,
    xRT per scene, ms a block, fades queued)."""
    from oddio_tpu_torch.utils.scene_profile import build_sampler_pack

    drv = build_sampler_pack(16, 64, dev, mesh=mesh)
    reset_launches()
    out = np.concatenate(drv.render(nblk, device_out=False), axis=1)
    torch.cuda.synchronize()
    per = _mesh_launches("the sampler pack", nblk)
    same, flipped = _pack_fade_bits(drv.pack)
    if same != 16 or flipped != 16:
        raise AssertionError(f"sampler pack on {mesh}: bank bits = host mirrors in {same} "
                             f"scenes, flipped in {flipped}")
    xrt = _mesh_xrt(lambda k: drv.render(k), 48)
    return (out, per, *xrt, sum(d.fades for d in drv.drivers))


def _mesh_card_cpu(dev, tag):
    """Phase 35(d): the spatial pack (4 scenes of 64 buffered and 192 seek
    voices) and the config-5 pack (4 scenes of 64 voices) on a 1 x 2 mesh over [card, CPU] against the 1 x 1 card pack: the CPU
    shard runs the plain versions, so a cell that read its scenes' device
    would fail; the card shard launches as the 1 x 1 pack does."""
    from oddio_tpu_torch.parallel.mesh import make_mesh
    from oddio_tpu_torch.utils.scene_profile import build_config5_pack, build_spatial_pack

    cpu_mesh = make_mesh(1, 2, [dev, "cpu"])
    for label, build in (
            ("spatial pack 4 x (64 buffered + 192 seek)",
             lambda m: (build_spatial_pack(4, dev, mesh=m), [], None)),
            ("config-5 pack 4 x 64", lambda m: build_config5_pack(4, dev, voices=64, mesh=m))):
        runs = []
        for m in (None, cpu_mesh):
            pack, ctls, _ = build(m)
            pcm = np.full((len(ctls), 1024), 0.05, np.float32)
            reset_launches()
            out = config5_pack_run(pack, ctls, pcm, 6, 10)
            torch.cuda.synchronize()
            runs.append((out, _mesh_launches(f"the {label}", 16)))
        err = float(np.abs(runs[0][0] - runs[1][0]).max())
        print(f"phase 35(d) {label} on a 1 x 2 mesh over [cuda:0, cpu]: vs the 1 x 1 card pack "
              f"max|diff| {err:.3e} (<= {MESH_TOL}); launches per block 1 x 1 {runs[0][1]}, "
              f"[card, CPU] {runs[1][1]} (the CPU shard runs the plain versions) {tag}")
        if not err <= MESH_TOL or np.abs(runs[0][0]).max() <= 1e-3 or runs[1][1] != runs[0][1]:
            raise AssertionError(f"{label} on [card, CPU]: max|diff| {err}, launches "
                                 f"{runs[1][1]} vs {runs[0][1]}")


def mesh_paths(pt, dev, kern, tag):
    """Phase 35: ScenePacks on (scene, voice) meshes larger than 1 x 1, each
    against the 1 x 1 pack of the same scripts (launches per block from the
    wrappers' counters; xRT per scene beside the 1 x 1 pack's).  (a) the
    dry-run twin on 8 logical devices of the card, 2 x 4, against
    per-scene Renderers; (b) BASELINE config 5 at full width, 256 scenes x
    256 voices, on a 2 x 2 logical mesh: every kernel 4x; (c) the host-pool
    pack 16 x 256 and the sampler pack 16 x 64 on 2 x 2 logical meshes: the
    submix singletons on voice shard 0 only, K5's scene form once per
    cell, fades and speed writes in the shards that hold their slots; (d)
    1 x 2 meshes over [card, CPU], and (a) and (b) over distinct cards
    where the machine has them."""
    from oddio_tpu_torch.parallel.mesh import make_mesh

    def logical(a, b):
        return make_mesh(a, b, [dev] * (a * b))

    runs = {"dryrun 2x4": _mesh_dryrun([dev] * 8, "over [cuda:0] * 8", tag)}

    one, mesh = _mesh_config5(dev, None), _mesh_config5(dev, logical(2, 2))
    print(f"phase 35(b) config 5: 256 scenes x 256 voices (65,536), 48 kHz, 512-frame blocks; "
          f"built 1 x 1 in {one[4]:.2f} s, 2 x 2 over [cuda:0] * 4 in {mesh[4]:.2f} s {tag}")
    _mesh_compare("(b) config 5 256 x 256, 2 x 2", one, mesh, tag, factor=4)
    (g1, k1, c1, _), (g2, k2, c2, every) = one[5], mesh[5]
    share = c2["replays"] / (c2["replays"] + c2["eager"])
    print(f"phase 35(b) block steps: 1 x 1 graph_capture {g1}, {k1} step keys, graph_counts "
          f"{c1}; 2 x 2 graph_capture {g2}, {k2} step keys (one set per cell), graph_counts "
          f"{c2}: replays {share:.3f} of the calls, every cell captured {every} {tag}")
    if (not g1 or not c1["replays"] or not g2 or not every or c2["recaptures"]
            or share < 0.9):
        raise AssertionError(f"phase 35(b): the 1 x 1 and the 2 x 2 pack must replay graphs, "
                             f"every cell of the 2 x 2 its own, replays >= 0.9 of the calls, "
                             f"no recapture: {one[5]}, {mesh[5]}")
    runs["config5 256x256 2x2"] = mesh[1]

    one, mesh = _mesh_host(dev, None), _mesh_host(dev, logical(2, 2))
    _mesh_compare("(c) host-pool pack 16 x 256, 2 x 2", one, mesh, tag)
    h, u = one[4]
    k5 = (one[1].get("strip_select_scenes", 0), mesh[1].get("strip_select_scenes", 0))
    if k5 != (h + u, 4 * h + 2 * u):
        raise AssertionError(f"host-pool pack: K5's scene form {k5} a block, "
                             f"{(h + u, 4 * h + 2 * u)} expected ({h} host pools once per cell, "
                             f"{u} submix pools once per scene group)")
    print(f"phase 35(c) host-pool pack: K5's scene form {k5[1]:g} a block on 2 x 2 = {h} host "
          f"pool x 4 cells + {u} submix pool x 2 scene groups (voice shard 0 only) {tag}")
    runs["hostpack 16x256 2x2"] = mesh[1]

    one, mesh = _mesh_sampler(dev, None), _mesh_sampler(dev, logical(2, 2))
    _mesh_compare("(c) sampler pack 16 x 64, 2 x 2", one, mesh, tag, factor=4)
    print(f"phase 35(c) sampler pack: {mesh[4]} fades and the speed writes of 16 scripts; each "
          f"scene's bank bits, gathered from its shards, equal its host mirrors and flipped {tag}")
    runs["sampler 16x64 2x2"] = mesh[1]

    _mesh_card_cpu(dev, tag)
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        cards = [torch.device("cuda", i) for i in range(n_cards)]
        _mesh_dryrun(cards[:min(8, 2 * (n_cards // 2))], f"over {n_cards} cards", tag)
        a = 2 if n_cards >= 4 else 1
        one, mesh = _mesh_config5(dev, None), _mesh_config5(dev, make_mesh(a, 2, cards[:2 * a]))
        _mesh_compare(f"(d) config 5 256 x 256, {a} x 2 over distinct cards", one, mesh, tag,
                      factor=2 * a)
    else:
        print(f"phase 35(d) distinct cards: not run (torch.cuda.device_count() = {n_cards}: the "
              f"meshes above repeat one card) {tag}")
    for key, name in MESH_KERNELS.items():
        if name in kern:
            kern[name]["mesh_launches"] = {run: per[key] for run, per in runs.items()
                                           if key in per}


def _cells_captured(pack):
    """The cells of ``pack`` that captured a CUDA graph of their own."""
    return {key[-1] for key, steps in pack._steps.items()
            if any(st.graph is not None for st in steps.values())}


#: the ones each of phase 42's packs runs
MESH_GRAPH_PATH = {"config5": ("ring_place", "ring_resample", "agc_gains"),
                   "hostpack": ("rows_append", "window_select_ears", "ring_place",
                                "strip_select", "strip_select_scenes", "ring_resample",
                                "agc_gains"),
                   "sampler": ("arena_step",),
                   "dryrun": ("rows_append", "window_select_ears")}
#: (label, 8-block render) of phase 42's graph packs, profiled at the end
#: of the run for the device's busy share
MESH_BUSY = []
#: phase 42's idle blocks timed per pack (the 2 x 4 dry run renders its
#: eight cells op by op at ~80 ms a block: fewer keep the phase short)
MESH_IDLE = {"config5": 188, "hostpack": 94, "sampler": 188, "dryrun": 47}


def _mesh_graph_pack(pt, kind, dev, mesh):
    """Phase 42's pack ``kind`` on ``mesh``, from seed 0, at its full
    width: (pack, script, control, ingest, block frames, rate).
    ``script()`` runs control blocks, ingest blocks and idle runs and
    returns the audio (S, N, C); ``control()`` writes one control block's
    events, ``ingest()`` new PCM on every stream (None: no streams)."""
    from oddio_tpu_torch.parallel import dryrun as D
    from oddio_tpu_torch.parallel.sharded import ScenePack
    from oddio_tpu_torch.utils.scene_profile import (build_config5_pack, build_host_pools_pack,
                                                     build_sampler_pack, feed)

    if kind == "config5":
        pack, ctls, rng = build_config5_pack(256, dev, mesh=mesh)
        hs, turn = [], [0]

        def control():  # a play in the next scene and the stop of the last one
            if hs:
                hs.pop().stop()
            hs.append(pt.MixerControl(pack.scenes[turn[0] % pack.S]).play(_adapt_sine(rng)))
            turn[0] += 1

        return (pack, lambda: _pack_script(pack, ctls, rng), control,
                lambda: feed(ctls, rng, 256), BLOCK, RATE)
    if kind == "hostpack":
        pack, ctls, speeds, rng = build_host_pools_pack(16, 256, dev, mesh=mesh, handles=(hs := []))
        turn = [0]

        def control():  # phase 41's: 64 set_speed, 64 discontinuous moves
            t = turn[0]
            for j in range(64):
                speeds[(64 * t + j) % len(speeds)].set_speed(float(rng.uniform(0.8, 1.25)))
                hs[(64 * t + j + 1) % len(hs)].set_motion(rng.uniform(-15, 15, 3),
                                                          rng.uniform(-0.2, 0.2, 3), True)
            turn[0] = t + 1

        def script():
            out = []
            for _ in range(4):
                control()
                feed(ctls, rng, 1024)
                out.append(drain(pack.render_frames_device(BLOCK * 16)))
            return np.concatenate(out, axis=1)

        return pack, script, control, lambda: feed(ctls, rng, 256), BLOCK, RATE
    if kind == "sampler":
        drv = build_sampler_pack(16, 64, dev, mesh=mesh)

        def control():
            for d in drv.drivers:
                d.control()

        def script():  # 12 periods of 8 blocks, each period's control first
            out = []
            for _ in range(12):
                control()
                out += drv.pack.render_frames_device(BLOCK * 8)
            return drain(out)

        return drv.pack, script, control, None, BLOCK, RATE
    # the dry-run twin: 2 x 4, 2 scenes of 64 buffered + 1984 seek Sine
    # voices at 8 kHz, its three blocks of 256 (plays and moves), then 48
    # idle blocks
    cap = 512 * 4
    built = [D._build_scene(64, cap - 64, mesh.first, cap) for _ in range(2)]
    pack = ScenePack([b[1] for b in built], D.RATE, mesh)
    rng = np.random.default_rng(42)
    hs = [pt.Spatial(pool, i, int(pool.slot_gen[i]))
          for b in built for pool in b[1]._seek_pools.values() for i in range(16)]

    def control():  # 16 discontinuous moves
        for h in hs[:16]:
            h.set_motion(rng.uniform(-30, 30, 3), rng.uniform(-5, 5, 3), True)
        hs.append(hs.pop(0))

    def script():
        got, _ = D._run([b[0] for b in built], lambda: pack.render_block(D.BLOCK))
        idle = pack.render_frames_device(D.BLOCK * 48, block_size=D.BLOCK)
        return np.concatenate([got, drain(idle)], axis=1)

    return pack, script, control, None, D.BLOCK, D.RATE


def _mesh_card_cpu_graphs(pt, dev, tag):
    """Phase 42's [card, CPU] run: the config-5 pack 4 x 64 on a 1 x 2 mesh
    over [card, CPU], graph against ``eager()`` through ingest blocks and
    idle runs: bit-equal, the card cell replaying graphs of its own, the
    CPU cell running the same steps uncaptured."""
    from oddio_tpu_torch.parallel.mesh import make_mesh
    from oddio_tpu_torch.utils.scene_profile import build_config5_pack

    runs = {}
    for mode in ("eager", "graph"):
        pack, ctls, _ = build_config5_pack(4, dev, voices=64, mesh=make_mesh(1, 2, [dev, "cpu"]))
        pcm = np.full((len(ctls), 1024), 0.05, np.float32)
        reset_launches()
        with _mode(mode):
            out = np.concatenate([config5_pack_run(pack, ctls, pcm, 6, 10),
                                  drain(pack.render_frames_device(BLOCK * 16))], axis=1)
        torch.cuda.synchronize()
        runs[mode] = (out, all_launches(), dict(pack.graph_counts), _cells_captured(pack))
    (xe, le, _, _), (xg, lg, cg, cells) = runs["eager"], runs["graph"]
    err = float(np.abs(xg - xe).max())
    print(f"phase 42 [cuda:0, cpu] 1 x 2, config-5 pack 4 x 64: graph vs eager max|diff| "
          f"{err:.3e}; launches {lg} (eager {le}); cells captured {sorted(cells)}; "
          f"graph_counts {cg} (the CPU cell's calls run uncaptured) {tag}")
    if err != 0.0 or lg != le or cells != {(0, 0)} or cg["recaptures"] or not cg["replays"]:
        raise AssertionError(f"phase 42 [card, CPU]: max|diff| {err}, launches {lg} vs {le}, "
                             f"cells captured {cells}, graph_counts {cg}")


def mesh_graphs(pt, dev, kern, tag):
    """Phase 42: the ScenePack's block steps on meshes of the card's
    logical devices (see the module docstring)."""
    from oddio_tpu_torch.parallel.mesh import make_mesh

    t_phase = time.perf_counter()
    totals = {"captures": 0, "recaptures": 0, "replays": 0, "eager": 0}
    for kind, (a, b) in (("config5", (2, 2)), ("hostpack", (2, 2)), ("sampler", (2, 2)),
                         ("dryrun", (2, 4))):
        t_kind = time.perf_counter()
        runs = {}
        for mode in ("eager", "graph"):
            t0 = time.perf_counter()
            pack, script, control, ingest, block, rate = _mesh_graph_pack(
                pt, kind, dev, make_mesh(a, b, [dev] * (a * b)))
            built = time.perf_counter() - t0
            if not pack.graph_capture:
                raise AssertionError(f"phase 42 {kind}: the pack does not declare graph_capture")
            reset_launches()
            with _mode(mode):
                x = script()
            torch.cuda.synchronize()
            launches = all_launches()
            nb = x.shape[1] // block
            if not np.isfinite(x).all() or np.abs(x).max() <= 1e-3:
                raise AssertionError(f"phase 42 {kind} {mode}: non-finite or silent output")
            with _mode(mode):
                # config 5's runs meet the most step keys: a longer warm run
                # keeps its replays >= 0.9 of its calls
                idle_ms, prep_ms, wall = _timed_idle(
                    pack, pack, MESH_IDLE[kind], warm=(8, 188) if kind == "config5" else (8,),
                    block=block)
                ctl_ms = _timed_first(pack, pack, control, 5, block)
                ing_ms = None if ingest is None else _timed_first(pack, pack, ingest, 5, block)
            runs[mode] = (x, launches, nb, idle_ms, prep_ms, wall, ctl_ms, ing_ms, built,
                          dict(pack.graph_counts), _cells_captured(pack))
            if mode == "graph":
                MESH_BUSY.append((f"{kind} {a} x {b}", (lambda p=pack, k=block: _frames(
                    p, 8 * k, k))))
            del pack, script, control, ingest
            torch.cuda.empty_cache()
        (xe, le, nb, ie, pe, we, ce, ge, be, _, _), \
            (xg, lg, _, ig, pg, wg, cg, gg, bg, total, cells) = runs["eager"], runs["graph"]
        err = float(np.abs(xg - xe).max())
        if err != 0.0 or xg.shape != xe.shape:
            raise AssertionError(f"phase 42 {kind}: graph replay differs from eager dispatch "
                                 f"by {err}")
        if lg != le:
            raise AssertionError(f"phase 42 {kind}: launches eager {le} graph {lg}")
        missing = [k for k in MESH_GRAPH_PATH[kind] if not lg.get(MESH_GRAPH_KERNELS[k])]
        if missing:
            raise AssertionError(f"phase 42 {kind}: {missing} never launched: {lg}")
        calls = total["replays"] + total["eager"]
        share = total["replays"] / calls
        if total["recaptures"] or share < 0.9 or cells != {(g, k) for g in range(a)
                                                           for k in range(b)}:
            raise AssertionError(f"phase 42 {kind}: graph_counts {total}, replays {share:.3f} "
                                 f"of the calls, cells captured {sorted(cells)}")
        for k, v in total.items():
            totals[k] += v
        # the same pack on a 1 x 1 mesh, replaying graphs, timed the same way
        one, _, _, _, _, _ = _mesh_graph_pack(pt, kind, dev, make_mesh(1, 1, [dev]))
        w1 = _timed_idle(one, one, MESH_IDLE[kind], warm=(8, 188) if kind == "config5" else (8,),
                         block=block)[2]
        del one
        torch.cuda.empty_cache()
        per = {k: round(v / nb, 3) for k, v in lg.items()}
        for name in MESH_GRAPH_PATH[kind]:
            kern[name].setdefault("mesh_graph_launches", {})[f"{kind} {a}x{b}"] = (
                lg[MESH_GRAPH_KERNELS[name]] / nb)
        S, idle = xe.shape[0], MESH_IDLE[kind]
        xrt = lambda w: idle * block / rate / w  # noqa: E731
        ingest = "" if ge is None else f", ingest: eager {ge:.4f} graph {gg:.4f}"
        print(f"phase 42 {kind} {S} scenes on {a} x {b} over [cuda:0] * {a * b}: built in "
              f"{be:.2f}/{bg:.2f} s, {nb} blocks of {block}, graph vs eager max|diff| "
              f"{err:.3e} (bit-equal); launches a block {per} (equal); every cell captured; "
              f"graph_counts with the timed runs {total}: replays {share:.3f} of {calls} "
              f"calls, recaptures 0; dispatch host ms a block, idle: eager {ie:.4f} graph "
              f"{ig:.4f}, control: eager {ce:.4f} graph {cg:.4f}{ingest}; host_prepare ms a "
              f"block eager {pe:.4f} graph {pg:.4f}; {idle} idle blocks xRT per scene eager "
              f"{xrt(we):.2f}x graph {xrt(wg):.2f}x, the 1 x 1 pack's graph {xrt(w1):.2f}x "
              f"({time.perf_counter() - t_kind:.1f} s) {tag}")
    _mesh_card_cpu_graphs(pt, dev, tag)
    calls = totals["replays"] + totals["eager"]
    print(f"phase 42: graph runs {totals}, replays {totals['replays'] / calls:.3f} of {calls} "
          f"calls ({time.perf_counter() - t_phase:.1f} s) {tag}")


def mesh_busy(tag):
    """Phase 42's profiles, at the end of the run (``graph_busy``)."""
    graph_busy(42, MESH_BUSY, tag)


def graph_busy(phase, items, tag):
    """A phase's busy profiles, at the end of the run: for each (label,
    render) of ``items``, a graph engine's 8 idle blocks' untraced wall ms a
    block (the median of three runs, each ended by a synchronize) and the
    device ms a block of the same 8 blocks under ``torch.profiler``: the
    device's busy share."""
    from oddio_tpu_torch.utils import kernel_bench as KB

    for label, render in items:
        render()
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            render()
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0) / 8)
        wall_ms = float(np.median(walls))
        split, kernels = KB.device_profile(render, reps=1)
        dev_ms = sum(split.values()) / 8
        print(f"phase {phase} profile: {label} graph, 8 idle blocks: device {dev_ms:.4f} ms a "
              f"block, {kernels / 8:.1f} device kernels a block, untraced wall {wall_ms:.4f} ms "
              f"a block: busy share {dev_ms / wall_ms:.3f} {tag}")
    items.clear()

def example_twins(tag):
    """Phase 34: the seven example twins on the card, each in its own
    temporary directory at its own constants: wall time, output peak and,
    for the real-time ones, underruns; a non-finite or silent output fails."""
    import contextlib
    import importlib
    import io
    import os
    import re
    import tempfile

    from oddio_tpu_torch.utils.wav import read_wav

    argv, cwd = sys.argv, os.getcwd()
    for name in EXAMPLES:
        mod = importlib.import_module(f"oddio_tpu_torch.examples.{name}")
        with tempfile.TemporaryDirectory() as td:
            os.chdir(td)
            sys.argv = [argv[0]]  # wav_playback reads argv[1]
            out = io.StringIO()
            try:
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(out):
                    ret = mod.main()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                if name in EXAMPLE_WAVS:
                    audio, _ = read_wav(EXAMPLE_WAVS[name])
                else:
                    audio = None
            finally:
                os.chdir(cwd)
                sys.argv = argv
        lines = out.getvalue().strip().splitlines()
        extra = ""
        if name == "realtime_spatial":
            drv, audio = ret
            extra = f", underruns {drv.underruns}, {drv.blocks} blocks"
        elif name == "simple":
            extra = f", underruns {ret.underruns}, {ret.blocks} blocks"
        if audio is not None:
            _audible(f"example {name}", audio)
            peak = float(np.abs(audio).max())
        else:  # game_mix and simple print their peak
            m = re.search(r"peak (\d+\.\d+)", out.getvalue())
            peak = float(m.group(1)) if m else float("nan")
            if not peak > 1e-3:
                raise AssertionError(f"example {name}: silent or no peak printed: {lines}")
        print(f"phase 34 example {name}: {wall:.2f} s wall, peak {peak:.4f}{extra}; "
              f"prints {lines} {tag}")


#: bench.py's dispatch-size buckets (BUCKETS)
BENCH_BUCKETS = (1504, 47, 46, 12, 3, 1)


def all_launches():
    """Every wrapper's nonzero launch count, by module and name."""
    from oddio_tpu_torch.ops import agc, flat_kernels, ring_kernels, stream_kernels

    return {f"{m.__name__.rsplit('.', 1)[1]}.{k}": v
            for m in (ring_kernels, stream_kernels, agc, flat_kernels)
            for k, v in m.LAUNCHES.items() if v}


def _graph_script(r, control, hs, kind):
    """Phase 36's control script: 24 blocks, four ticks of 64 set_motion
    deltas (at the scene's own spread and speeds; the subpass scene's
    clamped voices stay) and 47 blocks, a listener rotation and 47
    blocks.  Returns the blocks, (B, C, n) device tensors."""
    rng = np.random.default_rng(36)
    p, v = {"buffered": (15.0, 0.2), "subpass": (15.0, 0.05)}.get(kind, (30.0, 5.0))
    first = 64 if kind == "subpass" else 0
    out = list(r.render_frames_device(BLOCK * 24))
    for t in range(4):
        for h in hs[first + 64 * t:first + 64 * (t + 1)]:
            h.set_motion(rng.uniform(-p, p, 3), rng.uniform(-v, v, 3), False)
        out += r.render_frames_device(BLOCK * 47)
    control.set_listener_rotation([np.cos(0.2), 0.0, np.sin(0.2), 0.0])
    out += r.render_frames_device(BLOCK * 47)
    return out


@contextlib.contextmanager
def _prepare_time(engine):
    """Add the host seconds ``host_prepare`` takes, of ``engine`` or of
    every scene of a ScenePack, to the yielded one-item list."""
    engines = getattr(engine, "scenes", [engine])
    spent = [0.0]

    def timer(inner):
        def host_prepare(*a, **kw):
            t0 = time.perf_counter()
            try:
                return inner(*a, **kw)
            finally:
                spent[0] += time.perf_counter() - t0

        return host_prepare

    for e in engines:
        e.host_prepare = timer(e.host_prepare)
    try:
        yield spent
    finally:
        for e in engines:
            del e.host_prepare


def _frames(r, total, block=BLOCK):
    """``render_frames_device`` of a Renderer (no handle readback) or of a
    ScenePack (which starts none), in blocks of ``block`` frames."""
    if hasattr(r, "scenes"):
        return r.render_frames_device(total, block)
    return r.render_frames_device(total, block, sync=False)


def _timed_idle(r, scene, nblk=188, warm=(47,), block=BLOCK):
    """``nblk`` idle blocks of ``block`` frames after warm runs of ``warm``
    blocks: (dispatch host ms a block, host_prepare ms a block, wall s).
    The host time is the render call's, ended before any wait for the
    card, less host_prepare's."""
    for k in warm:
        _frames(r, block * k, block)
    torch.cuda.synchronize()
    with _prepare_time(scene) as spent:
        t0 = time.perf_counter()
        _frames(r, block * nblk, block)
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return 1e3 * (host - spent[0]) / nblk, 1e3 * spent[0] / nblk, wall


def main_path_graphs(pt, dev, tag):
    """Phase 36: the main path's four scenes, graph replay against eager
    dispatch (see the module docstring)."""
    from oddio_tpu_torch.utils.scene_profile import MAIN_PATH, build_main_path

    totals = {"captures": 0, "recaptures": 0, "replays": 0, "eager": 0}
    for kind in MAIN_PATH:
        runs = {}
        for mode in ("eager", "graph"):
            control, scene, hs = build_main_path(kind, VOICES, dev)
            r = pt.Renderer(scene, RATE, scan_buckets=BENCH_BUCKETS)
            rings = [p.dr_state()["ring"] for p in scene._buffered_pools.values()]
            ptrs = [x.data_ptr() for x in rings]
            reset_launches()
            with _mode(mode):
                out = _graph_script(r, control, hs, kind)
            torch.cuda.synchronize()
            launches = all_launches()
            x = torch.cat([o.permute(0, 2, 1).reshape(-1, 2) for o in out]).cpu().numpy()
            if not np.isfinite(x).all() or np.abs(x).max() <= 1e-3:
                raise AssertionError(f"phase 36 {kind} {mode}: non-finite or silent output")
            moved = [p.dr_state()["ring"].data_ptr() for p in scene._buffered_pools.values()]
            if moved != ptrs:
                raise AssertionError(f"phase 36 {kind} {mode}: a ring moved")
            counts = dict(r.graph_counts)
            with _mode(mode):
                host_ms, prep_ms, wall = _timed_idle(r, scene)
            nblk = x.shape[0] // BLOCK
            runs[mode] = (x, launches, counts, host_ms, prep_ms, wall, nblk)
            if mode == "graph":
                for k, v in r.graph_counts.items():
                    totals[k] += v
            label = f"{kind} {mode}"
            BLOCK_PROFILES.append((36, f"the {VOICES}-voice {label} renderer",
                                   (lambda r=r, m=mode: _render8(r, m)), 8))
        (xe, le, ce, he, pe, we, nb), (xg, lg, cg, hg, pg, wg, _) = runs["eager"], runs["graph"]
        err = float(np.abs(xg - xe).max())
        if err != 0.0:
            raise AssertionError(f"phase 36 {kind}: graph replay differs from eager dispatch "
                                 f"by {err}")
        if lg != le:
            raise AssertionError(f"phase 36 {kind}: launches eager {le} graph {lg}")
        if cg["recaptures"] or cg["replays"] == 0:
            raise AssertionError(f"phase 36 {kind}: graph_counts {cg}")
        per = {k: round(v / nb, 3) for k, v in lg.items()}
        xrt = lambda w: 188 * BLOCK / RATE / w  # noqa: E731
        print(f"phase 36 {kind}: {VOICES} voices, {nb} blocks, graph vs eager max|diff| {err:.3e} "
              f"(bit-equal); launches a block {per} (equal); graph_counts {cg} (eager run "
              f"{ce['eager']} op-by-op calls); dispatch host ms a block eager {he:.4f} graph "
              f"{hg:.4f}; host_prepare ms a block eager {pe:.4f} graph {pg:.4f}; 188 idle "
              f"blocks xRT eager {xrt(we):.2f}x graph {xrt(wg):.2f}x {tag}")
    calls = totals["replays"] + totals["eager"]
    share = totals["replays"] / calls
    print(f"phase 36: graph runs {totals}, replays {share:.3f} of {calls} calls {tag}")
    if share < 0.9 or totals["recaptures"]:
        raise AssertionError(f"phase 36: replays {share:.3f} of the calls, "
                             f"{totals['recaptures']} recaptures")


def _mixer_script(r, control, ctls, rng):
    """Phase 37's control script on the config-5 mixer: 24 blocks, then
    four ticks of new PCM on 64 streams, 8 Adapt(Sine) plays, 8 stops of
    earlier plays and 16 stream closes, each followed by 47 blocks.
    Returns the blocks, (B, C, n) device tensors."""
    from oddio_tpu_torch.utils.scene_profile import feed

    out = list(r.render_frames_device(BLOCK * 24))
    hs = []
    for t in range(4):
        feed(ctls[64 * t:64 * (t + 1)], rng, 1024)
        hs += [control.play(_adapt_sine(rng)) for _ in range(8)]
        for h in hs[8 * t - 8:8 * t] if t else ():
            h.stop()
        for c in ctls[256 + 16 * t:256 + 16 * (t + 1)]:
            c.close()
        out += r.render_frames_device(BLOCK * 47)
    return out


def _adapt_sine(rng):
    """A config-5 Adapt(Sine) voice drawn from ``rng``."""
    import oddio_tpu_torch as pt

    return pt.Adapt(pt.Sine(rng.uniform(0, 6), rng.uniform(50, 2000)), 0.1,
                    pt.AdaptOptions(tau=0.1, max_gain=4.0))


def _timed_ingest(r, mixer, ctls, rng, k=10):
    """``k`` ingest blocks, each after new PCM on every stream: the median
    dispatch host ms of one (the render call's host time, ended before
    any wait for the card, less host_prepare's)."""
    from oddio_tpu_torch.utils.scene_profile import feed

    ms = []
    with _prepare_time(mixer) as spent:
        for _ in range(k):
            feed(ctls, rng, 256)
            torch.cuda.synchronize()
            spent[0] = 0.0
            t0 = time.perf_counter()
            _frames(r, BLOCK)
            ms.append(1e3 * (time.perf_counter() - t0 - spent[0]))
            torch.cuda.synchronize()
    return float(np.median(ms))


def mixer_graphs(pt, dev, tag):
    """Phase 37: the 4096-voice config-5 mixer, graph replay against eager
    dispatch through one script (see the module docstring)."""
    from oddio_tpu_torch.utils.scene_profile import build_mixer_agc

    runs = {}
    for mode in ("eager", "graph"):
        control, mixer, ctls, rng = build_mixer_agc(VOICES, dev)
        r = pt.Renderer(mixer, RATE, scan_buckets=BENCH_BUCKETS)
        if not mixer.graph_capture:
            raise AssertionError("phase 37: the config-5 mixer does not declare graph_capture")
        rings = [p.dr_state()["inner"]["inner"]["ring"] for p in mixer._pools.values()
                 if "ring" in p.dr_state()["inner"]["inner"]]
        ptrs = [x.data_ptr() for x in rings]
        reset_launches()
        with _mode(mode):
            out = _mixer_script(r, control, ctls, rng)
            out += r.render_frames_device(BLOCK * 188)
        torch.cuda.synchronize()
        launches = all_launches()
        x = torch.cat([o.permute(0, 2, 1).reshape(-1, 1) for o in out]).cpu().numpy()
        if not np.isfinite(x).all() or np.abs(x).max() <= 1e-3:
            raise AssertionError(f"phase 37 mixer {mode}: non-finite or silent output")
        if [p.dr_state()["inner"]["inner"]["ring"].data_ptr() for p in mixer._pools.values()
                if "ring" in p.dr_state()["inner"]["inner"]] != ptrs:
            raise AssertionError(f"phase 37 mixer {mode}: a ring moved")
        counts = dict(r.graph_counts)
        with _mode(mode):
            host_ms, prep_ms, wall = _timed_idle(r, mixer)
            ingest_ms = _timed_ingest(r, mixer, ctls, rng)
        nblk = x.shape[0] // BLOCK
        runs[mode] = (x, launches, counts, host_ms, prep_ms, wall, ingest_ms, nblk,
                      dict(r.graph_counts))
        BLOCK_PROFILES.append((37, f"the {VOICES}-voice config-5 mixer {mode} renderer",
                               (lambda r=r, m=mode: _render8(r, m)), 8))
    (xe, le, ce, he, pe, we, ie, nb, _), (xg, lg, cg, hg, pg, wg, ig, _, total) = (
        runs["eager"], runs["graph"])
    err = float(np.abs(xg - xe).max())
    if err != 0.0:
        raise AssertionError(f"phase 37 mixer: graph replay differs from eager dispatch by {err}")
    if lg != le:
        raise AssertionError(f"phase 37 mixer: launches eager {le} graph {lg}")
    for k in ("stream_kernels.ring_place", "stream_kernels.ring_resample", "agc.agc_gains"):
        if not lg.get(k):
            raise AssertionError(f"phase 37 mixer: {k} never launched: {lg}")
    if any(k.startswith("ring_kernels.") for k in lg):
        raise AssertionError(f"phase 37 mixer: a ring kernel launched: {lg}")
    calls = total["replays"] + total["eager"]
    share = total["replays"] / calls
    if total["recaptures"] or share < 0.9:
        raise AssertionError(f"phase 37 mixer: graph_counts {total}, replays {share:.3f} of "
                             f"the calls")
    per = {k: round(v / nb, 3) for k, v in lg.items()}
    xrt = lambda w: 188 * BLOCK / RATE / w  # noqa: E731
    print(f"phase 37 mixer: {VOICES} voices (512 Adapt(Stream), 3584 Adapt(Sine)), {nb} blocks "
          f"(feeds, plays, stops, closes, 188 idle), graph vs eager max|diff| {err:.3e} "
          f"(bit-equal); launches a block {per} (equal); graph_counts over the script {cg}, "
          f"with the timed runs {total}: replays {share:.3f} of {calls} calls (eager run "
          f"{ce['eager']} op-by-op calls); dispatch host ms a block, idle: eager {he:.4f} graph "
          f"{hg:.4f}, ingest: eager {ie:.4f} graph {ig:.4f}; host_prepare ms a block eager "
          f"{pe:.4f} graph {pg:.4f}; 188 idle blocks xRT eager {xrt(we):.2f}x graph "
          f"{xrt(wg):.2f}x {tag}")


def _pack_script(pack, ctls, rng):
    """Phase 38's control script on a pack: 4 blocks through render_block
    and 24 through render_frames_device; on a config-5 pack then a
    1024-sample feed to every stream and an Adapt(Sine) play in every
    scene, 47 blocks, a stop of each play and one stream close in every
    scene, 47 blocks; on the spatial pack a move near a buffered voice
    and a listener rotation in scene 0, 47 blocks; then 188 idle blocks.
    Returns the audio, numpy (S, N, C)."""
    import oddio_tpu_torch as pt
    from oddio_tpu_torch.utils.scene_profile import feed

    out = [pack.render_block(BLOCK) for _ in range(4)]
    out.append(drain(pack.render_frames_device(BLOCK * 24)))
    if ctls is not None:
        feed(ctls, rng, 1024)
        hs = [pt.MixerControl(s).play(_adapt_sine(rng)) for s in pack.scenes]
        out.append(drain(pack.render_frames_device(BLOCK * 47)))
        for h in hs:
            h.stop()
        per = len(ctls) // pack.S
        for s in range(pack.S):
            ctls[per * s + s % per].close()
    else:
        scene = pack.scenes[0]
        pool = next(iter(scene._buffered_pools.values()))
        pt.Spatial(pool, 3, int(pool.slot_gen[3])).set_motion([6.0, -2.0, 4.0],
                                                              [1.0, 0.0, -1.0], False)
        pt.SpatialSceneControl(scene).set_listener_rotation([np.cos(0.2), 0.0, np.sin(0.2), 0.0])
    out.append(drain(pack.render_frames_device(BLOCK * 47)))
    out.append(drain(pack.render_frames_device(BLOCK * 188)))
    return np.concatenate(out, axis=1)


def _pack_rings(pack):
    """Addresses of the stack's rings (the leaves the steps write in place)."""
    out = []

    def walk(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v)
            elif k == "ring":
                out.append(v.data_ptr())

    walk(pack._dstate[0, 0])
    return out


#: phase 38's kernels of each pack kind, by ``all_launches`` key
PACK_KERNELS = {
    "config5": ("stream_kernels.ring_place", "stream_kernels.ring_resample", "agc.agc_gains"),
    "spatial": ("ring_kernels.append", "ring_kernels.select_ears"),
}


def pack_graphs(pt, dev, tag):
    """Phase 38: the config-5 pack at 16 and 64 scenes of 256 voices and the
    16-scene spatial pack, each built twice from one seed and run through
    ``_pack_script``, once under ``eager()`` and once replaying the pack's
    graphs: bit-equal, every kernel's launches equal (K4/K6/K7, or K1/K2;
    no other ring kernel), the rings where they were, no recapture and
    replays >= 90% of the phase's calls; then 188 idle blocks each way
    (dispatch host ms a block, host_prepare ms a block, xRT per scene) and
    on the config-5 packs 10 ingest blocks (the median dispatch host ms of
    one); both ways' block profiles at the end of the run."""
    from oddio_tpu_torch.utils.scene_profile import build_config5_pack, build_spatial_pack

    totals = {"captures": 0, "recaptures": 0, "replays": 0, "eager": 0}
    packs = (("config-5 pack S=16", "config5", lambda: build_config5_pack(16, dev)),
             ("config-5 pack S=64", "config5", lambda: build_config5_pack(64, dev)),
             ("spatial pack S=16", "spatial", lambda: (build_spatial_pack(16, dev), None, None)))
    for label, kind, build in packs:
        runs = {}
        for mode in ("eager", "graph"):
            t0 = time.perf_counter()
            pack, ctls, rng = build()
            built = time.perf_counter() - t0
            if not pack.graph_capture:
                raise AssertionError(f"phase 38 {label}: the pack does not declare graph_capture")
            reset_launches()
            with _mode(mode):
                first = pack.render_block(BLOCK)
                ptrs = _pack_rings(pack)
                x = np.concatenate([first, _pack_script(pack, ctls, rng)], axis=1)
            torch.cuda.synchronize()
            launches = all_launches()
            read_flat_launches(f"phase 38 {label} {mode}")
            if not np.isfinite(x).all() or np.abs(x).max(axis=(1, 2)).min() <= 1e-3:
                raise AssertionError(f"phase 38 {label} {mode}: non-finite output or a silent "
                                     f"scene")
            if _pack_rings(pack) != ptrs:
                raise AssertionError(f"phase 38 {label} {mode}: a ring moved")
            counts = dict(pack.graph_counts)
            with _mode(mode):
                warm = [k for k in (8, 188 % pack.scan_unroll) if k]
                idle_ms, prep_ms, wall = _timed_idle(pack, pack, warm=warm)
                ingest_ms = None if ctls is None else _timed_ingest(pack, pack, ctls, rng)
            nblk = x.shape[1] // BLOCK
            runs[mode] = (x, launches, counts, idle_ms, prep_ms, wall, ingest_ms, nblk, built)
            if mode == "graph":
                for k, v in pack.graph_counts.items():
                    totals[k] += v
            BLOCK_PROFILES.append((38, f"the {label} {mode}",
                                   (lambda p=pack, m=mode: _render8(p, m)), 8))
        (xe, le, ce, he, pe, we, ie, nb, be), (xg, lg, cg, hg, pg, wg, ig, _, bg) = (
            runs["eager"], runs["graph"])
        err = float(np.abs(xg - xe).max())
        if err != 0.0:
            raise AssertionError(f"phase 38 {label}: graph replay differs from eager dispatch "
                                 f"by {err}")
        if lg != le:
            raise AssertionError(f"phase 38 {label}: launches eager {le} graph {lg}")
        want = PACK_KERNELS[kind]
        if not all(lg.get(k) for k in want):
            raise AssertionError(f"phase 38 {label}: a kernel of the path never launched: {lg}")
        ring = {k for k in lg if k.startswith("ring_kernels.")} - {
            "ring_kernels.append", "ring_kernels.append_cursor", "ring_kernels.select_ears"}
        if ring or (kind == "config5" and any(k.startswith("ring_kernels.") for k in lg)):
            raise AssertionError(f"phase 38 {label}: another ring kernel launched: {lg}")
        if cg["recaptures"] or cg["replays"] == 0:
            raise AssertionError(f"phase 38 {label}: graph_counts {cg}")
        per = {k: round(v / nb, 3) for k, v in lg.items()}
        xrt = lambda w: 188 * BLOCK / RATE / w  # noqa: E731
        ingest = "" if ie is None else f", ingest: eager {ie:.4f} graph {ig:.4f}"
        print(f"phase 38 {label}: built in {be:.2f}/{bg:.2f} s, {nb} blocks, graph vs eager "
              f"max|diff| {err:.3e} (bit-equal); launches a block {per} (equal); rings "
              f"unmoved; graph_counts over the script {cg} (eager run {ce['eager']} op-by-op "
              f"calls); dispatch host ms a block, idle: eager {he:.4f} graph {hg:.4f}{ingest}; "
              f"host_prepare ms a block eager {pe:.4f} graph {pg:.4f}; 188 idle blocks xRT per "
              f"scene eager {xrt(we):.2f}x graph {xrt(wg):.2f}x {tag}")
    calls = totals["replays"] + totals["eager"]
    share = totals["replays"] / calls
    print(f"phase 38: graph runs {totals}, replays {share:.3f} of {calls} calls {tag}")
    if share < 0.9 or totals["recaptures"]:
        raise AssertionError(f"phase 38: replays {share:.3f} of the calls, "
                             f"{totals['recaptures']} recaptures")


#: phase 39's scenes open their pools with room for the script's plays,
#: so that no pool grows (a growth recaptures every step; the card tests
#: hold that case)
DENSE_CAPACITY = 2048


def _dense_script(r, mixer, ctls, rng, kind, frames):
    """Phase 39's control script: 24 blocks; four ticks, each of a write
    on 64 voices (set_gain on the dense mix; set_speed on the wavetable,
    the third tick's into the step tier 4, past tier 2) and 8 plays, and
    each followed by 47 blocks; on the wavetable 8 voices of a new
    2048-sample table (the sample arena is rebuilt); 188 blocks.  Returns
    (the blocks, (B, C, n) device tensors; the recaptures before the new
    table)."""
    from oddio_tpu_torch.utils.scene_profile import (densemix_voice, wavetable_frames,
                                                     wavetable_voice)

    out = list(_frames(r, BLOCK * 24))
    for t in range(4):
        for c in ctls[64 * t:64 * (t + 1)]:
            if kind == "densemix":
                c.set_gain(float(rng.uniform(-20, 0)))
            else:
                c.set_speed(float(rng.uniform(2.2, 3.8) if t == 2 else rng.uniform(0.8, 1.25)))
        for _ in range(8):
            mixer.play((densemix_voice(rng) if kind == "densemix"
                        else wavetable_voice(frames, rng))[1])
        out += _frames(r, BLOCK * 47)
    before = r.graph_counts["recaptures"]
    if kind == "wavetable":
        table = wavetable_frames()
        for _ in range(8):
            mixer.play(wavetable_voice(table, rng)[1])
    out += _frames(r, BLOCK * 188)
    return out, before


def dense_graphs(pt, dev, tag):
    """Phase 39: BASELINE config 4's dense mix and bench.py's wavetable at
    1024 voices, graph replay against eager dispatch through one script
    (see the module docstring)."""
    from oddio_tpu_torch.utils.scene_profile import (build_densemix, build_wavetable,
                                                     wavetable_frames)

    totals = {"captures": 0, "recaptures": 0, "replays": 0, "eager": 0}
    for kind in ("densemix", "wavetable"):
        runs = {}
        for mode in ("eager", "graph"):
            frames = None
            if kind == "densemix":
                root, mixer, ctls, rng = build_densemix(1024, dev, capacity=DENSE_CAPACITY)
                r = pt.Renderer(root, RATE, scan_unroll=4, scan_buckets=BENCH_BUCKETS)
            else:
                frames = wavetable_frames()
                mixer, ctls, rng = build_wavetable(1024, dev, capacity=DENSE_CAPACITY,
                                                   frames=frames)
                root = mixer
                r = pt.Renderer(root, RATE, scan_buckets=BENCH_BUCKETS)
            if not root.graph_capture:
                raise AssertionError(f"phase 39 {kind}: the root does not declare graph_capture")
            reset_launches()
            with _mode(mode):
                out, before = _dense_script(r, mixer, ctls, rng, kind, frames)
            torch.cuda.synchronize()
            launches = all_launches()
            x = torch.cat([o.permute(0, 2, 1).reshape(-1, 1) for o in out]).cpu().numpy()
            if not np.isfinite(x).all() or np.abs(x).max() <= 1e-3:
                raise AssertionError(f"phase 39 {kind} {mode}: non-finite or silent output")
            counts = dict(r.graph_counts)
            with _mode(mode):
                host_ms, prep_ms, wall = _timed_idle(r, root)
            nblk = x.shape[0] // BLOCK
            runs[mode] = (x, launches, counts, before, host_ms, prep_ms, wall, nblk,
                          dict(r.graph_counts))
            BLOCK_PROFILES.append((39, f"the 1024-voice {kind} {mode} renderer",
                                   (lambda r=r, m=mode: _render8(r, m)), 8))
        (xe, le, ce, _, he, pe, we, nb, _), (xg, lg, cg, bg, hg, pg, wg, _, total) = (
            runs["eager"], runs["graph"])
        err = float(np.abs(xg - xe).max())
        if err != 0.0:
            raise AssertionError(f"phase 39 {kind}: graph replay differs from eager dispatch "
                                 f"by {err}")
        if lg != le:
            raise AssertionError(f"phase 39 {kind}: launches eager {le} graph {lg}")
        want = {"stream_kernels.arena_step": nb} if kind == "wavetable" else {}
        if lg != want:
            raise AssertionError(f"phase 39 {kind}: launches {lg} in {nb} blocks, want {want}")
        after = cg["recaptures"] - bg
        if bg or total["recaptures"] != cg["recaptures"] or (kind == "wavetable") != (after > 0):
            raise AssertionError(f"phase 39 {kind}: {bg} recaptures before the new table, "
                                 f"{after} after it, {total['recaptures']} with the timed runs")
        calls = total["replays"] + total["eager"]
        share = total["replays"] / calls
        if share < 0.9:
            raise AssertionError(f"phase 39 {kind}: graph_counts {total}, replays {share:.3f} "
                                 f"of the calls")
        for k, v in total.items():
            totals[k] += v
        per = {k: round(v / nb, 3) for k, v in lg.items()}
        xrt = lambda w: 188 * BLOCK / RATE / w  # noqa: E731
        print(f"phase 39 {kind}: 1024 voices, {nb} blocks (24, four ticks of 64 writes and 8 "
              f"plays, {'a new table, ' if kind == 'wavetable' else ''}188), graph vs eager "
              f"max|diff| {err:.3e} (bit-equal); launches a block {per} (equal); graph_counts "
              f"over the script {cg}, with the timed runs {total}: replays {share:.3f} of "
              f"{calls} calls, recaptures {after} after the new table (eager run "
              f"{ce['eager']} op-by-op calls); dispatch host ms a block, idle: eager {he:.4f} "
              f"graph {hg:.4f}; host_prepare ms a block eager {pe:.4f} graph {pg:.4f}; 188 "
              f"idle blocks xRT eager {xrt(we):.2f}x graph {xrt(wg):.2f}x {tag}")
    calls = totals["replays"] + totals["eager"]
    print(f"phase 39: graph runs {totals}, replays {totals['replays'] / calls:.3f} of {calls} "
          f"calls {tag}")


def _sampler_scene(kind, dev):
    """Phase 40's scene ``kind`` at its full width, from seed 0: (the
    Renderer or the pack, the engine whose prepare is timed, its control
    for one period, its renderer of ``nb`` blocks to device tensors)."""
    import oddio_tpu_torch as pt
    from oddio_tpu_torch.utils.scene_profile import (build_sampler, build_sampler_pack,
                                                     build_seek_sampler)

    if kind == "sampler_pack":
        drv = build_sampler_pack(16, 64, dev)
        pack = drv.pack

        def control():
            for d in drv.drivers:
                d.control()

        return pack, pack, control, lambda nb: pack.render_frames_device(BLOCK * nb)
    if kind == "sampler":
        drv = build_sampler(1024, dev)
        engine, control = drv.mixer, drv.control
    else:
        _, engine, hs, rng = build_seek_sampler(1024, dev)
        turn = [0]

        def control():
            for h in hs[64 * turn[0]:64 * (turn[0] + 1)]:
                h.set_motion(rng.uniform(-15, 15, 3), rng.uniform(-5, 5, 3), False)
            turn[0] = (turn[0] + 1) % 16

    r = pt.Renderer(engine, RATE, scan_buckets=BENCH_BUCKETS)
    return r, engine, control, lambda nb: r.render_frames_device(BLOCK * nb, sync=False)


def _timed_periods(r, engine, control, render, periods=6):
    """``periods`` control periods of 8 blocks: (dispatch host ms a block,
    host_prepare ms a block, the control's ms a period, wall s).  The host
    time is the render calls', ended before any wait for the card, less
    host_prepare's."""
    torch.cuda.synchronize()
    ctl = host = 0.0
    with _prepare_time(engine) as spent:
        t0 = time.perf_counter()
        for _ in range(periods):
            t1 = time.perf_counter()
            control()
            t2 = time.perf_counter()
            render(8)
            ctl += t2 - t1
            host += time.perf_counter() - t2
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    nb = 8 * periods
    return 1e3 * (host - spent[0]) / nb, 1e3 * spent[0] / nb, 1e3 * ctl / periods, wall


def sampler_graphs(pt, dev, kern, tag):
    """Phase 40: the samplers' block steps as CUDA graphs against eager
    dispatch (see the module docstring)."""
    totals = {"captures": 0, "recaptures": 0, "replays": 0, "eager": 0}
    per_block = {}
    for kind in ("sampler", "seek_sampler", "sampler_pack"):
        runs = {}
        for mode in ("eager", "graph"):
            t0 = time.perf_counter()
            r, engine, control, render = _sampler_scene(kind, dev)
            built = time.perf_counter() - t0
            if not engine.graph_capture:
                raise AssertionError(f"phase 40 {kind}: the engine does not declare "
                                     f"graph_capture")
            reset_launches()
            out = []
            with _mode(mode):
                for _ in range(12):
                    control()
                    out += render(8)
            torch.cuda.synchronize()
            launches = all_launches()
            x = torch.cat([o.reshape(-1) for o in out]).cpu().numpy()
            if not np.isfinite(x).all() or np.abs(x).max() <= 1e-3:
                raise AssertionError(f"phase 40 {kind} {mode}: non-finite or silent output")
            counts = dict(r.graph_counts)
            with _mode(mode):
                host_ms, prep_ms, wall = _timed_idle(r, engine)
                ph, pp, pc, pw = _timed_periods(r, engine, control, render)
            runs[mode] = (x, launches, counts, host_ms, prep_ms, wall, ph, pp, pc, pw, built,
                          dict(r.graph_counts))
            BLOCK_PROFILES.append((40, f"the {kind} {mode} (a control period of 8 blocks)",
                                   (lambda c=control, rd=render, m=mode:
                                    _control_period(c, rd, m)), 8))
        (xe, le, ce, he, pe, we, phe, ppe, pce, pwe, be, _), \
            (xg, lg, cg, hg, pg, wg, phg, ppg, pcg, pwg, bg, total) = runs["eager"], runs["graph"]
        nb = 96
        err = float(np.abs(xg - xe).max())
        if err != 0.0 or xg.shape != xe.shape:
            raise AssertionError(f"phase 40 {kind}: graph replay differs from eager dispatch "
                                 f"by {err}")
        if lg != le:
            raise AssertionError(f"phase 40 {kind}: launches eager {le} graph {lg}")
        want = {"stream_kernels.arena_step": nb}
        if lg != want:
            raise AssertionError(f"phase 40 {kind}: launches {lg} in {nb} blocks, want {want}")
        calls = total["replays"] + total["eager"]
        share = total["replays"] / calls
        if total["recaptures"] or share < 0.9:
            raise AssertionError(f"phase 40 {kind}: graph_counts {total}, replays {share:.3f} "
                                 f"of the calls")
        for k, v in total.items():
            totals[k] += v
        per_block[kind] = lg["stream_kernels.arena_step"] / nb
        xrt = lambda n, w: n * BLOCK / RATE / w  # noqa: E731
        scenes = " per scene" if kind == "sampler_pack" else ""
        print(f"phase 40 {kind}: built in {be:.2f}/{bg:.2f} s, {nb} blocks (12 control periods "
              f"of 8), graph vs eager max|diff| {err:.3e} (bit-equal); launches a block "
              f"{ {k: v / nb for k, v in lg.items()} } (equal); graph_counts over the script "
              f"{cg}, with the timed runs {total}: replays {share:.3f} of {calls} calls, "
              f"recaptures 0 (eager run {ce['eager']} op-by-op calls); 188 idle blocks: "
              f"dispatch host ms a block eager {he:.4f} graph {hg:.4f}, host_prepare ms a "
              f"block eager {pe:.4f} graph {pg:.4f}, xRT{scenes} eager {xrt(188, we):.2f}x "
              f"graph {xrt(188, wg):.2f}x; 6 control periods: dispatch host ms a block eager "
              f"{phe:.4f} graph {phg:.4f}, host_prepare ms a block eager {ppe:.4f} graph "
              f"{ppg:.4f}, control ms a period eager {pce:.3f} graph {pcg:.3f}, xRT{scenes} "
              f"eager {xrt(48, pwe):.2f}x graph {xrt(48, pwg):.2f}x {tag}")
    kern["arena_step"]["graph_launches"] = per_block
    calls = totals["replays"] + totals["eager"]
    print(f"phase 40: graph runs {totals}, replays {totals['replays'] / calls:.3f} of {calls} "
          f"calls; arena_step launches a block under graphs {per_block} {tag}")


#: phase 41's kernels (K1, K2, K4, K5, K6, K7): kernels-line name ->
#: ``all_launches`` key
HOST_GRAPH_KERNELS = {"rows_append": "ring_kernels.append",
                      "window_select_ears": "ring_kernels.select_ears",
                      "ring_place": "stream_kernels.ring_place",
                      "strip_select": "ring_kernels.strip_select",
                      "ring_resample": "stream_kernels.ring_resample",
                      "agc_gains": "agc.agc_gains",
                      "strip_select_scenes": "ring_kernels.strip_select_scenes"}
#: the ones each of phase 41's engines runs (K5's scene form in the pack;
#: the Mixer has no delay ring)
HOST_GRAPH_PATH = {"hostpools": tuple(HOST_GRAPH_KERNELS)[:-1],
                   "hostpack": tuple(HOST_GRAPH_KERNELS),
                   "mixerhost": ("ring_place", "ring_resample", "agc_gains")}

#: phase 42's kernels: phase 41's and K6's arena form
MESH_GRAPH_KERNELS = {**HOST_GRAPH_KERNELS, "arena_step": "stream_kernels.arena_step"}


def _host_graph_scene(pt, kind, dev):
    """Phase 41's engine ``kind`` at full width, from seed 0: the
    4096-voice host-pool scene, the host-pool pack 16 x 256 or a Mixer of
    4096 Speed(Stream) voices (its host ``Pool``) with a 256-voice config-5
    submix.  Returns (renderer or pack, engine, control, feed, fly-by
    handles): ``control()`` writes ``set_speed`` on the next 64 Speed
    voices and moves the next 64 voices (discontinuous jumps within 15 m),
    ``feed()`` writes 1024 samples of PCM to every stream."""
    from oddio_tpu_torch.utils.scene_profile import (build_host_pools, build_host_pools_pack,
                                                     build_mixer_host_pools, feed)

    hs = []
    if kind == "hostpools":
        _, engine, ctls, speeds, rng = build_host_pools(VOICES, dev, handles=hs)
        r = pt.Renderer(engine, RATE, scan_buckets=BENCH_BUCKETS)
        fly = [hs[0]]
    elif kind == "hostpack":
        r, ctls, speeds, rng = build_host_pools_pack(16, 256, dev, handles=hs)
        engine = r
        fly = [hs[0]]  # scene 0 alone leaves K5's gate: the pack's exact route
    else:
        _, engine, ctls, speeds, rng = build_mixer_host_pools(VOICES, dev)
        r = pt.Renderer(engine, RATE, scan_buckets=BENCH_BUCKETS)
        fly = []
    turn = [0]

    def control():
        t = turn[0]
        for j in range(64):
            speeds[(64 * t + j) % len(speeds)].set_speed(float(rng.uniform(0.8, 1.25)))
        for j in range(64 if hs else 0):
            hs[(64 * t + j + 1) % len(hs)].set_motion(rng.uniform(-15, 15, 3),
                                                      rng.uniform(-0.2, 0.2, 3), True)
        turn[0] = t + 1

    return r, engine, control, (lambda: feed(ctls, rng, 1024)), fly


def _timed_first(r, engine, before, k=10, block=BLOCK):
    """``k`` one-block calls, each after ``before()``: the median dispatch
    host ms of one (the render call's host time, ended before any wait for
    the card, less host_prepare's)."""
    ms = []
    with _prepare_time(engine) as spent:
        for _ in range(k):
            before()
            torch.cuda.synchronize()
            spent[0] = 0.0
            t0 = time.perf_counter()
            _frames(r, block, block)
            ms.append(1e3 * (time.perf_counter() - t0 - spent[0]))
            torch.cuda.synchronize()
    return float(np.median(ms))


def host_pool_graphs(pt, dev, kern, tag):
    """Phase 41: the host-pool scene, the host-pool pack and the Mixer's
    host pools, graph replay against eager dispatch (see the module
    docstring)."""
    totals = {"captures": 0, "recaptures": 0, "replays": 0, "eager": 0}
    for kind in ("hostpools", "hostpack", "mixerhost"):
        runs = {}
        for mode in ("eager", "graph"):
            t0 = time.perf_counter()
            r, engine, control, feed, fly = _host_graph_scene(pt, kind, dev)
            built = time.perf_counter() - t0
            if not engine.graph_capture:
                raise AssertionError(f"phase 41 {kind}: the engine does not declare "
                                     f"graph_capture")
            reset_launches()
            out = []
            with _mode(mode):
                for h in fly:  # a fly-by: K5's strip gate off, on, off inside single calls
                    h.set_motion([-30.0, 5.0, 0.0], [60.0, 0.0, 0.0], True)
                for _ in range(6):
                    control()
                    feed()
                    out += _frames(r, BLOCK * 16)
            torch.cuda.synchronize()
            launches = all_launches()
            x = torch.cat([o.reshape(-1) for o in out]).cpu().numpy()
            if not np.isfinite(x).all() or np.abs(x).max() <= 1e-3:
                raise AssertionError(f"phase 41 {kind} {mode}: non-finite or silent output")
            counts = dict(r.graph_counts)
            with _mode(mode):
                for h in fly:  # the fly-by stops 11 m out: K5's strip route again
                    h.set_motion([10.0, 5.0, 0.0], [0.0, 0.0, 0.0], True)
                host_ms, prep_ms, wall = _timed_idle(r, engine)
                ctl_ms = _timed_first(r, engine, control)
                ing_ms = _timed_first(r, engine, feed)
            runs[mode] = (x, launches, counts, host_ms, prep_ms, wall, ctl_ms, ing_ms, built,
                          dict(r.graph_counts))
            BLOCK_PROFILES.append((41, f"the {kind} {mode} (8 blocks)",
                                   (lambda r=r, m=mode: _render8(r, m)), 8))
        (xe, le, ce, he, pe, we, cte, ie, be, _), \
            (xg, lg, cg, hg, pg, wg, ctg, ig, bg, total) = runs["eager"], runs["graph"]
        nb = 96
        err = float(np.abs(xg - xe).max())
        if err != 0.0 or xg.shape != xe.shape:
            raise AssertionError(f"phase 41 {kind}: graph replay differs from eager dispatch "
                                 f"by {err}")
        if lg != le:
            raise AssertionError(f"phase 41 {kind}: launches eager {le} graph {lg}")
        missing = [k for k in HOST_GRAPH_PATH[kind] if not lg.get(HOST_GRAPH_KERNELS[k])]
        if missing:
            raise AssertionError(f"phase 41 {kind}: {missing} never launched: {lg}")
        calls = total["replays"] + total["eager"]
        share = total["replays"] / calls
        if total["recaptures"] or share < 0.9:
            raise AssertionError(f"phase 41 {kind}: graph_counts {total}, replays {share:.3f} "
                                 f"of the calls")
        for k, v in total.items():
            totals[k] += v
        for name in HOST_GRAPH_PATH[kind]:
            kern[name].setdefault("graph_launches", {})[kind] = (
                lg[HOST_GRAPH_KERNELS[name]] / nb)
        xrt = lambda w: 188 * BLOCK / RATE / w  # noqa: E731
        scenes = " per scene" if kind == "hostpack" else ""
        print(f"phase 41 {kind}: built in {be:.2f}/{bg:.2f} s, {nb} blocks (6 periods of 16: "
              f"64 set_speed, 64 set_motion and PCM on every stream before each; "
              f"{len(fly)} fly-by), graph vs eager max|diff| {err:.3e} (bit-equal); launches a "
              f"block { {k: round(v / nb, 3) for k, v in lg.items()} } (equal); graph_counts "
              f"over the script {cg}, with the timed runs {total}: replays {share:.3f} of "
              f"{calls} calls, recaptures 0 (eager run {ce['eager']} op-by-op calls); dispatch "
              f"host ms a block, idle: eager {he:.4f} graph {hg:.4f}, control: eager {cte:.4f} "
              f"graph {ctg:.4f}, ingest: eager {ie:.4f} graph {ig:.4f}; host_prepare ms a block "
              f"eager {pe:.4f} graph {pg:.4f}; 188 idle blocks xRT{scenes} eager "
              f"{xrt(we):.2f}x graph {xrt(wg):.2f}x {tag}")
    calls = totals["replays"] + totals["eager"]
    print(f"phase 41: graph runs {totals}, replays {totals['replays'] / calls:.3f} of {calls} "
          f"calls {tag}")


#: phase 43's kernels (K1, K2, K3, K6's arena form): kernels-line name ->
#: ``all_launches`` key
ARENA_GRAPH_KERNELS = {"rows_append": "ring_kernels.append",
                       "window_select_ears": "ring_kernels.select_ears",
                       "window_select_multi": "ring_kernels.select_multi",
                       "arena_step": "stream_kernels.arena_step"}
#: each of phase 43's engines: the kernels it runs and the arena step's
#: forms it launches (0 a leaf's step, ``arena_step``; 1 a seek read,
#: ``arena_warp``; 2 a Fader, ``fader_step``).  Packs fuse no idle groups
ARENA_GRAPH_PATH = {"spatial_sampler": (tuple(ARENA_GRAPH_KERNELS), {0, 2}),
                    "seek_chains": (("arena_step",), {1}),
                    "spatial_pack": (("rows_append", "window_select_ears", "arena_step"),
                                     {0, 2})}
#: (label, 8-block render) of phase 43's graph engines, profiled at the end
ARENA_BUSY = []


def _arena_graph_scene(pt, kind, dev):
    """Phase 43's engine ``kind`` from seed 0: the 4096-voice spatial
    sampler or seek chains (``scene_profile.build_spatial_sampler``,
    ``build_seek_chains``), or a 1 x 1 ScenePack of 16 spatial samplers of
    256 voices (scene s from seed s).  Returns (Renderer or pack, the
    engine whose prepare is timed, the control scripts (``SpatialDriver``),
    a renderer of ``nb`` blocks to device tensors)."""
    from oddio_tpu_torch.parallel.mesh import make_mesh
    from oddio_tpu_torch.parallel.sharded import ScenePack
    from oddio_tpu_torch.utils.scene_profile import build_seek_chains, build_spatial_sampler

    if kind == "spatial_pack":
        drvs = [build_spatial_sampler(256, dev, seed=s, capacity=32, k=16) for s in range(16)]
        pack = ScenePack([d.scene for d in drvs], RATE, make_mesh(1, 1, [dev]))
        return pack, pack, drvs, lambda nb: pack.render_frames_device(BLOCK * nb)
    build = build_spatial_sampler if kind == "spatial_sampler" else build_seek_chains
    drv = build(VOICES, dev)
    r = pt.Renderer(drv.scene, RATE, scan_buckets=BENCH_BUCKETS)
    return r, drv.scene, [drv], lambda nb: r.render_frames_device(BLOCK * nb, sync=False)


def _new_frames(pt):
    """A new sound and a FramesSignal over it: the global sample arena's
    device tensors (plain and guarded) are replaced."""
    pt.FramesSignal(pt.Frames.from_slice(44100, np.linspace(-0.1, 0.1, 4000,
                                                            dtype=np.float32)))


def _captured(r):
    """The steps of ``r`` that hold a CUDA graph."""
    return sum(st.graph is not None for steps in r._steps.values() for st in steps.values())


def _arena_script(pt, kind, r, drvs, render, mode):
    """Phase 43's control script: 8 blocks, then 8 ticks each followed by 4
    blocks (every tick 64 moves, one discontinuous; every second tick 64
    speed writes and 64 fades; Speed voice 0 past the arena step's bound at
    tick 2 and back at tick 4; 64 plays that grow a full pool at tick 3),
    a new ``Frames``, then 64 blocks (idle once the moves' 0.5 s smoothing
    has passed: fused groups); the pack: 4 blocks, then the same as 3 ticks
    each followed by 4 blocks, a new ``Frames`` and 4 blocks.  Returns
    (the blocks, the graphs that growth and the new arena may recapture)."""
    pack = kind == "spatial_pack"
    ticks, after = (3, 4) if pack else (8, 64)
    bound, grow = ({1: 5.0, 2: 1.0}, 1) if pack else ({2: 5.0, 4: 1.0}, 3)
    forced = 0
    with _mode(mode):
        out = list(render(4 if pack else 8))
        for t in range(ticks):
            for d in drvs:
                d.tick()
                if d.speeds and t in bound:
                    d.speeds[0].set_speed(bound[t])
            if t == grow:
                forced += _captured(r) if mode == "graph" else 0
                for d in drvs:
                    d.play(d.k)
            out += render(4)
        forced += _captured(r) if mode == "graph" else 0
        _new_frames(pt)
        out += render(after)
    return out, forced


def spatial_arena_graphs(pt, dev, kern, tag):
    """Phase 43: the spatial sampler, the seek chains and the spatial
    sampler pack, graph replay against eager dispatch (see the module
    docstring)."""
    from oddio_tpu_torch.ops import stream_kernels as SK

    totals = {"captures": 0, "recaptures": 0, "replays": 0, "eager": 0}
    launch = SK._step_launch
    for kind in ARENA_GRAPH_PATH:
        runs = {}
        for mode in ("eager", "graph"):
            t0 = time.perf_counter()
            r, engine, drvs, render = _arena_graph_scene(pt, kind, dev)
            built = time.perf_counter() - t0
            if not engine.graph_capture:
                raise AssertionError(f"phase 43 {kind}: the engine does not declare "
                                     f"graph_capture")
            forms = {"eager": set(), "captured": set()}

            def spy(garena, kind_, form, *a, _forms=forms, **kw):
                _forms["captured" if torch.cuda.is_current_stream_capturing()
                       else "eager"].add(form)
                return launch(garena, kind_, form, *a, **kw)

            SK._step_launch = spy
            try:
                reset_launches()
                out, forced = _arena_script(pt, kind, r, drvs, render, mode)
                torch.cuda.synchronize()
                x = torch.cat([o.reshape(-1) for o in out]).cpu().numpy() + np.float32(0.0)
                scenes = getattr(engine, "scenes", [engine])
                rings = [p.dr_state()["ring"].data_ptr() for sc in scenes
                         for p in sc._buffered_pools.values()]
                counts = dict(r.graph_counts)
                # the timed runs count too: their idle runs fuse groups (K3)
                with _mode(mode):
                    host_ms, prep_ms, wall = _timed_idle(r, engine)
                    ctl_ms = _timed_first(r, engine, lambda: [d.move() for d in drvs])
                    fade_ms = (_timed_first(r, engine, lambda: [d.retune() for d in drvs])
                               if drvs[0].faders else None)
                torch.cuda.synchronize()
                launches = all_launches()
            finally:
                SK._step_launch = launch
            if not np.isfinite(x).all() or np.abs(x).max() <= 1e-3:
                raise AssertionError(f"phase 43 {kind} {mode}: non-finite or silent output")
            moved = [p.dr_state()["ring"].data_ptr() for sc in scenes
                     for p in sc._buffered_pools.values()]
            if moved != rings:
                raise AssertionError(f"phase 43 {kind} {mode}: a ring moved after the script")
            engine.sync()
            fin = [h.is_finished() for h in drvs[0].voices]
            runs[mode] = (x, launches, counts, host_ms, prep_ms, wall, ctl_ms, fade_ms, built,
                          dict(r.graph_counts), forms, forced, fin)
            with _mode(mode):  # the moves' 0.5 s smoothing passes: the profiles see idle blocks
                _frames(r, BLOCK * 48)
            if mode == "graph":
                ARENA_BUSY.append((kind, lambda r=r: _render8(r, "graph")))
            BLOCK_PROFILES.append((43, f"the {kind} {mode} (8 idle blocks)",
                                   (lambda r=r, m=mode: _render8(r, m)), 8))
        (xe, le, ce, he, pe, we, cte, fe, be, _, fme, _, fine), \
            (xg, lg, cg, hg, pg, wg, ctg, fg, bg, total, fmg, forced, fing) = (
                runs["eager"], runs["graph"])
        # the script's blocks, then the timed runs': 47 + 188 idle, 10 + 10 one-block
        nscript = 20 if kind == "spatial_pack" else 104
        nb = nscript + 235 + (20 if fe is not None else 10)
        err = float(np.abs(xg - xe).max()) if xg.shape == xe.shape else float("inf")
        if err != 0.0:
            raise AssertionError(f"phase 43 {kind}: graph replay differs from eager dispatch "
                                 f"by {err} (-0.0 taken as 0.0)")
        if lg != le:
            raise AssertionError(f"phase 43 {kind}: launches eager {le} graph {lg}")
        names, want_forms = ARENA_GRAPH_PATH[kind]
        missing = [k for k in names if not lg.get(ARENA_GRAPH_KERNELS[k])]
        if missing or fmg["captured"] != want_forms or fme["eager"] != want_forms:
            raise AssertionError(f"phase 43 {kind}: {missing} never launched ({lg}); arena "
                                 f"step forms captured {fmg['captured']}, eager "
                                 f"{fme['eager']}, want {want_forms}")
        if fing != fine:
            raise AssertionError(f"phase 43 {kind}: handles' is_finished differ from eager")
        calls = total["replays"] + total["eager"]
        share = total["replays"] / calls
        if share < 0.9 or not 0 < total["recaptures"] <= forced:
            raise AssertionError(f"phase 43 {kind}: graph_counts over the script {cg}, with "
                                 f"the timed runs {total}: replays {share:.3f} of the calls, "
                                 f"recaptures allowed by growth and the new arena {forced}")
        for k, v in total.items():
            totals[k] += v
        for name in names:
            kern[name].setdefault("graph_launches", {})[kind] = (
                lg[ARENA_GRAPH_KERNELS[name]] / nb)
        xrt = lambda w: 188 * BLOCK / RATE / w  # noqa: E731
        per = " per scene" if kind == "spatial_pack" else ""
        fades = "" if fe is None else f", fade: eager {fe:.4f} graph {fg:.4f}"
        print(f"phase 43 {kind}: built in {be:.2f}/{bg:.2f} s, {nscript} "
              f"blocks, graph vs eager max|diff| {err:.3e} (bit-equal, -0.0 as 0.0); launches "
              f"a block over them and the timed runs ({nb} blocks) "
              f"{ {k: round(v / nb, 3) for k, v in lg.items()} } (equal), arena step forms "
              f"in the graphs {sorted(fmg['captured'])}; is_finished equal "
              f"({sum(fing)} of {len(fing)} finished); graph_counts over the script {cg}, with "
              f"the timed runs {total} (recaptures <= {forced}, the graphs held at the growth "
              f"and at the new arena): replays {share:.3f} of {calls} calls (eager run "
              f"{ce['eager']} op-by-op calls); rings unmoved; dispatch host ms a block, idle: "
              f"eager {he:.4f} graph {hg:.4f}, control ({drvs[0].k} moves{per}): eager "
              f"{cte:.4f} graph "
              f"{ctg:.4f}{fades}; host_prepare ms a block eager {pe:.4f} graph {pg:.4f}; 188 "
              f"idle blocks xRT{per} eager {xrt(we):.2f}x graph {xrt(wg):.2f}x {tag}")
    calls = totals["replays"] + totals["eager"]
    print(f"phase 43: graph runs {totals}, replays {totals['replays'] / calls:.3f} of {calls} "
          f"calls {tag}")


def _control_period(control, render, mode):
    """A block profile's call: one control period of 8 blocks in
    ``mode``."""
    with _mode(mode):
        control()
        render(8)


def _mode(mode):
    """``core.run.eager()`` for the op-by-op runs, else nothing."""
    from oddio_tpu_torch.core.run import eager

    return eager() if mode == "eager" else contextlib.nullcontext()


def _render8(r, mode):
    """A block profile's call: 8 blocks through ``r`` (a Renderer or a
    ScenePack) in ``mode``."""
    with _mode(mode):
        _frames(r, BLOCK * 8)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs a CUDA card",
              file=sys.stderr)
        return 1
    import oddio_tpu_torch as pt
    from oddio_tpu_torch.ops import _build
    from oddio_tpu_torch.ops import ring_kernels as RK
    from oddio_tpu_torch.utils import kernel_bench as KB
    from oddio_tpu_torch.utils.scene_profile import build_spatial, card_line

    card = card_line()
    print(f"card: {card}")
    tag = f"[{card}]"
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 2. build ------------------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build()
    wall = time.perf_counter() - t0
    for name, (so, secs, ptxas) in built.items():
        _build.lib(name)
        print(f"build: {so.name} in {secs:.2f} s (nvcc {' '.join(_build.NVCC_FLAGS[:2])}) {tag}")
        if ptxas:
            print(ptxas.strip(), file=sys.stderr)
    print(f"build: {len(built)} libraries in {wall:.2f} s wall (parallel) {tag}")
    from oddio_tpu_torch.control import native

    fresh = not native.library_path().exists()
    t0 = time.perf_counter()
    native.load()
    print(f"build: {native.library_path().name} from native/control_plane.cpp in "
          f"{time.perf_counter() - t0:.2f} s (g++ {' '.join(native.GXX_FLAGS)}; "
          f"{'built' if fresh else 'cached'}) {tag}")

    # -- 3. kernels vs plain at main-path shapes -------------------------------------
    kern = {}
    # phases 20 and 25, K6's arena form and its whole steps, and phase 15
    # run first: a fault in them shows in seconds
    arena_kernel(dev, kern, tag)
    step_kernel(dev, tag)
    # phase 15, K8-K10 (no path), too
    flat_kernels(dev, kern, tag)

    kern["rows_append"] = rows_append_check(dev, tag)

    kern["window_select_ears"], kern["window_select_multi"], captured = ring_read_checks(dev, tag)

    # -- 4. the main path at 4096 voices ---------------------------------------------
    t0 = time.perf_counter()
    _, sb = build_spatial(True, VOICES, dev)
    _, ss = build_spatial(False, VOICES, dev)
    rb = pt.Renderer(sb, RATE)
    rs = pt.Renderer(ss, RATE)
    print(f"scenes: {VOICES} buffered + {VOICES} seek voices built in "
          f"{time.perf_counter() - t0:.2f} s {tag}")
    reset_launches()
    a = rb.render_frames(RATE)
    dev_out = rb.render_frames_device(BLOCK * 94)
    torch.cuda.synchronize()
    launches = {k: RK.LAUNCHES[k] for k in ("append", "select_ears", "select_multi")}
    read_flat_launches("the spatial path")
    b = torch.cat([o.permute(0, 2, 1).reshape(-1, 2) for o in dev_out]).cpu().numpy()
    c = rs.render_frames(RATE)
    for name, x in (("buffered render_frames", a), ("buffered render_frames_device", b),
                    ("seek render_frames", c)):
        if not np.isfinite(x).all() or np.abs(x).max() <= 1e-3:
            raise AssertionError(f"{name}: non-finite or silent output")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    if RK.LAUNCHES["append_cursor"] != launches["append"]:
        raise AssertionError(f"the main path launched K1 {launches['append']} times, "
                             f"{RK.LAUNCHES['append_cursor']} through the cursor form")
    print(f"main path: 1 s + {BLOCK * 94 / RATE:.3f} s buffered, 1 s seek; peak "
          f"|out| {np.abs(a).max():.4f}/{np.abs(c).max():.4f}; launches {launches} {tag}")

    # -- 5. 256 voices on the card vs the CPU ----------------------------------------
    _, s_gpu = build_spatial(True, 256, dev)
    _, s_cpu = build_spatial(True, 256, "cpu")
    x_gpu = pt.Renderer(s_gpu, RATE).render_frames(BLOCK * 48)
    x_cpu = pt.Renderer(s_cpu, RATE).render_frames(BLOCK * 48)
    err = float(np.abs(x_gpu - x_cpu).max())
    if not err <= TOL:
        raise AssertionError(f"256-voice card render differs from the CPU render by {err}")
    print(f"reference: 256 voices, card vs CPU plain, max|diff| {err:.3e} (<= {TOL}) {tag}")

    # -- 6. real-time factors ----------------------------------------------------------
    for label, r in (("buffered", rb), ("seek", rs)):
        r.render_frames_device(BLOCK * 94, sync=False)
        torch.cuda.synchronize()
        nblk = 188
        t0 = time.perf_counter()
        r.render_frames_device(BLOCK * nblk, sync=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        xrt = (nblk * BLOCK / RATE) / wall
        print(f"xRT {label} {VOICES} voices: {xrt:.2f}x ({nblk} blocks in {wall:.3f} s) {tag}")

    BLOCK_PROFILES.append((4, "the main path's buffered renderer (render_frames_device)",
                           lambda: rb.render_frames_device(BLOCK * 8, sync=False), 8))

    # -- 36. the block steps as CUDA graphs against eager dispatch ---------------------
    main_path_graphs(pt, dev, tag)
    for name, key in zip(("rows_append", "window_select_ears", "window_select_multi"),
                         ("append", "select_ears", "select_multi")):
        kern[name]["launches"] = launches[key]

    # -- 7-10. the config-5 mixer path ----------------------------------------------
    stream_agc_kernels(dev, kern, tag)
    mixer_path(pt, dev, kern, tag)
    # -- 37. the config-5 mixer's block steps as CUDA graphs against eager ---------------
    mixer_graphs(pt, dev, tag)

    # -- 11-14. the host-pool path ----------------------------------------------------
    strip_select_kernel(dev, kern, tag)
    host_pool_path(pt, dev, kern, tag)

    # -- 16-19. the scene axis, the ScenePack paths (15, K8-K10, ran first) ------------
    scene_axis_kernels(dev, tag)
    packs = pack_path(pt, dev, tag)
    for key, name in FLAT_KERNELS.items():
        kern[name]["launches"] = FLAT_PATH_LAUNCHES[key]
    pack_reference(pt, dev, tag)
    pack_xrt(packs, dev, tag)
    del packs
    # -- 38. the packs' block steps as CUDA graphs against eager ----------------------
    pack_graphs(pt, dev, tag)

    # -- 28-31. K5's scene form, the sampler and host-pool packs -----------------------
    strip_select_scene_kernel(dev, kern, tag)
    host_pools_pack_path(pt, dev, kern, tag)
    new_pack_reference(pt, dev, tag)
    # -- 41. the host-pool scene's, pack's and Mixer's block steps as CUDA graphs ------
    host_pool_graphs(pt, dev, kern, tag)

    # -- 21-24, 26. configs 4 and 2, the wavetable, the seek sampler; 27. their steps --
    step_paths(dev, kern, tag)
    sampler_paths(pt, dev, kern, tag)
    # -- 39. the dense mix's and the wavetable's block steps as CUDA graphs -------------
    dense_graphs(pt, dev, tag)
    sampler_pack_path(pt, dev, kern, tag)
    # -- 40. the samplers' block steps as CUDA graphs ------------------------------------
    sampler_graphs(pt, dev, kern, tag)

    # -- 32-34. checkpoints, the realtime driver, the example twins --------------------
    checkpoint_paths(pt, dev, kern, tag)
    realtime_paths(pt, dev, kern, tag)
    example_twins(tag)

    # -- 35. ScenePacks on (scene, voice) meshes -----------------------------------------
    mesh_paths(pt, dev, kern, tag)
    # -- 42. the mesh packs' block steps as CUDA graphs, one per cell -------------------
    mesh_graphs(pt, dev, kern, tag)
    # -- 43. the last spatial pools' block steps as CUDA graphs --------------------------
    spatial_arena_graphs(pt, dev, kern, tag)

    # the one-kernel checks first, then the heavy path profiles
    read_kernel_counts(captured, tag)
    step_kernel_counts(tag)
    one_kernel(27, "arena step", STEP_ONE, tag)
    one_kernel(15, "K8/K10 call", FLAT_ONE, tag)
    print(f"profiler: {KB.PROFILE_RETAKES['sessions']} one-kernel check sessions retaken "
          f"{tag}")
    block_profiles(tag)
    mesh_busy(tag)
    graph_busy(43, ARENA_BUSY, tag)
    profile_device(tag)
    print(json.dumps({"kernels": [kernel_line(name, k) for name, k in kern.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
