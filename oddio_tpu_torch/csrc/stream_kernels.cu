// Stream ring kernels, for Hopper (sm_90a).
//
// Built by oddio_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded through ctypes.
// Every entry point launches on the stream it is given, allocates nothing,
// does not synchronise, and returns cudaGetLastError() after its launch.
//
// A stream voice's ring is one row of size_pad floats per channel; the
// caller passes the pool's rings as (R, size_pad) rows.  Both kernels
// address the ring directly, modulo size_pad: the TPU kernels they replace
// worked on row strips that XLA gathered (and, for the write, scattered
// back) around them.

#include <cuda_runtime.h>
#include <stdint.h>

// ---------------------------------------------------------------------------
// K4: ring_place
//
// Replaces oddio_tpu/ops/pallas_ring.py::strip_place (_place_kernel) as the
// stream pool ingest uses it (oddio_tpu/ops/stream.py::_write_pool: row
// gather, strip place, row scatter) and as the host buffered pool writes
// its rings (oddio_tpu/spatial.py:526):
//   ring[r, (pos_v + j) mod size_pad] = chunk[r, j]   for j < min(count_v, mw)
// with v = r / C (C channel rows per voice) and pos_v = row_mul*wrow[v] +
// wadd[v]: a stream's write cursor (row_mul 1, no wadd), or the host
// pool's cursor form, 128*wrow + extra_w read from its operand record.
//
// Bound on the H100: memory traffic only, and only the written lanes: it
// reads count_v floats of each chunk row and writes them once (the TPU
// form moved whole row strips in and out).  Design: G threads per row (G
// a power of two in [32, 256] near mw/4), up to 256/G rows per CUDA block
// (fewer where the grid would not give every SM two blocks), so no block
// is launched only to find its lanes past a row's count.  A row's
// write is at most two contiguous runs, before and after the ring's end;
// each is stored as 16-byte float4 stores over its 16-byte-aligned
// interior, from scalar coalesced loads of the chunk, with the head and
// tail peeled (csrc/append.cuh's pattern for the stride-513 slab).  The
// cursor and the channel map are read inside: the caller forms no
// per-row cursor tensors.
// ---------------------------------------------------------------------------

#define PLACE_THREADS 256
#define PLACE_MIN_BLOCKS 264  // two CUDA blocks for each of an H100's 132 SMs

__device__ __forceinline__ void store_run(float* __restrict__ dst,
                                          const float* __restrict__ src,
                                          int len, int lane, int G) {
  if (len <= 0) return;
  const int head =
      min(len, (int)(((16u - ((unsigned)(uintptr_t)dst & 15u)) & 15u) >> 2));
  if (lane < head) dst[lane] = src[lane];
  const int nvec = (len - head) >> 2;
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  const float* s = src + head;
  for (int q = lane; q < nvec; q += G)
    d4[q] = make_float4(s[4 * q], s[4 * q + 1], s[4 * q + 2], s[4 * q + 3]);
  const int tail = (len - head) & 3;
  if (lane < tail) dst[head + 4 * nvec + lane] = s[4 * nvec + lane];
}

__global__ void __launch_bounds__(PLACE_THREADS) ring_place_kernel(
    float* __restrict__ ring, const float* __restrict__ chunk,
    long long chunk_stride, const int* __restrict__ wrow,
    const int* __restrict__ wadd, int row_mul, int s_pos,
    const int* __restrict__ wcount, int s_count, int rows, int size_pad,
    int mw, int C, int G) {
  const int r = blockIdx.x * (blockDim.x / G) + threadIdx.x / G;
  const int lane = threadIdx.x % G;
  if (r >= rows) return;
  const int v = C == 1 ? r : r / C;
  // the count and the cursor loaded together, before the count's test
  const int cnt = min(wcount[(long long)v * s_count], mw);
  // 32-bit: row_mul*wrow + wadd is a ring position (< 2^31)
  int p = row_mul * wrow[(long long)v * s_pos];
  if (wadd != nullptr) p += wadd[(long long)v * s_pos];
  if (cnt <= 0) return;
  p %= size_pad;
  if (p < 0) p += size_pad;
  float* row = ring + (long long)r * size_pad;
  const float* src = chunk + (long long)r * chunk_stride;
  const int run = min(cnt, size_pad - p);  // mw <= size_pad: two runs
  store_run(row + p, src, run, lane, G);
  store_run(row, src + run, cnt - run, lane, G);
}

extern "C" int ring_place(float* ring, const float* chunk,
                          long long chunk_stride, const int* wrow,
                          const int* wadd, int row_mul, int s_pos,
                          const int* wcount, int s_count, int rows,
                          int size_pad, int mw, int C, int G,
                          cudaStream_t stream) {
  if (rows < 1 || mw < 1 || mw > size_pad || C < 1 || G < 32 ||
      G > PLACE_THREADS || PLACE_THREADS % G)
    return (int)cudaErrorInvalidValue;
  // rows per block: up to PLACE_THREADS / G, fewer where that would
  // leave the card's SMs short of blocks
  const int per = max(1, min(PLACE_THREADS / G, rows / PLACE_MIN_BLOCKS));
  ring_place_kernel<<<(rows + per - 1) / per, per * G, 0, stream>>>(
      ring, chunk, chunk_stride, wrow, wadd, row_mul, s_pos, wcount, s_count,
      rows, size_pad, mw, C, G);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K6: ring_resample
//
// Replaces oddio_tpu/ops/pallas_ring.py::strip_resample (_resample_kernel)
// as the stream read uses it (oddio_tpu/ops/stream.py::render_batched: row
// strip gather, kernel, then the underrun mask) together with the torch
// ops around it in a device-resident pool's Stream step (the step split
// and the cursor release): one launch per stream pool per block.  Per
// row r (one mono stream voice), from its operands as the pool keeps them:
//   ds    = rate*iv (the DR step: rate (V,), iv the host interval) or ds
//           (V,) as a host pool ships it
//   split as ops/_dev.py device_split_ds: d = floor(ds), f = ds - d,
//           f_hi = floor(f*4096) * 2^-12, f_lo = f - f_hi
//   H = j*f_hi, u = (H - floor H) + (t + j*f_lo), fr = u - floor u
//   wr = j*d + floor H + floor u             (whole position, unadjusted)
//   wr < 0 && fr > 0: wr += 1, fr -= 1       (truncate toward zero)
//   a = ring[(start + wr) mod size_pad], b = the next sample
//   out[r, j] = wr_unadjusted < len ? a + fr*(b - a) : 0
// and in the DR form the release of stream.rs:63-69, to new (V,) tensors:
//   tc = min(t + (count*iv)*rate, len),  rel = trunc(tc)
//   t' = tc - rel,  len' = len - rel,  start' = (start + rel) mod size_pad
// written by the row's first thread after its reads of the old values
// (the old cursors are never overwritten).
//
// Every site uses the round-to-nearest intrinsics: the split-ds products
// are exact in f32 (12-bit f_hi, j < 4096), and a contracted a*b + c
// would move a floor() boundary and with it the sample read; the release
// is term for term the host mirror Stream._tick_math.
//
// Bound on the H100: latency of two dependent loads per output sample; the
// bytes are small (each voice reads about n*ds + 2 floats of its ring,
// which sits in L2 after the ingest, plus ~40 bytes of cursors).  Design:
// grid (frame tiles, rows), one thread per output frame, so a warp's loads
// of one ring row are near-contiguous for ds <= 4 and its stores are
// coalesced; every thread splits its row's step itself (a few dependent
// ops, no operand tensors).  The TPU kernel's sub-block realign and
// 128-lane gathers (and the clamp to its 768-wide window, which never
// binds where the stream routes here) become the index modulo size_pad.
// ---------------------------------------------------------------------------

#define RESAMPLE_THREADS 128

struct ResampleArgs {
  const float* ring;  // (rows, size_pad)
  const float* t;     // (rows,) read offset in (-1, 1)
  const float* step;  // (rows,) rate (DR form) or ds
  float iv;           // DR form: the interval; ds form: unused
  const int* start;   // (rows,)
  const int* len;     // (rows,)
  const int* count;   // DR form: count[r * s_count]; ds form: null
  int s_count;
  float* out;         // (rows, n)
  float* t_out;       // DR form: (rows,) each
  int* len_out;
  int* start_out;
  int rows, size_pad, n;
};

__global__ void __launch_bounds__(RESAMPLE_THREADS)
    ring_resample_kernel(const ResampleArgs A) {
  const int r = blockIdx.y;
  const int j = blockIdx.x * RESAMPLE_THREADS + threadIdx.x;
  const bool dr = A.count != nullptr;
  const float t0 = A.t[r];
  const int st = A.start[r];
  const int ln = A.len[r];
  const float rate = A.step[r];
  const float ds = dr ? __fmul_rn(rate, A.iv) : rate;
  if (dr && j == 0) {
    const float cf = (float)A.count[(long long)r * A.s_count];
    const float nxt = __fadd_rn(t0, __fmul_rn(__fmul_rn(cf, A.iv), rate));
    const float lf = (float)ln;
    const float tc = (nxt < lf || nxt != nxt) ? nxt : lf;  // torch.minimum
    const int rel = (int)tc;  // trunc
    A.t_out[r] = __fsub_rn(tc, (float)rel);
    A.len_out[r] = ln - rel;
    int s2 = (st + rel) % A.size_pad;
    if (s2 < 0) s2 += A.size_pad;
    A.start_out[r] = s2;
  }
  if (j >= A.n) return;
  const float d = floorf(ds);
  const float f = __fsub_rn(ds, d);
  const float f_hi = __fmul_rn(floorf(__fmul_rn(f, 4096.0f)), 1.0f / 4096.0f);
  const float f_lo = __fsub_rn(f, f_hi);
  const float tj = (float)j;
  const float H = __fmul_rn(tj, f_hi);
  const float Hf = floorf(H);
  const float u =
      __fadd_rn(__fsub_rn(H, Hf), __fadd_rn(t0, __fmul_rn(tj, f_lo)));
  const float fl_u = floorf(u);
  float fr = __fsub_rn(u, fl_u);
  float wr = __fadd_rn(__fadd_rn(__fmul_rn(tj, d), Hf), fl_u);
  const int whole = (int)wr;
  if (wr < 0.0f && fr > 0.0f) {
    wr = __fadd_rn(wr, 1.0f);
    fr = __fsub_rn(fr, 1.0f);
  }
  float s = 0.0f;
  if (whole < ln) {
    const float* row = A.ring + (long long)r * A.size_pad;
    int p = (st + (int)wr) % A.size_pad;
    if (p < 0) p += A.size_pad;
    const int q = (p + 1 == A.size_pad) ? 0 : p + 1;
    const float a = row[p];
    const float b = row[q];
    s = __fadd_rn(a, __fmul_rn(fr, __fsub_rn(b, a)));
  }
  A.out[(long long)r * A.n + j] = s;
}

extern "C" int ring_resample(const float* ring, const float* t,
                             const float* step, float iv, const int* start,
                             const int* len, const int* count, int s_count,
                             float* out, float* t_out, int* len_out,
                             int* start_out, int rows, int size_pad, int n,
                             cudaStream_t stream) {
  if (rows < 1 || n < 1 || n > 4096 || size_pad < 1 || rows > 65535 ||
      (count != nullptr && (t_out == nullptr || len_out == nullptr ||
                            start_out == nullptr)))
    return (int)cudaErrorInvalidValue;
  const ResampleArgs A{ring,   t,     step,    iv,        start, len,
                       count,  s_count, out,   t_out,     len_out,
                       start_out, rows, size_pad, n};
  dim3 grid((n + RESAMPLE_THREADS - 1) / RESAMPLE_THREADS, rows);
  ring_resample_kernel<<<grid, RESAMPLE_THREADS, 0, stream>>>(A);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K6, arena form: arena_resample
//
// Replaces oddio_tpu/ops/pallas_ring.py::strip_resample (_resample_kernel)
// as the sampler reads use it (oddio_tpu/core/frames.py::_dr_resample: a
// row window of the guarded or looped sample arena gathered around each
// row's cursor, then the kernel), for FramesSignal, Cycle and the spatial
// seek pool's warped reads.  Per row r, from its (rows,) operands:
//   xc = clamp(xg - 1, lo, hi)           (the cursor kept in its region)
//   H = j*f_hi, u = (H - floor H) + (o0 + j*f_lo), fr = u - floor u
//   wr = j*ds_int + floor H + floor u
//   wr < 0 && fr > 0: wr += 1, fr -= 1   (truncate toward zero: o0 is a
//                                          trunc-form fraction in (-1, 1))
//   a = arena[xc + 1 + wr], b = arena[xc + 2 + wr]
//   out[r, j] = a + fr*(b - a)
// The window of the TPU form started one sample before xc, at xc + 1 -
// extra + row start, so its index extra + wr is the flat arena position
// xc + 1 + wr here: the arena is read in place, with no window gather.
// The TPU kernel's clamps (to its realigned 768-wide window and to the
// fetched rows) never bind where the pool routes here (ds <= 4, windows
// sized for the pool's step tier), and the regions' zero guards and loop
// copies keep every read inside the region, so none is kept.  They are
// sized for n <= ARENA_NMAX at ds <= 4, so the entry refuses a longer n,
// and a read past the arena's ends (only a larger ds can ask for one)
// takes the nearest end, as the plain version's does.
//
// Every site uses the round-to-nearest intrinsics, as ring_resample.
//
// Bound on the H100: bytes.  Each output sample costs two loads of the
// arena span a row walks (about n*ds + 2 floats) and one store; the
// operands are 28 bytes a row.  Design: grid (rows, frame tiles), one
// thread per output frame, so a warp's loads of one row are
// near-contiguous for ds <= 4 and its stores coalesced; rows on the grid's
// x axis, so the row count is not limited to 65535.
// ---------------------------------------------------------------------------

#define ARENA_NMAX 640  // RESAMPLE_NMAX: the read span the arena's guards cover

struct ArenaArgs {
  const float* arena;  // flat guarded/looped arena
  long long arena_len;
  const int* xg;       // (rows,) region cursor (trunc-form integer part)
  const int* lo;       // (rows,) clamp bounds of xg - 1
  const int* hi;
  const float* o0;     // (rows,) trunc-form fraction
  const int* ds_int;   // (rows,) exact step split
  const float* f_hi;
  const float* f_lo;
  float* out;          // (rows, n)
  int rows, n;
};

__global__ void __launch_bounds__(RESAMPLE_THREADS)
    arena_resample_kernel(const ArenaArgs A) {
  const int r = blockIdx.x;
  const int j = blockIdx.y * RESAMPLE_THREADS + threadIdx.x;
  if (j >= A.n) return;
  int xc = A.xg[r] - 1;
  xc = max(xc, A.lo[r]);
  xc = min(xc, A.hi[r]);
  const float o0 = A.o0[r];
  const float d = (float)A.ds_int[r];
  const float f_hi = A.f_hi[r];
  const float f_lo = A.f_lo[r];
  const float tj = (float)j;
  const float H = __fmul_rn(tj, f_hi);
  const float Hf = floorf(H);
  const float u =
      __fadd_rn(__fsub_rn(H, Hf), __fadd_rn(o0, __fmul_rn(tj, f_lo)));
  const float fl_u = floorf(u);
  float fr = __fsub_rn(u, fl_u);
  float wr = __fadd_rn(__fadd_rn(__fmul_rn(tj, d), Hf), fl_u);
  if (wr < 0.0f && fr > 0.0f) {
    wr = __fadd_rn(wr, 1.0f);
    fr = __fsub_rn(fr, 1.0f);
  }
  long long p = (long long)xc + 1 + (long long)wr;
  p = min(max(p, 0LL), A.arena_len - 2);
  const float a = A.arena[p];
  const float b = A.arena[p + 1];
  A.out[(long long)r * A.n + j] = __fadd_rn(a, __fmul_rn(fr, __fsub_rn(b, a)));
}

extern "C" int arena_resample(const float* arena, long long arena_len,
                              const int* xg, const int* lo, const int* hi,
                              const float* o0, const int* ds_int,
                              const float* f_hi, const float* f_lo,
                              float* out, int rows, int n,
                              cudaStream_t stream) {
  if (rows < 1 || n < 1 || n > ARENA_NMAX || arena_len < 2)
    return (int)cudaErrorInvalidValue;
  const ArenaArgs A{arena, arena_len, xg, lo, hi, o0, ds_int, f_hi, f_lo,
                    out, rows, n};
  dim3 grid(rows, (n + RESAMPLE_THREADS - 1) / RESAMPLE_THREADS);
  arena_resample_kernel<<<grid, RESAMPLE_THREADS, 0, stream>>>(A);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K6, arena form, whole steps: arena_step
//
// Replaces the same TPU kernel (oddio_tpu/ops/pallas_ring.py::strip_resample
// as oddio_tpu/core/frames.py::_dr_resample calls it) together with the
// torch chains around each sampler read, one launch per step:
//   form 0, a device-resident FramesSignal or Cycle step (FramesSignal
//           dr_render, Cycle dr_render, and a Speed chain over either):
//           the step split, the rows, the chunked read and the cursor
//           release;
//   form 1, a seek pool's warped read (dr_warp_render): (V, E) t0 and dt,
//           E rows per voice, no release;
//   form 2, a whole device-resident Fader over such a chain: both banks'
//           rows and the crossfade of oddio_tpu/ops/fader.py (fader.rs:38-70),
//           both banks released.
// Per voice v, everything the torch chains computed, in their order:
//   the step: the slot row's host split (a static interval), or
//     ds = rate*w with w the (V,) interval column or the host interval,
//     times the innermost Speed's factor where given (speed.rs:32-36);
//     FramesSignal (and its seek form) snaps |ds - 1| <= eps32 to 1
//     (frames.rs:180-187), Cycle does not; then device_split_ds's exact
//     split (ops/_dev.py);
//   the rows: FramesSignal channel c reads its guarded region at
//     goff + c*(2*guard + len + (-len mod row)), clamped to
//     [region - guard, region + len]; Cycle its looped region at loff,
//     clamped to [loff - 1, loff + len - 1];
//   the read: arena_resample's, at clamp(xg - 1, lo, hi) + 1 + p_j and the
//     next sample, in WARP_CHUNK-frame chunks; between chunks the cursor
//     moves as FramesSignal's _floor_advance (to floor form, then
//     device_advance) or as Cycle's device_advance then remainder(., len);
//   the release, to new tensors: FramesSignal t' = t + f64(w)*f64(count),
//     then the reference's split (trunc of t'*f64(rate), clipped to
//     +-2^30, the f32 fraction); Cycle the position at max(count - 1, 0)
//     reduced mod len plus one step, kept where count <= 0;
//   the seek cursor: FramesSignal trunc-splits t + f64(t0); Cycle shifts by
//     warp_shift's split product (r_hi = top12(rate)) and wraps rem_euclid;
//   the Fader: done = fading & prog >= 1, flip ^= done, fading &= ~done;
//     p_j = min(prog + j*inc, 1); old*sqrt(1 - p) + new*sqrt(p) on fading
//     voices, old elsewhere; prog' = min(prog + count*inc, 1).
// A voice that is not fading after the completion check needs only its
// active bank: its other bank's weight is 0 all block, so that bank is not
// read (its cursor is released all the same).  The torch chain adds
// new*0 = +-0 to old there, so the output equals it (torch.equal) but
// for the sign of an exact zero.
//
// Every site uses the round-to-nearest intrinsics (f32 and f64) and
// sqrt is the IEEE __fsqrt_rn: the chains round every op once, and a
// contracted product would move a floor() boundary, a read, or the f64
// cursor by an ulp that grows over a long render.
//
// Bound on the H100: bytes, the union of the rows' read spans (for
// ds <= 4 about n*ds + 2 floats a row, shared by rows on one sound), the
// output and the per-voice state in and out (about 60 bytes a bank).
// arena_resample ran one thread per output frame over (rows, frame
// tiles): every thread reloaded seven row operands and then waited on its
// two dependent loads with nothing else in flight, four waves of such
// threads latency-bound at about 1.4 TB/s.  Here STEP_TPR threads take a
// whole output row: its state, step split and cursor are computed once a
// thread (redundantly, from broadcast loads, no shuffles or barriers),
// then each thread walks every STEP_TPR-th frame, so a warp's two loads
// per frame are near-contiguous for ds <= 4 and its stores coalesced, and
// the unrolled frame loop keeps its few frames' load pairs in flight
// together.  Neither the reads nor the stores bound it at the paths'
// sizes (PERF.md section 6: without either the time barely moves, and
// the grid's launch alone takes ~2 us): the instructions do, each
// thread's row setup and each frame's floors and conversions (the slow
// conversion pipe), so the frame loops count in floats, the read
// position converts in 32 bits and the grid's y axis is the channel (no
// divisions).  A warp per row (the first form) left three quarters of
// the card's thread slots empty at 2048 rows and walked 16 frames a lane;
// 64 threads a row, two rows a CUDA block, was the fastest layout on the
// sampler's and the seek pool's 2048 rows (PERF.md).
// ---------------------------------------------------------------------------

#define STEP_TPR 64    // threads per output row
#define STEP_ROWS 2    // output rows per CUDA block
#define STEP_CHUNK 512                     // ops/_dev.py WARP_CHUNK
#define STEP_EPS32 1.1920928955078125e-07f  // float32 machine epsilon
#define STEP_CLIP 1073741824.0             // 2^30, the base clip of the split

struct LeafOps {        // one bank's leaf state, (V,) columns
  const double* t;      // FramesSignal's f64 time cursor
  const int* base;      // trunc-form cursor
  const float* frac;
  const int* roff;      // goff (FramesSignal) or loff (Cycle)
  const int* len;
  const float* rate;
  const float* r_hi;    // Cycle's seek: top12(rate)
  const int* ds_int;    // the slot row's split, read for a static interval
  const float* f_hi;
  const float* f_lo;
  const float* ivc;     // (V,) interval column, or null: the host interval
  const float* speed;   // (V,) factor of the innermost Speed, or null
  double* t_out;        // the released cursor (forms 0 and 2)
  int* base_out;
  float* frac_out;
};
#define LEAF_PTRS 15

struct StepArgs {
  const float* arena;
  long long arena_len;
  LeafOps bank[2];
  const int* count;     // count[v * s_count]
  const float* t0;      // form 1: (V, E)
  const float* dt;
  const float* prog;    // form 2: the Fader's (V,) state
  const float* inc;
  const unsigned char* fading;
  const unsigned char* flip;
  float* prog_out;
  unsigned char* fading_out;
  unsigned char* flip_out;
  float* out;           // (V, C, n) forms 0 and 2, (V, E, n) form 1
  float iv;             // the host interval, f32
  int s_count, V, C, E, n, guard, row;
};
#define STEP_PTRS (12 + 2 * LEAF_PTRS)

struct Split {  // ds = d + fh + fl exactly (ops/_dev.py split_ds)
  float d, fh, fl;
  int di;
};

__device__ __forceinline__ Split split_of(float ds) {  // device_split_ds
  Split s;
  s.d = floorf(ds);
  s.di = (int)s.d;
  const float f = __fsub_rn(ds, s.d);
  s.fh = __fmul_rn(floorf(__fmul_rn(f, 4096.0f)), 1.0f / 4096.0f);
  s.fl = __fsub_rn(f, s.fh);
  return s;
}

__device__ __forceinline__ int mod_floor(int a, int m) {  // torch.remainder, m > 0
  const int r = a % m;
  return r < 0 ? r + m : r;
}

// ops/_dev.py device_advance: the cursor moved by cnt steps, floor form
__device__ __forceinline__ void advance(int& b, float& o, int cnt, const Split& s) {
  const float cf = (float)cnt;
  const float H = __fmul_rn(cf, s.fh);
  const float Hfl = floorf(H);
  const float u = __fadd_rn(__fsub_rn(H, Hfl), __fadd_rn(o, __fmul_rn(cf, s.fl)));
  const float fl = floorf(u);
  b = b + cnt * s.di + (int)Hfl + (int)fl;
  o = __fsub_rn(u, fl);
}

// frames.rs:177-189 as split_t: s0 = t*rate, the trunc-form (base, frac)
__device__ __forceinline__ void split_t(double t, float rate, int& b, float& o) {
  const double s0 = __dmul_rn(t, (double)rate);
  const double bt = trunc(s0);
  b = (int)fmin(fmax(bt, -STEP_CLIP), STEP_CLIP);
  o = __double2float_rn(__dsub_rn(s0, bt));
}

// arena_resample's read of frame tj (its index in the chunk, a float: the
// loops count in floats, exact below 2^24, so no frame pays an int-to-float
// conversion) of a chunk whose cursor is (xc, o)
__device__ __forceinline__ float arena_lerp(const float* __restrict__ arena,
                                            long long alen, int xc, float o,
                                            const Split& s, float tj) {
  const float H = __fmul_rn(tj, s.fh);
  const float Hf = floorf(H);
  const float u = __fadd_rn(__fsub_rn(H, Hf), __fadd_rn(o, __fmul_rn(tj, s.fl)));
  const float fl_u = floorf(u);
  float fr = __fsub_rn(u, fl_u);
  float wr = __fadd_rn(__fadd_rn(__fmul_rn(tj, s.d), Hf), fl_u);
  if (wr < 0.0f && fr > 0.0f) {
    wr = __fadd_rn(wr, 1.0f);
    fr = __fsub_rn(fr, 1.0f);
  }
  // wr is a whole number: a 32-bit conversion (saturating past 2^31, where
  // the clamp to the arena gives the int64 read's own end) is exact
  long long p = (long long)xc + 1 + __float2int_rn(wr);
  p = min(max(p, 0LL), alen - 2);
  const float a = __ldg(arena + p);
  const float b = __ldg(arena + p + 1);
  return __fadd_rn(a, __fmul_rn(fr, __fsub_rn(b, a)));
}

template <bool CYC, int FORM>
__global__ void __launch_bounds__(STEP_TPR * STEP_ROWS) arena_step_kernel(const StepArgs A) {
  constexpr int NB = FORM == 2 ? 2 : 1;
  const int lane = threadIdx.x % STEP_TPR;
  // grid (voices, channels or ears): row r = v*per + blockIdx.y
  const int v = blockIdx.x * STEP_ROWS + threadIdx.x / STEP_TPR;
  if (v >= A.V) return;
  const int r = v * (FORM == 1 ? A.E : A.C) + blockIdx.y;
  const int c = FORM == 1 ? 0 : blockIdx.y;  // the channel
  int b[NB], lo[NB], hi[NB], roff[NB], len[NB];
  float o[NB];
  Split s[NB];
  float w[NB];
  bool dyn[NB];
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    const LeafOps& L = A.bank[k];
    len[k] = L.len[v];
    const float rate = L.rate[v];
    if (FORM == 1) {
      const float t0 = A.t0[r];
      float ds = __fmul_rn(A.dt[r], rate);
      if (CYC) {  // ops/_dev.py warp_shift, then the rem_euclid wrap
        const float rh = L.r_hi[v];
        const float rl = __fsub_rn(rate, rh);
        const float ti = __int_as_float(__float_as_int(t0) & ~0xFFF);
        const float tl = __fsub_rn(t0, ti);
        const float Aa = __fmul_rn(ti, rh);
        const float rest = __fadd_rn(__fmul_rn(ti, rl), __fmul_rn(tl, rate));
        const float Af = floorf(Aa);
        const float u = __fadd_rn(__fsub_rn(Aa, Af), rest);
        const float uf = floorf(u);
        const int si = (int)__fadd_rn(Af, uf);
        const float u2 = __fadd_rn(L.frac[v], __fsub_rn(u, uf));
        const float uf2 = floorf(u2);
        b[k] = mod_floor(L.base[v] + si + (int)uf2, len[k]);
        o[k] = __fsub_rn(u2, uf2);
      } else {
        split_t(__dadd_rn(L.t[v], (double)t0), rate, b[k], o[k]);
        if (fabsf(__fsub_rn(ds, 1.0f)) <= STEP_EPS32) ds = 1.0f;
      }
      s[k] = split_of(ds);
      dyn[k] = true;
      w[k] = 0.0f;
    } else {
      b[k] = L.base[v];
      o[k] = L.frac[v];
      dyn[k] = L.ivc != nullptr || L.speed != nullptr;
      w[k] = L.ivc != nullptr ? L.ivc[v] : A.iv;
      if (L.speed != nullptr) w[k] = __fmul_rn(w[k], L.speed[v]);
      if (dyn[k]) {
        float ds = __fmul_rn(rate, w[k]);
        if (!CYC && fabsf(__fsub_rn(ds, 1.0f)) <= STEP_EPS32) ds = 1.0f;
        s[k] = split_of(ds);
      } else {
        s[k].di = L.ds_int[v];
        s[k].d = (float)s[k].di;
        s[k].fh = L.f_hi[v];
        s[k].fl = L.f_lo[v];
      }
    }
    if (CYC) {
      roff[k] = L.roff[v];
      lo[k] = roff[k] - 1;
      hi[k] = roff[k] + len[k] - 1;
    } else {
      roff[k] = L.roff[v] + c * (2 * A.guard + len[k] + ((-len[k]) & (A.row - 1)));
      lo[k] = roff[k] - A.guard;
      hi[k] = roff[k] + len[k];
    }
  }

  // the Fader's completion check (fader.rs:66-70 at block start)
  bool fad = false, flp = false;
  float pr = 0.0f, inc = 0.0f;
  if (FORM == 2) {
    pr = A.prog[v];
    inc = A.inc[v];
    const bool done = A.fading[v] && pr >= 1.0f;
    fad = A.fading[v] && !done;
    flp = (A.flip[v] != 0) != done;
  }

  // the release, by one lane of the voice's first row, from the old state
  if (FORM != 1 && c == 0 && lane == 0) {
    const int cnt = A.count[(long long)v * A.s_count];
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      const LeafOps& L = A.bank[k];
      if (CYC) {  // cycle.rs:40-47: the last position reduced, one step on
        int b1 = L.base[v];
        float f1 = L.frac[v];
        if (cnt > 0) {
          advance(b1, f1, max(cnt - 1, 0), s[k]);
          b1 = mod_floor(b1, len[k]);
          advance(b1, f1, 1, s[k]);
        }
        L.base_out[v] = b1;
        L.frac_out[v] = f1;
      } else {  // frames.rs:198 on the f64 cursor, then its split
        const double wd = dyn[k] ? (double)w[k] : (double)A.iv;
        const double t2 = __dadd_rn(L.t[v], __dmul_rn(wd, (double)cnt));
        L.t_out[v] = t2;
        split_t(t2, L.rate[v], L.base_out[v], L.frac_out[v]);
      }
    }
    if (FORM == 2) {
      const float p2 = __fadd_rn(pr, __fmul_rn((float)cnt, inc));
      A.prog_out[v] = p2 > 1.0f ? 1.0f : p2;
      A.fading_out[v] = fad;
      A.flip_out[v] = flp;
    }
  }

  float* __restrict__ orow = A.out + (long long)r * A.n;
  for (int j0 = 0; j0 < A.n; j0 += STEP_CHUNK) {
    int xc[NB];
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      if (j0 > 0) {
        if (CYC) {
          advance(b[k], o[k], STEP_CHUNK, s[k]);
          b[k] = mod_floor(b[k], len[k]);
        } else {  // _floor_advance: to floor form, then device_advance
          if (o[k] < 0.0f) {
            b[k] -= 1;
            o[k] = __fadd_rn(o[k], 1.0f);
          }
          advance(b[k], o[k], STEP_CHUNK, s[k]);
        }
      }
      xc[k] = min(max(roff[k] + b[k] - 1, lo[k]), hi[k]);
    }
    const int nc = min(STEP_CHUNK, A.n - j0);
    const float tl = (float)lane, tstep = (float)STEP_TPR;
    if constexpr (FORM != 2) {
      float tj = tl;
#pragma unroll 4
      for (int jj = lane; jj < nc; jj += STEP_TPR, tj = __fadd_rn(tj, tstep))
        orow[j0 + jj] = arena_lerp(A.arena, A.arena_len, xc[0], o[0], s[0], tj);
    } else if (!fad) {  // the active bank alone (selects, not a local-memory index)
      const int xa = flp ? xc[1] : xc[0];
      const float oa = flp ? o[1] : o[0];
      const Split sa = flp ? s[1] : s[0];
      float tj = tl;
#pragma unroll 4
      for (int jj = lane; jj < nc; jj += STEP_TPR, tj = __fadd_rn(tj, tstep))
        orow[j0 + jj] = arena_lerp(A.arena, A.arena_len, xa, oa, sa, tj);
    } else {
      const float fj0 = (float)j0;
      float tj = tl;
#pragma unroll 2
      for (int jj = lane; jj < nc; jj += STEP_TPR, tj = __fadd_rn(tj, tstep)) {
        const float sa = arena_lerp(A.arena, A.arena_len, xc[0], o[0], s[0], tj);
        const float sb = arena_lerp(A.arena, A.arena_len, xc[1], o[1], s[1], tj);
        const float old = flp ? sb : sa;
        const float nw = flp ? sa : sb;
        float p = __fadd_rn(pr, __fmul_rn(__fadd_rn(fj0, tj), inc));
        p = p > 1.0f ? 1.0f : p;
        orow[j0 + jj] = __fadd_rn(__fmul_rn(old, __fsqrt_rn(__fsub_rn(1.0f, p))),
                                  __fmul_rn(nw, __fsqrt_rn(p)));
      }
    }
  }
}

template <bool CYC>
static void step_launch(const StepArgs& A, int form, dim3 grid, cudaStream_t stream) {
  const int threads = STEP_TPR * STEP_ROWS;
  if (form == 0)
    arena_step_kernel<CYC, 0><<<grid, threads, 0, stream>>>(A);
  else if (form == 1)
    arena_step_kernel<CYC, 1><<<grid, threads, 0, stream>>>(A);
  else
    arena_step_kernel<CYC, 2><<<grid, threads, 0, stream>>>(A);
}

// ptrs: arena, count, t0, dt, prog, inc, fading, flip, prog_out, fading_out,
// flip_out, out, then LEAF_PTRS pointers (LeafOps order) for each of two
// banks (the second unread outside form 2); a null where a form reads none
extern "C" int arena_step(const void* const* ptrs, long long arena_len, float iv,
                          int s_count, int cyc, int form, int V, int C, int E, int n,
                          int guard, int row, cudaStream_t stream) {
  const int per = form == 1 ? E : C;
  if (V < 1 || C < 1 || n < 1 || form < 0 || form > 2 || (form == 1 && (E < 1 || C != 1)) ||
      (cyc && C != 1) || arena_len < 2 || guard < 0 || row < 1 || (row & (row - 1)) ||
      per > 65535 || (long long)V * per > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  StepArgs A;
  A.arena = (const float*)ptrs[0];
  A.arena_len = arena_len;
  A.count = (const int*)ptrs[1];
  A.t0 = (const float*)ptrs[2];
  A.dt = (const float*)ptrs[3];
  A.prog = (const float*)ptrs[4];
  A.inc = (const float*)ptrs[5];
  A.fading = (const unsigned char*)ptrs[6];
  A.flip = (const unsigned char*)ptrs[7];
  A.prog_out = (float*)ptrs[8];
  A.fading_out = (unsigned char*)ptrs[9];
  A.flip_out = (unsigned char*)ptrs[10];
  A.out = (float*)ptrs[11];
  for (int k = 0; k < 2; ++k) {
    const void* const* q = ptrs + 12 + k * LEAF_PTRS;
    A.bank[k] = LeafOps{(const double*)q[0], (const int*)q[1],   (const float*)q[2],
                        (const int*)q[3],    (const int*)q[4],   (const float*)q[5],
                        (const float*)q[6],  (const int*)q[7],   (const float*)q[8],
                        (const float*)q[9],  (const float*)q[10], (const float*)q[11],
                        (double*)q[12],      (int*)q[13],        (float*)q[14]};
  }
  A.iv = iv;
  A.s_count = s_count;
  A.V = V;
  A.C = C;
  A.E = E;
  A.n = n;
  A.guard = guard;
  A.row = row;
  const dim3 grid((V + STEP_ROWS - 1) / STEP_ROWS, per);
  if (cyc)
    step_launch<true>(A, form, grid, stream);
  else
    step_launch<false>(A, form, grid, stream);
  return (int)cudaGetLastError();
}
