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
