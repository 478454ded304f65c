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
// gather, strip place, row scatter):
//   ring[r, (wpos[r] + j) mod size_pad] = chunk[r, j]   for j < wcount[r]
//
// Bound on the H100: memory traffic only, and only the written lanes: it
// reads wcount[r] floats of each chunk row and writes them once (the TPU
// form moved whole row strips in and out).  Design: grid (lane tiles, rows),
// one thread per lane j, so a warp reads 32 neighbouring chunk floats and
// writes 32 neighbouring ring floats (two runs where the write wraps).
// wpos and wcount are device int32 columns: the caller never reads a
// cursor back to the host.
// ---------------------------------------------------------------------------

#define PLACE_THREADS 256

__global__ void ring_place_kernel(float* __restrict__ ring,
                                  const float* __restrict__ chunk,
                                  long long chunk_stride,
                                  const int* __restrict__ wpos,
                                  const int* __restrict__ wcount,
                                  int size_pad, int mw) {
  const int r = blockIdx.y;
  const int j = blockIdx.x * PLACE_THREADS + threadIdx.x;
  if (j >= mw || j >= wcount[r]) return;
  int p = wpos[r] % size_pad;
  if (p < 0) p += size_pad;
  p += j;  // j < mw <= size_pad: one wrap at most
  if (p >= size_pad) p -= size_pad;
  ring[(long long)r * size_pad + p] = chunk[(long long)r * chunk_stride + j];
}

extern "C" int ring_place(float* ring, const float* chunk,
                          long long chunk_stride, const int* wpos,
                          const int* wcount, int rows, int size_pad, int mw,
                          cudaStream_t stream) {
  if (rows < 1 || mw < 1 || mw > size_pad || rows > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((mw + PLACE_THREADS - 1) / PLACE_THREADS, rows);
  ring_place_kernel<<<grid, PLACE_THREADS, 0, stream>>>(
      ring, chunk, chunk_stride, wpos, wcount, size_pad, mw);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K6: ring_resample
//
// Replaces oddio_tpu/ops/pallas_ring.py::strip_resample (_resample_kernel)
// as the stream read uses it (oddio_tpu/ops/stream.py::render_batched: row
// strip gather, kernel, then the underrun mask), fused into one pass:
//   H = j*f_hi, u = (H - floor H) + (t + j*f_lo), fr = u - floor u
//   wr = j*ds_int + floor H + floor u        (whole position, unadjusted)
//   wr < 0 && fr > 0: wr += 1, fr -= 1       (truncate toward zero)
//   a = ring[(start + wr) mod size_pad], b = the next sample
//   out[r, j] = wr_unadjusted < len ? a + fr*(b - a) : 0
//
// The position sites use the round-to-nearest intrinsics: the split-ds
// products are exact in f32 (12-bit f_hi, j < 4096), and a contracted
// a*b + c would move a floor() boundary and with it the sample read.
//
// Bound on the H100: latency of two dependent loads per output sample; the
// bytes are small (each voice reads about n*ds + 2 floats of its ring, which
// sits in L2 after the ingest).  Design: grid (frame tiles, rows), one
// thread per output frame, so a warp's loads of one ring row are
// near-contiguous for ds <= 4 and its stores are coalesced.  The TPU
// kernel's sub-block realign and 128-lane gathers (and the clamp to its
// 768-wide window, which never binds where the stream routes here) become
// the index modulo size_pad.
// ---------------------------------------------------------------------------

#define RESAMPLE_THREADS 128

__global__ void ring_resample_kernel(const float* __restrict__ ring,
                                     const float* __restrict__ t0,
                                     const int* __restrict__ ds_int,
                                     const float* __restrict__ f_hi,
                                     const float* __restrict__ f_lo,
                                     const int* __restrict__ start,
                                     const int* __restrict__ len,
                                     float* __restrict__ out, int size_pad,
                                     int n) {
  const int r = blockIdx.y;
  const int j = blockIdx.x * RESAMPLE_THREADS + threadIdx.x;
  if (j >= n) return;
  const float t = (float)j;
  const float H = __fmul_rn(t, f_hi[r]);
  const float Hf = floorf(H);
  const float u =
      __fadd_rn(__fsub_rn(H, Hf), __fadd_rn(t0[r], __fmul_rn(t, f_lo[r])));
  const float fl_u = floorf(u);
  float fr = __fsub_rn(u, fl_u);
  float wr = __fadd_rn(__fadd_rn(__fmul_rn(t, (float)ds_int[r]), Hf), fl_u);
  const int whole = (int)wr;
  if (wr < 0.0f && fr > 0.0f) {
    wr = __fadd_rn(wr, 1.0f);
    fr = __fsub_rn(fr, 1.0f);
  }
  float s = 0.0f;
  if (whole < len[r]) {
    const float* row = ring + (long long)r * size_pad;
    int p = (start[r] + (int)wr) % size_pad;
    if (p < 0) p += size_pad;
    const int q = (p + 1 == size_pad) ? 0 : p + 1;
    const float a = row[p];
    const float b = row[q];
    s = __fadd_rn(a, __fmul_rn(fr, __fsub_rn(b, a)));
  }
  out[(long long)r * n + j] = s;
}

extern "C" int ring_resample(const float* ring, const float* t,
                             const int* ds_int, const float* f_hi,
                             const float* f_lo, const int* start,
                             const int* len, float* out, int rows,
                             int size_pad, int n, cudaStream_t stream) {
  if (rows < 1 || n < 1 || size_pad < 1 || rows > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((n + RESAMPLE_THREADS - 1) / RESAMPLE_THREADS, rows);
  ring_resample_kernel<<<grid, RESAMPLE_THREADS, 0, stream>>>(
      ring, t, ds_int, f_hi, f_lo, start, len, out, size_pad, n);
  return (int)cudaGetLastError();
}
