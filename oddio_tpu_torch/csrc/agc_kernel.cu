// Fused AGC (Adapt) gain kernel, for Hopper (sm_90a).
//
// Built by oddio_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded through ctypes.
// The entry point launches on the stream it is given, allocates nothing,
// does not synchronise, and returns cudaGetLastError() after its launch.
// No --use_fast_math: expf, sqrtf and the divisions are the precise ones.
//
// K7: agc_gains
//
// Replaces oddio_tpu/ops/pallas_agc.py::agc_gains (_agc_kernel): per voice,
// the closed form of adapt.rs:69-88's EMA and gain over one block of n
// frames (n a multiple of 128, at most 512), with the carry frozen past
// `count` frames:
//   lim    = count
//   c_i    = min(i+1, lim),  M_i = expf(c_i*lg),  lg = log1p(-a)
//   term_i = i < lim ? a*s_i^2/M_i : 0
//   csum_i = inclusive prefix sum of term;  excl_i = csum_i - term_i
//   prev_i = expf(min(i, lim)*lg) * (avg0 + excl_i)
//   avg2_i = s_i^2*a + prev_i*(1-a)
//   gain_i = peak < low ? min(low/peak, max_gain)
//          : peak > high ? high/peak : 1,     peak = sqrtf(avg2_i)*sqrt(2)
//   carry  = expf(min(n, lim)*lg) * (avg0 + csum_{n-1})
//
// Bound on the H100: neither bytes (8 bytes in and 4 out per frame) nor
// flops (two expf per frame); the prefix sum's dependency chain sets the
// latency.  Design: one CUDA block per voice, one thread per frame; the
// TPU kernel's one-hot 128x128 matmul prefix becomes a warp-shuffle
// inclusive scan (5 steps), then a scan of the per-warp totals by the first
// warp, added back to every warp: 10 dependent shuffle steps for n = 512.
// The order of that sum differs from torch.cumsum's; ops/agc.py
// agc_tolerance bounds the difference.

#include <cuda_runtime.h>
#include <math.h>

#define MAX_WARPS 16  // n <= 512

__device__ __forceinline__ float warp_inclusive_scan(float x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x = __fadd_rn(x, y);
  }
  return x;
}

__global__ void agc_gains_kernel(const float* __restrict__ s,
                                 const float* __restrict__ scal,
                                 float* __restrict__ gains,
                                 float* __restrict__ carry, int n) {
  __shared__ float warp_sum[MAX_WARPS];
  const int v = blockIdx.x;
  const int i = threadIdx.x;
  const int lane = i & 31;
  const int warp = i >> 5;
  const int nwarps = blockDim.x >> 5;
  const float* sc = scal + (long long)v * 8;
  const float avg0 = sc[0];
  const float a = sc[1];
  const float lg = sc[2];
  const float lim = sc[3];  // count, exact in f32
  const float low = sc[4];
  const float high = sc[5];
  const float mg = sc[6];

  const float fi = (float)i;
  const float x = s[(long long)v * n + i];
  const float s2 = __fmul_rn(x, x);
  const float M = expf(__fmul_rn(fminf(__fadd_rn(fi, 1.0f), lim), lg));
  const float term = (fi < lim) ? __fdiv_rn(__fmul_rn(a, s2), M) : 0.0f;

  // block-wide inclusive prefix sum of term
  float csum = warp_inclusive_scan(term, lane);
  if (lane == 31) warp_sum[warp] = csum;
  __syncthreads();
  if (warp == 0) {
    float w = lane < nwarps ? warp_sum[lane] : 0.0f;
    w = warp_inclusive_scan(w, lane);
    if (lane < nwarps) warp_sum[lane] = w;
  }
  __syncthreads();
  if (warp > 0) csum = __fadd_rn(csum, warp_sum[warp - 1]);

  const float excl = __fsub_rn(csum, term);
  const float prev =
      __fmul_rn(expf(__fmul_rn(fminf(fi, lim), lg)), __fadd_rn(avg0, excl));
  const float avg2 =
      __fadd_rn(__fmul_rn(s2, a), __fmul_rn(prev, __fsub_rn(1.0f, a)));
  const float peak = __fmul_rn(sqrtf(avg2), 1.41421353816986083984375f);
  float g;
  if (peak < low) {
    const float q = __fdiv_rn(low, peak);
    g = (q != q) ? q : fminf(q, mg);  // NaN-propagating min, as torch's
  } else if (peak > high) {
    g = __fdiv_rn(high, peak);
  } else {
    g = 1.0f;
  }
  gains[(long long)v * n + i] = g;
  if (i == n - 1) {
    const float c_last = fminf((float)n, lim);
    carry[v] = __fmul_rn(expf(__fmul_rn(c_last, lg)), __fadd_rn(avg0, csum));
  }
}

extern "C" int agc_gains(const float* s, const float* scal, float* gains,
                         float* carry, int V, int n, cudaStream_t stream) {
  if (V < 1 || n < 128 || n > 32 * MAX_WARPS || n % 128)
    return (int)cudaErrorInvalidValue;
  agc_gains_kernel<<<V, n, 0, stream>>>(s, scal, gains, carry, n);
  return (int)cudaGetLastError();
}
