// Fused AGC (Adapt) step kernel, for Hopper (sm_90a).
//
// Built by oddio_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded through ctypes.
// The entry point launches on the stream it is given, allocates nothing,
// does not synchronise, and returns cudaGetLastError() after its launch.
// No --use_fast_math: expf, log1pf, sqrtf and the divisions are the
// precise ones, as in torch's CUDA ops.
//
// K7: agc_step
//
// Replaces oddio_tpu/ops/pallas_agc.py::agc_gains (_agc_kernel) together
// with the torch ops around it in Adapt.dr_render (oddio_tpu/ops/adapt.py
// dr_render: alpha, the channel sum, the scalar pack, the gain multiply):
// one launch per Adapt pool per block.  Per voice v, over n frames
// (1 <= n <= AGC_NMAX, any n) of the inner's samples x (V, C, n):
//   a      = 1 - expf(-iv/tau)  (iv a host scalar or a per-voice column),
//   lg     = log1pf(-a),  lim = count (int, exact in f32)
//   s_i    = x_0,i + x_1,i + ...   (channels in order: torch's sum at C = 2)
//   M_i    = expf(min(i+1, lim)*lg)
//   term_i = i < lim ? a*s_i^2/M_i : 0
//   excl_i = sum_{k<i} term_k,  csum_i = excl_i + term_i
//   prev_i = M_{i-1} * (avg0 + excl_i)    (M_{i-1} = expf(min(i, lim)*lg))
//   avg2_i = s_i^2*a + prev_i*(1-a)
//   gain_i = peak < low ? min(low/peak, max_gain)
//          : peak > high ? high/peak : 1,     peak = sqrtf(avg2_i)*sqrt(2)
//   out_c,i = x_c,i * gain_i,   carry = M_{n-1} * (avg0 + csum_{n-1})
// valid while every exp argument stays in [-EMA_GATE, EMA_GATE]
// (n*iv/tau <= 32), which the pool checks on the host (ops/agc.py).
// The output goes to a new tensor (the wrapper allocates it), the carry
// to a new (V,) tensor.
//
// Bound on the H100: the bytes are the samples in, the output out and
// ~28 bytes of per-voice state each way (16.8 MB at 4096 mono voices, n =
// 512: 0.005 ms at 3.35 TB/s); the work is one expf, one division and a
// short dependent chain per frame.  Design: a warp per voice, AGC_WARPS
// voices per CUDA block (1, 4 and 8 measure within about 10% of each
// other at 4096 voices, PERF.md section 6).  The warp copies its
// voice's C*n samples into shared memory with coalesced scalar loads
// (rows of 513 floats are not 16-byte aligned), then each lane owns F
// consecutive frames (F odd, so the lanes' strided shared-memory reads
// hit 32 distinct banks): a serial prefix in registers, a 5-step
// shuffle scan of the lane totals for the lane's offset, and a second
// serial pass that writes x*gain back into shared memory, stored
// coalesced.  No __syncthreads, no serial warp-0
// pass; the gains never reach device memory.  One expf per frame: the
// prev factor expf(min(i, lim)*lg) is the previous frame's M (the same
// argument, so the same value); the lane's first frame computes its own.
// What bounds it (PERF.md section 6): instruction issue, not bytes: the
// divisions are about a fifth of its time, the loads within the run's
// noise; at a few hundred voices a CUDA block per voice is faster (more
// warps in flight), at 4096 slower.  Tensor cores do not apply: the
// prefix as a TF32 triangular product would lose the precision
// ops/agc.py agc_tolerance demands.
// The prefix order (lane-serial, then the lane offsets) differs from
// torch.cumsum's; agc_tolerance bounds any order.

#include <cuda_runtime.h>
#include <math.h>

#define AGC_WARPS 8     // voices per CUDA block
#define AGC_NMAX 544    // frames per block (F <= 17)
#define AGC_CN_MAX 1536 // channels * frames: AGC_WARPS * 6 KB, the default 48 KB

struct AgcArgs {
  const float* x;       // (V, C, n) samples, contiguous
  float* out;           // (V, C, n)
  const float* avg0;    // (V,)
  const float* tau;     // (V,)
  const float* iv_v;    // (V,) interval per voice, or null: iv
  float iv;
  int s_iv;             // iv_v's voice stride
  const int* count;     // count[v * s_count]
  int s_count;
  const float* low;
  const float* high;
  const float* mg;
  float* carry;         // (V,)
  int V, C, n;
};

__device__ __forceinline__ float agc_gain(float avg2, float low, float high,
                                          float mg) {
  const float peak = __fmul_rn(sqrtf(avg2), 1.41421353816986083984375f);
  if (peak < low) {
    const float q = __fdiv_rn(low, peak);
    return (q != q) ? q : fminf(q, mg);  // NaN-propagating min, as torch's
  }
  if (peak > high) return __fdiv_rn(high, peak);
  return 1.0f;
}

// the channel sum of frame i, channels in order
__device__ __forceinline__ float chan_sum(const float* buf, int i, int n,
                                          int C) {
  float x = buf[i];
  for (int c = 1; c < C; ++c) x = __fadd_rn(x, buf[c * n + i]);
  return x;
}

template <int F>
__global__ void __launch_bounds__(AGC_WARPS * 32)
    agc_step_kernel(const AgcArgs A) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int v = blockIdx.x * AGC_WARPS + warp;
  if (v >= A.V) return;  // warp-uniform; nothing below waits on the block
  const int n = A.n, C = A.C, cn = C * n;
  float* buf = smem + warp * cn;
  const float* src = A.x + (long long)v * cn;
  for (int j = lane; j < cn; j += 32) buf[j] = __ldg(src + j);

  // per-voice operands: every lane loads the same words (one broadcast)
  const float iv =
      A.iv_v != nullptr ? A.iv_v[(long long)v * A.s_iv] : A.iv;
  const float a = __fsub_rn(1.0f, expf(__fdiv_rn(-iv, A.tau[v])));
  const float lg = log1pf(-a);
  const float lim = (float)A.count[(long long)v * A.s_count];
  const float avg0 = A.avg0[v];
  const float low = A.low[v], high = A.high[v], mg = A.mg[v];
  __syncwarp();

  // pass 1: this lane's terms and decay prefixes, and their serial sum
  const int i0 = lane * F;
  float term[F], M[F];
  float run = 0.0f;
#pragma unroll
  for (int k = 0; k < F; ++k) {
    const int i = i0 + k;
    term[k] = 0.0f;
    M[k] = 1.0f;
    if (i < n) {
      const float x = chan_sum(buf, i, n, C);
      const float fi = (float)i;
      M[k] = expf(__fmul_rn(fminf(__fadd_rn(fi, 1.0f), lim), lg));
      if (fi < lim) term[k] = __fdiv_rn(__fmul_rn(a, __fmul_rn(x, x)), M[k]);
      run = __fadd_rn(run, term[k]);
    }
  }
  // the lane's offset: exclusive scan of the lane totals
  float incl = run;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl = __fadd_rn(incl, y);
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0f;

  // pass 2: the gains, applied in shared memory
  float Mprev = i0 < n ? expf(__fmul_rn(fminf((float)i0, lim), lg)) : 1.0f;
  const float one_a = __fsub_rn(1.0f, a);
#pragma unroll
  for (int k = 0; k < F; ++k) {
    const int i = i0 + k;
    if (i < n) {
      const float x = chan_sum(buf, i, n, C);
      const float s2 = __fmul_rn(x, x);
      const float prev = __fmul_rn(Mprev, __fadd_rn(avg0, excl));
      const float avg2 = __fadd_rn(__fmul_rn(s2, a), __fmul_rn(prev, one_a));
      const float g = agc_gain(avg2, low, high, mg);
      excl = __fadd_rn(excl, term[k]);
      for (int c = 0; c < C; ++c) buf[c * n + i] = __fmul_rn(buf[c * n + i], g);
      if (i == n - 1) A.carry[v] = __fmul_rn(M[k], __fadd_rn(avg0, excl));
      Mprev = M[k];
    }
  }
  __syncwarp();
  float* dst = A.out + (long long)v * cn;
  for (int j = lane; j < cn; j += 32) dst[j] = buf[j];
}

template <int F>
static int launch(const AgcArgs& A, cudaStream_t stream) {
  const int blocks = (A.V + AGC_WARPS - 1) / AGC_WARPS;
  const size_t smem = (size_t)AGC_WARPS * A.C * A.n * sizeof(float);
  agc_step_kernel<F><<<blocks, AGC_WARPS * 32, smem, stream>>>(A);
  return (int)cudaGetLastError();
}

extern "C" int agc_step(const float* x, float* out, const float* avg0,
                        const float* tau, const float* iv_v, float iv,
                        int s_iv, const int* count, int s_count,
                        const float* low, const float* high, const float* mg,
                        float* carry, int V, int C, int n,
                        cudaStream_t stream) {
  if (V < 1 || C < 1 || n < 1 || n > AGC_NMAX || C * n > AGC_CN_MAX)
    return (int)cudaErrorInvalidValue;
  const AgcArgs A{x,     out,   avg0, tau,   iv_v, iv, s_iv, count,
                  s_count, low, high, mg, carry, V,   C,  n};
  // frames per lane: an odd F with 32*F >= n
  if (n <= 32) return launch<1>(A, stream);
  if (n <= 96) return launch<3>(A, stream);
  if (n <= 160) return launch<5>(A, stream);
  if (n <= 288) return launch<9>(A, stream);
  return launch<17>(A, stream);
}
