// K5: the host buffered pool's two-ear delay-ring read, for Hopper (sm_90a).
//
// Built by oddio_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded through ctypes.
// The entry point launches on the stream it is given, allocates nothing,
// does not synchronise, and returns cudaGetLastError() after its launches.
//
// Replaces oddio_tpu/ops/pallas_ring.py::strip_select (_select_kernel,
// _ear_pipeline, _positions_sb, _realign_rows, _gather3).  For each voice
// v, ear e and 128-frame sub-block of frames j:
//   kk_j  = clip(whole_j - j + K, 0, 2K), fr_j from the exact split-ds math
//   kmin  = min of kk over the WHOLE sub-block (frames past n included)
//   a_j   = ring[v, (128*rrow + extra_e + j + kmin + min(kk_j - kmin, R-1)) mod L]
//   b_j   = the next sample (mod L);  s = a + fr*(b - a)
//   out[e, j] = sum_v (s * (g0_e + j*dg_e)) * mask_v
// The min(., R-1) clamp (SELECT_R = 16) is part of what the TPU kernel
// computes (its realign reaches kmin + 15 at most); it binds for voices
// whose |ds - 1|*127 exceeds 15, and is reproduced here and in the plain
// version.
//
// Bound on the H100: bytes.  Per voice and ear the read touches about
// n + |ds-1|*n + 1 contiguous floats of the ring (~2.1 KB at n = 512), so
// at 4096 voices the kernel must read ~17 MB, against ~20 f32 operations
// per (voice, ear, frame) (84 MFLOP).  Design: the ring is addressed
// directly, modulo L, instead of through the TPU's gathered row strips (no
// strip copy, no realign: wrap positions are private storage, so the
// values read are the same).  One CUDA block owns one 128-frame sub-block
// of VC voices, one thread per frame: the per-voice scalars are staged in
// shared memory, each thread rebuilds its positions, the sub-block minimum
// of kk is a warp __reduce_min_sync plus a 4-warp pass through shared
// memory, and a warp's loads of one voice row are contiguous.  The voice
// sum is deterministic: each block writes its chunk's partial sums per
// (ear, frame) and a second kernel adds the chunks in a fixed order (no
// atomics).  --fmad=false and the _rn intrinsics keep the position math,
// the lerp and the gain ramp rounded op by op, as the plain version is.

#include <cuda_runtime.h>
#include <stdint.h>

#define SB 128       // frames per sub-block = threads per CUDA block
#define VC 16        // voices per CUDA block: one partial sum per chunk
#define SELECT_R 16  // residual walk clamp of the TPU kernel (pallas_ring.py:258)

__device__ __forceinline__ void position(float o0, float f_hi, float f_lo,
                                         float dsm1, int K, float t, int* kk,
                                         float* fr) {
  const float H = __fmul_rn(t, f_hi);  // exact: 12-bit f_hi, t < 4096
  const float Hf = floorf(H);
  const float u = __fadd_rn(__fsub_rn(H, Hf), __fadd_rn(o0, __fmul_rn(t, f_lo)));
  const float fl_u = floorf(u);
  *fr = __fsub_rn(u, fl_u);
  float k = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(t, dsm1), Hf), fl_u),
                      (float)K);
  k = fminf(fmaxf(k, 0.0f), (float)(2 * K));
  *kk = (int)k;
}

__global__ void strip_select_partial(const float* __restrict__ ring, int L,
                                     const int* __restrict__ rrow,
                                     const int* __restrict__ extra,
                                     const float* __restrict__ scal,
                                     const float* __restrict__ g0,
                                     const float* __restrict__ dg,
                                     const float* __restrict__ maskf,
                                     float* __restrict__ part, int V, int n,
                                     int K) {
  __shared__ float s_sc[VC][2][4];
  __shared__ float s_g[VC][2][2];
  __shared__ float s_m[VC];
  __shared__ long long s_base[VC][2];
  __shared__ int s_wmin[SB / 32][VC][2];

  const int sb = blockIdx.x;
  const int chunk = blockIdx.y;
  const int v0 = chunk * VC;
  const int nv = min(VC, V - v0);
  const int t = threadIdx.x;

  if (t < 2 * VC) {
    const int e = t / VC;
    const int i = t % VC;
    if (i < nv) {
      const long long v = v0 + i;
      for (int k = 0; k < 4; ++k) s_sc[i][e][k] = scal[(v * 2 + e) * 4 + k];
      s_g[i][e][0] = g0[v * 2 + e];
      s_g[i][e][1] = dg[v * 2 + e];
      s_base[i][e] = 128LL * rrow[v] + extra[v * 2 + e];
      if (e == 0) s_m[i] = maskf[v];
    }
  }
  __syncthreads();

  // every thread of the sub-block takes part in its minimum, also past n
  const int j = sb * SB + t;
  const float tf = (float)j;
  int kk[VC][2];
  float fr[VC][2];
#pragma unroll
  for (int i = 0; i < VC; ++i) {
    if (i < nv) {  // uniform over the block
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        position(s_sc[i][e][0], s_sc[i][e][1], s_sc[i][e][2],
                 __fsub_rn(s_sc[i][e][3], 1.0f), K, tf, &kk[i][e], &fr[i][e]);
        const int wmin = __reduce_min_sync(0xffffffffu, kk[i][e]);
        if ((t & 31) == 0) s_wmin[t >> 5][i][e] = wmin;
      }
    }
  }
  __syncthreads();
  if (j >= n) return;

  float acc[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < VC; ++i) {
    if (i < nv) {
      const float* row = ring + (long long)(v0 + i) * L;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        int kmin = s_wmin[0][i][e];
#pragma unroll
        for (int w = 1; w < SB / 32; ++w) kmin = min(kmin, s_wmin[w][i][e]);
        const int r = min(kk[i][e] - kmin, SELECT_R - 1);
        long long m = (s_base[i][e] + j + kmin + r) % L;
        if (m < 0) m += L;
        const long long m1 = (m + 1 == L) ? 0 : m + 1;
        const float a = row[m];
        const float b = row[m1];
        const float s = __fadd_rn(a, __fmul_rn(fr[i][e], __fsub_rn(b, a)));
        const float gain = __fadd_rn(s_g[i][e][0], __fmul_rn(tf, s_g[i][e][1]));
        acc[e] = __fadd_rn(acc[e], __fmul_rn(__fmul_rn(s, gain), s_m[i]));
      }
    }
  }
  // part layout: [chunk][ear][n]
#pragma unroll
  for (int e = 0; e < 2; ++e)
    part[((long long)chunk * 2 + e) * n + j] = acc[e];
}

__global__ void strip_select_reduce(const float* __restrict__ part,
                                    float* __restrict__ out, int n,
                                    int nchunks) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 2 * n) return;
  const int e = idx / n;
  const int j = idx % n;
  float s = 0.0f;
  for (int c = 0; c < nchunks; ++c)
    s = __fadd_rn(s, part[((long long)c * 2 + e) * n + j]);
  out[idx] = s;
}

extern "C" int strip_select(const float* ring, int L, const int* rrow,
                            const int* extra, const float* scal,
                            const float* g0, const float* dg,
                            const float* maskf, float* part, float* out, int V,
                            int n, int K, cudaStream_t stream) {
  if (V < 1 || n < 1 || L < 2) return (int)cudaErrorInvalidValue;
  const int nchunks = (V + VC - 1) / VC;
  dim3 grid((n + SB - 1) / SB, nchunks);
  strip_select_partial<<<grid, SB, 0, stream>>>(ring, L, rrow, extra, scal,
                                                 g0, dg, maskf, part, V, n, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  strip_select_reduce<<<(2 * n + 255) / 256, 256, 0, stream>>>(part, out, n,
                                                                nchunks);
  return (int)cudaGetLastError();
}
