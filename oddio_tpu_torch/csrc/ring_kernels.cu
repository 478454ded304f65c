// Delay-ring kernels of the buffered spatial pool, for Hopper (sm_90a).
//
// Built by oddio_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded through ctypes.
// Every entry point launches on the stream it is given, allocates nothing,
// does not synchronise, and returns cudaGetLastError() after its launches.
//
// --fmad=false keeps every multiply and add separately rounded: the read
// positions are rebuilt with the exact split-ds arithmetic of
// oddio_tpu/ops/_dev.py, where a contracted a*b+c would move floor()
// boundaries and with them the sample read.  The position sites also use
// the explicit round-to-nearest intrinsics, so they stay exact whatever
// the flags.

#include <assert.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define SB 128      // frames per CUDA block (threads) in the select kernels
#define VC 16       // voices per CUDA block: one partial sum per chunk
#define MAX_NB 8    // blocks a multi-block select may fuse

// ---------------------------------------------------------------------------
// K1: rows_append
//
// Replaces oddio_tpu/ops/pallas_ring.py::rows_append_dma
// (_rows_append_kernel): two strided HBM->HBM DMAs per voice tile.
//
// Bound on the H100: memory traffic only — it reads the (V, W) slab once
// and writes it twice, 2*V*W*4 bytes (16.8 MB per block at V = 4096,
// W = 512), no arithmetic.  Design: one thread per 16-byte vector of the
// slab; neighbouring threads own neighbouring vectors of one voice row, so
// loads and both 16-byte stores are fully coalesced, and the slab is read
// once for both legs.  The row indices come from a device int32 pair, so
// the caller never reads them back to the host (idle blocks derive them
// on the device).  A leg whose rows fall outside the ring trips a
// device-side assert, as the plain version's index_copy_ raises.
// ---------------------------------------------------------------------------

__global__ void rows_append_kernel(float* __restrict__ ring,
                                   const float* __restrict__ slab,
                                   long long slab_stride,
                                   const int* __restrict__ rows,
                                   int V, int RPV, int nr, int vec_src) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int w4 = nr * 32;  // float4 vectors per voice row
  if (q >= (long long)V * w4) return;
  const int v = (int)(q / w4);
  const int c = (int)(q % w4) * 4;
  const float* src = slab + (long long)v * slab_stride + c;
  float4 x;
  if (vec_src) {
    x = *reinterpret_cast<const float4*>(src);
  } else {
    x = make_float4(src[0], src[1], src[2], src[3]);
  }
  float* base = ring + (long long)v * RPV * 128 + c;
  const int r0 = rows[0];
  const int r1 = rows[1];
  assert(r0 >= 0 && r0 + nr <= RPV && r1 >= 0 && r1 + nr <= RPV);
  *reinterpret_cast<float4*>(base + (long long)r0 * 128) = x;
  *reinterpret_cast<float4*>(base + (long long)r1 * 128) = x;
}

extern "C" int rows_append(float* ring, const float* slab,
                           long long slab_stride, const int* rows, int V,
                           int RPV, int nr, cudaStream_t stream) {
  const long long total = (long long)V * nr * 32;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  const int vec_src =
      (slab_stride % 4 == 0) && ((uintptr_t)slab % 16 == 0) ? 1 : 0;
  if (blocks > 0)
    rows_append_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
        ring, slab, slab_stride, rows, V, RPV, nr, vec_src);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K2/K3: window_select (ears, and multi-block)
//
// Replaces oddio_tpu/ops/pallas_ring.py::window_select_tiles_ears
// (_select_tiles_kernel, with _realign_rows, _positions_sb,
// _ears_pipeline_flat, _gather_pair, _mix_rows) and
// window_select_tiles_multi (_select_tiles_multi_kernel).
//
// For each voice v, ear e and frame j of block b:
//   win  = wide[v, col0[b] + 128*clamp(rowshift[v,b], 0, H[b]-1) :]
//   kk_j = clip(whole_j - j + K, 0, 2K), fr_j from the exact split-ds math
//   s    = a + fr*(b - a),  a = win[extra + j + kk_j],  b = the next sample
//          (a voice with frz > 0 repeats its j = 0 sample)
//   out[e, b*n + j] = (sum_v g0*s) + j*(sum_v dg*s)
//
// Bound on the H100: neither bytes nor flops are large — per voice each
// ear reads ~n+2K contiguous floats of a window that sits in L2 — so the
// kernel is bound by load latency and the ~30 scalar ops per sample.
// Design: on the GPU the TPU's log-step row realign and 128-lane table
// gathers become one index offset; one thread owns one frame j and walks
// the VC voices of its block (the per-voice scalars staged once in shared
// memory), so a warp's loads of one voice row are contiguous.  The voice
// sum is deterministic: each block writes its chunk's two partial sums per
// (ear, frame), and a second small kernel adds the chunks in a fixed
// order — no atomics, whose order would change from run to run.  The
// block index of K3 is the grid's z dimension.
// ---------------------------------------------------------------------------

struct BlockCfg {
  int col0[MAX_NB];  // static start column of each block's slice
  int hcap[MAX_NB];  // realign range H: rowshift clamps into [0, H)
};

__device__ __forceinline__ float ear_sample(const float* __restrict__ row,
                                            int S2, int base, float o0,
                                            float f_hi, float f_lo,
                                            float dsm1, int K, int j) {
  const float t = (float)j;
  const float H = __fmul_rn(t, f_hi);  // exact: 12-bit f_hi, t < 4096
  const float Hf = floorf(H);
  const float u = __fadd_rn(__fsub_rn(H, Hf), __fadd_rn(o0, __fmul_rn(t, f_lo)));
  const float fl_u = floorf(u);
  const float fr = __fsub_rn(u, fl_u);
  float kk = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(t, dsm1), Hf), fl_u),
                       (float)K);
  kk = fminf(fmaxf(kk, 0.0f), (float)(2 * K));
  const int m = base + j + (int)kk;
  assert(m >= 0 && m <= S2 - 2);  // the plain version's gather raises
  const float a = row[m];
  const float b = row[m + 1];
  return __fadd_rn(a, __fmul_rn(fr, __fsub_rn(b, a)));
}

__global__ void select_partial_kernel(
    const float* __restrict__ wide, long long wide_stride, int S2,
    const int* __restrict__ rowshift, const float* __restrict__ sc0,
    const float* __restrict__ sc1, const float* __restrict__ g0,
    const float* __restrict__ g1, const int* __restrict__ e0,
    const int* __restrict__ e1, const float* __restrict__ f0,
    const float* __restrict__ f1, float* __restrict__ part, int V, int n,
    int K, int nb, BlockCfg cfg) {
  __shared__ float s_sc[2][VC][4];
  __shared__ float s_g[2][VC][2];
  __shared__ int s_base[2][VC];
  __shared__ int s_frz[2][VC];

  const int chunk = blockIdx.y;
  const int nchunks = gridDim.y;
  const int b = blockIdx.z;
  const int v0 = chunk * VC;
  const int nv = min(VC, V - v0);
  const int t = threadIdx.x;

  if (t < 2 * VC) {
    const int e = t / VC;
    const int i = t % VC;
    if (i < nv) {
      const int v = v0 + i;
      const float* sc = e ? sc1 : sc0;
      const float* g = e ? g1 : g0;
      const int* ex = e ? e1 : e0;
      const float* fz = e ? f1 : f0;
      for (int k = 0; k < 4; ++k) s_sc[e][i][k] = sc[(long long)v * 4 * nb + 4 * b + k];
      s_g[e][i][0] = g[(long long)v * 2 * nb + 2 * b];
      s_g[e][i][1] = g[(long long)v * 2 * nb + 2 * b + 1];
      int sh = rowshift[(long long)v * nb + b];
      sh = min(max(sh, 0), cfg.hcap[b] - 1);
      s_base[e][i] = cfg.col0[b] + 128 * sh + ex[(long long)v * nb + b];
      s_frz[e][i] = (fz != nullptr && fz[(long long)v * nb + b] > 0.0f) ? 1 : 0;
    }
  }
  __syncthreads();

  const int j = blockIdx.x * SB + t;
  if (j >= n) return;
  float m0[2] = {0.0f, 0.0f};
  float m1[2] = {0.0f, 0.0f};
  for (int i = 0; i < nv; ++i) {
    const float* row = wide + (long long)(v0 + i) * wide_stride;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float s = ear_sample(row, S2, s_base[e][i], s_sc[e][i][0],
                                 s_sc[e][i][1], s_sc[e][i][2],
                                 __fsub_rn(s_sc[e][i][3], 1.0f), K,
                                 s_frz[e][i] ? 0 : j);
      m0[e] = __fadd_rn(m0[e], __fmul_rn(s_g[e][i][0], s));
      m1[e] = __fadd_rn(m1[e], __fmul_rn(s_g[e][i][1], s));
    }
  }
  // part layout: [b][chunk][ear][m0 | m1][n]
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    float* p = part + (((long long)b * nchunks + chunk) * 2 + e) * 2 * n;
    p[j] = m0[e];
    p[n + j] = m1[e];
  }
}

__global__ void select_reduce_kernel(const float* __restrict__ part,
                                     float* __restrict__ out, int n, int nb,
                                     int nchunks) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 2 * nb * n) return;
  const int e = idx / (nb * n);
  const int r = idx % (nb * n);
  const int b = r / n;
  const int j = r % n;
  float m0 = 0.0f;
  float m1 = 0.0f;
  for (int c = 0; c < nchunks; ++c) {
    const float* p = part + (((long long)b * nchunks + c) * 2 + e) * 2 * n;
    m0 = __fadd_rn(m0, p[j]);
    m1 = __fadd_rn(m1, p[n + j]);
  }
  out[(long long)e * nb * n + (long long)b * n + j] =
      __fadd_rn(m0, __fmul_rn((float)j, m1));
}

extern "C" int window_select(const float* wide, long long wide_stride, int S2,
                             const int* rowshift, const float* sc0,
                             const float* sc1, const float* g0,
                             const float* g1, const int* e0, const int* e1,
                             const float* f0, const float* f1, float* part,
                             float* out, int V, int n, int K, int nb,
                             const int* col0s, const int* hcaps,
                             cudaStream_t stream) {
  if (nb < 1 || nb > MAX_NB || V < 1 || n < 1) return (int)cudaErrorInvalidValue;
  BlockCfg cfg;
  for (int b = 0; b < MAX_NB; ++b) {
    cfg.col0[b] = col0s[b];
    cfg.hcap[b] = hcaps[b] > 0 ? hcaps[b] : 1;
  }
  const int nchunks = (V + VC - 1) / VC;
  dim3 grid((n + SB - 1) / SB, nchunks, nb);
  select_partial_kernel<<<grid, SB, 0, stream>>>(
      wide, wide_stride, S2, rowshift, sc0, sc1, g0, g1, e0, e1, f0, f1,
      part, V, n, K, nb, cfg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = 2 * nb * n;
  select_reduce_kernel<<<(total + 255) / 256, 256, 0, stream>>>(
      part, out, n, nb, nchunks);
  return (int)cudaGetLastError();
}
