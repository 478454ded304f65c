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

#include "append.cuh"

#define SB 128      // frames per CUDA block (threads) in the select kernels
#define VC 16       // voices per CUDA block: one partial sum per chunk
#define MAX_NB 8    // blocks a multi-block select may fuse

// ---------------------------------------------------------------------------
// K1: rows_append, rows_append_cursor
//
// Replaces oddio_tpu/ops/pallas_ring.py::rows_append_dma
// (_rows_append_kernel): two strided HBM->HBM DMAs per voice tile, the
// (V, W) slab written into every voice's rows-native ring (V, RPV, 128)
// at row r0 and at row rmir0.
//
// Bound on the H100: bytes only, the slab read once and written twice,
// 12*V*W bytes (25.2 MB per block at V = 4096, W = 512), no arithmetic.
// Design: append.cuh's slab append (a column of CUDA blocks per voice, one
// thread per 16-byte vector, both legs stored from one load).  The main
// path's slab is 512 frames of a 513-frame render, rows not 16-byte
// aligned, which append.cuh loads as scalars.  A ring row is 128 floats
// (512 bytes), so both legs take 16-byte stores.  The rows come by value
// (host ints) or from device int32 arrays, so the caller never reads them
// back to the host; the cursor form derives them on the device from the
// pool's write cursor, as oddio_tpu/spatial.py derives them beside the
// call:
//   r0 = (FP + start) // 128,
//   rm = (FP + (start < M ? start + cap : cap + M)) // 128
// (floor division), so the caller launches nothing else.  A leg outside
// the ring trips a device-side assert, as the plain version raises.
//
// Scene axis (ScenePack): the V rows are S scenes of vps voices each, and
// each leg (or the cursor) holds one value per scene; voice v uses its
// scene's, index v / vps.  One scene is S = 1, vps = V.
// ---------------------------------------------------------------------------

__device__ __forceinline__ int floor_div128(int x) {
  return x >= 0 ? x / 128 : -((-x + 127) / 128);
}

// voice v's leg offsets from its rows a (primary) and b (mirror)
__device__ __forceinline__ void row_legs(int a, int b, int RPV, int nr,
                                         long long& o0, long long& o1) {
  assert(a >= 0 && a + nr <= RPV && b >= 0 && b + nr <= RPV);
  o0 = 128LL * a;
  o1 = 128LL * b;
}

struct RowLegs {
  const int* r0p;  // (S,) device rows, or null: r0 for every scene
  const int* r1p;
  int r0, r1, vps, RPV, nr;
  __device__ void operator()(int v, long long& o0, long long& o1) const {
    const int sc = v / vps;
    row_legs(r0p ? r0p[sc] : r0, r1p ? r1p[sc] : r1, RPV, nr, o0, o1);
  }
};

struct CursorLegs {
  const int* start;  // (S,) device write cursors
  int FP, cap, M, vps, RPV, nr;
  __device__ void operator()(int v, long long& o0, long long& o1) const {
    const int st = start[v / vps];
    row_legs(floor_div128(FP + st),
             floor_div128(FP + (st < M ? st + cap : cap + M)), RPV, nr, o0, o1);
  }
};

// r0p/r1p: (S,) device int32 rows, or null to take r0/r1 for every scene.
extern "C" int rows_append(float* ring, const float* slab,
                           long long slab_stride, const int* r0p,
                           const int* r1p, int r0, int r1, int V, int RPV,
                           int nr, int vps, cudaStream_t stream) {
  if (vps < 1 || V % vps || nr < 1) return (int)cudaErrorInvalidValue;
  const append::Slab s{slab, slab_stride, ring, RPV * 128LL, V, nr * 128};
  return append::launch(s, RowLegs{r0p, r1p, r0, r1, vps, RPV, nr}, stream);
}

// start: (S,) device int32 write cursors.
extern "C" int rows_append_cursor(float* ring, const float* slab,
                                  long long slab_stride, const int* start,
                                  int FP, int cap, int M, int V, int RPV,
                                  int nr, int vps, cudaStream_t stream) {
  if (vps < 1 || V % vps || nr < 1 || start == nullptr)
    return (int)cudaErrorInvalidValue;
  const append::Slab s{slab, slab_stride, ring, RPV * 128LL, V, nr * 128};
  return append::launch(s, CursorLegs{start, FP, cap, M, vps, RPV, nr}, stream);
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
//
// Scene axis (ScenePack, K2): the V rows are S scenes of vps voices each
// and the output is (S, 2, nb*n), each scene's voices summed apart, as a
// vmapped pallas_call sums them.  A scene has its own ceil(vps / VC)
// chunks, so no chunk straddles two scenes, and the reduction adds each
// scene's chunks in order.  One scene is S = 1, vps = V.
//
// K8: window_select (_select_flat_kernel) is this kernel on flat windows:
// rowshift absent (0), H = 1, the window at column 0, no frozen flags;
// window_select_flat below is its entry.
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
    const float* __restrict__ f1, float* __restrict__ part, int vps, int n,
    int K, int nb, BlockCfg cfg) {
  __shared__ float s_sc[2][VC][4];
  __shared__ float s_g[2][VC][2];
  __shared__ int s_base[2][VC];
  __shared__ int s_frz[2][VC];

  const int chunk = blockIdx.y;
  const int nchunks = gridDim.y;
  const int b = blockIdx.z;
  const int cps = (vps + VC - 1) / VC;  // chunks per scene
  const int lc = chunk % cps;
  const int v0 = (chunk / cps) * vps + lc * VC;
  const int nv = min(VC, vps - lc * VC);
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
      int sh = rowshift != nullptr ? rowshift[(long long)v * nb + b] : 0;
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
                                     int S, int cps) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= S * 2 * nb * n) return;
  const int s = idx / (2 * nb * n);
  const int q = idx % (2 * nb * n);
  const int e = q / (nb * n);
  const int r = q % (nb * n);
  const int b = r / n;
  const int j = r % n;
  const int nchunks = S * cps;
  float m0 = 0.0f;
  float m1 = 0.0f;
  for (int c = s * cps; c < (s + 1) * cps; ++c) {
    const float* p = part + (((long long)b * nchunks + c) * 2 + e) * 2 * n;
    m0 = __fadd_rn(m0, p[j]);
    m1 = __fadd_rn(m1, p[n + j]);
  }
  out[(long long)s * 2 * nb * n + (long long)e * nb * n + (long long)b * n + j] =
      __fadd_rn(m0, __fmul_rn((float)j, m1));
}

static int launch_select(const float* wide, long long wide_stride, int S2,
                         const int* rowshift, const float* sc0,
                         const float* sc1, const float* g0, const float* g1,
                         const int* e0, const int* e1, const float* f0,
                         const float* f1, float* part, float* out, int V,
                         int vps, int n, int K, int nb, const BlockCfg& cfg,
                         cudaStream_t stream) {
  if (nb < 1 || nb > MAX_NB || V < 1 || n < 1 || vps < 1 || V % vps)
    return (int)cudaErrorInvalidValue;
  const int S = V / vps;
  const int cps = (vps + VC - 1) / VC;
  dim3 grid((n + SB - 1) / SB, S * cps, nb);
  select_partial_kernel<<<grid, SB, 0, stream>>>(
      wide, wide_stride, S2, rowshift, sc0, sc1, g0, g1, e0, e1, f0, f1,
      part, vps, n, K, nb, cfg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = S * 2 * nb * n;
  select_reduce_kernel<<<(total + 255) / 256, 256, 0, stream>>>(
      part, out, n, nb, S, cps);
  return (int)cudaGetLastError();
}

// K2/K3.  part holds nb * S * ceil(vps / VC) * 4 * n floats; out (S, 2, nb*n).
extern "C" int window_select(const float* wide, long long wide_stride, int S2,
                             const int* rowshift, const float* sc0,
                             const float* sc1, const float* g0,
                             const float* g1, const int* e0, const int* e1,
                             const float* f0, const float* f1, float* part,
                             float* out, int V, int vps, int n, int K, int nb,
                             const int* col0s, const int* hcaps,
                             cudaStream_t stream) {
  BlockCfg cfg;
  for (int b = 0; b < MAX_NB; ++b) {
    cfg.col0[b] = col0s[b];
    cfg.hcap[b] = hcaps[b] > 0 ? hcaps[b] : 1;
  }
  return launch_select(wide, wide_stride, S2, rowshift, sc0, sc1, g0, g1, e0,
                       e1, f0, f1, part, out, V, vps, n, K, nb, cfg, stream);
}

// K8 (oddio_tpu/ops/pallas_ring.py::window_select): both ears' reads from
// one flat window per voice starting at column 0, no realign, no frozen
// flags; the mask rides folded into g0/g1.  part holds
// ceil(V / VC) * 4 * n floats; out (2, n).
extern "C" int window_select_flat(const float* windows, long long stride,
                                  int S, const float* sc0, const float* sc1,
                                  const float* g0, const float* g1,
                                  const int* e0, const int* e1, float* part,
                                  float* out, int V, int n, int K,
                                  cudaStream_t stream) {
  BlockCfg cfg;
  for (int b = 0; b < MAX_NB; ++b) {
    cfg.col0[b] = 0;
    cfg.hcap[b] = 1;
  }
  return launch_select(windows, stride, S, nullptr, sc0, sc1, g0, g1, e0, e1,
                       nullptr, nullptr, part, out, V, V, n, K, 1, cfg,
                       stream);
}
