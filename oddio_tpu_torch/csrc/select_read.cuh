// The exact split-ds read position (K2/K3, K8, K10) and the flat-window
// select body K8 and K10 share, for Hopper (sm_90a).  Included by
// ring_kernels.cu (K2/K3's position, K8's entry) and flat_kernels.cu
// (K10's entry); built with their flags (--fmad=false), so every multiply
// and add below is rounded on its own.

#pragma once

#include <assert.h>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

// floor(x) for |x| < 2^22 with two full-rate adds instead of a quarter-rate
// FRND: x + 1.5*2^23 lies in [2^23, 2^24), where floats are the integers,
// so rounding it down and taking 1.5*2^23 away again is exactly floor(x).
#define MAGIC 12582912.0f  // 1.5 * 2^23, bits 0x4B400000
__device__ __forceinline__ float floor_small(float x) {
  return __fsub_rn(__fadd_rd(x, MAGIC), MAGIC);
}

// The exact read offset kk = clip(whole - j + K, 0, 2K) and fraction fr of
// frame t (< 4096) from a cursor's packed scalars: oddio_tpu/ops/_dev.py's
// split-ds math (_positions_sb, pallas_ring.py:265), rounded op by op.  H <
// 4096 and u in (-1, 2) (o0 in [0, 1)), so floor_small is floorf there; kk
// is an integer-valued float in [0, 2K], so its int is the low mantissa bits
// of kk + 1.5*2^23 (no quarter-rate F2I).
__device__ __forceinline__ void position(float o0, float f_hi, float f_lo,
                                         float dsm1, int K, float t, int* kk,
                                         float* fr) {
  const float H = __fmul_rn(t, f_hi);  // exact: 12-bit f_hi, t < 4096
  const float Hf = floor_small(H);
  const float u = __fadd_rn(__fsub_rn(H, Hf), __fadd_rn(o0, __fmul_rn(t, f_lo)));
  const float fl_u = floor_small(u);
  *fr = __fsub_rn(u, fl_u);
  float k = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(t, dsm1), Hf), fl_u),
                      (float)K);
  k = fminf(fmaxf(k, 0.0f), (float)(2 * K));
  *kk = __float_as_int(__fadd_rn(k, MAGIC)) - 0x4B400000;
}

// ---------------------------------------------------------------------------
// K8 and K10: the flat-window select (no path)
//
// For each voice v, ear e and frame j < n (kk_j, fr_j from position()):
//   a  = row_v[extra_e + j + kk_j],  b = the next sample,  s = a + fr*(b - a)
//   K8:  row_v = windows + v*stride;
//        out[e, j] = (sum_v g0m·s) + j*(sum_v dgm·s), [g0m, dgm] = [g0, dg]·mask
//        (the JAX package's _mix_rows form);
//   K10: row_v = ring + v*rowlen + rstart_v (the flat ring: a window past
//        its row end reads the next row, as the TPU's DMA does);
//        out[e, j] = sum_v (s·(g0 + j*dg))·mask (the TPU kernel's summands).
//
// Bound on the H100: bytes, ~2.1 KB read per voice and ear (n + 2K + 2
// floats at most), against ~21-23 f32 operations per (voice, ear, frame).
//
// Design: K2's (ring_kernels.cu ring_select), one launch per call.
// * Operands read where they lie: the wrapper passes each operand's
//   pointer and element strides (FlatOps), so a view that is not
//   contiguous costs no copy, and the wrapper launches nothing before the
//   kernel.  One thread per voice builds that voice's values in shared
//   memory: the four cursor scalars per ear, the gains (K8 folds the mask
//   in with __fmul_rn, rounding exactly as [g0, dg]·mask does), the
//   staggers and the row base.
// * Bounds, once per voice: K10's fetch [v*rowlen + 1024*floor(rstart/1024),
//   +2048) must lie in the ring, and each stagger in [0, emax2).  The
//   wrappers' contracts then put every tap inside the row: K8's window
//   width S >= select_window(n, emax2, K) >= n + emax2 + 2K + 1, and K10's
//   7*128 + select_window(n, 127 + emax2, K) <= 2048, which holds the taps
//   (rstart mod 1024 + extra_e + n + 2K at most past the fetch's start)
//   inside the fetch.  So no tap checks its address.
// * K2's voice loop: a CUDA block owns FS_VC = 32 voices and one 128-frame
//   sub-block, a thread per frame (and share of the voices, below); the
//   voice loop is unrolled 8 deep, taps go through __ldg (a warp's 32
//   frames of one ear lie within ~33 + |ds - 1|*32 floats: one or two
//   cache lines), positions come from position() (no quarter-rate floor or
//   conversion), and each tap is a 32-bit offset from the voice's 64-bit
//   row base.
// * K2's fixed-order voice sum, no float atomics, no second launch: the
//   blocks of a thread block cluster (up to FS_CL = 8 along the voice axis)
//   add their sums through distributed shared memory in rank order; where
//   several clusters hold the voices, each writes its partial to scratch
//   and the last to finish a sub-block (a device ticket, __threadfence)
//   adds them in cluster order and leaves its ticket zeroed.  Two calls on
//   the same inputs are bit-equal.
// * More loads in flight than K2: FS_SPLIT = 2 threads share a frame, each
//   taking a contiguous half of the block's 32 voices, their sums joined in
//   share order (256 threads a block, 131k at 4096 voices and n = 512).
//   On an H100 at 4096 voices that kept the warm device time of one thread
//   a frame (within the runs' spread) and took 19-30% off the cold one; 4
//   threads a frame and 16 voices a block were slower, 64 voices a block
//   (cold) too, clusters of 4 no faster (PERF.md section 6).
// ---------------------------------------------------------------------------

#define FS_SB 128     // frames per CUDA block and per sub-block
#define FS_VC 32      // voices per CUDA block
#define FS_CL 8       // CUDA blocks per cluster at most (the portable maximum)
#define FS_SPLIT 2    // threads per frame, each a share of the block's voices
#define FS_FETCH 2048  // K10's per-voice fetch: two 1024-sample pages

// A call's operands as they lie: pointers and element strides.
struct FlatOps {
  const float* src;  // K8: the windows; K10: the ring
  long long row;     // K8: the windows' row stride; K10: rowlen
  long long total;   // K10: the ring's elements (the fetch check)
  const float* scal;  // (V, 2, 4) [frac, f_hi, f_lo, ds_int]
  long long sc_v, sc_e, sc_k;
  const float* g0;  // (V, 2) gain at frame 0
  long long g0_v, g0_e;
  const float* dg;  // (V, 2) gain step per frame
  long long dg_v, dg_e;
  const float* mask;  // (V,) 0/1
  long long mk_v;
  const int* extra;  // (V, 2) per-ear staggers, below emax2
  long long ex_v, ex_e;
  const int* rstart;  // K10: (V,) window base columns
  long long rs_v;
  int emax2;
};

// FlatOps from the entry points' host arrays: ptrs = scal, gain0, d_gain,
// maskf, extra, rstart (or null); strides = scal's three, gain0's two,
// d_gain's two, maskf's, extra's two, rstart's (elements).
inline FlatOps flat_ops(const float* src, long long row, long long total,
                        const void* const* p, const long long* s, int emax2) {
  return FlatOps{src, row, total,
                 (const float*)p[0], s[0], s[1], s[2],
                 (const float*)p[1], s[3], s[4],
                 (const float*)p[2], s[5], s[6],
                 (const float*)p[3], s[7],
                 (const int*)p[4], s[8], s[9],
                 (const int*)p[5], s[10],
                 emax2};
}

template <bool DMA>
__global__ void __launch_bounds__(FS_SB * FS_SPLIT) flat_select_kernel(
    FlatOps A, float* __restrict__ part, unsigned* __restrict__ ticket,
    float* __restrict__ out, int V, int n, int K, int cps) {
  constexpr int NACC = DMA ? 2 : 4;  // K10: a sum per ear; K8: g0m·s, dgm·s per ear
  constexpr int SHARE = FS_VC / FS_SPLIT;
  __shared__ float4 s_pos[FS_VC][2];  // [frac, f_hi, f_lo, ds - 1] per ear
  __shared__ float2 s_g[FS_VC][2];    // K8 [g0, dg]·mask; K10 [g0, dg]
  __shared__ float s_m[FS_VC];        // K10's mask
  __shared__ int s_q[FS_VC][2];       // the ear's stagger past the row base
  __shared__ const float* s_row[FS_VC];
  __shared__ float s_acc[NACC][FS_SPLIT][FS_SB];
  __shared__ int s_last;

  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const unsigned csize = cluster.num_blocks();
  const int lb = blockIdx.x;
  const int nv = max(0, min(FS_VC, V - lb * FS_VC));
  const int y = blockIdx.y;
  const int tid = threadIdx.x;
  const int t = tid % FS_SB;  // the thread's frame in the sub-block
  const int h = tid / FS_SB;  // its share of the block's voices
  const int j = y * FS_SB + t;

  // 1. one thread per voice builds its values
  if (tid < nv) {
    const long long v = (long long)lb * FS_VC + tid;
    const float* row;
    if constexpr (DMA) {
      const int rs = A.rstart[v * A.rs_v];
      const int rw = rs >= 0 ? rs / 1024 : -((-rs + 1023) / 1024);
      const long long lo = v * A.row + 1024LL * rw;
      assert(lo >= 0 && lo + FS_FETCH <= A.total);  // the plain version raises
      row = A.src + (v * A.row + rs);
    } else {
      row = A.src + v * A.row;
    }
    const float m = A.mask[v * A.mk_v];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float* sc = A.scal + v * A.sc_v + e * A.sc_e;
      s_pos[tid][e] = make_float4(sc[0], sc[A.sc_k], sc[2 * A.sc_k],
                                  __fsub_rn(sc[3 * A.sc_k], 1.0f));
      const float g0 = A.g0[v * A.g0_v + e * A.g0_e];
      const float dg = A.dg[v * A.dg_v + e * A.dg_e];
      s_g[tid][e] = DMA ? make_float2(g0, dg) : make_float2(__fmul_rn(g0, m), __fmul_rn(dg, m));
      const int ex = A.extra[v * A.ex_v + e * A.ex_e];
      assert(ex >= 0 && ex < A.emax2);  // with the wrapper's width: every tap in the row
      s_q[tid][e] = ex;
    }
    s_m[tid] = m;
    s_row[tid] = row;
  }
  __syncthreads();

  // 2. each thread's frame, its share of the block's voices in order
  const float tf = (float)j;
  float acc[NACC];
#pragma unroll
  for (int k = 0; k < NACC; ++k) acc[k] = 0.0f;
  if (j < n) {
    const int i1 = min(nv, (h + 1) * SHARE);
#pragma unroll 8
    for (int i = h * SHARE; i < i1; ++i) {
      const float* row = s_row[i];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 P = s_pos[i][e];
        int kk;
        float fr;
        position(P.x, P.y, P.z, P.w, K, tf, &kk, &fr);
        const int q = s_q[i][e] + j + kk;
        const float a = __ldg(row + q);
        const float s = __fadd_rn(a, __fmul_rn(fr, __fsub_rn(__ldg(row + q + 1), a)));
        const float2 g = s_g[i][e];
        if constexpr (DMA) {
          const float x = __fmul_rn(s, __fadd_rn(g.x, __fmul_rn(tf, g.y)));
          acc[e] = __fadd_rn(acc[e], __fmul_rn(x, s_m[i]));
        } else {
          acc[2 * e] = __fadd_rn(acc[2 * e], __fmul_rn(g.x, s));
          acc[2 * e + 1] = __fadd_rn(acc[2 * e + 1], __fmul_rn(g.y, s));
        }
      }
    }
  }

  // 3. the cluster's sums, rank by rank and share by share (voice order),
  // through distributed shared memory
#pragma unroll
  for (int k = 0; k < NACC; ++k) s_acc[k][h][t] = acc[k];
  cluster.sync();
  const unsigned rank = cluster.block_rank();
  const bool lead = h == 0;  // the threads that sum and store
  float sum[NACC];
#pragma unroll
  for (int k = 0; k < NACC; ++k) sum[k] = 0.0f;
  if (rank == 0 && lead) {
    for (unsigned r = 0; r < csize; ++r) {
      const float* peer = cluster.map_shared_rank(&s_acc[0][0][0], r);
#pragma unroll
      for (int k = 0; k < NACC; ++k) {
#pragma unroll
        for (int s = 0; s < FS_SPLIT; ++s)
          sum[k] = __fadd_rn(sum[k], peer[(k * FS_SPLIT + s) * FS_SB + t]);
      }
    }
  }
  cluster.sync();  // the peers' shared memory outlives rank 0's reads
  if (rank != 0) return;
  auto store = [&](const float* x) {
    if constexpr (DMA) {
      out[j] = x[0];
      out[n + j] = x[1];
    } else {
      out[j] = __fadd_rn(x[0], __fmul_rn(tf, x[1]));
      out[n + j] = __fadd_rn(x[2], __fmul_rn(tf, x[3]));
    }
  };
  if (cps == 1) {
    if (lead && j < n) store(sum);
    return;
  }

  // 4. several clusters: the last to finish this sub-block adds their
  // partials in cluster order
  float* p = part + ((long long)y * cps + lb / (int)csize) * NACC * FS_SB;
  if (lead) {
#pragma unroll
    for (int k = 0; k < NACC; ++k) p[k * FS_SB + t] = sum[k];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&ticket[y], 1u) == (unsigned)cps - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (lead) {
    float tot[NACC];
#pragma unroll
    for (int k = 0; k < NACC; ++k) tot[k] = 0.0f;
    const float* pq = part + (long long)y * cps * NACC * FS_SB;
#pragma unroll 8
    for (int r = 0; r < cps; ++r) {
#pragma unroll
      for (int k = 0; k < NACC; ++k)
        tot[k] = __fadd_rn(tot[k], __ldcg(pq + (r * NACC + k) * FS_SB + t));
    }
    if (j < n) store(tot);
  }
  if (tid == 0) ticket[y] = 0;
}

// One launch over V voices and n frames.  part: ceil(n/128) * clusters *
// NACC * 128 floats and ticket one zeroed uint per sub-block, left zeroed
// (both unused, and may be null, where one cluster holds every voice).
template <bool DMA>
int flat_select_launch(const FlatOps& A, float* part, unsigned* ticket, float* out,
                       int V, int n, int K, cudaStream_t stream) {
  if (V < 1 || n < 1 || n > 4096 || K < 0 || A.emax2 < 1)
    return (int)cudaErrorInvalidValue;
  const int bps = (V + FS_VC - 1) / FS_VC;
  int cl = 1;
  while (cl < bps && cl < FS_CL) cl <<= 1;
  const int cps = (bps + cl - 1) / cl;
  if (cps > 1 && (part == nullptr || ticket == nullptr)) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cps * cl, (n + FS_SB - 1) / FS_SB, 1);
  cfg.blockDim = dim3(FS_SB * FS_SPLIT, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, flat_select_kernel<DMA>, A, part, ticket, out,
                                       V, n, K, cps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
