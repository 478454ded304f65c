// K5: the host buffered pool's two-ear delay-ring read, for Hopper (sm_90a).
//
// Built by oddio_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded through ctypes.
// The entry point launches on the stream it is given, allocates nothing,
// does not synchronise, and returns cudaGetLastError() after its launch.
//
// Replaces oddio_tpu/ops/pallas_ring.py::strip_select (_select_kernel,
// _ear_pipeline, _positions_sb, _realign_rows, _gather3).  For each voice
// v, ear e and 128-frame sub-block of frames j:
//   kk_j  = clip(whole_j - j + K, 0, 2K), fr_j from the exact split-ds math
//   kmin  = min of kk over the WHOLE sub-block (frames past n included)
//   a_j   = ring[v, (128*rrow + extra_e + j + kmin + min(kk_j - kmin, R-1)) mod L]
//   b_j   = the next sample (mod L);  s = a + fr*(b - a)
//   out[e, j] = sum_v (s * (g0_e + j*dg_e)) * mask_v
// Scene axis (ScenePack): the V rows are S scenes of vps voices each, and
// each scene's voices are summed apart into out (S, 2, n).  One scene is
// S = 1, vps = V.
// The min(., R-1) clamp (SELECT_R = 16) is part of what the TPU kernel
// computes (its realign reaches kmin + 15 at most); it binds for voices
// whose |ds - 1|*127 exceeds 15, and is reproduced here and in the plain
// version.
//
// Bound on the H100: bytes.  Per voice and ear the read touches about
// n + |ds-1|*n + 1 contiguous floats of the ring (~2.1 KB at n = 512), so
// at 4096 voices the kernel must read ~9.5 MB, against ~22 f32 operations
// per (voice, ear, frame).
//
// Design: one launch.  A CUDA block owns one 128-frame sub-block of VC = 32
// voices, one thread per frame.
// * One staged window per voice.  Both ears of a (voice, sub-block) read
//   within [start_e, start_e + 144) of the ring, start_e = 128*rrow +
//   extra_e + j0 + kmin_e: 128 frames, the SELECT_R - 1 walk residual and
//   the b tap.  The union of the two ears' windows, from the 16-byte floor
//   of the earlier start, is copied once into shared memory with 16-byte
//   cp.async copies: at most 3 + (extra spread < 161) + (kmin spread <= 2K
//   = 128) + 144 = 436 floats, so the stage holds STAGE = 448 floats per
//   voice and one copy per thread fills it.  A window that crosses the
//   ring's end is two runs; each 16-byte vector lies in one of them (L is a
//   multiple of 4), so the wrap is one compare per vector.  The block's
//   voices stage in groups of VH = 8, one commit group each, into two
//   buffers: group g + 1's windows land while group g is read.  Both ears'
//   a and b taps then read shared memory, and each ring sample leaves
//   device memory once per sub-block (the TPU kernel's one gathered window
//   per voice, pallas_ring.py:362).  A window that does not fit (operands
//   outside the pool's contract, a ring not 16-byte aligned or shorter
//   than the stage) is read from device memory directly.
// * Registers and shared memory sized for residency: the positions are
//   computed twice (for the sub-block minimum, then for the read) rather
//   than held for 32 voices, and two groups of 8 voices stage at a time,
//   so the 512-block grid of 4096 voices (n = 512) is resident at once.  A
//   masked voice adds nothing and is skipped after its operands load.
// * 32-bit index math: the ring offset is reduced mod L once per (voice,
//   ear, sub-block); per-frame offsets into the stage are small ints.
// * A fixed-order voice sum, no float atomics: each thread adds its block's
//   voices in order; the blocks of a thread block cluster (up to 8 along
//   the voice axis) add their partials through distributed shared memory
//   in rank order; where the grid holds several clusters, each writes its
//   partial to scratch and the last cluster to finish a sub-block (a
//   device ticket, __threadfence) adds them in cluster order and resets the
//   ticket.  One cluster (vps <= 256) writes the output directly: no
//   scratch, no ticket.
// * Scenes: each scene owns its own blocks and clusters (cps clusters of
//   cl blocks), so no block or cluster straddles two scenes: a scene whose
//   vps is not a multiple of VC ends in a short block, and the partials
//   and tickets are kept per (scene, sub-block).  One launch for all S.
// --fmad=false and the _rn intrinsics keep the position math, the lerp and
// the gain ramp rounded op by op, as the plain version is.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define SB 128           // frames per sub-block = threads per CUDA block
#define VC 32            // voices per CUDA block
#define CL_MAX 8         // CUDA blocks per cluster (the portable maximum)
#define SELECT_R 16      // residual walk clamp of the TPU kernel (pallas_ring.py:258)
#define EAR_WIN (SB + SELECT_R)  // floats one ear reads from its start
#define STAGE 448        // staged floats per voice (see above)
#define VH 8             // voices staged per group; two groups' buffers

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

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Operands are read field by field, each with its own voice stride: the
// record form points every field into one (V, 20)-word record row, the
// tensor form at its own (V, ...) tensor.
__global__ void __launch_bounds__(SB) strip_select_kernel(
    const float* __restrict__ ring, int L, int can_stage,
    const int* __restrict__ rrow, int st_rrow,
    const int* __restrict__ extra, int st_extra,
    const float* __restrict__ scal, int st_scal,
    const float* __restrict__ g0, const float* __restrict__ dg, int st_g,
    const float* __restrict__ maskf, int st_mask,
    float* __restrict__ part, unsigned* __restrict__ ticket,
    float* __restrict__ out, int vps, int n, int K, int cps) {
  __shared__ __align__(16) float s_win[2][VH][STAGE];
  __shared__ float4 s_pos[VC][2];  // [frac, f_hi, f_lo, ds_int - 1] per ear
  __shared__ float4 s_rd[VC][2];   // [g0, dg, kmin, start in the stage]
  __shared__ float s_m[VC];        // mask; 0: the voice adds nothing
  __shared__ int s_base[VC][2];    // (128*rrow + extra_e + j0) mod L
  __shared__ int s_wmin[SB / 32][VC][2];
  __shared__ int s_start[VC][2];   // each ear's read start, mod L
  __shared__ int s_lo[VC];         // the staged window's 16-byte start, mod L
  __shared__ int s_nq[VC];         // its 16-byte vectors (0: read directly)
  __shared__ float s_acc[2][SB];
  __shared__ int s_last;

  cg::cluster_group cluster = cg::this_cluster();
  const unsigned csize = cluster.num_blocks();
  const int per_scene = cps * (int)csize;  // CUDA blocks per scene
  const int sc = blockIdx.x / per_scene;
  const int lb = blockIdx.x % per_scene;   // the block within its scene
  const int sb = blockIdx.y;
  const int j0 = sb * SB;
  const int v0 = sc * vps + lb * VC;
  const int nv = max(0, min(VC, vps - lb * VC));
  const int t = threadIdx.x;
  const int j = j0 + t;
  const float tf = (float)j;

  // 1. the block's voices' operands; each ear's base reduced mod L once
  if (t < 2 * VC) {
    const int i = t >> 1;
    const int e = t & 1;
    if (i < nv) {
      const long long v = v0 + i;
      const float* sc = scal + v * st_scal + 4 * e;
      s_pos[i][e] = make_float4(sc[0], sc[1], sc[2], __fsub_rn(sc[3], 1.0f));
      s_rd[i][e] = make_float4(g0[v * st_g + e], dg[v * st_g + e], 0.0f, 0.0f);
      if (e == 0) s_m[i] = maskf[v * st_mask];
      long long b = (128LL * rrow[v * st_rrow] + extra[v * st_extra + e] + j0) % L;
      s_base[i][e] = (int)(b < 0 ? b + L : b);
    }
  }
  __syncthreads();

  // Each (voice, ear)'s smallest walk offset kmin over the sub-block (all
  // 128 frames, also past n).  kk is monotone in the frame (the read
  // position is linear in it), so the first pass takes the smaller of the
  // two end frames' kk; the reads then check every frame's kk against it,
  // and a sub-block where the f32 position math broke the order (a
  // rounding at a sample boundary) is done again in a second pass with
  // the minimum over all frames.
  float acc[2];
  for (int pass = 0;; ++pass) {
    if (pass == 0) {
      if (t < 2 * VC && (t >> 1) < nv) {
        const int i = t >> 1;
        const int e = t & 1;
        const float4 P = s_pos[i][e];
        int k0, k1;
        float f;
        position(P.x, P.y, P.z, P.w, K, (float)j0, &k0, &f);
        position(P.x, P.y, P.z, P.w, K, (float)(j0 + SB - 1), &k1, &f);
        s_wmin[0][i][e] = min(k0, k1);
      }
    } else {
      for (int i = 0; i < nv; ++i) {  // uniform over the block
        if (s_m[i] == 0.0f) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float4 P = s_pos[i][e];
          int kk;
          float f;
          position(P.x, P.y, P.z, P.w, K, tf, &kk, &f);
          const int wmin = __reduce_min_sync(0xffffffffu, kk);
          if ((t & 31) == 0) s_wmin[t >> 5][i][e] = wmin;
        }
      }
    }
    __syncthreads();

    // one window per voice: the union of both ears' reads
    if (t < nv && s_m[t] != 0.0f) {
      const int i = t;
      int st[2], kmin[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        kmin[e] = s_wmin[0][i][e];
        if (pass > 0) {
#pragma unroll
          for (int w = 1; w < SB / 32; ++w) kmin[e] = min(kmin[e], s_wmin[w][i][e]);
        }
        st[e] = (s_base[i][e] + kmin[e]) % L;
        s_start[i][e] = st[e];
      }
      int d = st[1] - st[0];  // ear 1's lead over ear 0 on the ring
      if (d < 0) d += L;
      const bool lo0 = d <= L - d;
      const int lo = lo0 ? st[0] : st[1];
      const int head = lo & 3;
      const int lead = lo0 ? d : L - d;
      const int nq = (head + lead + EAR_WIN + 3) >> 2;
      const bool fits = can_stage && 4 * nq <= STAGE && 4 * nq <= L;
      const int off[2] = {head + (lo0 ? 0 : lead), head + (lo0 ? lead : 0)};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s_rd[i][e].z = __int_as_float(kmin[e]);
        s_rd[i][e].w = __int_as_float(off[e]);
      }
      s_lo[i] = lo - head;
      s_nq[i] = fits ? nq : 0;
    }
    __syncthreads();

    // in groups of VH voices, double-buffered: group g + 1's windows are
    // in flight (one commit group) while group g is read.  Voices add in
    // order.
    auto stage = [&](int h, int buf) {
#pragma unroll
      for (int q = 0; q < VH; ++q) {
        const int i = h + q;
        if (i < nv && s_m[i] != 0.0f && t < s_nq[i]) {  // nq <= STAGE/4 < SB
          int g = s_lo[i] + 4 * t;
          if (g >= L) g -= L;  // the run past the ring's end
          cp_async16(&s_win[buf][q][4 * t], ring + (long long)(v0 + i) * L + g);
        }
      }
      cp_async_commit();
    };
    acc[0] = acc[1] = 0.0f;
    bool early = false;  // a frame whose kk is below the first pass's kmin
    stage(0, 0);
    for (int h = 0, buf = 0; h < nv; h += VH, buf ^= 1) {
      if (h + VH < nv) {
        stage(h + VH, buf ^ 1);  // its buffer's reads ended at the last barrier
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // group h has landed, every thread's copies
#pragma unroll
      for (int q = 0; q < VH; ++q) {
        const int i = h + q;
        if (i >= nv) break;  // uniform over the block
        const float m = s_m[i];
        if (m == 0.0f) continue;
        const float* row = ring + (long long)(v0 + i) * L;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float4 P = s_pos[i][e];
          const float4 R = s_rd[i][e];
          int kk;
          float fr;
          position(P.x, P.y, P.z, P.w, K, tf, &kk, &fr);
          const int kmin = __float_as_int(R.z);
          early |= kk < kmin;
          if (j >= n) continue;
          // (>= 0 but where the first pass's kmin is wrong; redone then)
          const int r = max(min(kk - kmin, SELECT_R - 1), 0);
          float a, b;
          if (s_nq[i]) {
            const int mm = __float_as_int(R.w) + t + r;
            a = s_win[buf][q][mm];
            b = s_win[buf][q][mm + 1];
          } else {
            const int mm = (s_start[i][e] + t + r) % L;
            a = row[mm];
            b = row[mm + 1 == L ? 0 : mm + 1];
          }
          const float s = __fadd_rn(a, __fmul_rn(fr, __fsub_rn(b, a)));
          const float x = __fmul_rn(s, __fadd_rn(R.x, __fmul_rn(tf, R.y)));
          acc[e] = __fadd_rn(acc[e], __fmul_rn(x, m));
        }
      }
      __syncthreads();  // buffer buf is read: group h + 2 may land there
    }
    // (the second pass's kmin is every frame's minimum: it never repeats)
    if (pass > 0 || !__syncthreads_or(early)) break;
  }

  // 6. the cluster's sum, in rank order, through distributed shared memory
  s_acc[0][t] = acc[0];
  s_acc[1][t] = acc[1];
  cluster.sync();
  const unsigned rank = cluster.block_rank();
  float sum[2] = {0.0f, 0.0f};
  if (rank == 0) {
    for (unsigned q = 0; q < csize; ++q) {
      const float* peer = cluster.map_shared_rank(&s_acc[0][0], q);
      sum[0] = __fadd_rn(sum[0], peer[t]);
      sum[1] = __fadd_rn(sum[1], peer[SB + t]);
    }
  }
  cluster.sync();  // the peers' shared memory outlives rank 0's reads
  if (rank != 0) return;
  float* o = out + (long long)sc * 2 * n;
  if (cps == 1) {
    if (j < n) {
      o[j] = sum[0];
      o[n + j] = sum[1];
    }
    return;
  }

  // 7. several clusters in the scene: the last to finish this sub-block
  // adds their partials in cluster order
  const long long slot = (long long)sc * gridDim.y + sb;
  float* p = part + (slot * cps + lb / (int)csize) * 2 * SB;
  p[t] = sum[0];
  p[SB + t] = sum[1];
  __threadfence();
  __syncthreads();
  if (t == 0) s_last = atomicAdd(&ticket[slot], 1u) == (unsigned)cps - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  float tot[2] = {0.0f, 0.0f};
  const float* pq = part + slot * cps * 2 * SB;
#pragma unroll 8
  for (int q = 0; q < cps; ++q) {
    tot[0] = __fadd_rn(tot[0], __ldcg(pq + q * 2 * SB + t));
    tot[1] = __fadd_rn(tot[1], __ldcg(pq + q * 2 * SB + SB + t));
  }
  if (j < n) {
    o[j] = tot[0];
    o[n + j] = tot[1];
  }
  if (t == 0) ticket[slot] = 0;
}

// V rows of S = V / vps scenes.  part: S x (n/128 rounded up) x clusters
// per scene x 2 x 128 floats; ticket: one zeroed uint per (scene,
// sub-block), left zeroed (both unused, and may be null, when one cluster
// holds a scene).  out: (S, 2, n).
extern "C" int strip_select(const float* ring, int L, int can_stage,
                            const int* rrow, int st_rrow, const int* extra,
                            int st_extra, const float* scal, int st_scal,
                            const float* g0, const float* dg, int st_g,
                            const float* maskf, int st_mask, float* part,
                            unsigned* ticket, float* out, int V, int vps, int n,
                            int K, cudaStream_t stream) {
  if (V < 1 || vps < 1 || V % vps || n < 1 || L < 2) return (int)cudaErrorInvalidValue;
  const int S = V / vps;
  const int bps = (vps + VC - 1) / VC;  // CUDA blocks of each scene's voices
  int cl = 1;
  while (cl < bps && cl < CL_MAX) cl <<= 1;
  const int cps = (bps + cl - 1) / cl;
  if (cps > 1 && (part == nullptr || ticket == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S * cps * cl, (n + SB - 1) / SB, 1);
  cfg.blockDim = dim3(SB, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, strip_select_kernel, ring, L, can_stage, rrow, st_rrow, extra,
      st_extra, scal, st_scal, g0, dg, st_g, maskf, st_mask, part, ticket, out, vps,
      n, K, cps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
