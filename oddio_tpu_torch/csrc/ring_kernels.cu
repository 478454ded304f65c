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
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "append.cuh"
#include "select_read.cuh"

namespace cg = cooperative_groups;

#define SB 128  // frames per CUDA block (threads) in K2/K3

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
// K2/K3: ring_select, the device-resident buffered pool's two-ear read
//
// Replaces oddio_tpu/ops/pallas_ring.py::window_select_tiles_ears
// (_select_tiles_kernel, with _realign_rows, _positions_sb,
// _ears_pipeline_flat, _gather_pair, _mix_rows) and
// window_select_tiles_multi (_select_tiles_multi_kernel), together with
// the read preparation oddio_tpu/spatial.py does around them
// (_BufferedPoolDR._windows_read and render_multi's superwindow): the
// shared-ear window start, the per-ear staggers, the granule gather, the
// coarse shift and the gain fold.
//
// For each read voice v (a pool voice, or a sub-pass list entry naming
// one), ear e, block b (K3: one of nb fused blocks; K2: nb = 1) and frame
// j of read chunk c (j0 = c*R; K3 blocks are one chunk each):
//   cursor  = block b's (base_e, frac_e) advanced c*R frames (device_advance)
//   ob_e    = base_e mod cap,  dlr = (ob0 - ob1) mod cap,  ahead = dlr <= DMAX
//   cm      = ahead ? ob1 : ob0
//   dstart  = [clip(ahead ? dlr : 0, 0, DMAX), clip(ahead ? 0 : cap - dlr, 0, DMAX)]
//   rstart  = (cm - K) mod cap + FP       (rstart0: block 0's)
//   X       = rstart0 - 1024*(rstart0 / 1024) + ((rstart - rstart0) mod cap)
//   sh      = clamp(X / 128 - row0[b], 0, hcap[b] - 1)
//   q       = 1024*(rstart0 / 1024) - FP + 128*(row0[b] + sh) + rstart % 128
//             + dstart_e + j + kk_j     (kk_j, fr_j: the exact split-ds math)
//   a_j     = ring[v, FP + q] (K2), ring[v, FP + q mod cap] (K3); b_j the next
//   s_j     = a + fr*(b - a)   (frz_e > 0 repeats j = 0)
//   m       = mask * tight (main pass), mask[v] * sub_on (sub-pass)
//   out[e, b*n + j0 + j] = sum_v ((p_gain + j0*d_gain)*m)*s + j*sum_v (d_gain*m)*s
// K2 is this with row0 = 0, hcap = 8 and no wrap, where q reduces to
// rstart - FP + dstart_e + j + kk_j: the parent's gathered window indexed
// at 128*rowshift + exr + dstart_e + j + kk_j.  The pool's read tiers keep
// that read inside [FP, FP + cap + M) (the mirror), so it never wraps.
// K3's superwindow was gathered granule-wise modulo cap/1024, which is the
// sample-wise wrap FP + (q mod cap); its coarse-shift clamp is kept, so an
// out-of-contract shift reads what the TPU kernel reads.
//
// Bound on the H100: bytes.  Per voice and ear a 512-frame read touches
// about n + |ds - 1|*n + 1 contiguous floats of the ring (~2.1 KB), ~10 MB
// at 4096 voices, against ~21 f32 operations per (voice, ear, frame).
//
// Design: one launch per read, no gather and no operand preparation
// before it (the gather form it replaces issued ~46 device launches per
// K2 read and ~163 per K3 group, and gathered each voice's window into a
// new tensor).
// * Operands read where they lie: each block's per-ear cursor, step,
//   gain, frozen flag and mask tensors come as device pointers in one
//   by-value struct per block (ReadArgs: nb <= 8 of them, ~1.2 KB of
//   kernel parameters).  One thread per voice rebuilds the window start,
//   staggers, coarse shift, chunk cursor and gain fold with the integer
//   and _rn float operations of the torch code it replaces, so every
//   value read stays what the parent read.
// * Reads through L1: a warp's 32 frames of one voice and ear lie within
//   about 33 + |ds - 1|*32 contiguous floats, so each load instruction
//   touches one or two 128-byte lines, and the lerp's b tap hits the
//   line the a tap brought in.  Staging each voice's window in shared
//   memory first (K5's design) took three times as long here, and 16 or
//   64 voices per block were slower too (PERF.md section 6).
// * Issue-bound: the loads are a quarter of the time (a variant with
//   no reads), so the voice loop is unrolled 8 deep and the position math
//   takes no quarter-rate floor or conversion (floor_small).
// * K5's fixed-order voice sum (select_kernel.cu): a CUDA block owns 32
//   voices and one 128-frame sub-block, one thread per frame, and adds
//   its voices in order into four sums (g0·s and dg·s per ear); the
//   blocks of a thread block cluster (up to 8 along the voice axis) add
//   theirs through distributed shared memory in rank order; where a scene
//   holds several clusters, each writes its partial to scratch and the
//   last to finish a sub-block (a device ticket, __threadfence) adds them
//   in cluster order and resets the ticket.  No float atomics, no partial
//   buffer per voice chunk, no second launch.
// * Scene axis (ScenePack): the V read rows are S scenes of vps voices
//   each; a scene owns its own clusters, so none straddles two scenes,
//   and the output is (S, 2, nb*n).  One scene is S = 1, vps = V.
// ---------------------------------------------------------------------------

#define RS_VC 32  // voices per CUDA block
#define RS_CL 8   // CUDA blocks per cluster at most (the portable maximum)
#define MAX_NB 8  // blocks one read may fuse (K3)
#define RS_PTRS 18  // pointers per block in the host array (BlockOps order)

struct EarOps {
  const int* base;   // (V,) int32 read cursor, pool index
  const float* frac;  // (V,) its fraction in [0, 1)
  const int* ds;      // (V,) int32 step, split: ds + f_hi + f_lo
  const float* fhi;
  const float* flo;
  const float* gain;   // (V,) gain at frame 0
  const float* dgain;  // (V,) gain step per frame
  const float* frz;    // (V,) frozen flag, or null
};

struct BlockOps {
  EarOps ear[2];
  const float* mask;   // (V,) 0/1
  const float* tight;  // (V,) main pass beside a sub-pass, or null
};

struct ReadArgs {
  BlockOps ops[MAX_NB];
  int row0[MAX_NB];  // K3's static coarse row of each block (K2: 0)
  int hcap[MAX_NB];  // its coarse-shift range (K2: 8)
};

__device__ __forceinline__ int imod(int x, int m) {
  const int r = x % m;
  return r < 0 ? r + m : r;
}

// oddio_tpu_torch/ops/_dev.py device_advance, rounded op by op
__device__ __forceinline__ void advance(int& base, float& frac, int count, int ds,
                                        float fhi, float flo) {
  const float cf = (float)count;
  const float H = __fmul_rn(cf, fhi);
  const float Hfl = floorf(H);
  const float u = __fadd_rn(__fsub_rn(H, Hfl), __fadd_rn(frac, __fmul_rn(cf, flo)));
  const float fl = floorf(u);
  base = base + count * ds + (int)Hfl + (int)fl;
  frac = __fsub_rn(u, fl);
}

// the shared-ear window start and the per-ear staggers (the two ears'
// starts differ by at most the inter-ear distance)
__device__ __forceinline__ void ear_starts(int b0, int b1, int cap, int DMAX, int K,
                                           int FP, int& rstart, int* d) {
  const int ob0 = imod(b0, cap);
  const int ob1 = imod(b1, cap);
  const int dlr = imod(ob0 - ob1, cap);
  const bool ahead = dlr <= DMAX;
  d[0] = min(max(ahead ? dlr : 0, 0), DMAX);
  d[1] = min(max(ahead ? 0 : cap - dlr, 0), DMAX);
  rstart = imod((ahead ? ob1 : ob0) - K, cap) + FP;
}

__global__ void __launch_bounds__(SB) ring_select_kernel(
    const float* __restrict__ ring, long long rowlen, int rows, ReadArgs A,
    const int* __restrict__ sub_idx, const float* __restrict__ sub_on,
    float* __restrict__ part, unsigned* __restrict__ ticket, float* __restrict__ out,
    int vps, int n, int R, int K, int DMAX, int FP, int cap, int wrap, int nb, int cps) {
  __shared__ float4 s_pos[RS_VC][2];  // [frac, f_hi, f_lo, ds - 1] per ear
  __shared__ float2 s_g[RS_VC][2];    // [g0, dg] per ear, the mask folded in
  __shared__ int s_q[RS_VC][2];       // frame 0's read offset past FP, before kk
  __shared__ int s_frz[RS_VC][2];
  __shared__ long long s_row[RS_VC];  // the voice row's column FP
  __shared__ float s_acc[4][SB];      // [ear][g0·s | dg·s] per frame
  __shared__ int s_last;

  cg::cluster_group cluster = cg::this_cluster();
  const unsigned csize = cluster.num_blocks();
  const int per_scene = cps * (int)csize;  // CUDA blocks per scene
  const int sc = blockIdx.x / per_scene;
  const int lb = blockIdx.x % per_scene;
  const int nv = max(0, min(RS_VC, vps - lb * RS_VC));
  const int nsb = (n + SB - 1) / SB;
  const int y = blockIdx.y;
  const int b = y / nsb;
  const int jb = (y % nsb) * SB;  // the sub-block's first frame in block b
  const int c = jb / R;           // its read chunk
  const int j0 = c * R;
  const int t = threadIdx.x;

  // 1. one thread per voice rebuilds its read operands
  if (t < nv) {
    const int vr = sc * vps + lb * RS_VC + t;
    const int v = sub_idx != nullptr ? sub_idx[vr] : vr;
    assert(v >= 0 && v < rows);
    const BlockOps& O = A.ops[b];
    float m = O.mask[v];
    if (O.tight != nullptr) m = __fmul_rn(m, O.tight[v]);
    if (sub_on != nullptr) m = __fmul_rn(m, sub_on[vr]);
    int base[2], ds[2];
    float frac[2], fhi[2], flo[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const EarOps& E = O.ear[e];
      base[e] = E.base[v];
      frac[e] = E.frac[v];
      ds[e] = E.ds[v];
      fhi[e] = E.fhi[v];
      flo[e] = E.flo[v];
      for (int k = 0; k < c; ++k) advance(base[e], frac[e], R, ds[e], fhi[e], flo[e]);
    }
    int rstart, d[2];
    ear_starts(base[0], base[1], cap, DMAX, K, FP, rstart, d);
    int rstart0 = rstart;
    if (b > 0) {  // K3: block 0 anchors the superwindow (one chunk per block)
      int d0[2];
      ear_starts(A.ops[0].ear[0].base[v], A.ops[0].ear[1].base[v], cap, DMAX, K, FP,
                 rstart0, d0);
    }
    const int base_col = rstart0 / 1024 * 1024;
    const int X = rstart0 - base_col + imod(rstart - rstart0, cap);
    const int sh = min(max(X / 128 - A.row0[b], 0), A.hcap[b] - 1);
    const int q0 = base_col - FP + 128 * (A.row0[b] + sh) + (rstart & 127);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const EarOps& E = O.ear[e];
      const float dg = E.dgain[v];
      s_q[t][e] = q0 + d[e];
      s_pos[t][e] = make_float4(frac[e], fhi[e], flo[e], __fsub_rn((float)ds[e], 1.0f));
      s_g[t][e] = make_float2(__fmul_rn(__fadd_rn(E.gain[v], __fmul_rn((float)j0, dg)), m),
                              __fmul_rn(dg, m));
      s_frz[t][e] = E.frz != nullptr && E.frz[v] > 0.0f;
    }
    s_row[t] = (long long)v * rowlen + FP;
  }
  __syncthreads();

  // 2. each thread's frame, every voice of the block in order
  const int jg = jb + t;   // frame in block b
  const int jl = jg - j0;  // frame in the read chunk
  const float tl = (float)jl;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (jg < n) {
#pragma unroll 8
    for (int i = 0; i < nv; ++i) {
      const float* row = ring + s_row[i];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 P = s_pos[i][e];
        const bool fz = s_frz[i][e];
        const int jj = fz ? 0 : jl;
        int kk;
        float fr;
        position(P.x, P.y, P.z, P.w, K, fz ? 0.0f : tl, &kk, &fr);
        int q = s_q[i][e] + jj + kk;
        int q1 = q + 1;
        if (wrap) {
          while (q >= cap) q -= cap;
          q1 = q + 1 == cap ? 0 : q + 1;
        }
        const float a = __ldg(row + q);
        const float s = __fadd_rn(a, __fmul_rn(fr, __fsub_rn(__ldg(row + q1), a)));
        const float2 g = s_g[i][e];
        acc[2 * e] = __fadd_rn(acc[2 * e], __fmul_rn(g.x, s));
        acc[2 * e + 1] = __fadd_rn(acc[2 * e + 1], __fmul_rn(g.y, s));
      }
    }
  }

  // 3. the cluster's sums, in rank order, through distributed shared memory
#pragma unroll
  for (int k = 0; k < 4; ++k) s_acc[k][t] = acc[k];
  cluster.sync();
  const unsigned rank = cluster.block_rank();
  float sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (rank == 0) {
    for (unsigned r = 0; r < csize; ++r) {
      const float* peer = cluster.map_shared_rank(&s_acc[0][0], r);
#pragma unroll
      for (int k = 0; k < 4; ++k) sum[k] = __fadd_rn(sum[k], peer[k * SB + t]);
    }
  }
  cluster.sync();  // the peers' shared memory outlives rank 0's reads
  if (rank != 0) return;
  const long long bn = (long long)nb * n;
  float* o = out + sc * 2 * bn + (long long)b * n + jg;
  const float jf = (float)jl;
  if (cps == 1) {
    if (jg < n) {
      o[0] = __fadd_rn(sum[0], __fmul_rn(jf, sum[1]));
      o[bn] = __fadd_rn(sum[2], __fmul_rn(jf, sum[3]));
    }
    return;
  }

  // 4. several clusters in the scene: the last to finish this sub-block
  // adds their partials in cluster order
  const long long slot = (long long)sc * gridDim.y + y;
  float* p = part + (slot * cps + lb / (int)csize) * 4 * SB;
#pragma unroll
  for (int k = 0; k < 4; ++k) p[k * SB + t] = sum[k];
  __threadfence();
  __syncthreads();
  if (t == 0) s_last = atomicAdd(&ticket[slot], 1u) == (unsigned)cps - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  float tot[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const float* pq = part + slot * cps * 4 * SB;
#pragma unroll 8
  for (int r = 0; r < cps; ++r) {
#pragma unroll
    for (int k = 0; k < 4; ++k) tot[k] = __fadd_rn(tot[k], __ldcg(pq + (r * 4 + k) * SB + t));
  }
  if (jg < n) {
    o[0] = __fadd_rn(tot[0], __fmul_rn(jf, tot[1]));
    o[bn] = __fadd_rn(tot[2], __fmul_rn(jf, tot[3]));
  }
  if (t == 0) ticket[slot] = 0;
}

// K2/K3.  ptrs: nb * RS_PTRS host pointers, per block ear 0's then ear 1's
// (base, frac, ds, f_hi, f_lo, gain, d_gain, frz or null), then mask and
// tight (or null); geo: nb host ints row0, then nb hcap.  sub_idx/sub_on:
// the sub-pass list (V entries naming pool voices), or null.  part: S *
// nb*ceil(n/128) * clusters * 4 * 128 floats and ticket one zeroed uint per
// (scene, sub-block), left zeroed (both unused, and may be null, where one
// cluster holds a scene).  out: (S, 2, nb*n).  K2 passes nb = 1, its read
// chunk R (a multiple of 128) and wrap = 0; K3 R >= n and wrap = 1.
extern "C" int ring_select(const float* ring, long long rowlen, int rows,
                           const void* const* ptrs, const int* geo,
                           const int* sub_idx, const float* sub_on, float* part,
                           unsigned* ticket, float* out, int V, int vps, int n,
                           int R, int K, int DMAX, int FP, int cap, int wrap, int nb,
                           cudaStream_t stream) {
  if (nb < 1 || nb > MAX_NB || V < 1 || vps < 1 || V % vps || n < 1 || R < SB ||
      R % SB || (nb > 1 && R < n) || cap < 1 || rows < 1)
    return (int)cudaErrorInvalidValue;
  ReadArgs A;
  for (int b = 0; b < nb; ++b) {
    const void* const* p = ptrs + b * RS_PTRS;
    BlockOps& O = A.ops[b];
    for (int e = 0; e < 2; ++e) {
      const void* const* q = p + 8 * e;
      O.ear[e] = EarOps{(const int*)q[0], (const float*)q[1], (const int*)q[2],
                        (const float*)q[3], (const float*)q[4], (const float*)q[5],
                        (const float*)q[6], (const float*)q[7]};
    }
    O.mask = (const float*)p[16];
    O.tight = (const float*)p[17];
    A.row0[b] = geo[b];
    A.hcap[b] = geo[nb + b] > 0 ? geo[nb + b] : 1;
  }
  const int S = V / vps;
  const int bps = (vps + RS_VC - 1) / RS_VC;
  int cl = 1;
  while (cl < bps && cl < RS_CL) cl <<= 1;
  const int cps = (bps + cl - 1) / cl;
  if (cps > 1 && (part == nullptr || ticket == nullptr)) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S * cps * cl, nb * ((n + SB - 1) / SB), 1);
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
  cudaError_t err = cudaLaunchKernelEx(&cfg, ring_select_kernel, ring, rowlen, rows, A,
                                       sub_idx, sub_on, part, ticket, out, vps, n, R, K,
                                       DMAX, FP, cap, wrap, nb, cps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// K8: window_select_flat (no path)
//
// Replaces oddio_tpu/ops/pallas_ring.py::window_select (_select_flat_kernel):
// both ears' reads from one flat window per voice, starting at column 0,
// the mask folded into the gains, mixed as sum_v g0m·s + j*sum_v dgm·s.
// It is K2's wide-window form with no realign, no cursor advance and no
// frozen flags, and runs K2's design: select_read.cuh's flat_select_kernel
// (its note has the bound and the design), one launch per call.
// ---------------------------------------------------------------------------

// windows: (V, >= select_window) rows at stride (unit columns); ptrs,
// strides: flat_ops's host arrays (rstart null); part/ticket:
// _cluster_scratch's, 4*128 floats per (sub-block, cluster); out (2, n).
extern "C" int window_select_flat(const float* windows, long long stride,
                                  const void* const* ptrs, const long long* strides,
                                  float* part, unsigned* ticket, float* out, int V,
                                  int n, int K, int emax2, cudaStream_t stream) {
  return flat_select_launch<false>(flat_ops(windows, stride, 0, ptrs, strides, emax2),
                                   part, ticket, out, V, n, K, stream);
}
