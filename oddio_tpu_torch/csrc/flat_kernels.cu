// Flat-ring kernels, for Hopper (sm_90a): K9 flat_append_aligned (on
// append.cuh, K1's slab append) and K10 dma_window_select.  (K8, the
// flat-window select, shares K2's body in ring_kernels.cu.)
//
// Built by oddio_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded through ctypes.
// Every entry point launches on the stream it is given, allocates nothing,
// does not synchronise, and returns cudaGetLastError() after its launches.
// The read positions are rebuilt with the exact split-ds arithmetic of
// oddio_tpu/ops/_dev.py, with the explicit round-to-nearest intrinsics at
// every position site, as in ring_kernels.cu.

#include <assert.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "append.cuh"

#define SB 128       // frames per CUDA block (threads) in the select
#define VC 16        // voices per CUDA block: one partial sum per chunk
#define APPEND_PW 512  // K9's page width (pallas_ring.py APPEND_PW)
#define FETCH 2048   // K10's per-voice fetch: two 1024-sample pages

// ---------------------------------------------------------------------------
// K9: flat_append_aligned
//
// Replaces oddio_tpu/ops/pallas_ring.py::flat_append_aligned
// (_append_kernel): the (V, W) slab, W a multiple of 512, written into
// every voice's flat ring row at page pcol and again at page pmir, in
// place.
//
// Bound on the H100: bytes only, the slab read once and written twice,
// 12*V*W bytes, no arithmetic.  Design: append.cuh's slab append (the
// same routine as K1): a column of CUDA blocks per voice, one thread per
// 16-byte vector, both pages stored from one load.  The two pages come
// by value (host ints) or from device int32 scalars (no host read).  A
// device page whose span leaves the row trips a device-side assert, as
// the plain version's slice assignment raises (the wrapper checks host
// pages itself).
// ---------------------------------------------------------------------------

struct PageLegs {
  const int* p0p;  // device page, or null: p0
  const int* p1p;
  int p0, p1, W;
  long long rowlen;
  __device__ void operator()(int, long long& o0, long long& o1) const {
    o0 = (long long)(p0p ? *p0p : p0) * APPEND_PW;
    o1 = (long long)(p1p ? *p1p : p1) * APPEND_PW;
    assert(o0 >= 0 && o0 + W <= rowlen && o1 >= 0 && o1 + W <= rowlen);
  }
};

// p0p/p1p: device int32 pages, or null to take p0/p1.
extern "C" int flat_append(float* ring, long long rowlen, const float* src,
                           long long src_stride, const int* p0p,
                           const int* p1p, int p0, int p1, int V, int W,
                           cudaStream_t stream) {
  if (V < 1 || W < 1 || W % APPEND_PW) return (int)cudaErrorInvalidValue;
  const append::Slab s{src, src_stride, ring, rowlen, V, W};
  return append::launch(s, PageLegs{p0p, p1p, p0, p1, W, rowlen}, stream);
}

// ---------------------------------------------------------------------------
// K10: dma_window_select
//
// Replaces oddio_tpu/ops/pallas_ring.py::dma_window_select
// (_dma_select_kernel): the TPU kernel DMAs each voice's 2048-sample window
// from the FLAT ring (ring.reshape(-1)) at v*rowlen + 1024*floor(rstart/1024),
// realigns it by the 128-granule remainder, and runs K8's per-ear read at
// rstart + extra_e + j + kk_j; then s*(g0 + j*dg)*mask, summed over voices
// on the VPU (no MXU).
//
// On the GPU the fetch and the realign are one address: each read is
// ring_flat[v*rowlen + rstart + extra_e + j + kk_j] (and the next sample),
// the same flat address, so a window past the end of row v reads row v+1,
// as the TPU's DMA does.  Where the 2048-sample fetch would leave the
// tensor (the last voice's window past its row end, or a negative start),
// a device-side assert trips; the plain version raises there.  A host
// check would read rstart back every call.
//
// Bound on the H100: like K2, load latency and ~30 scalar ops per sample
// (each voice's two ears read ~n + 2K floats that sit in L2).  Design: one
// thread per frame walking the VC voices of its chunk (scalars staged in
// shared memory); the gains multiply per voice in the TPU kernel's order,
// (s*gain)*mask; the chunk sums are added in a fixed order by a second
// kernel (deterministic, no atomics).
// ---------------------------------------------------------------------------

__device__ __forceinline__ float ear_read(const float* __restrict__ flat,
                                          long long base, float o0,
                                          float f_hi, float f_lo, float dsm1,
                                          int K, int j, long long total) {
  const float t = (float)j;
  const float H = __fmul_rn(t, f_hi);  // exact: 12-bit f_hi, t < 4096
  const float Hf = floorf(H);
  const float u = __fadd_rn(__fsub_rn(H, Hf), __fadd_rn(o0, __fmul_rn(t, f_lo)));
  const float fl_u = floorf(u);
  const float fr = __fsub_rn(u, fl_u);
  float kk = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(t, dsm1), Hf), fl_u),
                       (float)K);
  kk = fminf(fmaxf(kk, 0.0f), (float)(2 * K));
  const long long m = base + j + (long long)kk;
  assert(m >= 0 && m + 1 < total);  // the plain version's gather raises
  const float a = flat[m];
  const float b = flat[m + 1];
  return __fadd_rn(a, __fmul_rn(fr, __fsub_rn(b, a)));
}

__global__ void dma_select_partial_kernel(
    const float* __restrict__ flat, long long rowlen,
    const int* __restrict__ rstart, const float* __restrict__ sc0,
    const float* __restrict__ sc1, const float* __restrict__ g0,
    const float* __restrict__ g1, const float* __restrict__ maskf,
    const int* __restrict__ e0, const int* __restrict__ e1,
    float* __restrict__ part, int V, int n, int K) {
  __shared__ float s_sc[2][VC][4];
  __shared__ float s_g[2][VC][2];
  __shared__ long long s_base[2][VC];
  __shared__ float s_m[VC];

  const int chunk = blockIdx.y;
  const int v0 = chunk * VC;
  const int nv = min(VC, V - v0);
  const int t = threadIdx.x;
  const long long total = (long long)V * rowlen;

  if (t < 2 * VC) {
    const int e = t / VC;
    const int i = t % VC;
    if (i < nv) {
      const int v = v0 + i;
      const float* sc = e ? sc1 : sc0;
      const float* g = e ? g1 : g0;
      const int* ex = e ? e1 : e0;
      const int rs = rstart[v];
      // the TPU kernel's fetch: two pages from 1024*floor(rstart/1024)
      const int rw = rs >= 0 ? rs / 1024 : -((-rs + 1023) / 1024);
      const long long lo = (long long)v * rowlen + 1024LL * rw;
      assert(lo >= 0 && lo + FETCH <= total);
      for (int k = 0; k < 4; ++k) s_sc[e][i][k] = sc[(long long)v * 4 + k];
      s_g[e][i][0] = g[(long long)v * 2];
      s_g[e][i][1] = g[(long long)v * 2 + 1];
      s_base[e][i] = (long long)v * rowlen + rs + ex[v];
      if (e == 0) s_m[i] = maskf[v];
    }
  }
  __syncthreads();

  const int j = blockIdx.x * SB + t;
  if (j >= n) return;
  float acc[2] = {0.0f, 0.0f};
  for (int i = 0; i < nv; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float s = ear_read(flat, s_base[e][i], s_sc[e][i][0],
                               s_sc[e][i][1], s_sc[e][i][2],
                               __fsub_rn(s_sc[e][i][3], 1.0f), K, j, total);
      const float gain = __fadd_rn(s_g[e][i][0], __fmul_rn((float)j, s_g[e][i][1]));
      acc[e] = __fadd_rn(acc[e], __fmul_rn(__fmul_rn(s, gain), s_m[i]));
    }
  }
  // part layout: [chunk][ear][n]
#pragma unroll
  for (int e = 0; e < 2; ++e) part[((long long)chunk * 2 + e) * n + j] = acc[e];
}

__global__ void dma_select_reduce_kernel(const float* __restrict__ part,
                                         float* __restrict__ out, int n,
                                         int nchunks) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 2 * n) return;
  const int e = idx / n;
  const int j = idx % n;
  float acc = 0.0f;
  for (int c = 0; c < nchunks; ++c)
    acc = __fadd_rn(acc, part[((long long)c * 2 + e) * n + j]);
  out[(long long)e * n + j] = acc;
}

// part holds ceil(V / VC) * 2 * n floats; out (2, n).
extern "C" int dma_window_select(const float* ring, long long rowlen,
                                 const int* rstart, const float* sc0,
                                 const float* sc1, const float* g0,
                                 const float* g1, const float* maskf,
                                 const int* e0, const int* e1, float* part,
                                 float* out, int V, int n, int K,
                                 cudaStream_t stream) {
  if (V < 1 || n < 1 || rowlen < FETCH) return (int)cudaErrorInvalidValue;
  const int nchunks = (V + VC - 1) / VC;
  dim3 grid((n + SB - 1) / SB, nchunks);
  dma_select_partial_kernel<<<grid, SB, 0, stream>>>(
      ring, rowlen, rstart, sc0, sc1, g0, g1, maskf, e0, e1, part, V, n, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dma_select_reduce_kernel<<<(2 * n + 255) / 256, 256, 0, stream>>>(
      part, out, n, nchunks);
  return (int)cudaGetLastError();
}
