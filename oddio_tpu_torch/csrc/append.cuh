// Slab append for Hopper (sm_90a): the device routine K1 (ring_kernels.cu
// rows_append, rows_append_cursor) and K9 (flat_kernels.cu flat_append)
// share.  Both copy a (V, W) slab into every voice's ring at two places,
// a primary leg and a mirror leg, in place.
//
// Replaces the TPU's DMA engine work in oddio_tpu/ops/pallas_ring.py:
// rows_append_dma (two strided HBM->HBM DMAs per voice tile) and
// flat_append_aligned (output blocks mapped onto the written pages).
//
// Bound on the H100: bytes only, the slab read once and written twice,
// 12*V*W bytes (25.2 MB at V = 4096, W = 512: 7.5 us at 3.35 TB/s); no
// arithmetic.  Design: a column of CUDA blocks per voice (grid x; no
// index division), one thread per 16-byte vector of the row, so loads and
// both stores coalesce and the slab is read once for both legs.  Each
// thread reads its voice's two leg offsets from the Legs functor (one
// cached load of a device int, or values).  Where the slab's rows are
// not 16-byte aligned (the buffered pool hands K1 512 frames of its
// 513-frame render) a thread loads its vector as four scalars, still
// coalesced across the warp; the ring rows take 16-byte stores (the
// wrappers check their alignment).  A bulk-copy (TMA) form of this
// routine ran no faster on the card, warm or cold (PERF.md).

#pragma once

#include <assert.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define APPEND_THREADS 128  // threads per CUDA block: 512 floats of a row

namespace append {

// the geometry of one launch
struct Slab {
  const float* src;      // slab row v at src + v*src_stride
  long long src_stride;  // floats
  float* dst;            // voice v's ring row at dst + v*dst_stride
  long long dst_stride;  // floats
  int V, W;              // voices, floats per row (a multiple of 4)
};

// Legs: a functor, legs(v, o0, o1) sets voice v's two leg offsets in
// floats from its ring row base (and asserts that both stay inside it).
template <class Legs>
__global__ void __launch_bounds__(APPEND_THREADS)
    slab_append_kernel(Slab s, Legs legs, int vec) {
  const int v = blockIdx.x;
  const int c = (blockIdx.y * APPEND_THREADS + threadIdx.x) * 4;
  if (c >= s.W) return;
  long long o0, o1;
  legs(v, o0, o1);
  const float* src = s.src + (long long)v * s.src_stride + c;
  float4 x;
  if (vec) {
    x = *reinterpret_cast<const float4*>(src);
  } else {
    x = make_float4(src[0], src[1], src[2], src[3]);
  }
  float* row = s.dst + (long long)v * s.dst_stride + c;
  *reinterpret_cast<float4*>(row + o0) = x;
  *reinterpret_cast<float4*>(row + o1) = x;
}

// Launch one slab append on `stream`.  The ring rows (dst, dst_stride)
// and the leg offsets must keep 16-byte alignment; W a multiple of 4.
template <class Legs>
static int launch(const Slab& s, const Legs& legs, cudaStream_t stream) {
  if (s.V < 1 || s.W < 4 || s.W % 4 || s.dst_stride % 4 ||
      (uintptr_t)s.dst % 16)
    return (int)cudaErrorInvalidValue;
  const int vec = ((uintptr_t)s.src % 16 == 0 && s.src_stride % 4 == 0) ? 1 : 0;
  const dim3 grid(s.V, (s.W / 4 + APPEND_THREADS - 1) / APPEND_THREADS);
  slab_append_kernel<Legs><<<grid, APPEND_THREADS, 0, stream>>>(s, legs, vec);
  return (int)cudaGetLastError();
}

}  // namespace append
