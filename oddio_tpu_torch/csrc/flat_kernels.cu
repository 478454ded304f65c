// Flat-ring kernels, for Hopper (sm_90a): K9 flat_append_aligned (on
// append.cuh, K1's slab append) and K10 dma_window_select (on
// select_read.cuh's flat-window select, shared with K8 in ring_kernels.cu).
//
// Built by oddio_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded through ctypes.
// Every entry point launches on the stream it is given, allocates nothing,
// does not synchronise, and returns cudaGetLastError() after its launches.
// K10's read positions are rebuilt with the exact split-ds arithmetic of
// oddio_tpu/ops/_dev.py (select_read.cuh's position()), with the explicit
// round-to-nearest intrinsics at every position site, as in
// ring_kernels.cu.

#include <assert.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "append.cuh"
#include "select_read.cuh"

#define APPEND_PW 512  // K9's page width (pallas_ring.py APPEND_PW)

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
// K10: dma_window_select (no path)
//
// Replaces oddio_tpu/ops/pallas_ring.py::dma_window_select
// (_dma_select_kernel): the TPU kernel DMAs each voice's 2048-sample window
// from the FLAT ring (ring.reshape(-1)) at v*rowlen + 1024*floor(rstart/1024),
// realigns it by the 128-granule remainder, and runs K8's per-ear read at
// rstart + extra_e + j + kk_j; then (s*(g0 + j*dg))*mask, summed over voices
// on the VPU (no MXU).
//
// On the GPU the fetch and the realign are one address: each read is
// ring_flat[v*rowlen + rstart + extra_e + j + kk_j] (and the next sample),
// so a window past the end of row v reads row v+1, as the TPU's DMA does.
// Where the 2048-sample fetch would leave the tensor (the last voice's
// window past its row end, a negative start), a device-side assert trips,
// once per voice; the plain version raises there.  A host check would read
// rstart back every call.  The kernel is K8's: select_read.cuh's
// flat_select_kernel with each voice's row base at v*rowlen + rstart_v and
// the TPU kernel's summands, one launch per call (its note has the bound,
// the design, and why no tap checks its address).
// ---------------------------------------------------------------------------

// ring: (V, rowlen) contiguous, rowlen a multiple of 1024; ptrs, strides:
// flat_ops's host arrays; part/ticket: _cluster_scratch's, 2*128 floats per
// (sub-block, cluster); out (2, n).
extern "C" int dma_window_select(const float* ring, long long rowlen,
                                 const void* const* ptrs, const long long* strides,
                                 float* part, unsigned* ticket, float* out, int V,
                                 int n, int K, int emax2, cudaStream_t stream) {
  if (rowlen < FS_FETCH || rowlen % 1024 || ptrs[5] == nullptr)
    return (int)cudaErrorInvalidValue;
  return flat_select_launch<true>(flat_ops(ring, rowlen, V * rowlen, ptrs, strides, emax2),
                                  part, ticket, out, V, n, K, stream);
}
