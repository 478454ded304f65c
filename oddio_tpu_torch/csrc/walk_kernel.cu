// The device-resident buffered pool's walk and read preparation, for Hopper
// (sm_90a).
//
// Built by oddio_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded through ctypes.
// The entry point launches on the stream it is given, allocates nothing,
// does not synchronise, and returns cudaGetLastError() after its launch.
//
// Replaces the per-voice torch chain of oddio_tpu_torch/spatial.py
// _BufferedPoolDR._advance_block (the counterpart of XLA's fusion of
// oddio_tpu/spatial.py _walk_device and the read preparation after it):
//   2. the motion lanes: the last real lane naming a voice refreshes its
//      motion and, smoothed or discontinuous, its previous position;
//   3. both smoothed positions, rotated by the listener's previous and
//      current rotation, and the smoothing clock;
//   4. lingering: a finished voice's time since it finished, expiry once the
//      sound has travelled its distance, the stop flag and the mask;
//   5. each voice's own ring cursor (ring.rs:18-41), what it writes, its lag
//      behind the pool's cursor and the frames its source renders;
//   7. both ears' read operands at both positions (spatial.rs:409-431): the
//      offset clamps, the gain ramps, the read cursor's pool index and
//      fraction, the split read step, the frozen flag and the 0/1 mask.
//
// Bound on the H100: launch latency.  The work is ~20 float32 words in and
// ~30 out per voice, 0.8 MB at 4096 voices, and ~250 float32 operations a
// voice; the torch chain it replaces took ~350 launches of one (V,) column
// operation each.  Design: one thread per voice, every state column read
// once and written once in place, the read operands written as the rows of
// one (17, V) array, each row where ring_select (K2/K3) reads it.  The
// motion lanes' slot numbers are staged in shared memory, a tile at a time,
// and each thread scans them for its own.
//
// Bit-equality with the torch chain on CUDA tensors: every operation is the
// ATen CUDA kernel's, rounded once (--fmad=false and the _rn intrinsics):
// a division by a Python scalar is ATen's multiplication by the float32
// reciprocal (the caller passes each reciprocal, rounded as ATen rounds
// it), `0.5 / x` is ATen's reciprocal(x) * 0.5, clamp(max=1) and maximum
// propagate NaN as ATen's do, remainder adds the divisor where the signs
// differ, and float to int32 truncates.
//
// Scene axis (ScenePack): the V rows are S scenes of V/S voices each; the
// rotations (4,) or (S, 4) and the pool write count (1,) or (S,) hold one
// value per scene, voice v uses row v / (rows' voices per scene).
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define WALK_THREADS 128  // voices per CUDA block
#define WALK_TILE 1024    // motion lanes staged in shared memory at a time

struct WalkPtrs {
  // state columns, read and written in place
  uint8_t* mask;
  uint8_t* stopped;
  float* ff;        // finished_for (NaN while playing)
  float* smdt;      // smoothing clock
  float* prev;      // (V, 3) previous position
  float* mpos;      // (V, 3) motion position
  float* mvel;      // (V, 3) motion velocity
  float* vcur;      // each voice's own ring cursor
  int* vbase;       // the pool index of its ring's index 0
  int* lag;         // samples its source runs ahead (null: no late path)
  // read only
  const float* radius;
  const float* maxd;
  const uint8_t* fin;   // the inner source finished
  const float* rot_prev;  // (R, 4)
  const float* rot;       // (R, 4)
  const int* nw;          // (S,) the pool cursor's write count
  const int* lidx;        // (K,) motion lanes (null when K = 0)
  const float* lpos;      // (K, 3)
  const float* lvel;      // (K, 3)
  const uint8_t* ldisc;   // (K,)
  // outputs
  float* ops;        // (17, V): per ear base (int32), frac, ds_int (int32),
                     // f_hi, f_lo, gain, d_gain, frozen; then the 0/1 mask
  int* n_write;      // (V,) frames the source advances
  uint8_t* late;     // (V,) the lag before this block > 0 (null: no late path)
};

struct WalkScal {
  int V, prev_vps, rot_vps, nw_vps, K, cap;
  float ef;      // elapsed seconds (float32)
  float adv;     // the cursor's advance, elapsed * rate in float32
  float ratef;   // the rate in float32
  float inv_nf;  // 1 / n as ATen rounds a division by the Python float n
  float inv_c;   // 1 / 343 likewise (the speed of sound)
  float inv_t;   // 1 / 0.5 likewise (the smoothing period)
  float neg_inv_c;  // float32(-1) / float32(343): the ear offset's factor
  float ear_x[2];   // the ears' x (y and z are 0)
  float ear_dir[2][3];  // the ears' directions of least attenuation
  float inv4096;    // float32(1 / 4096)
};

__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }

// torch.clamp(x, max=1.0)
__device__ __forceinline__ float clamp_max1(float v) { return isnan(v) ? v : fminf(v, 1.0f); }

// torch.maximum on float32
__device__ __forceinline__ float maximum(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmaxf(a, b);
}

// torch.remainder on int32
__device__ __forceinline__ int remainder_i(int a, int b) {
  int r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

struct V3 {
  float x, y, z;
};

// ops/geometry.py smoothed_position_c at a clock of dt = state_dt + extra
__device__ __forceinline__ V3 smoothed(V3 pv, float sd, float extra, V3 mp, V3 mv,
                                       float inv_t) {
  const float dt = fadd(sd, extra);
  const float r = clamp_max1(fmul(dt, inv_t));
  const float one_r = fsub(1.0f, r);
  V3 o;
  float c = fmul(mv.x, dt);
  o.x = fadd(fmul(one_r, fadd(pv.x, c)), fmul(r, fadd(mp.x, c)));
  c = fmul(mv.y, dt);
  o.y = fadd(fmul(one_r, fadd(pv.y, c)), fmul(r, fadd(mp.y, c)));
  c = fmul(mv.z, dt);
  o.z = fadd(fmul(one_r, fadd(pv.z, c)), fmul(r, fadd(mp.z, c)));
  return o;
}

// ops/geometry.py quat_rotate_c: quat_mul(rot, quat_mul((0, p), quat_invert(rot)))[1:]
// term for term, the zero products of the pure quaternion's scalar part kept
__device__ __forceinline__ V3 rotate(const float* q, V3 p) {
  const float rs = q[0], rx = q[1], ry = q[2], rz = q[3];
  const float nrx = fmul(rx, -1.0f), nry = fmul(ry, -1.0f), nrz = fmul(rz, -1.0f);
  const float z0 = 0.0f;
  const float As = fsub(fsub(fsub(fmul(z0, rs), fmul(p.x, nrx)), fmul(p.y, nry)), fmul(p.z, nrz));
  const float Ax = fsub(fadd(fadd(fmul(z0, nrx), fmul(p.x, rs)), fmul(p.y, nrz)), fmul(p.z, nry));
  const float Ay = fadd(fadd(fsub(fmul(z0, nry), fmul(p.x, nrz)), fmul(p.y, rs)), fmul(p.z, nrx));
  const float Az = fadd(fsub(fadd(fmul(z0, nrz), fmul(p.x, nry)), fmul(p.y, nrx)), fmul(p.z, rs));
  V3 o;
  o.x = fsub(fadd(fadd(fmul(rs, Ax), fmul(rx, As)), fmul(ry, Az)), fmul(rz, Ay));
  o.y = fadd(fadd(fsub(fmul(rs, Ay), fmul(rx, Az)), fmul(ry, As)), fmul(rz, Ax));
  o.z = fadd(fsub(fadd(fmul(rs, Az), fmul(rx, Ay)), fmul(ry, Ax)), fmul(rz, As));
  return o;
}

// ops/geometry.py ear_states_c for ear e: (offset, gain)
__device__ __forceinline__ void ear_state(const WalkScal& c, int e, V3 p, float radius,
                                          float& off, float& gain) {
  const float relx = fsub(p.x, c.ear_x[e]);
  const float rely = fsub(p.y, 0.0f);
  const float relz = fsub(p.z, 0.0f);
  const float distance =
      __fsqrt_rn(fadd(fmul(relx, relx), fadd(fmul(rely, rely), fmul(relz, relz))));
  off = fmul(distance, c.neg_inv_c);
  const float distance_gain = fdiv(radius, maximum(distance, radius));
  const float inv = fmul(fdiv(1.0f, distance), 0.5f);
  const float sx = fmul(p.x, inv), sy = fmul(p.y, inv), sz = fmul(p.z, inv);
  const float d = fadd(fmul(sx, c.ear_dir[e][0]),
                       fadd(fmul(sy, c.ear_dir[e][1]), fmul(sz, c.ear_dir[e][2])));
  const float stereo_gain = fadd(distance < 1e-3f ? 0.5f : d, 0.5f);
  gain = fmul(stereo_gain, distance_gain);
}

__global__ void __launch_bounds__(WALK_THREADS)
voice_walk_kernel(WalkPtrs P, WalkScal c) {
  __shared__ int s_idx[WALK_TILE];
  const int v = blockIdx.x * WALK_THREADS + threadIdx.x;

  // 2. the motion lane that refreshes voice v: the last one naming it (a
  // padding lane names no voice in [0, V))
  int pick = -1;
  for (int t0 = 0; t0 < c.K; t0 += WALK_TILE) {
    const int nt = min(WALK_TILE, c.K - t0);
    __syncthreads();
    for (int j = threadIdx.x; j < nt; j += WALK_THREADS) s_idx[j] = P.lidx[t0 + j];
    __syncthreads();
    for (int j = 0; j < nt; ++j)
      if (s_idx[j] == v) pick = t0 + j;
  }
  if (v >= c.V) return;

  V3 pv = {P.prev[3 * v], P.prev[3 * v + 1], P.prev[3 * v + 2]};
  V3 mp = {P.mpos[3 * v], P.mpos[3 * v + 1], P.mpos[3 * v + 2]};
  V3 mv = {P.mvel[3 * v], P.mvel[3 * v + 1], P.mvel[3 * v + 2]};
  float sd = P.smdt[v];
  if (pick >= 0) {
    const V3 sm = smoothed(pv, sd, 0.0f, mp, mv, c.inv_t);
    mp = V3{P.lpos[3 * pick], P.lpos[3 * pick + 1], P.lpos[3 * pick + 2]};
    mv = V3{P.lvel[3 * pick], P.lvel[3 * pick + 1], P.lvel[3 * pick + 2]};
    pv = P.ldisc[pick] ? mp : sm;
    sd = 0.0f;
    P.prev[3 * v] = pv.x;
    P.prev[3 * v + 1] = pv.y;
    P.prev[3 * v + 2] = pv.z;
    P.mpos[3 * v] = mp.x;
    P.mpos[3 * v + 1] = mp.y;
    P.mpos[3 * v + 2] = mp.z;
    P.mvel[3 * v] = mv.x;
    P.mvel[3 * v + 1] = mv.y;
    P.mvel[3 * v + 2] = mv.z;
  }

  // 3. both positions, rotated by the listener; the smoothing clock
  const V3 p0 = rotate(P.rot_prev + 4 * (v / c.prev_vps), smoothed(pv, sd, 0.0f, mp, mv, c.inv_t));
  const V3 p1 = rotate(P.rot + 4 * (v / c.rot_vps), smoothed(pv, sd, c.ef, mp, mv, c.inv_t));
  P.smdt[v] = fadd(sd, c.ef);

  // 4. lingering reclamation
  const float dist = __fsqrt_rn(fadd(fmul(p0.x, p0.x), fadd(fmul(p0.y, p0.y), fmul(p0.z, p0.z))));
  const float ff = P.ff[v];
  const bool lingering = !isnan(ff);
  const bool expire = lingering && (ff > fmul(dist, c.inv_c));
  const bool mask0 = P.mask[v] != 0;
  const bool stopped = (P.stopped[v] != 0) || (expire && mask0);
  const bool newly = mask0 && !lingering && (P.fin[v] != 0);
  P.ff[v] = newly ? c.ef : ((lingering && !expire) ? fadd(ff, c.ef) : ff);
  P.stopped[v] = stopped;
  const bool mask = mask0 && !stopped;
  P.mask[v] = mask;

  // 5. the voice's own ring cursor and what it writes
  const float md = P.maxd[v];
  const float cc = fadd(ceilf(fmul(md, c.ratef)), 1.0f);
  const float vc0 = P.vcur[v];
  const float un = fadd(vc0, c.adv);
  const float nxt = fmodf(un, cc);
  const int vb = remainder_i(P.vbase[v] + (int)fsub(un, nxt), c.cap);
  P.vcur[v] = nxt;
  P.vbase[v] = vb;
  const int nws = P.nw[v / c.nw_vps];
  int nwv = nws;
  if (P.lag != nullptr) {
    nwv = (int)fadd(fsub(ceilf(nxt), ceilf(vc0)), fsub(un, nxt));
    const int lg = P.lag[v];
    P.late[v] = lg > 0;
    P.lag[v] = lg + nws - nwv;
  }
  P.n_write[v] = mask ? nwv : 0;

  // 7. both ears' read operands
  const float radius = P.radius[v];
  const float nmd = -md;
  const int ci = (int)cc;
  const int V = c.V;
  for (int e = 0; e < 2; ++e) {
    float po, pg, no, ng;
    ear_state(c, e, p0, radius, po, pg);
    ear_state(c, e, p1, radius, no, ng);
    po = maximum(fsub(po, c.ef), nmd);
    no = maximum(no, nmd);
    float* o = P.ops + (size_t)(8 * e) * V + v;
    // the read cursor (ring.rs:51-79): each voice's own, advanced
    const float x = fadd(nxt, fmul(po, c.ratef));
    const bool lap = x < 0.0f;
    const float off = lap ? fadd(x, cc) : x;
    const float fl = floorf(off);
    ((int*)o)[0] = remainder_i((vb - (lap ? ci : 0)) + (int)fl, c.cap);
    o[V] = fsub(off, fl);
    // the read step, split exactly (ops/_dev.py device_split_ds)
    const float ds = fmul(fmul(fsub(no, po), c.inv_nf), c.ratef);
    const float dsi = floorf(ds);
    const float f = fsub(ds, dsi);
    const float f_hi = fmul(floorf(fmul(f, 4096.0f)), c.inv4096);
    ((int*)o)[2 * V] = (int)dsi;
    o[3 * V] = f_hi;
    o[4 * V] = fsub(f, f_hi);
    o[5 * V] = pg;
    o[6 * V] = fmul(fsub(ng, pg), c.inv_nf);
    o[7 * V] = no == po ? 1.0f : 0.0f;
  }
  P.ops[(size_t)16 * V + v] = mask ? 1.0f : 0.0f;
}

extern "C" int voice_walk(const void* const* ptrs, const float* scal, int V, int prev_vps,
                          int rot_vps, int nw_vps, int K, int cap, cudaStream_t stream) {
  if (V < 1 || prev_vps < 1 || rot_vps < 1 || nw_vps < 1 || K < 0 || cap < 1)
    return (int)cudaErrorInvalidValue;
  const void* const* q = ptrs;
  WalkPtrs P{(uint8_t*)q[0], (uint8_t*)q[1], (float*)q[2], (float*)q[3], (float*)q[4],
             (float*)q[5], (float*)q[6], (float*)q[7], (int*)q[8], (int*)q[9],
             (const float*)q[10], (const float*)q[11], (const uint8_t*)q[12],
             (const float*)q[13], (const float*)q[14], (const int*)q[15], (const int*)q[16],
             (const float*)q[17], (const float*)q[18], (const uint8_t*)q[19], (float*)q[20],
             (int*)q[21], (uint8_t*)q[22]};
  WalkScal c;
  c.V = V;
  c.prev_vps = prev_vps;
  c.rot_vps = rot_vps;
  c.nw_vps = nw_vps;
  c.K = K;
  c.cap = cap;
  c.ef = scal[0];
  c.adv = scal[1];
  c.ratef = scal[2];
  c.inv_nf = scal[3];
  c.inv_c = scal[4];
  c.inv_t = scal[5];
  c.neg_inv_c = scal[6];
  c.ear_x[0] = scal[7];
  c.ear_x[1] = scal[8];
  for (int e = 0; e < 2; ++e)
    for (int k = 0; k < 3; ++k) c.ear_dir[e][k] = scal[9 + 3 * e + k];
  c.inv4096 = scal[15];
  voice_walk_kernel<<<(V + WALK_THREADS - 1) / WALK_THREADS, WALK_THREADS, 0, stream>>>(P, c);
  return (int)cudaGetLastError();
}
