// K2: complete projective point add and double, and the MSM's Horner chain.
//
// Replaces the TPU kernel fused_composite (plonky_tpu/fields/
// pallas_kernels.py) as instantiated by plonky_tpu/curves/ops.py:
// _fused_point_jit / _fused_point_op over the bodies _add_body (RCB15
// Algorithm 7) and _double_body (Algorithm 9), which the MSM runs as its
// Horner across windows (plonky_tpu/curves/msm.py:401-411: c doublings and
// one add per window, batched over the K MSMs of a call).
//
// What bounds it: a point op is 12 Montgomery products against at most 288
// bytes, so every kernel here is bound by the integer multiply pipe; the
// Horner is a chain of W - 1 windows x (c doublings + 1 add), on K <= 9
// points on the main path, so it is bound by the chain's latency, not by the
// card's rate.  The design:
//   - curve_horner runs the whole chain of one MSM in one warp, in one
//     launch per msm call.  The warp keeps the running point in Montgomery
//     form (curve.cuh) and runs each formula as two levels of independent
//     products (a double 4 + 4, an add 6 + 6): lane i multiplies operand
//     pair i from a per-warp scratch in shared memory, so a point op costs
//     about two product latencies; the additions and the multiplies by b3
//     between the levels run on every lane alike.  The one Montgomery
//     multiply of the chain sits in one out-of-line function.
//   - curve_add / curve_double stay one thread per point (any batch), on the
//     same Montgomery formulas, converting in and out around them.
// Built twice (_cuda.py): at 8 limbs, and at 12 (-DPT_LIMBS=12, BLS12-377
// G1; entries pt_curve_add_l12, ...), where a Montgomery product is 144
// limb products and 12 REDC rounds (>= 588 IMAD slots against 264) and a
// warp's Horner scratch is 3 x 8 x 48 bytes.
#include "curve.cuh"

PT_NAMESPACE_BEGIN

#define HORNER_WARPS 4      // MSMs (one warp each) per block
#define HORNER_PAIRS 8      // products of one level at most (a double's 4
                            // and the 3 conversions of the next window)

#if PT_BUILDS(1)  // curve_add
__global__ void curve_add_kernel(int32_t* ox, int32_t* oy, int32_t* oz,
                                 const int32_t* ax, const int32_t* ay, const int32_t* az,
                                 const int32_t* bx, const int32_t* by, const int32_t* bz,
                                 int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Point p, q;
  pt_load(p, ax, ay, az, n, i);
  pt_load(q, bx, by, bz, n, i);
  mpt_to_mont(p, c_curve);
  mpt_to_mont(q, c_curve);
  mpt_add(p, p, q, c_curve);
  mpt_from_mont(p, c_curve);
  pt_store(ox, oy, oz, n, i, p);
}
#endif

#if PT_BUILDS(2)  // curve_double
__global__ void curve_double_kernel(int32_t* ox, int32_t* oy, int32_t* oz,
                                    const int32_t* ax, const int32_t* ay, const int32_t* az,
                                    int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Point p;
  pt_load(p, ax, ay, az, n, i);
  mpt_to_mont(p, c_curve);
  mpt_double(p, p, c_curve);
  mpt_from_mont(p, c_curve);
  pt_store(ox, oy, oz, n, i, p);
}
#endif

#if PT_BUILDS(3)  // curve_horner
// A warp's scratch: operand pairs (a, b) and their products, L limbs each.
struct HornerScratch {
  uint32_t a[HORNER_PAIRS][PT_LIMBS];
  uint32_t b[HORNER_PAIRS][PT_LIMBS];
  uint32_t p[HORNER_PAIRS][PT_LIMBS];
};

__device__ __forceinline__ void limbs_put(uint32_t* dst, const uint32_t v[PT_LIMBS]) {
  uint4* d = (uint4*)dst;
#pragma unroll
  for (int k = 0; k < PT_LIMBS / 4; k++)
    d[k] = make_uint4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
}

__device__ __forceinline__ void limbs_get(uint32_t v[PT_LIMBS], const uint32_t* src) {
  const uint4* s = (const uint4*)src;
#pragma unroll
  for (int k = 0; k < PT_LIMBS / 4; k++) {
    uint4 q = s[k];
    v[4 * k] = q.x; v[4 * k + 1] = q.y; v[4 * k + 2] = q.z; v[4 * k + 3] = q.w;
  }
}

// Pair i of the next level (written by lane 0 only; every lane computes it).
__device__ __forceinline__ void pair_put(HornerScratch& s, bool lead, int i,
                                         const uint32_t a[PT_LIMBS],
                                         const uint32_t b[PT_LIMBS]) {
  if (lead) {
    limbs_put(s.a[i], a);
    limbs_put(s.b[i], b);
  }
}

// One level: lane i < n sets p[i] = a[i] b[i] / 2^(32 L) mod p; afterwards
// every lane of the warp may read the products.  Out of line, so that the
// chain has one copy of the multiply's code.
__device__ __noinline__ void horner_level(HornerScratch* s, int n) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  if (lane < n) {
    uint32_t a[PT_LIMBS], b[PT_LIMBS], r[PT_LIMBS];
    limbs_get(a, s->a[lane]);
    limbs_get(b, s->b[lane]);
    mf_mul(r, a, b, c_curve.f);
    limbs_put(s->p[lane], r);
  }
  __syncwarp();
}

// Window w of MSM m, canonical, as the next level's pairs i0 .. i0+2 with
// R^2 (its conversion to Montgomery form).
__device__ __forceinline__ void window_put(HornerScratch& s, bool lead, int i0,
                                           const int32_t* wx, const int32_t* wy,
                                           const int32_t* wz, int64_t stride, int64_t at) {
  if (lead) {
    Point q;
    pt_load(q, wx, wy, wz, stride, at);
    pair_put(s, lead, i0, q.x, c_curve.r2);
    pair_put(s, lead, i0 + 1, q.y, c_curve.r2);
    pair_put(s, lead, i0 + 2, q.z, c_curve.r2);
  }
}

// One warp per MSM m < k: acc = ws[nw-1]; for w = nw-2 .. 0: c doublings of
// acc, then acc += ws[w].  ws (wx, wy, wz): [L, k, nw] canonical; out:
// [L, k] canonical.  The field values are those of mpt_double / mpt_add
// (hence of curves/ops.py:double_plain / add_plain), so the output equals
// curves/msm.py:horner_plain word for word.
__global__ void __launch_bounds__(HORNER_WARPS * 32) curve_horner_kernel(
    int32_t* ox, int32_t* oy, int32_t* oz, const int32_t* wx, const int32_t* wy,
    const int32_t* wz, int64_t k, int64_t nw, int c) {
  __shared__ __align__(16) HornerScratch scratch[HORNER_WARPS];
  const int warp = threadIdx.x >> 5;
  const bool lead = (threadIdx.x & 31) == 0;
  const int64_t m = (int64_t)blockIdx.x * HORNER_WARPS + warp;
  if (m >= k) return;               // whole warps leave; no block barrier follows
  HornerScratch& s = scratch[warp];
  const FieldConsts& f = c_curve.f;
  const uint32_t b3 = c_curve.b3;
  const int64_t stride = k * nw;

  Point acc, q;
  window_put(s, lead, 0, wx, wy, wz, stride, m * nw + nw - 1);
  horner_level(&s, 3);
  limbs_get(acc.x, s.p[0]);
  limbs_get(acc.y, s.p[1]);
  limbs_get(acc.z, s.p[2]);

  for (int64_t w = nw - 2; w >= 0; w--) {
    for (int d = 0; d < c; d++) {
      // double, level 1: Y^2, Y Z, Z^2, X Y (and the window's conversion)
      pair_put(s, lead, 0, acc.y, acc.y);
      pair_put(s, lead, 1, acc.y, acc.z);
      pair_put(s, lead, 2, acc.z, acc.z);
      pair_put(s, lead, 3, acc.x, acc.y);
      if (d == 0) window_put(s, lead, 4, wx, wy, wz, stride, m * nw + w);
      horner_level(&s, d == 0 ? 7 : 4);
      if (d == 0) {
        limbs_get(q.x, s.p[4]);
        limbs_get(q.y, s.p[5]);
        limbs_get(q.z, s.p[6]);
      }
      uint32_t t0[PT_LIMBS], t1[PT_LIMBS], t2[PT_LIMBS], txy[PT_LIMBS];
      uint32_t z3p[PT_LIMBS], u[PT_LIMBS];
      limbs_get(t0, s.p[0]);
      limbs_get(t1, s.p[1]);
      limbs_get(t2, s.p[2]);
      limbs_get(txy, s.p[3]);
      fe_add(z3p, t0, t0, f);
      fe_add(z3p, z3p, z3p, f);
      fe_add(z3p, z3p, z3p, f);     // 8 Y^2
      mf_mul_small(t2, t2, b3, f);  // b3 Z^2
      fe_add(u, t2, t2, f);
      fe_add(u, u, t2, f);          // 3 b3 Z^2
      fe_sub(u, t0, u, f);          // t0m = Y^2 - 3 b3 Z^2
      fe_add(t0, t0, t2, f);        // y3p = Y^2 + b3 Z^2
      // level 2: b3 Z^2 8 Y^2, Y Z 8 Y^2, t0m y3p, 2 t0m X Y
      pair_put(s, lead, 0, t2, z3p);
      pair_put(s, lead, 1, t1, z3p);
      pair_put(s, lead, 2, u, t0);
      fe_add(u, u, u, f);
      pair_put(s, lead, 3, u, txy);
      horner_level(&s, 4);
      limbs_get(t0, s.p[0]);        // x3p
      limbs_get(acc.z, s.p[1]);     // Z3 = 8 Y^3 Z
      limbs_get(t1, s.p[2]);
      fe_add(acc.y, t1, t0, f);     // Y3 = t0m y3p + x3p
      limbs_get(acc.x, s.p[3]);     // X3 = 2 t0m X Y
    }

    // add acc + q, level 1: the three products and the three cross sums
    uint32_t u[PT_LIMBS], v[PT_LIMBS];
    pair_put(s, lead, 0, acc.x, q.x);
    pair_put(s, lead, 1, acc.y, q.y);
    pair_put(s, lead, 2, acc.z, q.z);
    fe_add(u, acc.x, acc.y, f);
    fe_add(v, q.x, q.y, f);
    pair_put(s, lead, 3, u, v);
    fe_add(u, acc.y, acc.z, f);
    fe_add(v, q.y, q.z, f);
    pair_put(s, lead, 4, u, v);
    fe_add(u, acc.x, acc.z, f);
    fe_add(v, q.x, q.z, f);
    pair_put(s, lead, 5, u, v);
    horner_level(&s, 6);
    uint32_t t0[PT_LIMBS], t1[PT_LIMBS], t2[PT_LIMBS], t3[PT_LIMBS], t4[PT_LIMBS];
    uint32_t xz[PT_LIMBS];
    limbs_get(t0, s.p[0]);
    limbs_get(t1, s.p[1]);
    limbs_get(t2, s.p[2]);
    limbs_get(t3, s.p[3]);
    fe_sub(t3, t3, t0, f);
    fe_sub(t3, t3, t1, f);          // t3 = X1 Y2 + X2 Y1
    limbs_get(t4, s.p[4]);
    fe_sub(t4, t4, t1, f);
    fe_sub(t4, t4, t2, f);          // t4 = Y1 Z2 + Y2 Z1
    limbs_get(xz, s.p[5]);
    fe_sub(xz, xz, t0, f);
    fe_sub(xz, xz, t2, f);          // xz = X1 Z2 + X2 Z1
    fe_add(u, t0, t0, f);
    fe_add(t0, u, t0, f);           // t0_3 = 3 t0
    mf_mul_small(t2, t2, b3, f);    // b3 t2
    fe_add(u, t1, t2, f);           // z3p = t1 + b3 t2
    fe_sub(t1, t1, t2, f);          // t1m = t1 - b3 t2
    mf_mul_small(xz, xz, b3, f);    // yb3 = b3 xz
    // level 2: the six products of X3, Y3, Z3
    pair_put(s, lead, 0, t3, t1);
    pair_put(s, lead, 1, t4, xz);
    pair_put(s, lead, 2, xz, t0);
    pair_put(s, lead, 3, t1, u);
    pair_put(s, lead, 4, u, t4);
    pair_put(s, lead, 5, t0, t3);
    horner_level(&s, 6);
    limbs_get(u, s.p[0]);
    limbs_get(v, s.p[1]);
    fe_sub(acc.x, u, v, f);         // X3 = t3 t1m - t4 yb3
    limbs_get(u, s.p[2]);
    limbs_get(v, s.p[3]);
    fe_add(acc.y, u, v, f);         // Y3 = yb3 t0_3 + t1m z3p
    limbs_get(u, s.p[4]);
    limbs_get(v, s.p[5]);
    fe_add(acc.z, u, v, f);         // Z3 = z3p t4 + t0_3 t3
  }

  // back to canonical coordinates: x R 1 / R = x
  uint32_t one[PT_LIMBS];
  fe_set_small(one, 1);
  pair_put(s, lead, 0, acc.x, one);
  pair_put(s, lead, 1, acc.y, one);
  pair_put(s, lead, 2, acc.z, one);
  horner_level(&s, 3);
  if (lead) {
    limbs_get(acc.x, s.p[0]);
    limbs_get(acc.y, s.p[1]);
    limbs_get(acc.z, s.p[2]);
    pt_store(ox, oy, oz, k, m, acc);
  }
}
#endif

extern "C" {

#if PT_BUILDS(1)
int PT_ENTRY(pt_curve_add)(void* ox, void* oy, void* oz, const void* ax, const void* ay,
                           const void* az, const void* bx, const void* by,
                           const void* bz, int64_t n, const void* consts, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int rc = curve_set_consts((const uint32_t*)consts, st);
  if (rc != 0) return rc;
  curve_add_kernel<<<pt_blocks(n), PT_THREADS, 0, st>>>(
      (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (const int32_t*)ax, (const int32_t*)ay,
      (const int32_t*)az, (const int32_t*)bx, (const int32_t*)by, (const int32_t*)bz, n);
  return (int)cudaGetLastError();
}
#endif

#if PT_BUILDS(2)
int PT_ENTRY(pt_curve_double)(void* ox, void* oy, void* oz, const void* ax,
                              const void* ay, const void* az, int64_t n,
                              const void* consts, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int rc = curve_set_consts((const uint32_t*)consts, st);
  if (rc != 0) return rc;
  curve_double_kernel<<<pt_blocks(n), PT_THREADS, 0, st>>>(
      (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (const int32_t*)ax, (const int32_t*)ay,
      (const int32_t*)az, n);
  return (int)cudaGetLastError();
}
#endif

#if PT_BUILDS(3)
int PT_ENTRY(pt_curve_horner)(void* ox, void* oy, void* oz, const void* wx,
                              const void* wy, const void* wz, int64_t k, int64_t nw,
                              int c, const void* consts, void* stream) {
  if (k < 1 || nw < 1 || c < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int rc = curve_set_consts((const uint32_t*)consts, st);
  if (rc != 0) return rc;
  const unsigned int blocks = (unsigned int)((k + HORNER_WARPS - 1) / HORNER_WARPS);
  curve_horner_kernel<<<blocks, HORNER_WARPS * 32, 0, st>>>(
      (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (const int32_t*)wx, (const int32_t*)wy,
      (const int32_t*)wz, k, nw, c);
  return (int)cudaGetLastError();
}
#endif

}  // extern "C"

PT_NAMESPACE_END
