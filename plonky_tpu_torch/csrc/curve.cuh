// Complete projective point add and double for y^2 = x^3 + b (a = 0),
// Renes-Costello-Batina 2015 Algorithms 7 and 9, with b3 = 3b mod p, on
// coordinates in Montgomery form (field.cuh: x held as x 2^(32 L) mod p, L =
// PT_LIMBS: 8, or 12 for BLS12-377 G1).  The
// identity is (0 : 1 : 0); the formulas have no exceptional cases.  The
// field values are those of plonky_tpu/curves/ops.py:_add_body and
// _double_body (and of curves/ops.py:add_plain / double_plain), so, converted
// back, the outputs are the same projective triples.
#pragma once

#include "field.cuh"

// The point kernels' constants (K2 and K4): the field's, b3 = 3b as a small
// integer, and R^2 = 2^(64 L) mod p, the factor into Montgomery form.
struct MontCurveConsts {
  FieldConsts f;
  uint32_t b3;
  uint32_t r2[PT_LIMBS];
};

// One copy per kernel object (static: each .o is its own module, so the 8-
// and 12-limb builds of a source hold one each), set on the launch's stream
// by curve_set_consts.
static __constant__ MontCurveConsts c_curve;

// Sets c_curve on `stream` ahead of a launch from the host buffer
// [p, -p^-1 mod 2^32, b3 (L limbs), 2^(64 L) mod p (L limbs)]
// (curves/ops.py:_consts_host); b3 must fit one limb, and at 8 limbs p
// must have the sparse shape (field.cuh: mf_mul).
static int curve_set_consts(const uint32_t* host, cudaStream_t stream) {
  MontCurveConsts c;
  c.f = field_consts_from(host);
  if (PT_LIMBS == 8 && !sparse_shape(c.f)) return (int)cudaErrorInvalidValue;
  c.b3 = host[PT_FIELD_WORDS];
  for (int k = 1; k < PT_LIMBS; k++)
    if (host[PT_FIELD_WORDS + k] != 0) return (int)cudaErrorInvalidValue;
  if (c.b3 == 0) return (int)cudaErrorInvalidValue;
  for (int k = 0; k < PT_LIMBS; k++) c.r2[k] = host[PT_FIELD_WORDS + PT_LIMBS + k];
  return (int)cudaMemcpyToSymbolAsync(c_curve, &c, sizeof(c), 0, cudaMemcpyHostToDevice,
                                      stream);
}

struct Point {
  uint32_t x[PT_LIMBS], y[PT_LIMBS], z[PT_LIMBS];
};

__device__ __forceinline__ void pt_identity(Point& r) {
  fe_set_small(r.x, 0);
  fe_set_small(r.y, 1);
  fe_set_small(r.z, 0);
}

__device__ __forceinline__ void pt_load(Point& r, const int32_t* x, const int32_t* y,
                                        const int32_t* z, int64_t stride, int64_t i) {
  fe_load(r.x, x, stride, i);
  fe_load(r.y, y, stride, i);
  fe_load(r.z, z, stride, i);
}

__device__ __forceinline__ void pt_store(int32_t* x, int32_t* y, int32_t* z, int64_t stride,
                                         int64_t i, const Point& r) {
  fe_store(x, stride, i, r.x);
  fe_store(y, stride, i, r.y);
  fe_store(z, stride, i, r.z);
}

// Canonical coordinates -> Montgomery form: x R^2 / R = x R.
__device__ __forceinline__ void mpt_to_mont(Point& r, const MontCurveConsts& cc) {
  mf_mul(r.x, r.x, cc.r2, cc.f);
  mf_mul(r.y, r.y, cc.r2, cc.f);
  mf_mul(r.z, r.z, cc.r2, cc.f);
}

// Montgomery form -> canonical coordinates: x R 1 / R = x.
__device__ __forceinline__ void mpt_from_mont(Point& r, const MontCurveConsts& cc) {
  uint32_t one[PT_LIMBS];
  fe_set_small(one, 1);
  mf_mul(r.x, r.x, one, cc.f);
  mf_mul(r.y, r.y, one, cc.f);
  mf_mul(r.z, r.z, one, cc.f);
}

// The point formulas' additions and subtractions, on carry chains
// (cc_add_mod, cc_sub_mod: branch-free, one PTX instruction a limb and
// step, fewer instructions than fe_add / fe_sub's 64-bit adds, which made
// the accumulation faster on the H100 at both widths: PERF.md §6,
// msm_sweep.py).
__device__ __forceinline__ void pt_fadd(uint32_t r[PT_LIMBS], const uint32_t a[PT_LIMBS],
                                        const uint32_t b[PT_LIMBS], const FieldConsts& c) {
  cc_add_mod(r, a, b, c);
}

__device__ __forceinline__ void pt_fsub(uint32_t r[PT_LIMBS], const uint32_t a[PT_LIMBS],
                                        const uint32_t b[PT_LIMBS], const FieldConsts& c) {
  cc_sub_mod(r, a, b, c);
}

// r = k a for a small constant k >= 1 (double and add over k's bits).
__device__ __forceinline__ void pt_mul_small(uint32_t r[PT_LIMBS], const uint32_t a[PT_LIMBS],
                                             uint32_t k, const FieldConsts& c) {
  uint32_t x[PT_LIMBS];
  fe_copy(x, a);
#pragma unroll 1
  for (int bit = 30 - __clz(k); bit >= 0; bit--) {
    cc_add_mod(x, x, x, c);
    if ((k >> bit) & 1) cc_add_mod(x, x, a, c);
  }
  fe_copy(r, x);
}

// RCB15 Algorithm 7 (a = 0): one Montgomery product per multiply, the two
// multiplies by b3 done by additions.  r may alias p or q.
__device__ __forceinline__ void mpt_add(Point& r, const Point& p, const Point& q,
                                        const MontCurveConsts& cc) {
  const FieldConsts& c = cc.f;
  uint32_t t0[PT_LIMBS], t1[PT_LIMBS], t2[PT_LIMBS], t3[PT_LIMBS], t4[PT_LIMBS];
  uint32_t u[PT_LIMBS], v[PT_LIMBS], xz[PT_LIMBS];
  mf_mul(t0, p.x, q.x, c);
  mf_mul(t1, p.y, q.y, c);
  mf_mul(t2, p.z, q.z, c);
  pt_fadd(u, p.x, p.y, c);
  pt_fadd(v, q.x, q.y, c);
  mf_mul(t3, u, v, c);
  pt_fsub(t3, t3, t0, c);
  pt_fsub(t3, t3, t1, c);          // t3 = X1 Y2 + X2 Y1
  pt_fadd(u, p.y, p.z, c);
  pt_fadd(v, q.y, q.z, c);
  mf_mul(t4, u, v, c);
  pt_fsub(t4, t4, t1, c);
  pt_fsub(t4, t4, t2, c);          // t4 = Y1 Z2 + Y2 Z1
  pt_fadd(u, p.x, p.z, c);
  pt_fadd(v, q.x, q.z, c);
  mf_mul(xz, u, v, c);
  pt_fsub(xz, xz, t0, c);
  pt_fsub(xz, xz, t2, c);          // xz = X1 Z2 + X2 Z1
  pt_fadd(u, t0, t0, c);
  pt_fadd(t0, u, t0, c);           // t0 <- 3 t0
  pt_mul_small(t2, t2, cc.b3, c); // t2 <- b3 t2
  pt_fadd(u, t1, t2, c);           // z3p = t1 + b3 t2
  pt_fsub(t1, t1, t2, c);          // t1m = t1 - b3 t2
  pt_mul_small(xz, xz, cc.b3, c); // yb3 = b3 xz
  mf_mul(v, t3, t1, c);
  mf_mul(t2, t4, xz, c);
  pt_fsub(r.x, v, t2, c);          // X3 = t3 t1m - t4 yb3
  mf_mul(v, xz, t0, c);
  mf_mul(t2, t1, u, c);
  pt_fadd(r.y, v, t2, c);          // Y3 = yb3 t0_3 + t1m z3p
  mf_mul(v, u, t4, c);
  mf_mul(t2, t0, t3, c);
  pt_fadd(r.z, v, t2, c);          // Z3 = z3p t4 + t0_3 t3
}

// RCB15 Algorithm 9 (a = 0), as mpt_add, its two squares on mf_sqr.  r
// may alias p.
__device__ __forceinline__ void mpt_double(Point& r, const Point& p,
                                           const MontCurveConsts& cc) {
  const FieldConsts& c = cc.f;
  uint32_t t0[PT_LIMBS], t1[PT_LIMBS], t2[PT_LIMBS], txy[PT_LIMBS];
  mf_sqr(t0, p.y, c);
  mf_mul(t1, p.y, p.z, c);
  mf_sqr(t2, p.z, c);
  mf_mul(txy, p.x, p.y, c);
  uint32_t z3p[PT_LIMBS], x3p[PT_LIMBS], u[PT_LIMBS];
  pt_fadd(z3p, t0, t0, c);
  pt_fadd(z3p, z3p, z3p, c);
  pt_fadd(z3p, z3p, z3p, c);       // 8 Y^2
  pt_mul_small(t2, t2, cc.b3, c); // b3 Z^2
  mf_mul(x3p, t2, z3p, c);
  mf_mul(r.z, t1, z3p, c);        // Z3 = 8 Y^3 Z
  pt_fadd(t1, t0, t2, c);          // y3p = Y^2 + b3 Z^2
  pt_fadd(u, t2, t2, c);
  pt_fadd(u, u, t2, c);            // 3 b3 Z^2
  pt_fsub(t0, t0, u, c);           // t0m = Y^2 - 3 b3 Z^2
  mf_mul(u, t0, t1, c);
  pt_fadd(r.y, u, x3p, c);         // Y3 = t0m y3p + x3p
  pt_fadd(u, t0, t0, c);
  mf_mul(r.x, u, txy, c);         // X3 = 2 t0m X Y
}
