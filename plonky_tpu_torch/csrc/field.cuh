// Prime-field arithmetic on canonical 8 x 32-bit limb elements (p < 2^255).
//
// Shared by every kernel of the port.  An element is an integer in [0, p);
// limb k of element i of an [8, N] int32 tensor sits at base[k * N + i], so
// the 32 threads of a warp read 32 neighbouring words per limb.
//
// Multiplication: a 512-bit schoolbook product (64-bit multiply-adds), then
// Montgomery's REDC over 9 limbs (divides by 2^288, result < 2p), then one
// Montgomery multiply by F = 2^(288+256) mod p, which cancels both
// scalings.  The result is the canonical product; no Montgomery form is
// visible outside a kernel.  A product sum  sum_i +-a_i b_i  accumulates
// the 512-bit products (a negative term adds p * 2^256 - a_i b_i) in 17
// limbs and reduces ONCE; with at most 32 terms the sum stays below 2^516,
// which keeps the REDC output below 2p.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define PT_LIMBS 8
#define PT_ACC 17
#define PT_MAX_TERMS 32
#define PT_THREADS 256

struct FieldConsts {
  uint32_t p[PT_LIMBS];   // the modulus
  uint32_t f[PT_LIMBS];   // 2^544 mod p
  uint32_t pinv;          // -p^-1 mod 2^32
};

static inline FieldConsts field_consts_from(const uint32_t* host) {
  FieldConsts c;
  for (int k = 0; k < PT_LIMBS; k++) {
    c.p[k] = host[k];
    c.f[k] = host[PT_LIMBS + k];
  }
  c.pinv = host[2 * PT_LIMBS];
  return c;
}

static inline unsigned int pt_blocks(int64_t n) {
  return (unsigned int)((n + PT_THREADS - 1) / PT_THREADS);
}

__device__ __forceinline__ void fe_load(uint32_t r[PT_LIMBS], const int32_t* base,
                                        int64_t stride, int64_t i) {
#pragma unroll
  for (int k = 0; k < PT_LIMBS; k++) r[k] = (uint32_t)base[k * stride + i];
}

__device__ __forceinline__ void fe_store(int32_t* base, int64_t stride, int64_t i,
                                         const uint32_t r[PT_LIMBS]) {
#pragma unroll
  for (int k = 0; k < PT_LIMBS; k++) base[k * stride + i] = (int32_t)r[k];
}

__device__ __forceinline__ void fe_copy(uint32_t r[PT_LIMBS], const uint32_t a[PT_LIMBS]) {
#pragma unroll
  for (int k = 0; k < PT_LIMBS; k++) r[k] = a[k];
}

__device__ __forceinline__ void fe_set_small(uint32_t r[PT_LIMBS], uint32_t v) {
  r[0] = v;
#pragma unroll
  for (int k = 1; k < PT_LIMBS; k++) r[k] = 0;
}

// r = a - b over 256 bits; returns the borrow out (1 when a < b).
__device__ __forceinline__ uint32_t sub_borrow(uint32_t r[PT_LIMBS], const uint32_t a[PT_LIMBS],
                                               const uint32_t b[PT_LIMBS]) {
  uint32_t borrow = 0;
#pragma unroll
  for (int k = 0; k < PT_LIMBS; k++) {
    uint64_t t = (uint64_t)a[k] - b[k] - borrow;
    r[k] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
  }
  return borrow;
}

// r = a + b over 256 bits; returns the carry out.
__device__ __forceinline__ uint32_t add_carry(uint32_t r[PT_LIMBS], const uint32_t a[PT_LIMBS],
                                              const uint32_t b[PT_LIMBS]) {
  uint64_t carry = 0;
#pragma unroll
  for (int k = 0; k < PT_LIMBS; k++) {
    uint64_t t = (uint64_t)a[k] + b[k] + carry;
    r[k] = (uint32_t)t;
    carry = t >> 32;
  }
  return (uint32_t)carry;
}

// x < 2p  ->  x mod p.
__device__ __forceinline__ void fe_csub(uint32_t x[PT_LIMBS], const FieldConsts& c) {
  uint32_t d[PT_LIMBS];
  uint32_t borrow = sub_borrow(d, x, c.p);
  if (!borrow) fe_copy(x, d);
}

__device__ __forceinline__ void fe_add(uint32_t r[PT_LIMBS], const uint32_t a[PT_LIMBS],
                                       const uint32_t b[PT_LIMBS], const FieldConsts& c) {
  add_carry(r, a, b);  // < 2p < 2^256: no carry out
  fe_csub(r, c);
}

__device__ __forceinline__ void fe_sub(uint32_t r[PT_LIMBS], const uint32_t a[PT_LIMBS],
                                       const uint32_t b[PT_LIMBS], const FieldConsts& c) {
  if (sub_borrow(r, a, b)) add_carry(r, r, c.p);  // wraps back into [0, p)
}

// w[0..15] = a * b (512 bits).
__device__ __forceinline__ void mul_wide(uint32_t w[2 * PT_LIMBS], const uint32_t a[PT_LIMBS],
                                         const uint32_t b[PT_LIMBS]) {
#pragma unroll
  for (int k = 0; k < 2 * PT_LIMBS; k++) w[k] = 0;
#pragma unroll
  for (int i = 0; i < PT_LIMBS; i++) {
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < PT_LIMBS; j++) {
      uint64_t t = (uint64_t)a[i] * b[j] + w[i + j] + carry;
      w[i + j] = (uint32_t)t;
      carry = t >> 32;
    }
    w[i + PT_LIMBS] = (uint32_t)carry;
  }
}

// Montgomery REDC of t[0 .. LEN-1] over STEPS limbs: afterwards
// t[STEPS .. STEPS+7] holds (t + m p) / 2^(32 STEPS) for the m that clears
// the low limbs.  The caller guarantees the sum fits LEN limbs.
template <int LEN, int STEPS>
__device__ __forceinline__ void redc(uint32_t t[LEN], const FieldConsts& c) {
#pragma unroll
  for (int i = 0; i < STEPS; i++) {
    uint32_t m = t[i] * c.pinv;
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < PT_LIMBS; j++) {
      uint64_t x = (uint64_t)m * c.p[j] + t[i + j] + carry;
      t[i + j] = (uint32_t)x;
      carry = x >> 32;
    }
#pragma unroll
    for (int k = i + PT_LIMBS; k < LEN; k++) {
      uint64_t x = (uint64_t)t[k] + carry;
      t[k] = (uint32_t)x;
      carry = x >> 32;
    }
  }
}

// acc (< 2^516) -> acc mod p.
__device__ __forceinline__ void fe_reduce_acc(uint32_t r[PT_LIMBS], uint32_t acc[PT_ACC],
                                              const FieldConsts& c) {
  redc<PT_ACC, 9>(acc, c);            // acc * 2^-288 mod p, < 2p
  uint32_t x[PT_LIMBS];
#pragma unroll
  for (int k = 0; k < PT_LIMBS; k++) x[k] = acc[9 + k];
  fe_csub(x, c);
  uint32_t w[2 * PT_LIMBS + 1];
  mul_wide(w, x, c.f);                // < p^2
  w[2 * PT_LIMBS] = 0;
  redc<2 * PT_LIMBS + 1, PT_LIMBS>(w, c);   // x F 2^-256 = acc mod p, < 2p
#pragma unroll
  for (int k = 0; k < PT_LIMBS; k++) r[k] = w[PT_LIMBS + k];
  fe_csub(r, c);
}

__device__ __forceinline__ void acc_zero(uint32_t acc[PT_ACC]) {
#pragma unroll
  for (int k = 0; k < PT_ACC; k++) acc[k] = 0;
}

// acc += x, x given as n limbs at offset `off`.
template <int N>
__device__ __forceinline__ void acc_add(uint32_t acc[PT_ACC], const uint32_t x[N], int off) {
  uint64_t carry = 0;
#pragma unroll
  for (int k = 0; k < PT_ACC; k++) {
    uint64_t xv = (k >= off && k - off < N) ? x[k - off] : 0;
    uint64_t t = (uint64_t)acc[k] + xv + carry;
    acc[k] = (uint32_t)t;
    carry = t >> 32;
  }
}

// acc -= x (the caller guarantees no underflow).
template <int N>
__device__ __forceinline__ void acc_sub(uint32_t acc[PT_ACC], const uint32_t x[N]) {
  uint32_t borrow = 0;
#pragma unroll
  for (int k = 0; k < PT_ACC; k++) {
    uint64_t xv = k < N ? x[k] : 0;
    uint64_t t = (uint64_t)acc[k] - xv - borrow;
    acc[k] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
  }
}

// acc += sign * a * b  (a negative term adds p * 2^256 - a b >= 0).
__device__ __forceinline__ void acc_product(uint32_t acc[PT_ACC], const uint32_t a[PT_LIMBS],
                                            const uint32_t b[PT_LIMBS], int sign,
                                            const FieldConsts& c) {
  uint32_t w[2 * PT_LIMBS];
  mul_wide(w, a, b);
  if (sign >= 0) {
    acc_add<2 * PT_LIMBS>(acc, w, 0);
  } else {
    acc_add<PT_LIMBS>(acc, c.p, PT_LIMBS);
    acc_sub<2 * PT_LIMBS>(acc, w);
  }
}

// acc += sign * a  (a negative term adds p - a).
__device__ __forceinline__ void acc_single(uint32_t acc[PT_ACC], const uint32_t a[PT_LIMBS],
                                           int sign, const FieldConsts& c) {
  if (sign >= 0) {
    acc_add<PT_LIMBS>(acc, a, 0);
  } else {
    uint32_t d[PT_LIMBS];
    sub_borrow(d, c.p, a);
    acc_add<PT_LIMBS>(acc, d, 0);
  }
}

__device__ __forceinline__ void fe_mul(uint32_t r[PT_LIMBS], const uint32_t a[PT_LIMBS],
                                       const uint32_t b[PT_LIMBS], const FieldConsts& c) {
  uint32_t acc[PT_ACC];
  mul_wide(acc, a, b);
  acc[2 * PT_LIMBS] = 0;
  fe_reduce_acc(r, acc, c);
}

// ---------------------------------------------------------------------------
// Montgomery form (R = 2^256), used inside the point kernels only (K2, K4;
// curve.cuh): an element x is held as x R mod p, canonical in [0, p).
// Additions are the canonical ones; a product is one CIOS Montgomery
// multiply (one 8 x 8 limb product interleaved with one REDC), a quarter of
// the work of fe_mul.  Only c.p and c.pinv are read.
// ---------------------------------------------------------------------------

// r = a b / 2^256 mod p for a, b < p (p < 2^255, so every partial sum fits
// 9 limbs and the result is below 2p before the final subtraction).  The
// loop over a's limbs is kept rolled (a shifts down one limb per round, so
// every index stays static and a stays in registers): ~70 instructions of
// machine code instead of the ~600 an unrolled product takes.
__device__ __forceinline__ void mf_mul(uint32_t r[PT_LIMBS], const uint32_t a_in[PT_LIMBS],
                                       const uint32_t b[PT_LIMBS], const FieldConsts& c) {
  uint32_t a[PT_LIMBS], t[PT_LIMBS];
#pragma unroll
  for (int k = 0; k < PT_LIMBS; k++) {
    a[k] = a_in[k];
    t[k] = 0;
  }
  uint32_t t8 = 0;
#pragma unroll 1
  for (int i = 0; i < PT_LIMBS; i++) {
    uint32_t ai = a[0];
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < PT_LIMBS; j++) {
      uint64_t x = (uint64_t)ai * b[j] + t[j] + carry;
      t[j] = (uint32_t)x;
      carry = x >> 32;
    }
    uint64_t top = (uint64_t)t8 + carry;
    uint32_t m = t[0] * c.pinv;
    uint64_t x = (uint64_t)m * c.p[0] + t[0];
    carry = x >> 32;
#pragma unroll
    for (int j = 1; j < PT_LIMBS; j++) {
      x = (uint64_t)m * c.p[j] + t[j] + carry;
      t[j - 1] = (uint32_t)x;
      carry = x >> 32;
    }
    top += carry;
    t[PT_LIMBS - 1] = (uint32_t)top;
    t8 = (uint32_t)(top >> 32);
#pragma unroll
    for (int k = 0; k < PT_LIMBS - 1; k++) a[k] = a[k + 1];
  }
#pragma unroll
  for (int k = 0; k < PT_LIMBS; k++) r[k] = t[k];
  fe_csub(r, c);
}

// r = k a for a small constant k >= 1 (double and add over k's bits; the
// multiply by b3 = 3b in the point formulas).
__device__ __forceinline__ void mf_mul_small(uint32_t r[PT_LIMBS], const uint32_t a[PT_LIMBS],
                                             uint32_t k, const FieldConsts& c) {
  uint32_t x[PT_LIMBS];
  fe_copy(x, a);
#pragma unroll 1
  for (int bit = 30 - __clz(k); bit >= 0; bit--) {
    fe_add(x, x, x, c);
    if ((k >> bit) & 1) fe_add(x, x, a, c);
  }
  fe_copy(r, x);
}
