// Prime-field arithmetic on canonical 8 x 32-bit limb elements (p < 2^255).
//
// Shared by every kernel of the port.  An element is an integer in [0, p);
// limb k of element i of an [8, N] int32 tensor sits at base[k * N + i], so
// the 32 threads of a warp read 32 neighbouring words per limb.
//
// Inputs and outputs are canonical; no Montgomery form is visible outside a
// kernel.  A single product (field_mul) is one Barrett reduction on carry
// chains (cc_mul_mod, below); the NTT's twiddle products are one Montgomery
// product against twiddles held as w 2^256 mod p (cc_mont_mul).  A product
// sum  sum_i +-a_i b_i  (field_product_sum) accumulates the 512-bit
// products (a negative term adds p * 2^256 - a_i b_i) in 17 limbs and
// reduces ONCE: Montgomery's REDC over 9 limbs (divides by 2^288, result
// < 2p), then one Montgomery multiply by F = 2^(288+256) mod p, which
// cancels both scalings; with at most 32 terms the sum stays below 2^516,
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

// ---------------------------------------------------------------------------
// Montgomery form (R = 2^256), used inside the point kernels only (K2, K4;
// curve.cuh): an element x is held as x R mod p, canonical in [0, p).
// Additions are the canonical ones; a product is one CIOS Montgomery
// multiply (one 8 x 8 limb product interleaved with one REDC), a quarter of
// the work of the two-pass reduction.  Only c.p and c.pinv are read.
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

// ---------------------------------------------------------------------------
// Carry-chain arithmetic (K1 and K3): the limb products and the carries run
// as PTX carry chains (mad.lo.cc / madc.hi.cc / addc.cc / subc.cc: the
// hardware carry flag), fully unrolled.  These are throughput kernels, so
// code size matters less than the instruction count.  Each helper is one
// PTX instruction; a chain is a run of them with nothing between that
// touches the carry flag.
//
// field_mul reduces ONCE per product, by Barrett (HAC 14.42 with the base
// 2^32): for x = a b < p^2,
//   q1 = floor(x / 2^224)                    (9 limbs, x's limbs 7..15)
//   q3 = floor(q1 mu / 2^288), mu = floor(2^512 / p)   (9 limbs)
//   r  = (x - q3 p) mod 2^256
// where the product q1 mu skips the limb products of columns 0..6 (their
// sum is below 2^259, against the 2^288 that q3 divides by).  Every
// truncation rounds down, so q3 <= floor(x / p).  Before q3's own floor,
// the truncated q1 mu / 2^288 falls short of x / p by less than
//   x / 2^512 + 2^224 / p + 2^-29 < 1      (for 2^226 < p < 2^255),
// and the floor loses less than 1 more, so x / p - q3 < 2: q3 is
// floor(x / p) or one less, r = x - q3 p < 2p < 2^256, and one
// conditional subtraction of p makes it canonical.  The Python model of
// these steps, with these bounds asserted, is tests/test_torch_barrett.py.
// ---------------------------------------------------------------------------

#define PT_MU_LIMBS 9

// K1's constants: the field's, and field_mul's Barrett factor.
struct MulConsts {
  FieldConsts f;
  uint32_t mu[PT_MU_LIMBS];   // floor(2^512 / p)
};

// From the host buffer [p, 2^544 mod p, -p^-1 mod 2^32, mu (9 limbs)]
// (fields/spec.py:FieldSpec.mul_consts).
static inline MulConsts mul_consts_from(const uint32_t* host) {
  MulConsts c;
  c.f = field_consts_from(host);
  for (int k = 0; k < PT_MU_LIMBS; k++) c.mu[k] = host[2 * PT_LIMBS + 1 + k];
  return c;
}

__device__ __forceinline__ uint32_t cc_add(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t cc_addc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t cc_addc_end(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t cc_sub(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t cc_subc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t cc_subc_end(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t cc_mad_lo(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t cc_madc_lo(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t cc_madc_lo_end(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.lo.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t cc_mad_hi(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("mad.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t cc_madc_hi(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t cc_madc_hi_end(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}

// acc[0 .. N+1] += x * y[0 .. N-1]: the low halves in one chain, the high
// halves one limb up in a second.  The caller keeps the sum within the
// N + 2 limbs (the carry out of acc[N+1] is dropped).
template <int N>
__device__ __forceinline__ void cc_mac_row(uint32_t* acc, uint32_t x, const uint32_t* y) {
  const uint32_t zero = 0;
  acc[0] = cc_mad_lo(x, y[0], acc[0]);
#pragma unroll
  for (int k = 1; k < N; k++) acc[k] = cc_madc_lo(x, y[k], acc[k]);
  acc[N] = cc_addc(acc[N], zero);
  acc[N + 1] = cc_addc_end(acc[N + 1], zero);
  acc[1] = cc_mad_hi(x, y[0], acc[1]);
#pragma unroll
  for (int k = 1; k < N; k++) acc[k + 1] = cc_madc_hi(x, y[k], acc[k + 1]);
  acc[N + 1] = cc_addc_end(acc[N + 1], zero);
}

// acc[0 .. N-1] += x * y[0 .. N-1] mod 2^(32 N): the products' parts at
// limb N and above are never formed.
template <int N>
__device__ __forceinline__ void cc_mac_row_lo(uint32_t* acc, uint32_t x, const uint32_t* y) {
  if constexpr (N == 1) {
    acc[0] += x * y[0];
  } else {
    acc[0] = cc_mad_lo(x, y[0], acc[0]);
#pragma unroll
    for (int k = 1; k < N - 1; k++) acc[k] = cc_madc_lo(x, y[k], acc[k]);
    acc[N - 1] = cc_madc_lo_end(x, y[N - 1], acc[N - 1]);
    if constexpr (N == 2) {
      acc[1] += __umulhi(x, y[0]);
    } else {
      acc[1] = cc_mad_hi(x, y[0], acc[1]);
#pragma unroll
      for (int k = 1; k < N - 2; k++) acc[k + 1] = cc_madc_hi(x, y[k], acc[k + 1]);
      acc[N - 1] = cc_madc_hi_end(x, y[N - 2], acc[N - 1]);
    }
  }
}

// x < 2p  ->  x mod p.
__device__ __forceinline__ void cc_csub(uint32_t x[PT_LIMBS], const FieldConsts& c) {
  const uint32_t zero = 0;
  uint32_t d[PT_LIMBS];
  d[0] = cc_sub(x[0], c.p[0]);
#pragma unroll
  for (int k = 1; k < PT_LIMBS; k++) d[k] = cc_subc(x[k], c.p[k]);
  uint32_t borrow = cc_subc_end(zero, zero);   // all ones when x < p
#pragma unroll
  for (int k = 0; k < PT_LIMBS; k++) x[k] = borrow ? x[k] : d[k];
}

// r = a + b mod p (a, b canonical: a + b < 2p < 2^256, no carry out).
__device__ __forceinline__ void cc_add_mod(uint32_t r[PT_LIMBS], const uint32_t a[PT_LIMBS],
                                           const uint32_t b[PT_LIMBS], const FieldConsts& c) {
  r[0] = cc_add(a[0], b[0]);
#pragma unroll
  for (int k = 1; k < PT_LIMBS - 1; k++) r[k] = cc_addc(a[k], b[k]);
  r[PT_LIMBS - 1] = cc_addc_end(a[PT_LIMBS - 1], b[PT_LIMBS - 1]);
  cc_csub(r, c);
}

// r = a - b mod p (a, b canonical): a - b, plus p where it borrowed.
__device__ __forceinline__ void cc_sub_mod(uint32_t r[PT_LIMBS], const uint32_t a[PT_LIMBS],
                                           const uint32_t b[PT_LIMBS], const FieldConsts& c) {
  const uint32_t zero = 0;
  r[0] = cc_sub(a[0], b[0]);
#pragma unroll
  for (int k = 1; k < PT_LIMBS; k++) r[k] = cc_subc(a[k], b[k]);
  uint32_t mask = cc_subc_end(zero, zero);
  r[0] = cc_add(r[0], c.p[0] & mask);
#pragma unroll
  for (int k = 1; k < PT_LIMBS - 1; k++) r[k] = cc_addc(r[k], c.p[k] & mask);
  r[PT_LIMBS - 1] = cc_addc_end(r[PT_LIMBS - 1], c.p[PT_LIMBS - 1] & mask);
}

// r = a b mod p for canonical a, b: the 512-bit product and one Barrett
// reduction (see the top of this section).
__device__ __forceinline__ void cc_mul_mod(uint32_t r[PT_LIMBS], const uint32_t a[PT_LIMBS],
                                           const uint32_t b[PT_LIMBS], const MulConsts& c) {
  // x = a b in w[0..15]; w[16..17] stay zero (room for cc_mac_row).
  uint32_t w[2 * PT_LIMBS + 2];
#pragma unroll
  for (int k = 0; k < 2 * PT_LIMBS + 2; k++) w[k] = 0;
#pragma unroll
  for (int i = 0; i < PT_LIMBS; i++) cc_mac_row<PT_LIMBS>(w + i, a[i], b);
  // q1 = w[7..15]; u[k] is column 7 + k of q1 mu.  Row i multiplies q1's
  // limb i by mu's limbs from 7 - i up (columns 0..6 skipped).
  uint32_t u[12];
#pragma unroll
  for (int k = 0; k < 12; k++) u[k] = 0;
  cc_mac_row<2>(u, w[7], c.mu + 7);
  cc_mac_row<3>(u, w[8], c.mu + 6);
  cc_mac_row<4>(u, w[9], c.mu + 5);
  cc_mac_row<5>(u, w[10], c.mu + 4);
  cc_mac_row<6>(u, w[11], c.mu + 3);
  cc_mac_row<7>(u, w[12], c.mu + 2);
  cc_mac_row<8>(u, w[13], c.mu + 1);
  cc_mac_row<9>(u, w[14], c.mu);
  cc_mac_row<9>(u + 1, w[15], c.mu);
  // q3 = columns 9..16 = u[2..9] (< p: one limb short of mu's 9)
  const uint32_t* q3 = u + 2;
  uint32_t v[PT_LIMBS];   // q3 p mod 2^256
#pragma unroll
  for (int k = 0; k < PT_LIMBS; k++) v[k] = 0;
  cc_mac_row_lo<8>(v, q3[0], c.f.p);
  cc_mac_row_lo<7>(v + 1, q3[1], c.f.p);
  cc_mac_row_lo<6>(v + 2, q3[2], c.f.p);
  cc_mac_row_lo<5>(v + 3, q3[3], c.f.p);
  cc_mac_row_lo<4>(v + 4, q3[4], c.f.p);
  cc_mac_row_lo<3>(v + 5, q3[5], c.f.p);
  cc_mac_row_lo<2>(v + 6, q3[6], c.f.p);
  cc_mac_row_lo<1>(v + 7, q3[7], c.f.p);
  // r = x - q3 p mod 2^256, in [0, 2p)
  r[0] = cc_sub(w[0], v[0]);
#pragma unroll
  for (int k = 1; k < PT_LIMBS - 1; k++) r[k] = cc_subc(w[k], v[k]);
  r[PT_LIMBS - 1] = cc_subc_end(w[PT_LIMBS - 1], v[PT_LIMBS - 1]);
  cc_csub(r, c.f);
}

// r = a b / 2^256 mod p for canonical a, b (CIOS Montgomery, unrolled, on
// carry chains): with b = w 2^256 mod p, r = a w mod p exactly.  The
// running sum t stays below 2p + 1 after each round (p < 2^255), so it
// fits t[0..9] while a round adds a_i b and m p.
__device__ __forceinline__ void cc_mont_mul(uint32_t r[PT_LIMBS], const uint32_t a[PT_LIMBS],
                                            const uint32_t b[PT_LIMBS], const FieldConsts& c) {
  uint32_t t[2 * PT_LIMBS + 2];   // the window t[i .. i+9] is round i's
#pragma unroll
  for (int k = 0; k < 2 * PT_LIMBS + 2; k++) t[k] = 0;
#pragma unroll
  for (int i = 0; i < PT_LIMBS; i++) {
    cc_mac_row<PT_LIMBS>(t + i, a[i], b);
    uint32_t m = t[i] * c.pinv;
    cc_mac_row<PT_LIMBS>(t + i, m, c.p);   // clears t[i]
  }
#pragma unroll
  for (int k = 0; k < PT_LIMBS; k++) r[k] = t[PT_LIMBS + k];
  cc_csub(r, c);
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
