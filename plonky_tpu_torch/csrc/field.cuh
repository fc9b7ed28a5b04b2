// Prime-field arithmetic on canonical L x 32-bit limb elements, L =
// PT_LIMBS: 8 for p < 2^255 (the default), 12 for p < 2^383 (built with
// -DPT_LIMBS=12, for BLS12-377's base field).
//
// Shared by every kernel of the port.  An element is an integer in [0, p);
// limb k of element i of an [L, N] int32 tensor sits at base[k * N + i], so
// the 32 threads of a warp read 32 neighbouring words per limb.
//
// Inputs and outputs are canonical; no Montgomery form is visible outside a
// kernel.  A single product (field_mul) is one Barrett reduction on carry
// chains (cc_mul_mod, below); the NTT's twiddle products are one Montgomery
// product against twiddles held as w 2^(32 L) mod p (cc_mont_mul).  A
// product sum  sum_i +-a_i b_i  (field_product_sum) adds its products
// straight into a (2L + 1)-limb accumulator on the same carry chains and
// reduces ONCE, by Barrett with mu = floor(2^(32 (2L + 1)) / p)
// (cc_acc_product, cc_sum_mod).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#ifndef PT_LIMBS
#define PT_LIMBS 8
#endif
static_assert(PT_LIMBS == 8 || PT_LIMBS == 12, "PT_LIMBS is 8 or 12");
#define PT_THREADS 256

// -DPT_ONLY=k builds only a source's k-th kernel and its C entry, so that
// the kernels of a large source compile in parallel, one object each
// (_cuda.py:objects); 0, the default, builds them all.
#ifndef PT_ONLY
#define PT_ONLY 0
#endif
#define PT_BUILDS(k) (PT_ONLY == 0 || PT_ONLY == (k))

// Both widths link into one library: the 12-limb build's C entries carry
// the suffix _l12 (PT_ENTRY(pt_field_mul) is pt_field_mul_l12) and its
// kernels live in namespace pt_l12, so that no symbol is defined twice.
#if PT_LIMBS == 8
#define PT_ENTRY(name) name
#define PT_NAMESPACE_BEGIN
#define PT_NAMESPACE_END
#else
#define PT_ENTRY_CAT(name, limbs) name##_l##limbs
#define PT_ENTRY_EXPAND(name, limbs) PT_ENTRY_CAT(name, limbs)
#define PT_ENTRY(name) PT_ENTRY_EXPAND(name, PT_LIMBS)
#define PT_NAMESPACE_BEGIN namespace pt_l12 {
#define PT_NAMESPACE_END }
#endif

struct FieldConsts {
  uint32_t p[PT_LIMBS];   // the modulus
  uint32_t pinv;          // -p^-1 mod 2^32
};

// The words of FieldSpec.kernel_consts: [p (L limbs), -p^-1 mod 2^32].
#define PT_FIELD_WORDS (PT_LIMBS + 1)

static inline FieldConsts field_consts_from(const uint32_t* host) {
  FieldConsts c;
  for (int k = 0; k < PT_LIMBS; k++) c.p[k] = host[k];
  c.pinv = host[PT_LIMBS];
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

// r = a - b over 32 L bits; returns the borrow out (1 when a < b).
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

// r = a + b over 32 L bits; returns the carry out.
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
  add_carry(r, a, b);  // < 2p < 2^(32 L): no carry out
  fe_csub(r, c);
}

__device__ __forceinline__ void fe_sub(uint32_t r[PT_LIMBS], const uint32_t a[PT_LIMBS],
                                       const uint32_t b[PT_LIMBS], const FieldConsts& c) {
  if (sub_borrow(r, a, b)) add_carry(r, r, c.p);  // wraps back into [0, p)
}

// ---------------------------------------------------------------------------
// Montgomery form (R = 2^(32 L)), used inside the point kernels (K2, K4;
// curve.cuh) and K5: an element x is held as x R mod p, canonical in
// [0, p).  Additions are the canonical ones.  The point kernels' product,
// mf_mul, is the unrolled product and REDC of the carry-chain section (at
// the end of this file): at 8 limbs with the sparse REDC rows, for
// p = 2^254 + c only; at 12 with the dense ones.  K5's conversions in and
// out of the form take mf_mul_any, any field: at 8 limbs one CIOS
// Montgomery multiply (one L x L limb product interleaved with one REDC),
// kept rolled; at 12 the point kernels' mf_mul.
// ---------------------------------------------------------------------------

#if PT_LIMBS == 8
// r = a b / 2^(32 L) mod p for a, b < p (p < 2^(32 L - 1), so every partial
// sum fits L + 1 limbs and the result is below 2p before the final
// subtraction).  The loop over a's limbs is kept rolled (a shifts down one
// limb per round, so every index stays static and a stays in registers):
// ~70 instructions of machine code at 8 limbs instead of the ~600 an
// unrolled product takes.
__device__ __forceinline__ void mf_mul_any(uint32_t r[PT_LIMBS], const uint32_t a_in[PT_LIMBS],
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
#endif  // PT_LIMBS == 8

// ---------------------------------------------------------------------------
// Carry-chain arithmetic (K1 and K3): the limb products and the carries run
// as PTX carry chains (mad.lo.cc / madc.hi.cc / addc.cc / subc.cc: the
// hardware carry flag), fully unrolled.  These are throughput kernels, so
// code size matters less than the instruction count.  Each helper is one
// PTX instruction; a chain is a run of them with nothing between that
// touches the carry flag.
//
// field_mul reduces ONCE per product, by Barrett (HAC 14.42 with the base
// 2^32): for x = a b < p^2 over L limbs,
//   q1 = floor(x / 2^(32 (L - 1)))           (L + 1 limbs, x's limbs L-1..2L-1)
//   q3 = floor(q1 mu / 2^(32 (L + 1))), mu = floor(2^(64 L) / p)   (L + 1 limbs)
//   r  = (x - q3 p) mod 2^(32 L)
// where the product q1 mu skips the limb products of columns 0..L-2 (their
// sum is below (L - 1) 2^(32 L) (1 + 2^-31): 2^259 at 8 limbs, 2^388 at
// 12, against the 2^(32 (L + 1)) that q3 divides by).  Every truncation
// rounds down, so q3 <= floor(x / p).  Before q3's own floor, the truncated
// q1 mu / 2^(32 (L + 1)) falls short of x / p by less than
//   x / 2^(64 L) + 2^(32 (L - 1)) / p + (L - 1) 2^-32 < 1,
// which holds at 8 limbs for 2^226 < p < 2^255 (2^-2 + 2^-2 + 2^-29) and at
// 12 limbs for 2^354 < p < 2^383 (2^-2 + 2^-2 + 2^-28; BLS12-377's
// 2^376 < p < 2^377 gives below 2^-14), and the floor loses less than 1
// more, so x / p - q3 < 2: q3 is floor(x / p) or one less,
// r = x - q3 p < 2p < 2^(32 L), and one conditional subtraction of p makes
// it canonical.  The Python model of these steps at both widths, with these
// bounds asserted, is tests/test_torch_barrett.py.
// ---------------------------------------------------------------------------

#define PT_MU_LIMBS (PT_LIMBS + 1)
#define PT_MU_SUM_LIMBS (PT_LIMBS + 2)

// K1's constants: the field's and the Barrett factors of a product and of a
// product sum.
struct MulConsts {
  FieldConsts f;
  uint32_t mu[PT_MU_LIMBS];           // floor(2^(64 L) / p)
  uint32_t mu_sum[PT_MU_SUM_LIMBS];   // floor(2^(32 (2L + 1)) / p)
};

// From the host buffer [p, -p^-1 mod 2^32, mu (L + 1 limbs), mu_sum (L + 2
// limbs)] (fields/spec.py:FieldSpec.mul_consts).
static inline MulConsts mul_consts_from(const uint32_t* host) {
  MulConsts c;
  c.f = field_consts_from(host);
  for (int k = 0; k < PT_MU_LIMBS; k++) c.mu[k] = host[PT_FIELD_WORDS + k];
  for (int k = 0; k < PT_MU_SUM_LIMBS; k++)
    c.mu_sum[k] = host[PT_FIELD_WORDS + PT_MU_LIMBS + k];
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

// r = a + b mod p (a, b canonical: a + b < 2p < 2^(32 L), no carry out).
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

// v += q3 p mod 2^(32 L), rows I .. L-1: row I adds q3's limb I times p's
// limbs 0 .. L-1-I into v[I ..] (at 8 limbs cc_mac_row_lo<8> on v, <7> on
// v + 1, ..., <1> on v + 7).
template <int I>
__device__ __forceinline__ void cc_qp_rows(uint32_t* v, const uint32_t* q3,
                                           const uint32_t* p) {
  if constexpr (I < PT_LIMBS) {
    cc_mac_row_lo<PT_LIMBS - I>(v + I, q3[I], p);
    cc_qp_rows<I + 1>(v, q3, p);
  }
}

// r = (x - q3 p) mod 2^(32 L) for x - q3 p in [0, 2p), then canonical: the
// last steps of both Barrett reductions.  Only x's and q3's low L limbs
// are read, and only q3 p's low 32 L bits are formed.
__device__ __forceinline__ void cc_barrett_finish(uint32_t r[PT_LIMBS], const uint32_t* x,
                                                  const uint32_t* q3, const FieldConsts& c) {
  uint32_t v[PT_LIMBS];   // q3 p mod 2^(32 L)
#pragma unroll
  for (int k = 0; k < PT_LIMBS; k++) v[k] = 0;
  cc_qp_rows<0>(v, q3, c.p);
  r[0] = cc_sub(x[0], v[0]);
#pragma unroll
  for (int k = 1; k < PT_LIMBS - 1; k++) r[k] = cc_subc(x[k], v[k]);
  r[PT_LIMBS - 1] = cc_subc_end(x[PT_LIMBS - 1], v[PT_LIMBS - 1]);
  cc_csub(r, c);
}

// u += the columns L-1 and up of q1 mu, rows I .. L, q1 = w[L-1 .. 2L-1],
// u[k] column L - 1 + k: row I < L multiplies q1's limb I by mu's limbs from
// L - 1 - I up (columns 0..L-2 skipped), into the window u[0 .. I + 3]; row
// L multiplies q1's top limb by all of mu, one limb up.  At 8 limbs:
// cc_mac_row<2>(u, w[7], mu + 7), <3>(u, w[8], mu + 6), ...,
// <9>(u, w[14], mu), then <9>(u + 1, w[15], mu).
template <int I>
__device__ __forceinline__ void cc_barrett_rows(uint32_t* u, const uint32_t* w,
                                                const uint32_t* mu) {
  if constexpr (I < PT_LIMBS) {
    cc_mac_row<I + 2>(u, w[PT_LIMBS - 1 + I], mu + (PT_LIMBS - 1 - I));
    cc_barrett_rows<I + 1>(u, w, mu);
  } else {
    cc_mac_row<PT_LIMBS + 1>(u + 1, w[2 * PT_LIMBS - 1], mu);
  }
}

// r = a b mod p for canonical a, b: the 64L-bit product and one Barrett
// reduction (see the top of this section).
__device__ __forceinline__ void cc_mul_mod(uint32_t r[PT_LIMBS], const uint32_t a[PT_LIMBS],
                                           const uint32_t b[PT_LIMBS], const MulConsts& c) {
  // x = a b in w[0..2L-1]; w[2L..2L+1] stay zero (room for cc_mac_row).
  uint32_t w[2 * PT_LIMBS + 2];
#pragma unroll
  for (int k = 0; k < 2 * PT_LIMBS + 2; k++) w[k] = 0;
#pragma unroll
  for (int i = 0; i < PT_LIMBS; i++) cc_mac_row<PT_LIMBS>(w + i, a[i], b);
  // q1 = w[L-1..2L-1]; u[k] is column L - 1 + k of q1 mu.
  uint32_t u[PT_LIMBS + 4];
#pragma unroll
  for (int k = 0; k < PT_LIMBS + 4; k++) u[k] = 0;
  cc_barrett_rows<0>(u, w, c.mu);
  // q3 = columns L+1..2L = u[2..L+1] (< p: one limb short of mu's L + 1)
  cc_barrett_finish(r, w, u + 2, c.f);
}

// r = a b / 2^(32 L) mod p for canonical a, b (CIOS Montgomery, unrolled,
// on carry chains): with b = w 2^(32 L) mod p, r = a w mod p exactly.  The
// running sum t stays below 2p + 1 after each round (p < 2^(32 L - 1)), so
// it fits t[i .. i+L] while a round adds a_i b and m p in the window
// t[i .. i+L+1].
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

// ---------------------------------------------------------------------------
// Product sums (field_product_sum): S = sum_t x_t y_t + sum_s z_s over at
// most PT_MAX_TERMS terms of canonical operands.  A negative product
// -a b enters as a (p - b), a negative single -z as p - z (the same
// residues; p - b <= p), so every term is a nonnegative integer below p^2
// and S < 32 p^2 < 2^(64 L + 3): below 2^515 at 8 limbs, 2^759 at 12
// (p < 2^377).
//
// The terms go straight into a 2L-limb accumulator acc[0..2L-1] on carry
// chains, with no 64L-bit temporary: row i of a product adds the low
// halves of x_i y into acc[i .. i+L-1] on one chain and the high halves
// into acc[i+1 .. i+L] on a second; each chain's carry out (into limb
// i + L or i + L + 1) is counted in cnt[i] or cnt[i + 1] (cnt[k]: carries
// into limb L + k, L + 1 counters) instead of rippling through the limbs
// above.  A single adds into acc[0..L-1], its carry into cnt[0].  A term
// adds at most 2 to a counter, so cnt[k] <= 64, and acc + sum_k cnt[k]
// 2^(32 (L + k)) is S exactly.  cc_acc_fold adds the counters in once,
// into 2L + 1 limbs (S < 2^(32 (2L + 1)): no carry leaves the top limb).
//
// Then ONE Barrett reduction (cc_sum_mod), cc_mul_mod's for 2L + 1 limbs:
//   q1 = floor(S / 2^(32 (L - 1)))              (L + 2 limbs, S's limbs L-1..2L)
//   q3 = floor(q1 mu / 2^(32 (L + 2))), mu = floor(2^(32 (2L + 1)) / p)
//   r  = (S - q3 p) mod 2^(32 L)
// where q1 mu skips the limb products of columns 0..L-1 (their sum is
// below L 2^(32 (L + 1)) (1 + 2^-31), against the 2^(32 (L + 2)) that q3
// divides by: 2^292 against 2^320 at 8 limbs, 2^420 against 2^448 at 12),
// and only columns L..2L+4 are formed.  Every truncation rounds down, so
// q3 <= floor(S / p).  Before q3's own floor, the truncated q1 mu /
// 2^(32 (L + 2)) falls short of S / p by less than
//   S / 2^(32 (2L + 1)) + 2^(32 (L - 1)) / p + L 2^-32 < 1:
// at 8 limbs for 2^226 < p < 2^255 (2^-29 + 2^-2 + 2^-29; below 2^-27 for
// the Tweedle fields, p > 2^254), at 12 limbs for 2^354 < p < 2^383
// (2^-29 + 2^-2 + 2^-28; BLS12-377's 2^376 < p < 2^377 gives below
// 2^-23), the ranges of field_mul's Barrett reduction
// (fields/spec.py:BARRETT_RANGE).  The floor loses less than 1 more, so
// S / p - q3 < 2: q3 is floor(S / p) or one less, r = S - q3 p < 2p <
// 2^(32 L), and exactly one conditional subtraction of p makes it
// canonical.  Only q3's low L limbs (columns L+2..2L+1) enter r.  The
// Python model of these steps at both widths, with every bound asserted,
// is tests/test_torch_product_sum.py.
// ---------------------------------------------------------------------------

#define PT_MAX_TERMS 32
#define PT_ACC_LIMBS (2 * PT_LIMBS)       // acc[0..2L-1]; the counters hold limbs L..2L
#define PT_ACC_CARRIES (PT_LIMBS + 1)

// acc[I .. I+L] += x y[0..L-1], carries out counted (see above).
template <int I>
__device__ __forceinline__ void cc_acc_row(uint32_t acc[PT_ACC_LIMBS],
                                           uint32_t cnt[PT_ACC_CARRIES], uint32_t x,
                                           const uint32_t y[PT_LIMBS]) {
  const uint32_t zero = 0;
  acc[I] = cc_mad_lo(x, y[0], acc[I]);
#pragma unroll
  for (int k = 1; k < PT_LIMBS; k++) acc[I + k] = cc_madc_lo(x, y[k], acc[I + k]);
  cnt[I] = cc_addc_end(cnt[I], zero);
  acc[I + 1] = cc_mad_hi(x, y[0], acc[I + 1]);
#pragma unroll
  for (int k = 1; k < PT_LIMBS; k++) acc[I + 1 + k] = cc_madc_hi(x, y[k], acc[I + 1 + k]);
  cnt[I + 1] = cc_addc_end(cnt[I + 1], zero);
}

// Rows I .. L-1 of cc_acc_product.
template <int I>
__device__ __forceinline__ void cc_acc_rows(uint32_t acc[PT_ACC_LIMBS],
                                            uint32_t cnt[PT_ACC_CARRIES],
                                            const uint32_t x[PT_LIMBS],
                                            const uint32_t y[PT_LIMBS]) {
  if constexpr (I < PT_LIMBS) {
    cc_acc_row<I>(acc, cnt, x[I], y);
    cc_acc_rows<I + 1>(acc, cnt, x, y);
  }
}

// acc += x y for x, y below 2^(32 L).
__device__ __forceinline__ void cc_acc_product(uint32_t acc[PT_ACC_LIMBS],
                                               uint32_t cnt[PT_ACC_CARRIES],
                                               const uint32_t x[PT_LIMBS],
                                               const uint32_t y[PT_LIMBS]) {
  cc_acc_rows<0>(acc, cnt, x, y);
}

// acc += z for z below 2^(32 L).
__device__ __forceinline__ void cc_acc_single(uint32_t acc[PT_ACC_LIMBS],
                                              uint32_t cnt[PT_ACC_CARRIES],
                                              const uint32_t z[PT_LIMBS]) {
  const uint32_t zero = 0;
  acc[0] = cc_add(acc[0], z[0]);
#pragma unroll
  for (int k = 1; k < PT_LIMBS; k++) acc[k] = cc_addc(acc[k], z[k]);
  cnt[0] = cc_addc_end(cnt[0], zero);
}

// x = p - x for canonical x (in [1, p]: a negative term's operand).
__device__ __forceinline__ void cc_negate(uint32_t x[PT_LIMBS], const FieldConsts& c) {
  x[0] = cc_sub(c.p[0], x[0]);
#pragma unroll
  for (int k = 1; k < PT_LIMBS - 1; k++) x[k] = cc_subc(c.p[k], x[k]);
  x[PT_LIMBS - 1] = cc_subc_end(c.p[PT_LIMBS - 1], x[PT_LIMBS - 1]);
}

// s[0..2L] = acc + the counted carries (the sum S, below 2^(32 (2L + 1))).
__device__ __forceinline__ void cc_acc_fold(uint32_t s[PT_ACC_LIMBS + 1],
                                            const uint32_t acc[PT_ACC_LIMBS],
                                            const uint32_t cnt[PT_ACC_CARRIES]) {
#pragma unroll
  for (int k = 0; k < PT_LIMBS; k++) s[k] = acc[k];
  s[PT_LIMBS] = cc_add(acc[PT_LIMBS], cnt[0]);
#pragma unroll
  for (int k = 1; k < PT_LIMBS; k++) s[PT_LIMBS + k] = cc_addc(acc[PT_LIMBS + k], cnt[k]);
  s[PT_ACC_LIMBS] = cc_addc_end(cnt[PT_LIMBS], 0u);
}

// s += t over 2L + 1 limbs (two partial sums whose total is below
// 2^(32 (2L + 1))).
__device__ __forceinline__ void cc_add_acc(uint32_t s[PT_ACC_LIMBS + 1],
                                           const uint32_t t[PT_ACC_LIMBS + 1]) {
  s[0] = cc_add(s[0], t[0]);
#pragma unroll
  for (int k = 1; k < PT_ACC_LIMBS; k++) s[k] = cc_addc(s[k], t[k]);
  s[PT_ACC_LIMBS] = cc_addc_end(s[PT_ACC_LIMBS], t[PT_ACC_LIMBS]);
}

// u += the columns L and up of q1 mu, rows I .. L + 1, q1 = s[L-1 .. 2L],
// u[k] column L + k: row I <= L multiplies q1's limb I by mu's limbs from
// L - I up (columns 0..L-1 skipped), into the window u[0 .. I + 3]; row
// L + 1 multiplies q1's top limb by all of mu, one limb up.  Each row's
// window holds the running sum (below 2^(32 (I + 1)) mu <
// 2^(32 (I + L + 3)), the window's top).  At 8 limbs:
// cc_mac_row<2>(u, s[7], mu + 8), <3>(u, s[8], mu + 7), ...,
// <10>(u, s[15], mu), then <10>(u + 1, s[16], mu).
template <int I>
__device__ __forceinline__ void cc_sum_rows(uint32_t* u, const uint32_t* s,
                                            const uint32_t* mu) {
  if constexpr (I <= PT_LIMBS) {
    cc_mac_row<I + 2>(u, s[PT_LIMBS - 1 + I], mu + (PT_LIMBS - I));
    cc_sum_rows<I + 1>(u, s, mu);
  } else {
    cc_mac_row<PT_MU_SUM_LIMBS>(u + 1, s[2 * PT_LIMBS], mu);
  }
}

// r = s mod p for s[0..2L] < 2^(32 (2L + 1)) and below 32 p^2: one Barrett
// reduction (see above).
__device__ __forceinline__ void cc_sum_mod(uint32_t r[PT_LIMBS],
                                           const uint32_t s[PT_ACC_LIMBS + 1],
                                           const MulConsts& c) {
  uint32_t u[PT_LIMBS + 5];
#pragma unroll
  for (int k = 0; k < PT_LIMBS + 5; k++) u[k] = 0;
  cc_sum_rows<0>(u, s, c.mu_sum);
  // q3's low limbs = columns L+2..2L+1 = u[2..L+1]
  cc_barrett_finish(r, s, u + 2, c.f);
}

// ---------------------------------------------------------------------------
// Separated Montgomery products (K5 at both widths, its sparse rows at 8
// limbs only; at 12 also the point kernels' mf_mul): the 64L-bit product
// or square first (cc_product, cc_square), then one Montgomery reduction
// of it (cc_redc), r = T / 2^(32 L) mod p.  A square forms each cross product a_i a_j
// (i < j) once and doubles the sum, then adds the L diagonal products: 36
// limb products where a product takes 64 (at 8 limbs).
//
// Every limb product a_i b_j goes to one of two accumulators by the parity
// of its limb i + j, e (even) or o (odd), T = e + o, so that its low and
// high halves sit on a pair of limbs (2k, 2k + 1) of e or (2k + 1, 2k + 2)
// of o and one chain runs over a row's products of one parity
// (cc_mac_pairs): ptxas fuses each mad.lo.cc / madc.hi.cc pair into one
// IMAD.WIDE.U32.X, where products on the rows of cc_mac_row take an IMAD, an
// IMAD.HI and two IADD3.X.
//
// cc_redc runs the L REDC rows over (e, o): row I makes limb I zero by
// adding m p 2^(32 I), m = -limb_I p^-1 mod 2^32, its products on pairs in
// the accumulator of their parity.  Each chain ends in a counter, cnt[k]
// holding carries pending into limb k, instead of rippling to the top; row
// I first folds e[I] + o[I] + cnt[I] into the exact limb I (overflows into
// cnt[I + 1]).  The value e + o + sum_k cnt[k] 2^(32 k) is T + sum_(j < I)
// m_j p 2^(32 j) throughout.  In the end limbs L..2L-1 of e, o and the
// counters give r = (T + M p) / 2^(32 L) < T / 2^(32 L) + p: below 2p for
// a product of values below p, not yet canonical.  (What the dropped limb
// 2L and the carries out of limb 2L - 1 hold is a multiple of 2^(32 L):
// the sum below 2p is exact mod 2^(32 L).)
//
// The sparse rows (SPARSE, 8 limbs) are for p = 2^254 + c with c < 2^128 and
// p = 1 mod 2^32 (the Tweedle and Pasta base fields: limbs [1, c1, c2, c3,
// 0, 0, 0, 2^30]; the host checks the shape, fields/chain.py:sparse_prime).
// Then limb I + m p_0 = limb I + m is 0 mod 2^32 with a carry unless limb I
// is 0, and m p's other limbs are the three products m c1, m c2, m c3: a
// row takes 3 limb products where the dense one takes 8.  The rows' m
// 2^254 terms (m 2^30 at limb I + 7) are added once at the end, as M 2^30
// at limb 7 (M = sum_I m_I 2^(32 I), a funnel shift a limb): only m_0's
// low part reaches a limb that a later row reads (limb 7), and it is added
// after row 0.  The quotient digit is s (-p^-1 mod 2^32) on either kind of
// row, an IMAD.  tests/test_torch_barrett.py models the product, the square
// and both kinds of row limb by limb.
// ---------------------------------------------------------------------------

#define PT_PRODUCT_LIMBS (2 * PT_LIMBS + 1)   // a product's limbs and a zero

// acc[0 .. 2N - 1] += sum_k x y[2k] 2^(64 k), the chain's carry added to
// `carry` (acc[2N] or a counter): each product's low and high halves on
// neighbouring limbs of one chain, which ptxas fuses into one
// IMAD.WIDE.U32.X (carry in and out).
template <int N>
__device__ __forceinline__ void cc_mac_pairs(uint32_t* acc, uint32_t x, const uint32_t* y,
                                             uint32_t& carry) {
  const uint32_t zero = 0;
  acc[0] = cc_mad_lo(x, y[0], acc[0]);
  acc[1] = cc_madc_hi(x, y[0], acc[1]);
#pragma unroll
  for (int k = 1; k < N; k++) {
    acc[2 * k] = cc_madc_lo(x, y[2 * k], acc[2 * k]);
    acc[2 * k + 1] = cc_madc_hi(x, y[2 * k], acc[2 * k + 1]);
  }
  carry = cc_addc_end(carry, zero);
}

// t[0 .. 15] = e + o (o[0] is 0; what leaves limb 15 is 0).
__device__ __forceinline__ void cc_merge(uint32_t t[PT_PRODUCT_LIMBS], const uint32_t* e,
                                         const uint32_t* o) {
  t[0] = e[0];
  t[1] = cc_add(e[1], o[1]);
#pragma unroll
  for (int k = 2; k < 2 * PT_LIMBS - 1; k++) t[k] = cc_addc(e[k], o[k]);
  t[2 * PT_LIMBS - 1] = cc_addc_end(e[2 * PT_LIMBS - 1], o[2 * PT_LIMBS - 1]);
  t[2 * PT_LIMBS] = 0;
}

// Row I of a b: a_I b_j at limb I + j goes to e where I + j is even, to o
// where it is odd, so that every product's halves sit on a pair of limbs
// (2k, 2k + 1) of e or (2k + 1, 2k + 2) of o.  Each chain's carry lands on
// a limb that only carries have reached so far (a later row's chain covers
// it), so no carry is lost.
template <int I>
__device__ __forceinline__ void cc_product_rows(uint32_t* e, uint32_t* o, const uint32_t* a,
                                                const uint32_t* b) {
  if constexpr (I < PT_LIMBS) {
    if constexpr (I % 2 == 0) {
      cc_mac_pairs<PT_LIMBS / 2>(e + I, a[I], b, e[I + PT_LIMBS]);
      cc_mac_pairs<PT_LIMBS / 2>(o + I + 1, a[I], b + 1, o[I + PT_LIMBS + 1]);
    } else {
      cc_mac_pairs<PT_LIMBS / 2>(e + I + 1, a[I], b + 1, e[I + PT_LIMBS + 1]);
      cc_mac_pairs<PT_LIMBS / 2>(o + I, a[I], b, o[I + PT_LIMBS]);
    }
    cc_product_rows<I + 1>(e, o, a, b);
  }
}

// a b = e + o for a, b below 2^(32 L) (the limbs above 2L - 1 are 0).
__device__ __forceinline__ void cc_product(uint32_t e[PT_PRODUCT_LIMBS],
                                           uint32_t o[PT_PRODUCT_LIMBS],
                                           const uint32_t a[PT_LIMBS],
                                           const uint32_t b[PT_LIMBS]) {
#pragma unroll
  for (int k = 0; k < PT_PRODUCT_LIMBS; k++) e[k] = o[k] = 0;
  cc_product_rows<0>(e, o, a, b);
}

// The cross products a_I a_j, j > I, split by the parity of I + j as in
// cc_product_rows: j = I + 1, I + 3, ... into o at limb 2 I + 1, j = I + 2,
// I + 4, ... into e at limb 2 I + 2.
template <int I>
__device__ __forceinline__ void cc_cross_rows(uint32_t* e, uint32_t* o, const uint32_t* a) {
  if constexpr (I < PT_LIMBS - 1) {
    constexpr int NO = (PT_LIMBS - I) / 2, NE = (PT_LIMBS - I - 1) / 2;
    cc_mac_pairs<NO>(o + 2 * I + 1, a[I], a + I + 1, o[2 * I + 1 + 2 * NO]);
    if constexpr (NE > 0) cc_mac_pairs<NE>(e + 2 * I + 2, a[I], a + I + 2, e[2 * I + 2 + 2 * NE]);
    cc_cross_rows<I + 1>(e, o, a);
  }
}

// t = a^2 for a below 2^(32 L): the cross products (below a^2 / 2),
// doubled by a shift, then the diagonal a_i^2 at limb 2 i on one chain.
__device__ __forceinline__ void cc_square(uint32_t t[PT_PRODUCT_LIMBS],
                                          const uint32_t a[PT_LIMBS]) {
  uint32_t e[PT_PRODUCT_LIMBS], o[PT_PRODUCT_LIMBS];
#pragma unroll
  for (int k = 0; k < PT_PRODUCT_LIMBS; k++) e[k] = o[k] = 0;
  cc_cross_rows<0>(e, o, a);
  cc_merge(t, e, o);
#pragma unroll
  for (int k = 2 * PT_LIMBS - 1; k > 0; k--) t[k] = __funnelshift_l(t[k - 1], t[k], 1);
  t[0] <<= 1;
  t[0] = cc_mad_lo(a[0], a[0], t[0]);
  t[1] = cc_madc_hi(a[0], a[0], t[1]);
#pragma unroll
  for (int i = 1; i < PT_LIMBS - 1; i++) {
    t[2 * i] = cc_madc_lo(a[i], a[i], t[2 * i]);
    t[2 * i + 1] = cc_madc_hi(a[i], a[i], t[2 * i + 1]);
  }
  t[2 * PT_LIMBS - 2] = cc_madc_lo(a[PT_LIMBS - 1], a[PT_LIMBS - 1], t[2 * PT_LIMBS - 2]);
  t[2 * PT_LIMBS - 1] = cc_madc_hi_end(a[PT_LIMBS - 1], a[PT_LIMBS - 1],
                                       t[2 * PT_LIMBS - 1]);
}

// REDC rows I .. 7 over t = e + o (see the top of this section); m[I]
// keeps row I's quotient digit.  Row I's products at limbs of the parity
// of I go to y, the others to x, on pairs of limbs as in cc_product_rows;
// its limb I, e[I] + o[I] + cnt[I], is folded first (overflow into
// cnt[I + 1]), and the chains' carries go to counters.
template <int I, bool SPARSE>
__device__ __forceinline__ void cc_redc_rows(uint32_t* e, uint32_t* o, uint32_t* cnt,
                                             uint32_t* m, const FieldConsts& c) {
  if constexpr (I < PT_LIMBS) {
    uint32_t* y = I % 2 == 0 ? e : o;
    uint32_t* x = I % 2 == 0 ? o : e;
    const uint32_t zero = 0;
    uint32_t s = cc_add(y[I], x[I]);                   // limb I, exact
    cnt[I + 1] = cc_addc_end(cnt[I + 1], zero);
    s = cc_add(s, cnt[I]);
    cnt[I + 1] = cc_addc_end(cnt[I + 1], zero);
    m[I] = s * c.pinv;
    if constexpr (SPARSE) {
      (void)cc_add(s, m[I]);                           // limb I + m p_0: 0, carry
      x[I + 1] = cc_madc_lo(m[I], c.p[1], x[I + 1]);
      x[I + 2] = cc_madc_hi(m[I], c.p[1], x[I + 2]);
      x[I + 3] = cc_madc_lo(m[I], c.p[3], x[I + 3]);
      x[I + 4] = cc_madc_hi(m[I], c.p[3], x[I + 4]);
      cnt[I + 5] = cc_addc_end(cnt[I + 5], zero);
      y[I + 2] = cc_mad_lo(m[I], c.p[2], y[I + 2]);
      y[I + 3] = cc_madc_hi(m[I], c.p[2], y[I + 3]);
      cnt[I + 4] = cc_addc_end(cnt[I + 4], zero);
      if constexpr (I == 0) {                          // m_0 2^254's limb 7
        o[7] = cc_add(o[7], m[0] << 30);
        cnt[8] = cc_addc_end(cnt[8], zero);
      }
    } else {
      y[I] = s;                                        // + m p_0 makes it 0
      cc_mac_pairs<PT_LIMBS / 2>(y + I, m[I], c.p, cnt[I + PT_LIMBS]);
      cc_mac_pairs<PT_LIMBS / 2>(x + I + 1, m[I], c.p + 1, cnt[I + PT_LIMBS + 1]);
    }
    cc_redc_rows<I + 1, SPARSE>(e, o, cnt, m, c);
  }
}

// r = (e + o) / 2^(32 L) mod p, in [0, (e + o) / 2^(32 L) + p) (see the top of
// this section).
template <bool SPARSE>
__device__ __forceinline__ void cc_redc(uint32_t r[PT_LIMBS], uint32_t e[PT_PRODUCT_LIMBS],
                                        uint32_t o[PT_PRODUCT_LIMBS], const FieldConsts& c) {
  uint32_t cnt[PT_PRODUCT_LIMBS], m[PT_LIMBS];
#pragma unroll
  for (int k = 0; k < PT_PRODUCT_LIMBS; k++) cnt[k] = 0;
  if constexpr (SPARSE || PT_LIMBS == 12) {
    // Row 0 waits for the product's top limb (+ its product with a zero
    // that the compiler cannot see: -p^-1 p_0 = -1 mod 2^32).  Left to
    // itself, ptxas starts the rows while the product's chains run, keeps
    // more carries alive than it has predicates and spills them (LOP3,
    // P2R, ISETP in the square's loop; PERF.md §6).  The 8-limb dense
    // rows gain from the overlap; the 12-limb ones, whose point add
    // inlines 12 products, lose more to the spills.
    const uint32_t zero = c.pinv * c.p[0] + 1u;
    e[0] += (e[2 * PT_LIMBS - 1] + o[2 * PT_LIMBS - 1]) * zero;
  }
  cc_redc_rows<0, SPARSE>(e, o, cnt, m, c);
  r[0] = cc_add(e[PT_LIMBS], o[PT_LIMBS]);
#pragma unroll
  for (int k = 1; k < PT_LIMBS - 1; k++) r[k] = cc_addc(e[PT_LIMBS + k], o[PT_LIMBS + k]);
  r[PT_LIMBS - 1] = cc_addc_end(e[2 * PT_LIMBS - 1], o[2 * PT_LIMBS - 1]);
  r[0] = cc_add(r[0], cnt[PT_LIMBS]);
#pragma unroll
  for (int k = 1; k < PT_LIMBS - 1; k++) r[k] = cc_addc(r[k], cnt[PT_LIMBS + k]);
  r[PT_LIMBS - 1] = cc_addc_end(r[PT_LIMBS - 1], cnt[2 * PT_LIMBS - 1]);
  if constexpr (SPARSE) {   // + M 2^30 at limb 7, its limbs 1 .. 8 (limb 0 is in)
    r[0] = cc_add(r[0], __funnelshift_l(m[0], m[1], 30));
#pragma unroll
    for (int k = 1; k < PT_LIMBS - 1; k++) r[k] = cc_addc(r[k], __funnelshift_l(m[k], m[k + 1], 30));
    r[PT_LIMBS - 1] = cc_addc_end(r[PT_LIMBS - 1], m[PT_LIMBS - 1] >> 2);
  }
}

// The lazy products of an exponent chain (K5's S-boxes, field_exp; with
// one cc_csub after each, the point kernels' mf_mul and mf_sqr): no
// conditional subtraction, r = a b / R (mod p) below (a b + (R - 1) p) / R,
// R = 2^(32 L).  From inputs below p, a chain of n such products stays below
// the bound B_n, B_0 = p, B_(k+1) = (B_k - 1)^2 / R + p; where B_n <= 2p
// one cc_csub after the chain makes it canonical.  Both Tweedle base
// fields (p = 2^254 (1 + 2^-132)) keep B_n below 2p for more than 10^5
// products, and any p < R / 4 (every other 8-limb field of the port, and
// BLS12-377's base field, p < 2^377 at R = 2^384) for every n; the host
// checks a field's chains (fields/chain.py:lazy_chain_bound).

// r = a b / R (mod p), lazily (above).
template <bool SPARSE>
__device__ __forceinline__ void cc_mont_mul_sos(uint32_t r[PT_LIMBS], const uint32_t a[PT_LIMBS],
                                                const uint32_t b[PT_LIMBS], const FieldConsts& c) {
  uint32_t e[PT_PRODUCT_LIMBS], o[PT_PRODUCT_LIMBS];
  cc_product(e, o, a, b);
  cc_redc<SPARSE>(r, e, o, c);
}

// r = a^2 / R (mod p), lazily (above).
template <bool SPARSE>
__device__ __forceinline__ void cc_mont_sqr(uint32_t r[PT_LIMBS], const uint32_t a[PT_LIMBS],
                                            const FieldConsts& c) {
  uint32_t t[PT_PRODUCT_LIMBS], zero[PT_PRODUCT_LIMBS];
  cc_square(t, a);
#pragma unroll
  for (int k = 0; k < PT_PRODUCT_LIMBS; k++) zero[k] = 0;
  cc_redc<SPARSE>(r, t, zero, c);
}

// An exponent chain (K5's S-boxes, field_exp): the host's sliding-window
// chain for x^e (fields/chain.py:sbox_schedule), one step a word: load
// slot bits 0-4, multiply slot 5-9, store slot 10-14, squares 16-31 (a
// field of PT_NO_SLOT names no slot).  A step is "s = slot[load], square
// s `squares` times, s = s slot[mul], slot[store] = s", the same for every
// thread, so the loop is uniform across the warp and has no per-bit select.
// The table of odd powers x, x^3, ... and x^2 holds one column a thread,
// limb k of slot j at tab[(j L + k) stride] (a block's threads side by
// side: stride = its thread count).
#define PT_NO_SLOT 31

__device__ __forceinline__ void slot_load(uint32_t v[PT_LIMBS], const uint32_t* tab,
                                          uint32_t slot, int stride) {
#pragma unroll
  for (int k = 0; k < PT_LIMBS; k++) v[k] = tab[(slot * PT_LIMBS + k) * stride];
}

__device__ __forceinline__ void slot_store(uint32_t* tab, uint32_t slot,
                                           const uint32_t v[PT_LIMBS], int stride) {
#pragma unroll
  for (int k = 0; k < PT_LIMBS; k++) tab[(slot * PT_LIMBS + k) * stride] = v[k];
}

// s = s^e by the chain steps[0 .. n_steps - 1] (Montgomery form, canonical
// in and out): one square site and one multiply site, both lazy (below 2p
// while the host's lazy_chain_bound holds), and one conditional
// subtraction at the end.
template <bool SPARSE>
__device__ __forceinline__ void exp_chain(uint32_t s[PT_LIMBS], const uint32_t* steps,
                                          int n_steps, const FieldConsts& f, uint32_t* tab,
                                          int stride) {
#pragma unroll 1
  for (int j = 0; j < n_steps; j++) {
    const uint32_t step = steps[j];
    const uint32_t load = step & 31, mul = (step >> 5) & 31, store = (step >> 10) & 31;
    const uint32_t squares = step >> 16;
    if (load != PT_NO_SLOT) slot_load(s, tab, load, stride);
#pragma unroll 1
    for (uint32_t q = 0; q < squares; q++) cc_mont_sqr<SPARSE>(s, s, f);
    if (mul != PT_NO_SLOT) {
      uint32_t y[PT_LIMBS];
      slot_load(y, tab, mul, stride);
      cc_mont_mul_sos<SPARSE>(s, s, y, f);
    }
    if (store != PT_NO_SLOT) slot_store(tab, store, s, stride);
  }
  cc_csub(s, f);
}

// Every step of a chain names table slots below `slots`, or none (host
// code: the C entries check a chain before they launch it).
static inline bool chain_steps_valid(const uint32_t* steps, uint32_t n_steps,
                                     uint32_t slots) {
  for (uint32_t j = 0; j < n_steps; j++)
    for (int shift = 0; shift < 15; shift += 5) {
      const uint32_t slot = (steps[j] >> shift) & 31;
      if (slot != PT_NO_SLOT && slot >= slots) return false;
    }
  return true;
}

// p = 2^254 + c, c < 2^128, p = 1 mod 2^32 (32-bit limbs [1, c1, c2, c3, 0,
// 0, 0, 2^30]): the shape of cc_redc's sparse rows (host code; no 12-limb
// field has it).
static inline bool sparse_shape(const FieldConsts& f) {
#if PT_LIMBS == 8
  return f.p[0] == 1u && f.p[4] == 0u && f.p[5] == 0u && f.p[6] == 0u &&
         f.p[7] == (1u << 30) && f.pinv == 0xffffffffu;
#else
  (void)f;
  return false;
#endif
}

// The point kernels' Montgomery product (K2 and K4): r = a b / R mod p for
// a, b < p, canonical.  The rolled CIOS loop (mf_mul_any at 8 limbs) is one
// long chain of dependent 64-bit steps (~140 a product, each an IMAD.WIDE
// and 64-bit adds on the previous carry), which left the MSM's accumulate
// at 26-28% of its bound and its reduce and Horner bound by that chain's
// latency.  Here the L^2 limb products run as pairs on two carry chains
// (even and odd limbs, one IMAD.WIDE.U32.X each), then the L REDC rows,
// then one conditional subtraction (cc_redc's result is below 2p): more
// code than the rolled loop, far shorter chains of dependent steps.  At 8
// limbs the rows are the sparse ones (3 limb products a row), so the 8-limb
// point kernels take a curve whose base field is p = 2^254 + c, c < 2^128,
// p = 1 mod 2^32 (every 8-limb curve of the port: the Tweedle and Pasta
// base fields; curve_set_consts refuses another); at 12 (BLS12-377's base
// field) the dense ones.  r may alias a or b (both are read into e and o
// first).
__device__ __forceinline__ void mf_mul(uint32_t r[PT_LIMBS], const uint32_t a[PT_LIMBS],
                                       const uint32_t b[PT_LIMBS], const FieldConsts& c) {
  cc_mont_mul_sos<PT_LIMBS == 8>(r, a, b, c);
  cc_csub(r, c);
}

// r = a^2 / R mod p for a < p, canonical: at 8 limbs cc_square's 36 limb
// products and the sparse rows; at 12 the product mf_mul, whose machine
// code the 12-limb kernels keep.
__device__ __forceinline__ void mf_sqr(uint32_t r[PT_LIMBS], const uint32_t a[PT_LIMBS],
                                       const FieldConsts& c) {
#if PT_LIMBS == 8
  cc_mont_sqr<true>(r, a, c);
  cc_csub(r, c);
#else
  mf_mul(r, a, a, c);
#endif
}

#if PT_LIMBS == 12
// K5's conversions at 12 limbs: the point kernels' product (dense rows).
__device__ __forceinline__ void mf_mul_any(uint32_t r[PT_LIMBS], const uint32_t a[PT_LIMBS],
                                           const uint32_t b[PT_LIMBS], const FieldConsts& c) {
  mf_mul(r, a, b, c);
}
#endif

// r = k a for a small constant k >= 1 (double and add over k's bits; the
// Horner's multiply by b3 = 3b, curve_kernels.cu).
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
