// K1: field arithmetic (add, sub, mul, product sum) on canonical limbs.
//
// Replaces the TPU kernels of plonky_tpu/fields/pallas_kernels.py:
// _conv_call / conv_pallas (the 8-bit digit convolution), _reduce_work_call
// / reduce_work_pallas (loose carry rounds + fold-matrix reduction) and
// their fusion fused_composite over fields/ops.py:_mul_body (the modular
// multiply).  The TPU had no fast 32-bit multiply and so convolved 8-bit
// digits in float32; Hopper has a native 32x32->64-bit multiply-add with a
// carry flag, so one thread computes a whole 255-bit product from 32-bit
// limbs in registers.
//
// What bounds it: add and sub move 3 x 32 bytes per element for ~20 integer
// operations, so they are bound by memory bytes.  mul moves the same 96
// bytes and needs at least 264 IMAD issue slots (an 8 x 8 limb product and
// one reduction), so at full rate the integer pipe and the bytes take about
// the same time.  The design: add, sub and mul run on PTX carry chains
// (field.cuh, cc_*), mul with ONE Barrett reduction per product (290
// 32-bit multiplies in its machine code, where the product / REDC /
// multiply by F / REDC it replaced took about twice that); every limb stays
// in registers and limbs are read coalesced.  A product sum accumulates its
// terms in 17 limbs and reduces once.
#include "field.cuh"

// add, sub and mul: one element a thread, 128 threads a block (at the main
// path's N = 9 2^14 that spreads 1,152 blocks evenly over the SMs, where
// 576 blocks of 256 left a tail; measured on the H100, PERF.md).
#define K1_THREADS 128

// Operand with a zero batch stride when `bcast` is set (an [8, 1] tensor
// broadcast over the batch), else a full [8, N] tensor.
__device__ __forceinline__ void load_operand(uint32_t r[PT_LIMBS], const int32_t* base,
                                             int bcast, int64_t n, int64_t i) {
  if (bcast) fe_load(r, base, 1, 0);
  else fe_load(r, base, n, i);
}

template <int OP>
__global__ void field_binary_kernel(int32_t* out, const int32_t* a, int a_bcast,
                                    const int32_t* b, int b_bcast, int64_t n,
                                    MulConsts c) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[PT_LIMBS], y[PT_LIMBS], r[PT_LIMBS];
  load_operand(x, a, a_bcast, n, i);
  load_operand(y, b, b_bcast, n, i);
  if (OP == 0) cc_add_mod(r, x, y, c.f);
  else if (OP == 1) cc_sub_mod(r, x, y, c.f);
  else cc_mul_mod(r, x, y, c);
  fe_store(out, n, i, r);
}

struct ProductSumTerms {
  const int32_t* a[PT_MAX_TERMS];
  const int32_t* b[PT_MAX_TERMS];  // null: the term is sign * a
  int32_t a_bcast[PT_MAX_TERMS];
  int32_t b_bcast[PT_MAX_TERMS];
  int32_t sign[PT_MAX_TERMS];
  int32_t count;
};

__global__ void field_product_sum_kernel(int32_t* out, ProductSumTerms terms, int64_t n,
                                         FieldConsts c) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t acc[PT_ACC];
  acc_zero(acc);
  for (int t = 0; t < terms.count; t++) {
    uint32_t x[PT_LIMBS];
    load_operand(x, terms.a[t], terms.a_bcast[t], n, i);
    if (terms.b[t] == nullptr) {
      acc_single(acc, x, terms.sign[t], c);
    } else {
      uint32_t y[PT_LIMBS];
      load_operand(y, terms.b[t], terms.b_bcast[t], n, i);
      acc_product(acc, x, y, terms.sign[t], c);
    }
  }
  uint32_t r[PT_LIMBS];
  fe_reduce_acc(r, acc, c);
  fe_store(out, n, i, r);
}

template <int OP>
static int launch_binary(void* out, const void* a, int a_bcast, const void* b,
                         int b_bcast, int64_t n, const void* consts, void* stream) {
  MulConsts c = mul_consts_from((const uint32_t*)consts);
  const unsigned int blocks = (unsigned int)((n + K1_THREADS - 1) / K1_THREADS);
  field_binary_kernel<OP><<<blocks, K1_THREADS, 0, (cudaStream_t)stream>>>(
      (int32_t*)out, (const int32_t*)a, a_bcast, (const int32_t*)b, b_bcast, n, c);
  return (int)cudaGetLastError();
}

extern "C" {

// consts: the host buffer FieldSpec.mul_consts.
int pt_field_add(void* out, const void* a, int a_bcast, const void* b, int b_bcast,
                 int64_t n, const void* consts, void* stream) {
  return launch_binary<0>(out, a, a_bcast, b, b_bcast, n, consts, stream);
}

int pt_field_sub(void* out, const void* a, int a_bcast, const void* b, int b_bcast,
                 int64_t n, const void* consts, void* stream) {
  return launch_binary<1>(out, a, a_bcast, b, b_bcast, n, consts, stream);
}

int pt_field_mul(void* out, const void* a, int a_bcast, const void* b, int b_bcast,
                 int64_t n, const void* consts, void* stream) {
  return launch_binary<2>(out, a, a_bcast, b, b_bcast, n, consts, stream);
}

// a_ptrs / b_ptrs: host arrays of `count` device pointers (b may hold 0);
// a_bcast / b_bcast / signs: host int32 arrays of `count` entries.
int pt_field_product_sum(void* out, const void* a_ptrs, const void* b_ptrs,
                         const void* a_bcast, const void* b_bcast, const void* signs,
                         int count, int64_t n, const void* consts, void* stream) {
  if (count < 1 || count > PT_MAX_TERMS) return (int)cudaErrorInvalidValue;
  ProductSumTerms terms;
  const uint64_t* ap = (const uint64_t*)a_ptrs;
  const uint64_t* bp = (const uint64_t*)b_ptrs;
  const int32_t* ab = (const int32_t*)a_bcast;
  const int32_t* bb = (const int32_t*)b_bcast;
  const int32_t* sg = (const int32_t*)signs;
  for (int t = 0; t < PT_MAX_TERMS; t++) {
    bool live = t < count;
    terms.a[t] = live ? (const int32_t*)ap[t] : nullptr;
    terms.b[t] = live ? (const int32_t*)bp[t] : nullptr;
    terms.a_bcast[t] = live ? ab[t] : 0;
    terms.b_bcast[t] = live ? bb[t] : 0;
    terms.sign[t] = live ? sg[t] : 1;
  }
  terms.count = count;
  FieldConsts c = field_consts_from((const uint32_t*)consts);
  field_product_sum_kernel<<<pt_blocks(n), PT_THREADS, 0, (cudaStream_t)stream>>>(
      (int32_t*)out, terms, n, c);
  return (int)cudaGetLastError();
}

}  // extern "C"
