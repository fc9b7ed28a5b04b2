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
// What bounds it: add and sub (field_add, field_sub: the TPU's
// reduce_work_pallas, pallas_kernels.py:134, under plonky_tpu/fields/
// ops.py:388 add and :392 sub) move 3 x 32 bytes per element for ~20
// integer operations, so they are bound by memory bytes.  mul moves the
// same 96 bytes and needs at least 264 IMAD issue slots (an 8 x 8 limb
// product and one reduction), so at full rate the integer pipe and the
// bytes take about the same time.  The design: add, sub and mul run on PTX
// carry chains (field.cuh, cc_*), mul with ONE Barrett reduction per
// product (290 32-bit multiplies in its machine code, where the product /
// REDC / multiply by F / REDC it replaced took about twice that); every
// limb stays in registers and limbs are read coalesced.  The three share
// one elementwise kernel (field_binary_kernel) that moves no byte the
// function does not need: its strided overload reads each operand in
// place, through a limb stride and a batch index of two levels
// (BinaryOperand; a zero stride broadcasts), where a contiguous copy of a
// strided slice (a gate's wire column, an IPA half) read and wrote the
// whole operand once more, in a torch copy launch of its own; contiguous
// operands and [L, 1] columns keep the lighter overload they had.  One
// element a thread: a sweep on the H100 (k1_sweep.py) found 2 and 4
// consecutive elements a thread, loaded as 8- and 16-byte vectors, no
// faster at the prove's sizes (N = 2^17 at most, so 4 elements a thread
// leave ~8 warps an SM) and the multiply up to 2x slower.  A product sum adds its
// products straight into a (2L + 1)-limb accumulator on the same chains
// and reduces once, by Barrett; one launch evaluates several sums over one
// batch (the grid's y), and where the batch is too small to fill the card
// a sum's terms are dealt out among 2 or 4 threads an element.
//
// Built twice (_cuda.py): at 8 limbs, and at 12 (-DPT_LIMBS=12, BLS12-377's
// base field), where every kernel is the same code over 12 limbs (entries
// pt_field_add_l12, ..., pt_field_product_sum_l12; a product is 144 limb
// products and one 12-limb Barrett reduction, >= 588 IMAD slots against
// 264) but for the two that the limb products bound: field_mul_l12 forms
// its product in the pair layout (field.cuh: cc_mul_mod), and the product
// sum has a kernel of its own at 12 limbs, each term's 144 limb products
// formed in the pair layout straight into two lazy accumulators (one
// IMAD.WIDE.U32.X a limb product, where the rows of cc_acc_product take an
// IMAD, an IMAD.HI and two IADD3.X), merged once a sum.  The 12-limb
// product sum is bound by operations: a term reads 96 B and needs 288 IMAD
// slots, about six times the bytes' time.
//
// field_exp (both widths) computes x^e for a host exponent e > 0 in one
// launch, where fields/ops.py:exp_const ran one field_mul launch a square
// or multiply (a Fermat inverse: ~300 launches at 8 limbs, ~560 at 12).
// It replaces the same TPU kernels under plonky_tpu/fields/ops.py:exp_const
// (a lax.scan of square-and-multiply steps through fused_composite).  One
// thread an element: into Montgomery form by a product with R^2, the
// host's sliding-window chain (fields/chain.py:exp_schedule, windows of 1
// to 5 bits) through field.cuh's exp_chain, K5's runner, its table of odd
// powers in dynamic shared memory, the products lazy (below 2p) with the
// sparse REDC rows where p = 2^254 + c, then a product with 1 and one
// conditional subtraction.  Bound by operations: the chain's ~250-380
// squares and ~50-80 multiplies against 2 L words an element.
#include <cstring>

#include "field.cuh"

PT_NAMESPACE_BEGIN

// 128 threads a block (add, sub and mul: one element a thread; at the main
// path's N = 9 2^14 that spreads 1,152 blocks evenly over the SMs, where
// 576 blocks of 256 left a tail; measured on the H100, PERF.md).
#define K1_THREADS 128

// Operand with a zero batch stride when `bcast` is set (an [L, 1] tensor
// broadcast over the batch), else a full [L, N] tensor.
__device__ __forceinline__ void load_operand(uint32_t r[PT_LIMBS], const int32_t* base,
                                             int bcast, int64_t n, int64_t i) {
  if (bcast) fe_load(r, base, 1, 0);
  else fe_load(r, base, n, i);
}

// One operand of an elementwise launch, read where it lies: limb k of
// element i (row-major over the batch) at base[k * limb + (i / inner_n) *
// outer + (i % inner_n) * inner] (fields/ops.py:operand_layout; a zero
// stride is a broadcast, an [L, 1] column has both).
struct BinaryOperand {
  const int32_t* base;
  int64_t limb, outer, inner, inner_n;
};

// The words of the host buffer fields/ops.py:_launch_binary fills, for a
// and then b: the base pointer, the limb, outer and inner strides, the
// inner size.
#define K1_OPERAND_WORDS 5

struct BinaryArgs {
  BinaryOperand a, b;
};

__device__ __forceinline__ void load_strided(uint32_t r[PT_LIMBS], const BinaryOperand& o,
                                             int64_t n, int64_t i) {
  int64_t off = i * o.inner;
  if (o.inner_n < n) {
    const int64_t q = i / o.inner_n;
    off = q * o.outer + (i - q * o.inner_n) * o.inner;
  }
  fe_load(r, o.base, o.limb, off);
}

// out [L, n] (contiguous) = a OP b, one element a thread, where every
// operand is a contiguous [L, n] tensor or (bcast) a contiguous [L, 1]
// column: the kernel as it was before views were read in place, kept for
// those layouts (its launch is lighter by 56 bytes of parameters and its
// loads need no offset; k1_sweep.py times both).
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

// The same over operands of any layout, read in place (BinaryOperand): an
// overload of the name, so that a kernel's SASS and its launches are found
// under one name.
template <int OP>
__global__ void field_binary_kernel(int32_t* out, const BinaryArgs args, int64_t n,
                                            MulConsts c) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[PT_LIMBS], y[PT_LIMBS], r[PT_LIMBS];
  load_strided(x, args.a, n, i);
  load_strided(y, args.b, n, i);
  if (OP == 0) cc_add_mod(r, x, y, c.f);
  else if (OP == 1) cc_sub_mod(r, x, y, c.f);
  else cc_mul_mod(r, x, y, c);
  fe_store(out, n, i, r);
}

// The term table of one product-sum launch, passed by value in the
// kernel's parameter space (no copy to the device): sum s has the terms
// first[s] .. first[s + 1] - 1.  A term is a b, or a alone when b is null;
// its flags mark an [L, 1] operand read with a zero batch stride and a
// negative sign.  The table takes 1,608 B (64 terms of 24 B, 17 sum
// starts, padding) at either width, beside MulConsts (112 B at 8 limbs,
// 160 at 12), inside the 4 KB of kernel parameters a launch takes
// without CUDA 12.1's larger space.  fields/ops.py defines the same
// limits and flags.
#define PS_MAX_SUMS 16
#define PS_MAX_ENTRIES 64
#define PS_MAX_SPLITS 4
#define PS_A_BCAST 1
#define PS_B_BCAST 2
#define PS_NEG 4

struct PsTerm {
  const int32_t* a;
  const int32_t* b;
  uint32_t flags;
};

struct PsTable {
  PsTerm term[PS_MAX_ENTRIES];
  int32_t first[PS_MAX_SUMS + 1];
};

#if PT_LIMBS == 8
#define K1_SUM_THREADS K1_THREADS

// One element of one sum a thread (the grid's y is the sum), or, with
// `splits` = 2 or 4, one element of one sum per `splits` threads: thread
// group g takes the sum's terms g, g + splits, ..., and the groups' partial
// sums meet in shared memory before the one reduction.  A warp lies in one
// group, so the term loop and its branches are uniform across it.
__global__ void __launch_bounds__(K1_THREADS)
field_product_sum_kernel(int32_t* out, const __grid_constant__ PsTable tab, int64_t n,
                         int splits, const __grid_constant__ MulConsts c) {
  const int per_block = K1_THREADS / splits;
  const int group = threadIdx.x / per_block;
  const int64_t i = (int64_t)blockIdx.x * per_block + threadIdx.x % per_block;
  const int sum = blockIdx.y;
  uint32_t acc[PT_ACC_LIMBS], cnt[PT_ACC_CARRIES];
#pragma unroll
  for (int k = 0; k < PT_ACC_LIMBS; k++) acc[k] = 0;
#pragma unroll
  for (int k = 0; k < PT_ACC_CARRIES; k++) cnt[k] = 0;
  if (i < n) {
#pragma unroll 1
    for (int t = tab.first[sum] + group; t < tab.first[sum + 1]; t += splits) {
      const PsTerm term = tab.term[t];
      const bool neg = term.flags & PS_NEG;
      uint32_t x[PT_LIMBS];
      load_operand(x, term.a, term.flags & PS_A_BCAST, n, i);
      if (term.b == nullptr) {
        if (neg) cc_negate(x, c.f);
        cc_acc_single(acc, cnt, x);
      } else {
        uint32_t y[PT_LIMBS];
        load_operand(y, term.b, term.flags & PS_B_BCAST, n, i);
        if (neg) cc_negate(y, c.f);
        cc_acc_product(acc, cnt, x, y);
      }
    }
  }
  uint32_t s[PT_ACC_LIMBS + 1];
  cc_acc_fold(s, acc, cnt);
  if (splits > 1) {
    __shared__ uint32_t part[PT_ACC_LIMBS + 1][K1_THREADS];
    if (group > 0) {
#pragma unroll
      for (int k = 0; k <= PT_ACC_LIMBS; k++) part[k][threadIdx.x] = s[k];
    }
    __syncthreads();
    if (group > 0) return;
    for (int g = 1; g < splits; g++) {
      uint32_t t[PT_ACC_LIMBS + 1];
#pragma unroll
      for (int k = 0; k <= PT_ACC_LIMBS; k++) t[k] = part[k][threadIdx.x + g * per_block];
      cc_add_acc(s, t);
    }
  }
  if (i >= n) return;
  uint32_t r[PT_LIMBS];
  cc_sum_mod(r, s, c);
  fe_store(out + (int64_t)sum * PT_LIMBS * n, n, i, r);
}
#else
// The 12-limb product sum's threads a block (ps_sweep.py).
#define K1_SUM_THREADS 128

// A term's operands: x = a, and y = b unless the term is a single.
__device__ __forceinline__ void ps_load(uint32_t x[PT_LIMBS], uint32_t y[PT_LIMBS],
                                        const PsTerm& term, int64_t n, int64_t i) {
  load_operand(x, term.a, term.flags & PS_A_BCAST, n, i);
  if (term.b != nullptr) load_operand(y, term.b, term.flags & PS_B_BCAST, n, i);
}

// The 8-limb kernel's sum, split and meeting, with the terms accumulated
// in the lazy pair layout (field.cuh: cc_pairs_product, cc_acc_single on
// e, one cc_pairs_fold a thread), each term's operands loaded while the
// term before it is accumulated, and the reduction on the pair layout
// (cc_sum_mod_pairs).
__global__ void __launch_bounds__(K1_SUM_THREADS)
field_product_sum_kernel(int32_t* out, const __grid_constant__ PsTable tab, int64_t n,
                         int splits, const __grid_constant__ MulConsts c) {
  const int per_block = K1_SUM_THREADS / splits;
  const int group = threadIdx.x / per_block;
  const int64_t i = (int64_t)blockIdx.x * per_block + threadIdx.x % per_block;
  const int sum = blockIdx.y;
  uint32_t e[PT_ACC_LIMBS], o[PT_ACC_LIMBS], cnt[PT_ACC_CARRIES];
#pragma unroll
  for (int k = 0; k < PT_ACC_LIMBS; k++) e[k] = o[k] = 0;
#pragma unroll
  for (int k = 0; k < PT_ACC_CARRIES; k++) cnt[k] = 0;
  if (i < n) {
    const int end = tab.first[sum + 1];
    int t = tab.first[sum] + group;
    uint32_t x[PT_LIMBS], y[PT_LIMBS];   // term t's operands, loaded ahead
    fe_set_small(y, 0);
    if (t < end) ps_load(x, y, tab.term[t], n, i);
#pragma unroll 1
    for (; t < end; t += splits) {
      const bool single = tab.term[t].b == nullptr;
      const bool neg = tab.term[t].flags & PS_NEG;
      uint32_t a[PT_LIMBS], b[PT_LIMBS];
      fe_copy(a, x);
      fe_copy(b, y);
      if (t + splits < end) ps_load(x, y, tab.term[t + splits], n, i);
      if (single) {
        if (neg) cc_negate(a, c.f);
        cc_acc_single(e, cnt, a);
      } else {
        if (neg) cc_negate(b, c.f);
        cc_pairs_product(e, o, cnt, a, b);
      }
    }
  }
  uint32_t s[PT_ACC_LIMBS + 1];
  cc_pairs_fold(s, e, o, cnt);
  if (splits > 1) {
    __shared__ uint32_t part[PT_ACC_LIMBS + 1][K1_SUM_THREADS];
    if (group > 0) {
#pragma unroll
      for (int k = 0; k <= PT_ACC_LIMBS; k++) part[k][threadIdx.x] = s[k];
    }
    __syncthreads();
    if (group > 0) return;
    for (int g = 1; g < splits; g++) {
      uint32_t t[PT_ACC_LIMBS + 1];
#pragma unroll
      for (int k = 0; k <= PT_ACC_LIMBS; k++) t[k] = part[k][threadIdx.x + g * per_block];
      cc_add_acc(s, t);
    }
  }
  if (i >= n) return;
  uint32_t r[PT_LIMBS];
  cc_sum_mod_pairs(r, s, c);
  fe_store(out + (int64_t)sum * PT_LIMBS * n, n, i, r);
}
#endif

// field_exp's limits: steps of a chain, table slots an element (windows up
// to 5 bits: x, x^3, ..., x^31 and x^2), threads a block (fewer, a
// multiple of 32, for a batch below it: one warp for N = 1).
#define EXP_MAX_STEPS 128
#define EXP_MAX_SLOTS 17
#define EXP_THREADS 128
#define EXP_MAX_BLOCKS (1 << 20)

// The words of fields/chain.py:exp_consts, in order.
struct ExpConsts {
  FieldConsts f;                  // p, -p^-1 mod 2^32
  uint32_t r2[PT_LIMBS];          // R^2 mod p, R = 2^(32 L)
  uint32_t sparse;                // 1: p = 2^254 + c (cc_redc's sparse rows)
  uint32_t slots;                 // table slots an element
  uint32_t n_steps;
  uint32_t steps[EXP_MAX_STEPS];  // exp_chain's step words
};
static_assert(sizeof(ExpConsts) == 4 * (2 * PT_LIMBS + 4 + EXP_MAX_STEPS),
              "ExpConsts must match the host buffer's word layout");

// out = x^e for canonical x [L, n] (out may be x), a thread an element,
// grid-stride; thread t's column of the table at exp_table + t.
template <bool SPARSE>
__global__ void __launch_bounds__(EXP_THREADS)
field_exp_kernel(int32_t* out, const int32_t* x, int64_t n,
                 const __grid_constant__ ExpConsts cs) {
  extern __shared__ uint32_t exp_table[];
  uint32_t* tab = exp_table + threadIdx.x;
  const FieldConsts& f = cs.f;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    uint32_t s[PT_LIMBS], one[PT_LIMBS];
    fe_load(s, x, n, i);
    cc_mont_mul_sos<SPARSE>(s, s, cs.r2, f);   // x R, below 2p
    cc_csub(s, f);
    exp_chain<SPARSE>(s, cs.steps, (int)cs.n_steps, f, tab, (int)blockDim.x);
    fe_set_small(one, 1);
    cc_mont_mul_sos<SPARSE>(s, s, one, f);     // x^e, at most p
    cc_csub(s, f);
    fe_store(out, n, i, s);
  }
}

// An operand from its host words; false where they are not a layout the
// kernel reads.
static bool operand_from(BinaryOperand& o, const int64_t* w, int64_t n) {
  o.base = (const int32_t*)w[0];
  o.limb = w[1];
  o.outer = w[2];
  o.inner = w[3];
  o.inner_n = w[4];
  return o.limb >= 0 && o.outer >= 0 && o.inner >= 0 && o.inner_n >= 1 &&
         (o.inner_n >= n || n % o.inner_n == 0);
}

// A contiguous [L, n] tensor or a contiguous [L, 1] column
// (field_binary_kernel's operands).
static bool contiguous_operand(const BinaryOperand& o, int64_t n) {
  return o.inner_n >= n && ((o.inner == 1 && o.limb == n) || (o.inner == 0 && o.limb == 1));
}

template <int OP>
static int launch_binary(void* out, const void* operands, int64_t n, const void* consts,
                         void* stream) {
  const int64_t* w = (const int64_t*)operands;
  BinaryArgs args;
  if (n < 1 || !operand_from(args.a, w, n) || !operand_from(args.b, w + K1_OPERAND_WORDS, n))
    return (int)cudaErrorInvalidValue;
  MulConsts c = mul_consts_from((const uint32_t*)consts);
  const unsigned int blocks = (unsigned int)((n + K1_THREADS - 1) / K1_THREADS);
  if (contiguous_operand(args.a, n) && contiguous_operand(args.b, n))
    field_binary_kernel<OP><<<blocks, K1_THREADS, 0, (cudaStream_t)stream>>>(
        (int32_t*)out, args.a.base, args.a.inner == 0, args.b.base, args.b.inner == 0, n, c);
  else
    field_binary_kernel<OP><<<blocks, K1_THREADS, 0, (cudaStream_t)stream>>>(
        (int32_t*)out, args, n, c);
  return (int)cudaGetLastError();
}

extern "C" {

// out [L, n]; operands: the host buffer of both operands' words
// (K1_OPERAND_WORDS each); consts: the host buffer FieldSpec.mul_consts.
int PT_ENTRY(pt_field_add)(void* out, const void* operands, int64_t n, const void* consts,
                           void* stream) {
  return launch_binary<0>(out, operands, n, consts, stream);
}

int PT_ENTRY(pt_field_sub)(void* out, const void* operands, int64_t n, const void* consts,
                           void* stream) {
  return launch_binary<1>(out, operands, n, consts, stream);
}

int PT_ENTRY(pt_field_mul)(void* out, const void* operands, int64_t n, const void* consts,
                           void* stream) {
  return launch_binary<2>(out, operands, n, consts, stream);
}

// n_sums sums over one batch of n into out [n_sums, L, n]; the host arrays
// a_ptrs / b_ptrs (device pointers, b may hold 0) and flags (int32) hold
// the terms of every sum in turn, first (int32, n_sums + 1 entries) where
// each sum's terms start; splits (1, 2 or 4) threads share an element.
int PT_ENTRY(pt_field_product_sum)(void* out, const void* a_ptrs, const void* b_ptrs,
                                   const void* flags, const void* first, int n_sums,
                                   int splits, int64_t n, const void* consts,
                                   void* stream) {
  const int32_t* fs = (const int32_t*)first;
  if (n_sums < 1 || n_sums > PS_MAX_SUMS || fs[0] != 0 || fs[n_sums] > PS_MAX_ENTRIES ||
      splits < 1 || splits > PS_MAX_SPLITS || (splits & (splits - 1)))
    return (int)cudaErrorInvalidValue;
  PsTable tab = {};
  const uint64_t* ap = (const uint64_t*)a_ptrs;
  const uint64_t* bp = (const uint64_t*)b_ptrs;
  const int32_t* fl = (const int32_t*)flags;
  for (int s = 0; s < n_sums; s++) {
    const int terms = fs[s + 1] - fs[s];
    if (terms < 1 || terms > PT_MAX_TERMS) return (int)cudaErrorInvalidValue;
  }
  for (int t = 0; t < fs[n_sums]; t++) {
    tab.term[t].a = (const int32_t*)ap[t];
    tab.term[t].b = (const int32_t*)bp[t];
    tab.term[t].flags = (uint32_t)fl[t];
  }
  for (int s = 0; s <= n_sums; s++) tab.first[s] = fs[s];
  MulConsts c = mul_consts_from((const uint32_t*)consts);
  const int64_t per_block = K1_SUM_THREADS / splits;
  dim3 grid((unsigned int)((n + per_block - 1) / per_block), (unsigned int)n_sums);
  field_product_sum_kernel<<<grid, K1_SUM_THREADS, 0, (cudaStream_t)stream>>>(
      (int32_t*)out, tab, n, splits, c);
  return (int)cudaGetLastError();
}

// out = x^e over n elements, x and out [L, n]; consts: the host buffer
// fields/chain.py:exp_consts (its sparse word picks the instance).
int PT_ENTRY(pt_field_exp)(void* out, const void* x, int64_t n, const void* consts,
                           void* stream) {
  ExpConsts cs;
  memcpy(&cs, consts, sizeof(cs));
  if (n < 1 || cs.slots < 1 || cs.slots > EXP_MAX_SLOTS || cs.n_steps < 1 ||
      cs.n_steps > EXP_MAX_STEPS || !chain_steps_valid(cs.steps, cs.n_steps, cs.slots) ||
      (cs.sparse && !sparse_shape(cs.f)))
    return (int)cudaErrorInvalidValue;
#if PT_LIMBS == 8
  auto kernel = cs.sparse ? field_exp_kernel<true> : field_exp_kernel<false>;
#else
  auto kernel = field_exp_kernel<false>;
#endif
  const int64_t threads = n >= EXP_THREADS ? EXP_THREADS : (n + 31) / 32 * 32;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > EXP_MAX_BLOCKS) blocks = EXP_MAX_BLOCKS;
  const size_t smem = (size_t)threads * cs.slots * PT_LIMBS * 4;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned int)blocks, (unsigned int)threads, smem, (cudaStream_t)stream>>>(
      (int32_t*)out, (const int32_t*)x, n, cs);
  return (int)cudaGetLastError();
}

}  // extern "C"

PT_NAMESPACE_END
