// K5: a batch of width-4 Rescue permutations (rescue_permutation).
//
// Replaces the TPU path of plonky_tpu/hashing/rescue.py:rescue_permutation
// (a lax.scan over rounds whose body reaches the three Pallas kernels of
// plonky_tpu/fields/pallas_kernels.py: fused_composite through
// fields/ops.py:exp_const, conv_pallas and reduce_work_pallas through the
// MDS product ops.mul_loose and its ops.sum_reduce).  On the TPU each
// round's S-box ran as a scan of whole-batch multiplies through device
// memory; here a permutation's state stays in registers from its first
// round to its last, and one launch runs the whole batch.
//
// What bounds it: operations.  The inverse S-box x^(1/alpha) has a 254-bit
// exponent: ~97% of the work is its ~250 squares and ~65 multiplies an
// element a round, against 2 squares and a multiply for x^5 and 8 products
// for the two MDS mixes; a permutation reads and writes 256 bytes
// (chip_smoke.py:rescue_work counts the least work).  On the card the
// integer ALU pipe (the carry chains' IADD3.X) and the instruction issue
// are the limits, so the design cuts instructions, not only products.
//
// The design: 4 threads a permutation (RESCUE_LANES), thread r of a quad
// holding state element r in Montgomery form (x 2^256 mod p, canonical
// between S-boxes), 256 threads a block (RESCUE_THREADS).
// - Each S-box runs the exponent chain that the host built
//   (fields/chain.py:sbox_schedule) through field.cuh's exp_chain, which
//   field_exp shares: a list of steps, each "load a table
//   slot, square k times, multiply by a table slot, store to a slot", the
//   same for every thread, so the loop is uniform across the warp and has
//   no per-bit select.  The chain is a sliding window of up to 3 bits
//   (hashing/rescue.py:KERNEL_WINDOW); the table of odd powers x, x^3, ...
//   and x^2 lives in dynamic shared memory, one column a thread.
// - A square is cc_mont_sqr (36 limb products), a multiply cc_mont_mul_sos
//   (64), both separated: the 512-bit product on pairs of limbs that ptxas
//   fuses into one IMAD.WIDE.U32.X a limb product, then one REDC
//   (field.cuh), left below 2p (lazy) until the chain's end.  For
//   p = 2^254 + c, c < 2^128 (both Tweedle base fields) the REDC takes 3
//   limb products a row instead of 8: the kernel's SPARSE instance, chosen
//   from p's limbs by the host.  Every other 8-limb field (BLS12-377's
//   scalar field) runs the dense one.
// - The MDS row r = sum_c M[r][c] s_c reads the quad's elements by
//   __shfl_sync, adds the four 512-bit products into one accumulator
//   (cc_acc_product) and reduces once.
// The constants (field, table size, chains, Montgomery MDS matrix and round
// constants) are one __grid_constant__ parameter of each launch (~18 KB at
// RESCUE_MAX_ROUNDS; Hopper takes up to 32 KB of parameters), so any 8-limb
// field and any round count up to RESCUE_MAX_ROUNDS runs without a rebuild.
// Threads past the batch keep running (zeros) so that every shuffle has its
// whole warp, and store nothing.
//
// The launch shape is the fastest of a sweep at 2^14 (PERF.md §6): 64 and
// 128 threads a block, a __launch_bounds__ minimum of blocks, and one
// thread a permutation running its 4 elements' chains side by side were
// all slower.
//
// Built twice (_cuda.py): at 8 limbs, and at 12 (-DPT_LIMBS=12, BLS12-377's
// base field, entry pt_rescue_permutation_l12), the same code over 12
// limbs with R = 2^384: the dense instance only (no 12-limb field has the
// sparse shape; the entry refuses the flag), 78 limb products a square and
// 144 a multiply, each with a 12-row REDC, and the MDS accumulator of
// 2L + 1 = 25 limbs.  Its constants take 26.5 KB of the parameter space,
// and its table of odd powers 60 KB of dynamic shared memory a block,
// which the C entry allows the kernel first.  The launch shape is the
// 8-limb sweep's, not retuned.
#include <cstddef>
#include <cstring>

#include "field.cuh"

PT_NAMESPACE_BEGIN

#define RESCUE_WIDTH 4
#define RESCUE_MAX_ROUNDS 64
#define RESCUE_MAX_STEPS 128     // steps of one S-box's chain
#define RESCUE_MAX_SLOTS 5       // table slots an element: windows up to 3 bits
#define RESCUE_NO_SLOT 31        // a step field that names no slot
static_assert(RESCUE_NO_SLOT == PT_NO_SLOT, "the chains' steps are field.cuh's");
#define RESCUE_THREADS 256
#define RESCUE_LANES 4           // threads a permutation, one element each
// A block's table of odd powers: 40 KB at 8 limbs, within the default
// 48 KB of dynamic shared memory; 60 KB at 12, allowed by the C entry.
#define RESCUE_TABLE_BYTES(slots) ((size_t)RESCUE_THREADS * (slots) * PT_LIMBS * 4)
static_assert(RESCUE_TABLE_BYTES(RESCUE_MAX_SLOTS) <= (PT_LIMBS == 8 ? 48 : 227) * 1024,
              "the table must fit the dynamic shared memory a block may have");

// The words of hashing/rescue.py:kernel_consts, in order.
struct RescueConsts {
  FieldConsts f;                                        // p, -p^-1 mod 2^32
  uint32_t r2[PT_LIMBS];                                // R^2 mod p, R = 2^(32 L)
  uint32_t sparse;                                      // 1: p = 2^254 + c
  uint32_t rounds;
  uint32_t slots;                                       // table slots an element
  uint32_t n_steps[2];                                  // x^(1/alpha), x^alpha
  uint32_t steps[2][RESCUE_MAX_STEPS];
  uint32_t mds[RESCUE_WIDTH][RESCUE_WIDTH][PT_LIMBS];   // Montgomery form
  uint32_t rc[RESCUE_MAX_ROUNDS][2][RESCUE_WIDTH][PT_LIMBS];
};

#define RESCUE_HEADER_WORDS                                            \
  (PT_FIELD_WORDS + PT_LIMBS + 5 + 2 * RESCUE_MAX_STEPS +              \
   RESCUE_WIDTH * RESCUE_WIDTH * PT_LIMBS)
#define RESCUE_ROUNDS_WORD (PT_FIELD_WORDS + PT_LIMBS + 1)
#define RESCUE_ROUND_WORDS (2 * RESCUE_WIDTH * PT_LIMBS)

static_assert(sizeof(RescueConsts) ==
                  4 * (RESCUE_HEADER_WORDS + RESCUE_MAX_ROUNDS * RESCUE_ROUND_WORDS),
              "RescueConsts must match the host buffer's word layout");
static_assert(offsetof(RescueConsts, rounds) == 4 * RESCUE_ROUNDS_WORD,
              "the round count's word");
static_assert(sizeof(RescueConsts) <= 32764,
              "RescueConsts must fit the kernel parameter space (CUDA 12.1+)");

// s = s^e for the S-box `half` (Montgomery form, canonical in and out):
// the host's chain through field.cuh's exp_chain, on this thread's column
// tab of the block's table.
template <bool SPARSE>
__device__ __forceinline__ void rescue_sbox(uint32_t s[PT_LIMBS], int half,
                                            const RescueConsts& cs, uint32_t* tab) {
  exp_chain<SPARSE>(s, cs.steps[half], (int)cs.n_steps[half], cs.f, tab,
                    RESCUE_THREADS);
}

// y = sum_c M[r][c] x_c + rc[round][half][r] for canonical x_c: the four
// products in one accumulator, one REDC (below 4 p^2 / R + p < 3p, and
// below R: kernel_consts refuses a field where it is not), two
// conditional subtractions.
template <bool SPARSE>
__device__ __forceinline__ void rescue_mds_row(uint32_t y[PT_LIMBS], const uint32_t x[RESCUE_WIDTH][PT_LIMBS],
                                               int r, int round, int half,
                                               const RescueConsts& cs) {
  uint32_t acc[PT_ACC_LIMBS], cnt[PT_ACC_CARRIES], t[PT_PRODUCT_LIMBS], zero[PT_PRODUCT_LIMBS];
#pragma unroll
  for (int k = 0; k < PT_ACC_LIMBS; k++) acc[k] = 0;
#pragma unroll
  for (int k = 0; k < PT_ACC_CARRIES; k++) cnt[k] = 0;
#pragma unroll
  for (int c = 0; c < RESCUE_WIDTH; c++) cc_acc_product(acc, cnt, x[c], cs.mds[r][c]);
  cc_acc_fold(t, acc, cnt);
#pragma unroll
  for (int k = 0; k < PT_PRODUCT_LIMBS; k++) zero[k] = 0;
  cc_redc<SPARSE>(y, t, zero, cs.f);
  cc_csub(y, cs.f);
  cc_csub(y, cs.f);
  cc_add_mod(y, y, cs.rc[round][half][r], cs.f);
}

// The MDS mix and round constants of this thread's element: row r =
// lane & 3 from the quad's elements read by __shfl_sync.
template <bool SPARSE>
__device__ __forceinline__ void rescue_mds_add(uint32_t s[PT_LIMBS], int r, int round,
                                               int half, const RescueConsts& cs) {
  uint32_t x[RESCUE_WIDTH][PT_LIMBS];
  const int base = (threadIdx.x & 31) & ~3;
#pragma unroll
  for (int c = 0; c < RESCUE_WIDTH; c++) {
#pragma unroll
    for (int k = 0; k < PT_LIMBS; k++) x[c][k] = __shfl_sync(0xffffffffu, s[k], base + c);
  }
  rescue_mds_row<SPARSE>(s, x, r, round, half, cs);
}

// state and out: [4, L, n] int32, element r of permutation i, limb k at
// (r L + k) n + i.  RESCUE_LANES threads a permutation (see the top).
template <bool SPARSE>
__global__ void __launch_bounds__(RESCUE_THREADS)
rescue_permutation_kernel(int32_t* out, const int32_t* state, int64_t n,
                          const __grid_constant__ RescueConsts cs) {
  extern __shared__ uint32_t rescue_table[];
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t i = t / RESCUE_LANES;
  const int r = (int)(t & 3);
  const bool valid = i < n;
  const FieldConsts& f = cs.f;
  uint32_t* tab = rescue_table + threadIdx.x;
  uint32_t s[PT_LIMBS];
  if (valid) fe_load(s, state + (int64_t)r * PT_LIMBS * n, n, i);
  else fe_set_small(s, 0);
  mf_mul_any(s, s, cs.r2, f);              // into Montgomery form
  const int rounds = (int)cs.rounds;
#pragma unroll 1
  for (int round = 0; round < rounds; round++) {
#pragma unroll 1
    for (int half = 0; half < 2; half++) {
      rescue_sbox<SPARSE>(s, half, cs, tab);
      rescue_mds_add<SPARSE>(s, r, round, half, cs);
    }
  }
  uint32_t one[PT_LIMBS];
  fe_set_small(one, 1);
  mf_mul_any(s, s, one, f);                // back to canonical
  if (valid) fe_store(out + (int64_t)r * PT_LIMBS * n, n, i, s);
}

// Every step of both chains names slots of the table, or none.
static bool rescue_steps_valid(const RescueConsts& cs) {
  if (cs.slots < 1 || cs.slots > RESCUE_MAX_SLOTS) return false;
  for (int half = 0; half < 2; half++)
    if (cs.n_steps[half] > RESCUE_MAX_STEPS ||
        !chain_steps_valid(cs.steps[half], cs.n_steps[half], cs.slots))
      return false;
  return true;
}

extern "C" {

// out, state: [4, L, n] int32 device tensors; consts: the host buffer
// hashing/rescue.py:kernel_consts of n_words uint32 words (its header and
// its round constants), passed to the kernel by value.  The buffer's
// sparse word picks the kernel's instance.
int PT_ENTRY(pt_rescue_permutation)(void* out, const void* state, int64_t n,
                                    const void* consts, int n_words, void* stream) {
  const uint32_t* words = (const uint32_t*)consts;
  if (n_words < RESCUE_HEADER_WORDS) return (int)cudaErrorInvalidValue;
  const uint32_t rounds = words[RESCUE_ROUNDS_WORD];
  if (rounds < 1 || rounds > RESCUE_MAX_ROUNDS ||
      n_words != RESCUE_HEADER_WORDS + (int)rounds * RESCUE_ROUND_WORDS)
    return (int)cudaErrorInvalidValue;
  RescueConsts cs = {};
  memcpy(&cs, consts, 4 * (size_t)n_words);
  if (!rescue_steps_valid(cs) || (cs.sparse && !sparse_shape(cs.f)))
    return (int)cudaErrorInvalidValue;
#if PT_LIMBS == 8
  auto kernel = cs.sparse ? rescue_permutation_kernel<true> : rescue_permutation_kernel<false>;
#else
  if (cs.sparse) return (int)cudaErrorInvalidValue;
  auto kernel = rescue_permutation_kernel<false>;
#endif
  const size_t smem = RESCUE_TABLE_BYTES(cs.slots);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t threads = RESCUE_LANES * n;
  const unsigned int blocks = (unsigned int)((threads + RESCUE_THREADS - 1) / RESCUE_THREADS);
  kernel<<<blocks, RESCUE_THREADS, smem, (cudaStream_t)stream>>>(
      (int32_t*)out, (const int32_t*)state, n, cs);
  return (int)cudaGetLastError();
}

}  // extern "C"

PT_NAMESPACE_END
