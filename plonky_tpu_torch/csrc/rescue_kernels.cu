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
// What bounds it: the inverse S-box x^(1/5) is a 254-bit exponent, 377
// modular multiplies an element a round by this kernel's square-and-multiply
// (~306 by 5-bit sliding windows), against 3 for the forward S-box and 8
// for the two MDS products; a permutation reads and writes 256 bytes and
// needs at least ~4.4e6 IMAD issue slots of products at 16 rounds
// (chip_smoke.py:rescue_work), so it is bound by operations, ~97% of them
// in the inverse S-box.
//
// The design: 4 threads a permutation, thread r of a quad holding state
// element r in Montgomery form (x 2^256 mod p, canonical).  Each S-box is
// a rolled square-and-multiply loop over the exponent's bits with ONE
// multiply site (cc_mont_mul, the unrolled carry-chain CIOS product of
// field.cuh); the exponent is the same for every thread, so the loop is
// uniform across the warp.  The MDS row r = sum_c M[r][c] s_c reads the
// quad's other elements by __shfl_sync, one rolled loop with a second
// multiply site.  The constants (field, exponents, Montgomery MDS matrix
// and round constants) are one __grid_constant__ parameter of each launch
// (~17 KB at RESCUE_MAX_ROUNDS; Hopper takes up to 32 KB of parameters), so
// any 8-limb field and any round count up to RESCUE_MAX_ROUNDS runs without
// a rebuild, and launches of different fields on different streams share
// no state.  Threads past the batch keep running (zeros) so that every
// shuffle has its whole warp, and store nothing.
#include <cstring>

#include "field.cuh"

#define RESCUE_WIDTH 4
#define RESCUE_MAX_ROUNDS 64
#define RESCUE_THREADS 128

// The words of hashing/rescue.py:kernel_consts, in order.
struct RescueConsts {
  FieldConsts f;                                        // p, -p^-1 mod 2^32
  uint32_t r2[PT_LIMBS];                                // 2^512 mod p
  uint32_t exp[2][PT_LIMBS];                            // 1/alpha, alpha
  uint32_t exp_top[2];                                  // index of the top bit
  uint32_t rounds;
  uint32_t mds[RESCUE_WIDTH][RESCUE_WIDTH][PT_LIMBS];   // Montgomery form
  uint32_t rc[RESCUE_MAX_ROUNDS][2][RESCUE_WIDTH][PT_LIMBS];
};

#define RESCUE_HEADER_WORDS \
  (PT_FIELD_WORDS + 3 * PT_LIMBS + 3 + RESCUE_WIDTH * RESCUE_WIDTH * PT_LIMBS)
#define RESCUE_ROUND_WORDS (2 * RESCUE_WIDTH * PT_LIMBS)

static_assert(sizeof(RescueConsts) ==
                  4 * (RESCUE_HEADER_WORDS + RESCUE_MAX_ROUNDS * RESCUE_ROUND_WORDS),
              "RescueConsts must match the host buffer's word layout");
static_assert(sizeof(RescueConsts) <= 32764,
              "RescueConsts must fit the kernel parameter space (CUDA 12.1+)");

// s = s^e for the exponent exp[half] (Montgomery form in and out): left to
// right, a square for every bit below the top one and a multiply by the
// input after each set bit, all through one multiply site.
__device__ __forceinline__ void rescue_sbox(uint32_t s[PT_LIMBS], int half,
                                            const RescueConsts& cs) {
  const FieldConsts& f = cs.f;
  uint32_t x[PT_LIMBS];
  fe_copy(x, s);
  int i = (int)cs.exp_top[half] - 1;
  bool mul_step = false;
#pragma unroll 1
  while (i >= 0) {
    uint32_t y[PT_LIMBS];
#pragma unroll
    for (int k = 0; k < PT_LIMBS; k++) y[k] = mul_step ? x[k] : s[k];
    cc_mont_mul(s, s, y, f);
    if (mul_step) {
      mul_step = false;
      i--;
    } else if ((cs.exp[half][i >> 5] >> (i & 31)) & 1) {
      mul_step = true;
    } else {
      i--;
    }
  }
}

// s = sum_c M[r][c] s_c + rc[round][half][r], the quad's elements s_c read
// from lanes (lane & ~3) + c.
__device__ __forceinline__ void rescue_mds_add(uint32_t s[PT_LIMBS], int r, int round,
                                               int half, const RescueConsts& cs) {
  const FieldConsts& f = cs.f;
  const int base = (threadIdx.x & 31) & ~3;
  uint32_t acc[PT_LIMBS];
  fe_copy(acc, cs.rc[round][half][r]);
#pragma unroll 1
  for (int c = 0; c < RESCUE_WIDTH; c++) {
    uint32_t v[PT_LIMBS], t[PT_LIMBS];
#pragma unroll
    for (int k = 0; k < PT_LIMBS; k++) v[k] = __shfl_sync(0xffffffffu, s[k], base + c);
    cc_mont_mul(t, v, cs.mds[r][c], f);
    cc_add_mod(acc, acc, t, f);
  }
  fe_copy(s, acc);
}

// state and out: [4, 8, n] int32, element r of permutation i, limb k at
// (r 8 + k) n + i.  Four threads a permutation (see the top of the file).
__global__ void __launch_bounds__(RESCUE_THREADS)
rescue_permutation_kernel(int32_t* out, const int32_t* state, int64_t n,
                          const __grid_constant__ RescueConsts cs) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t i = t >> 2;
  const int r = (int)(t & 3);
  const bool valid = i < n;
  const FieldConsts& f = cs.f;
  uint32_t s[PT_LIMBS];
  if (valid) fe_load(s, state + (int64_t)r * PT_LIMBS * n, n, i);
  else fe_set_small(s, 0);
  mf_mul(s, s, cs.r2, f);          // into Montgomery form
  const int rounds = (int)cs.rounds;
#pragma unroll 1
  for (int round = 0; round < rounds; round++) {
#pragma unroll 1
    for (int half = 0; half < 2; half++) {
      rescue_sbox(s, half, cs);
      rescue_mds_add(s, r, round, half, cs);
    }
  }
  uint32_t one[PT_LIMBS];
  fe_set_small(one, 1);
  mf_mul(s, s, one, f);                  // back to canonical
  if (valid) fe_store(out + (int64_t)r * PT_LIMBS * n, n, i, s);
}

extern "C" {

// out, state: [4, 8, n] int32 device tensors; consts: the host buffer
// hashing/rescue.py:kernel_consts of n_words uint32 words (its header and
// its round constants), passed to the kernel by value.
int pt_rescue_permutation(void* out, const void* state, int64_t n, const void* consts,
                          int n_words, void* stream) {
  const uint32_t* words = (const uint32_t*)consts;
  if (n_words < RESCUE_HEADER_WORDS) return (int)cudaErrorInvalidValue;
  const uint32_t rounds = words[PT_FIELD_WORDS + 3 * PT_LIMBS + 2];
  if (rounds < 1 || rounds > RESCUE_MAX_ROUNDS ||
      n_words != RESCUE_HEADER_WORDS + (int)rounds * RESCUE_ROUND_WORDS)
    return (int)cudaErrorInvalidValue;
  RescueConsts cs = {};
  memcpy(&cs, consts, 4 * (size_t)n_words);
  const int64_t threads = RESCUE_WIDTH * n;
  const unsigned int blocks = (unsigned int)((threads + RESCUE_THREADS - 1) / RESCUE_THREADS);
  rescue_permutation_kernel<<<blocks, RESCUE_THREADS, 0, (cudaStream_t)stream>>>(
      (int32_t*)out, (const int32_t*)state, n, cs);
  return (int)cudaGetLastError();
}

}  // extern "C"
