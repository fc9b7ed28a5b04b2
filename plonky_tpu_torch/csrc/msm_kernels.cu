// K4: the Pippenger bucket pipeline, in two kernels.
//
// Replaces the TPU kernel fused_composite (plonky_tpu/fields/
// pallas_kernels.py) at tile 512 under force_fusion(512), instantiated as
// the segmented-scan combine _seg_combine of plonky_tpu/curves/msm.py
// (:95-102) inside _chunked_scan_parts, _seg_scan_pair and
// _seg_scan_gather: a point add plus a select on the segment-start flag,
// scanned over points sorted by window digit, then the reversed-cumsum
// reduction sum_j j B_j (:376).  The digits and the argsort per window row
// stay in torch; the combination across windows (Horner) is K2's
// curve_horner.
//
// What bounds it: every point of a window row costs one complete add (12
// Montgomery products) against 96 bytes of point and two 4-byte indices,
// so both kernels are bound by the integer multiply pipe, and only if
// enough threads run one add chain each.  The design keeps every chain
// short whatever the digits are:
//   - accumulate: one thread per chunk of `chunk` sorted positions (32 at
//     8 limbs, 64 at 12: curves/msm.py:chunk_for), so the thread count is
//     R N / chunk; a run of equal digits that crosses
//     chunks is merged by a pairwise tree in shared memory over the block's
//     MSM_TILE chunks, and a run that crosses blocks leaves one carry per
//     block, added by the reduction (at most N / (chunk MSM_TILE) of
//     them);
//   - reduce: one block per window row (any number of rows a launch:
//     msm_chunked reduces all its slices' rows in one); lane s walks
//     segment s of `seg` buckets with the running-sum trick, a suffix scan
//     and two pairwise trees over the lanes combine the segments: ~2 seg +
//     2 log2 nseg + log2 seg dependent adds instead of 2^(c+1).  seg is
//     the smallest power of two that leaves at most 128 segments (32 for
//     more than 512 rows; curves/msm.py:reduce_seg).
// The points stay in Montgomery form (R = 2^(32 L)) from the basis copy to
// the reduction's output, which converts back to canonical coordinates
// once.  The gathered basis points arrive by cp.async into a per-thread
// double buffer in shared memory while the previous add runs.
//
// Built twice (_cuda.py): at 8 limbs, and at 12 (-DPT_LIMBS=12, BLS12-377
// G1; entries pt_msm_bucket_accumulate_l12, ...).  At both widths mf_mul
// is the unrolled carry-chain product (field.cuh; its sparse REDC rows at
// 8 limbs) and the formulas' additions run on carry chains
// (curve.cuh:pt_fadd).  A thread of the accumulation holds four points in
// static shared memory (two staged, its cont and head pieces): 128 x 4 x
// 96 bytes = 48 KB at 8 limbs, the static limit, so an SM runs at most 4
// blocks.  There the loop and the trees each inline an add: 200 registers
// and no spill, 2 blocks an SM (MSM_MIN_BLOCKS); capping the registers for
// 3 or 4 blocks spills, and the trees' out-of-line add (mpt_add_call)
// moves its points through the stack, both slower on the H100 (PERF.md
// §6, msm_sweep.py).  The 12-limb build's points of 144 bytes take 64
// chunks a block (36 KB; curves/msm.py:tile_for), and its accumulation
// inlines one add, in its loop, its trees taking the out-of-line one.
// There a thread holds ~250 registers, so an SM runs 4 blocks: 8 warps,
// whose chains of dependent products leave the multiply pipe idle about
// half the time (~51% of the operations bound on the H100).  Capping the
// registers for 5-8 blocks spills and is slower, as are a CIOS product and
// an out-of-line add in the loop.
#include "curve.cuh"

PT_NAMESPACE_BEGIN

#if PT_LIMBS == 8
#define MSM_TILE 128        // chunks, one per thread, in an accumulate block
#define MSM_MIN_BLOCKS 2    // accumulate blocks an SM (caps registers at 255)
#define MSM_ACC_BOUNDS __launch_bounds__(MSM_TILE, MSM_MIN_BLOCKS)
#else
#define MSM_TILE 64         // the same at 12 limbs (see above)
#define MSM_ACC_BOUNDS __launch_bounds__(MSM_TILE)
#endif
#define MSM_WORDS (3 * PT_LIMBS)   // a point: X, Y, Z, L limbs each
#define MSM_WARP 32         // reduce: the fewest lanes a row
#define REDUCE_MAX_LANES 128  // reduce: the most lanes a row, one a segment

__device__ __forceinline__ int64_t i64_min(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t i64_max(int64_t a, int64_t b) { return a > b ? a : b; }

__device__ __forceinline__ void mpt_load(Point& r, const uint32_t* src) {
  const uint4* s = (const uint4*)src;
  uint32_t w[MSM_WORDS];
#pragma unroll
  for (int k = 0; k < MSM_WORDS / 4; k++) {
    uint4 v = s[k];
    w[4 * k] = v.x;
    w[4 * k + 1] = v.y;
    w[4 * k + 2] = v.z;
    w[4 * k + 3] = v.w;
  }
#pragma unroll
  for (int k = 0; k < PT_LIMBS; k++) {
    r.x[k] = w[k];
    r.y[k] = w[PT_LIMBS + k];
    r.z[k] = w[2 * PT_LIMBS + k];
  }
}

__device__ __forceinline__ void mpt_save(uint32_t* dst, const Point& p) {
  uint4* d = (uint4*)dst;
#pragma unroll
  for (int k = 0; k < MSM_WORDS / 4; k++) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; i++) {
      int e = 4 * k + i;
      w[i] = e < PT_LIMBS ? p.x[e] : e < 2 * PT_LIMBS ? p.y[e - PT_LIMBS]
                                                      : p.z[e - 2 * PT_LIMBS];
    }
    d[k] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

__device__ __forceinline__ void cp_async_point(uint32_t* smem, const uint32_t* gmem) {
  uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
#pragma unroll
  for (int k = 0; k < MSM_WORDS / 4; k++)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s + 16 * k),
                 "l"(gmem + 4 * k)
                 : "memory");
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Block (row r, tile): thread q sums the sorted positions
// [chunk (tile MSM_TILE + q), + chunk) of row r.  A piece is the part of one
// run (equal nonzero digits) inside the chunk, summed in sorted order from
// its first point.  A piece that is its whole run goes to buckets[r, d].
// Otherwise the piece of a run that began in an earlier chunk goes to
// cont[q], and the piece of a run that begins here and runs on goes to
// head[q].  Then, for each run crossing chunks, a pairwise tree over its
// chunks within the tile, rooted at its first chunk here (offsets 1, 2,
// 4, ...: element i takes in element i + 2^k when i is a multiple of
// 2^(k+1)), sums the pieces; the root's sum goes to buckets[r, d] when the
// run begins in this tile, and to carries[r, tile] when it began in an
// earlier one.  Digit 0 is skipped; slots no one writes stay zero.
// basis: [N, 3L] Montgomery points; digits, order: [R, N] int32 (sorted
// digits, the argsort); starts: [R, nb + 1] int32 run starts; buckets:
// [R, nb, 3L]; carries: [R, ntiles, 3L].
//
// SIGNED (msm_bucket_accumulate_signed, the signed-window MSM that
// replaces plonky_tpu/curves/msm.py:292-294, which negates Y on the
// gathered points): bit 31 of an order word marks a position whose digit
// is negative (N < 2^31 leaves the bit free); the point is gathered from
// the low 31 bits and enters with Y negated (mpt_negate_y), before any
// add.  The unsigned kernel is the same body with SIGNED false, whose code
// the flag leaves as it was (ptxas_compare.py).
template <bool SIGNED>
__device__ __forceinline__ int64_t point_row(int32_t word) {
  if constexpr (SIGNED)
    return (int64_t)(word & 0x7FFFFFFF);
  else
    return (int64_t)word;
}

// y -> p - y (0 stays 0), in Montgomery form as in canonical form.
__device__ __forceinline__ void mpt_negate_y(Point& pt, const MontCurveConsts& cc) {
  uint32_t zero[PT_LIMBS];
  fe_set_small(zero, 0);
  fe_sub(pt.y, zero, pt.y, cc.f);
}

// The add out of line: one copy of the add's code serves every call site
// of the reduction (chains on few threads, where a call's moves through
// local memory cost little against the add) and, at 12 limbs, the
// accumulation's trees, so that the accumulation inlines one add (12
// unrolled products, field.cuh's 12-limb mf_mul), in its loop.
static __device__ __noinline__ void mpt_add_call(Point& r, const Point& p, const Point& q) {
  mpt_add(r, p, q, c_curve);
}

template <bool SIGNED>
__device__ __forceinline__ void msm_bucket_accumulate_body(
    uint32_t* buckets, uint32_t* carries, const uint32_t* basis, const int32_t* digits,
    const int32_t* order, const int32_t* starts, int64_t n, int64_t nb, int64_t chunk,
    int64_t ntiles) {
  __shared__ __align__(16) uint32_t stage[MSM_TILE][2][MSM_WORDS];
  __shared__ __align__(16) uint32_t cont[MSM_TILE][MSM_WORDS];
  __shared__ __align__(16) uint32_t head[MSM_TILE][MSM_WORDS];
  const int q = threadIdx.x;
  const int64_t r = blockIdx.x / ntiles;
  const int64_t tile = blockIdx.x - r * ntiles;
  const int64_t nchunks = (n + chunk - 1) / chunk;
  const int64_t first = tile * MSM_TILE;                      // first chunk of the tile
  const int64_t last = i64_min(first + MSM_TILE, nchunks) - 1;    // last chunk of the tile
  const int64_t cq = first + q;                               // this thread's chunk
  const int64_t s0 = cq * chunk;
  const int64_t s1 = i64_min(s0 + chunk, n);
  const int32_t* st = starts + r * (nb + 1);
  const int32_t* dig = digits + r * n;
  const int32_t* ord = order + r * n;
  uint32_t* out = buckets + r * nb * MSM_WORDS;

  // the runs this thread hands to the tree: the one it continues (cont) and
  // the one it begins (head), by their [lo, hi) and digit
  bool has_cont = false, has_head = false;
  int64_t cont_lo = 0, cont_hi = 0, head_hi = 0;
  int head_d = 0;

  const int64_t sb = i64_max(s0, (int64_t)st[1]);                 // skip digit 0
  if (sb < s1) {
    cp_async_point(stage[q][0], basis + point_row<SIGNED>(ord[sb]) * MSM_WORDS);
    Point acc;
    int64_t end = sb, lo = 0, hi = 0;
    int d = 0;
    for (int64_t s = sb; s < s1; s++) {
      const int buf = (int)((s - sb) & 1);
      if (s + 1 < s1) {
        cp_async_point(stage[q][buf ^ 1], basis + point_row<SIGNED>(ord[s + 1]) * MSM_WORDS);
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      }
      Point pt;
      mpt_load(pt, stage[q][buf]);
      if constexpr (SIGNED) {
        if (ord[s] < 0) mpt_negate_y(pt, c_curve);
      }
      if (s == end) {                                         // a new piece
        d = dig[s];
        lo = st[d];
        hi = st[d + 1];
        end = i64_min(hi, s1);
        acc = pt;
      } else {
        mpt_add(acc, acc, pt, c_curve);
      }
      if (s + 1 == end) {                                     // the piece ends
        if (lo >= s0 && hi <= s1) {
          mpt_save(out + (int64_t)d * MSM_WORDS, acc);
        } else if (lo < s0) {
          mpt_save(cont[q], acc);
          has_cont = true;
          cont_lo = lo;
          cont_hi = hi;
        } else {
          mpt_save(head[q], acc);
          has_head = true;
          head_hi = hi;
          head_d = d;
        }
      }
    }
  }
  __syncthreads();

  // the trees, one level per step; a receiver's partner holds a cont piece
  // of the same run and is no receiver at this step
  const int64_t cont_root = i64_max(cont_lo / chunk, first);
  const int64_t cont_last = i64_min((cont_hi - 1) / chunk, last);
  const int64_t head_last = i64_min((head_hi - 1) / chunk, last);
  for (int64_t step = 1; step < MSM_TILE; step <<= 1) {
    uint32_t* dst = nullptr;
    if (has_cont && ((cq - cont_root) & (2 * step - 1)) == 0 && cq + step <= cont_last)
      dst = cont[q];
    if (has_head && cq + step <= head_last) dst = head[q];
    if (dst != nullptr) {
      Point a, b;
      mpt_load(a, dst);
      mpt_load(b, cont[q + step]);
#if PT_LIMBS == 12
      mpt_add_call(a, a, b);        // one inlined add a kernel (see mpt_add_call)
#else
      mpt_add(a, a, b, c_curve);
#endif
      mpt_save(dst, a);
    }
    __syncthreads();
  }
  if (has_head) {
    Point a;
    mpt_load(a, head[q]);
    mpt_save(out + (int64_t)head_d * MSM_WORDS, a);
  }
  if (has_cont && cq == first) {
    Point a;
    mpt_load(a, cont[q]);
    mpt_save(carries + (r * ntiles + tile) * MSM_WORDS, a);
  }
}

#if PT_BUILDS(1)
__global__ void MSM_ACC_BOUNDS msm_bucket_accumulate_kernel(
    uint32_t* buckets, uint32_t* carries, const uint32_t* basis, const int32_t* digits,
    const int32_t* order, const int32_t* starts, int64_t n, int64_t nb, int64_t chunk,
    int64_t ntiles) {
  msm_bucket_accumulate_body<false>(buckets, carries, basis, digits, order, starts, n, nb,
                                    chunk, ntiles);
}
#endif

#if PT_BUILDS(2)
__global__ void MSM_ACC_BOUNDS msm_bucket_accumulate_signed_kernel(
    uint32_t* buckets, uint32_t* carries, const uint32_t* basis, const int32_t* digits,
    const int32_t* order, const int32_t* starts, int64_t n, int64_t nb, int64_t chunk,
    int64_t ntiles) {
  msm_bucket_accumulate_body<true>(buckets, carries, basis, digits, order, starts, n, nb,
                                   chunk, ntiles);
}
#endif

// acc (+)= x, where `has` says whether acc holds a point yet.
__device__ __forceinline__ void mpt_accumulate(Point& acc, bool& has, const Point& x) {
  if (has) {
    mpt_add_call(acc, acc, x);
  } else {
    acc = x;
    has = true;
  }
}

// One block per window row r, of `lanes` threads: a power of two from 32
// up, at least nseg (the C entry picks it; REDUCE_MAX_LANES at most).
// Buckets 1 .. nb-1 fall into nseg segments of `seg` buckets (a power of
// two; the last segment may be short): segment s holds buckets
// s seg + i + 1, i < seg.
//   1. Lane s adds to each nonempty bucket its carries (run [lo, hi):
//      those of tiles lo/tp + 1 .. (hi-1)/tp, tp = points per accumulate
//      tile), then walks i from the top down keeping
//        T_s = sum_i B_{s seg+i+1}   and   W_s = sum_i (i+1) B_{s seg+i+1}.
//   2. U_s = sum_{s' >= s} T_s', a suffix scan over the lanes: at distance
//      d = 1, 2, 4, ... lane s adds U_{s+d} as it stood before the step.
//   3. sum_j j B_j = sum_s W_s + seg sum_{s>=1} s T_s, and
//      sum_{s>=1} s T_s = sum_{s>=1} U_s: two pairwise trees at once, one
//      level a step, over the W_s (the receiving lane s adds) and over the
//      U_s with U_0 left out (lane s + step adds into node s, a lane with
//      no W work at that step).
//   4. Lane 0 doubles the U sum log2 seg times, adds the W sum and converts
//      to canonical coordinates (an empty row gives the identity
//      (0 : 1 : 0)).
// A row's chain is ~2 seg + 2 log2 nseg + log2 seg adds and doublings
// (~20 at nb = 256, 128 lanes), for ~nseg log2 nseg more adds than the 2
// a bucket of the walk.  curves/msm.py:reduce_seg trades the
// two by the row count: 128 lanes a row for a few hundred rows (the
// prove's msm, one slice), 32 for the 2,048 rows of msm_chunked's one
// reduce over 64 slices.  buckets: [R, nb, 3L]; carries: [R, ntiles, 3L];
// starts: [R, nb + 1]; out: [L, R] each.  Dynamic shared memory: the U_s
// and W_s, lanes points each, then their flags.
#if PT_BUILDS(3)
__global__ void __launch_bounds__(REDUCE_MAX_LANES) msm_bucket_reduce_kernel(
    int32_t* ox, int32_t* oy, int32_t* oz, const uint32_t* buckets, const uint32_t* carries,
    const int32_t* starts, int64_t rows, int64_t nb, int64_t ntiles, int64_t tile_points,
    int seg, int nseg) {
  extern __shared__ __align__(16) uint32_t reduce_smem[];
  const int lanes = blockDim.x;
  uint32_t* usum = reduce_smem;
  uint32_t* wsum = reduce_smem + lanes * MSM_WORDS;
  int* u_ok = (int*)(wsum + lanes * MSM_WORDS);
  int* w_ok = u_ok + lanes;
  const int s = threadIdx.x;
  const int64_t r = blockIdx.x;
  const int32_t* st = starts + r * (nb + 1);
  const uint32_t* brow = buckets + r * nb * MSM_WORDS;
  const uint32_t* crow = carries + r * ntiles * MSM_WORDS;

  // 1. the segment walks
  Point running, acc;
  bool has_run = false, has_acc = false;
  if (s < nseg) {
    for (int i = seg - 1; i >= 0; i--) {
      const int64_t j = (int64_t)s * seg + i + 1;
      if (j < nb) {
        const int64_t lo = st[j], hi = st[j + 1];
        if (hi > lo) {
          Point b;
          mpt_load(b, brow + j * MSM_WORDS);
          for (int64_t t = lo / tile_points + 1; t <= (hi - 1) / tile_points; t++) {
            Point cpt;
            mpt_load(cpt, crow + t * MSM_WORDS);
            mpt_add_call(b, b, cpt);
          }
          mpt_accumulate(running, has_run, b);
        }
      }
      if (has_run) mpt_accumulate(acc, has_acc, running);
    }
  }
  if (has_run) mpt_save(usum + s * MSM_WORDS, running);
  if (has_acc) mpt_save(wsum + s * MSM_WORDS, acc);
  u_ok[s] = has_run;
  w_ok[s] = has_acc;
  __syncthreads();

  // 2. the suffix scan, U_s kept in `running`
  for (int d = 1; d < nseg; d <<= 1) {
    Point b;
    const bool take = s + d < nseg && u_ok[s + d];
    if (take) mpt_load(b, usum + (s + d) * MSM_WORDS);
    __syncthreads();
    if (take) {
      mpt_accumulate(running, has_run, b);
      mpt_save(usum + s * MSM_WORDS, running);
      u_ok[s] = 1;
    }
    __syncthreads();
  }
  if (s == 0) u_ok[0] = 0;                  // U_0 is not in the sum
  __syncthreads();

  // 3. the two trees
  for (int step = 1; step < nseg; step <<= 1) {
    const int pos = s & (2 * step - 1);
    uint32_t* dst = nullptr;
    const uint32_t* src = nullptr;
    int* dst_ok = nullptr;
    if (pos == 0 && s + step < nseg && w_ok[s + step]) {
      dst = wsum + s * MSM_WORDS;
      src = wsum + (s + step) * MSM_WORDS;
      dst_ok = w_ok + s;
    } else if (pos == step && s < nseg && u_ok[s]) {
      dst = usum + (s - step) * MSM_WORDS;
      src = usum + s * MSM_WORDS;
      dst_ok = u_ok + s - step;
    }
    if (dst != nullptr) {
      Point a, b;
      bool has = *dst_ok;
      mpt_load(b, src);
      if (has) mpt_load(a, dst);
      mpt_accumulate(a, has, b);
      mpt_save(dst, a);
      *dst_ok = 1;
    }
    __syncthreads();
  }
  if (s != 0) return;

  // 4. seg times the U sum, plus the W sum
  Point res, u;
  bool has_res = w_ok[0];
  if (has_res) mpt_load(res, wsum);
  if (u_ok[0]) {
    mpt_load(u, usum);
    for (int m = 1; m < seg; m <<= 1) mpt_double(u, u, c_curve);
    mpt_accumulate(res, has_res, u);
  }
  if (has_res)
    mpt_from_mont(res, c_curve);
  else
    pt_identity(res);
  pt_store(ox, oy, oz, rows, r, res);
}
#endif

extern "C" {

#if PT_BUILDS(1)
int PT_ENTRY(pt_msm_bucket_accumulate)(void* buckets, void* carries, const void* basis,
                                       const void* digits, const void* order,
                                       const void* starts, int64_t rows, int64_t n,
                                       int64_t nb, int64_t chunk, int64_t tile,
                                       const void* consts, void* stream) {
  if (tile != MSM_TILE || chunk < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int rc = curve_set_consts((const uint32_t*)consts, st);
  if (rc != 0) return rc;
  const int64_t ntiles = (n + chunk * MSM_TILE - 1) / (chunk * MSM_TILE);
  msm_bucket_accumulate_kernel<<<(unsigned int)(rows * ntiles), MSM_TILE, 0, st>>>(
      (uint32_t*)buckets, (uint32_t*)carries, (const uint32_t*)basis, (const int32_t*)digits,
      (const int32_t*)order, (const int32_t*)starts, n, nb, chunk, ntiles);
  return (int)cudaGetLastError();
}
#endif

#if PT_BUILDS(2)
// As pt_msm_bucket_accumulate, with the signs in bit 31 of `order`.
int PT_ENTRY(pt_msm_bucket_accumulate_signed)(void* buckets, void* carries,
                                              const void* basis, const void* digits,
                                              const void* order, const void* starts,
                                              int64_t rows, int64_t n, int64_t nb,
                                              int64_t chunk, int64_t tile,
                                              const void* consts, void* stream) {
  if (tile != MSM_TILE || chunk < 1 || n > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int rc = curve_set_consts((const uint32_t*)consts, st);
  if (rc != 0) return rc;
  const int64_t ntiles = (n + chunk * MSM_TILE - 1) / (chunk * MSM_TILE);
  msm_bucket_accumulate_signed_kernel<<<(unsigned int)(rows * ntiles), MSM_TILE, 0, st>>>(
      (uint32_t*)buckets, (uint32_t*)carries, (const uint32_t*)basis, (const int32_t*)digits,
      (const int32_t*)order, (const int32_t*)starts, n, nb, chunk, ntiles);
  return (int)cudaGetLastError();
}
#endif

#if PT_BUILDS(3)
int PT_ENTRY(pt_msm_bucket_reduce)(void* ox, void* oy, void* oz, const void* buckets,
                                   const void* carries, const void* starts, int64_t rows,
                                   int64_t nb, int64_t ntiles, int64_t tile_points,
                                   int64_t seg, const void* consts, void* stream) {
  const int64_t nseg = (nb - 1 + seg - 1) / seg;
  if (seg < 1 || (seg & (seg - 1)) != 0 || nseg > REDUCE_MAX_LANES || tile_points < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int rc = curve_set_consts((const uint32_t*)consts, st);
  if (rc != 0) return rc;
  int lanes = MSM_WARP;
  while (lanes < nseg) lanes <<= 1;
  const size_t smem = (size_t)lanes * (2 * MSM_WORDS * sizeof(uint32_t) + 2 * sizeof(int));
  msm_bucket_reduce_kernel<<<(unsigned int)rows, lanes, smem, st>>>(
      (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (const uint32_t*)buckets,
      (const uint32_t*)carries, (const int32_t*)starts, rows, nb, ntiles, tile_points,
      (int)seg, (int)nseg);
  return (int)cudaGetLastError();
}
#endif

}  // extern "C"

PT_NAMESPACE_END
