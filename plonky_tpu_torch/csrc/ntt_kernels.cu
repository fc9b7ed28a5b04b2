// K3: the NTT in ceil(lg n / NTT_MAX_LAYERS) launches of ntt_pass, each
// running up to NTT_MAX_LAYERS radix-2 layers in shared memory.
//
// Replaces the TPU kernel fused_composite (plonky_tpu/fields/
// pallas_kernels.py) as instantiated by fields/ops.py:fused_elementwise
// from plonky_tpu/poly/fft.py:_fft_core, whose body `butterfly` computes
// (e + o w, e - o w) for every pair of one layer, after a bit-reversal
// gather, with the coset scaling and the 1/n of the inverse as separate
// multiplies.
//
// The transform is the one of poly/fft.py: the input in bit-reversed order,
// then layers ell = 0 .. lg n - 1 of half-size m = 2^ell, where the pair
// (pos, pos + m) with j = pos mod m takes the twiddle w_m^j.  A pass runs
// layers l0 .. l0 + kp - 1; they mix only positions that differ in bits
// l0 .. l0 + kp - 1, so the pass splits each row into n / 2^kp groups of
// S = 2^kp elements, pos = base + (s << l0), and a block holds G groups in
// shared memory for all kp layers (poly/fft.py:pass_plan, _pass_groups).
//  - The first pass (l0 = 0) loads its groups through the bit reversal:
//    group r of a row is the tile of S positions at rev(r) S, whose sources
//    are rev(s) Q + r (Q = n / S): the G groups of a block read G
//    neighbouring columns, coalesced.  A coset transform multiplies each
//    input by its table entry shift^i there.
//  - The last pass multiplies each output by its scale (n^-1, or
//    n^-1 shift^-i for the inverse coset transform) before the store.
//  - Twiddles and both tables are held as v 2^256 mod p, so each product is
//    one Montgomery product (cc_mont_mul) with a canonical result.
//
// What bounds it: a transform of B rows moves 2 x 32 B n bytes once and
// makes B (n / 2) (lg n - 1) Montgomery products (264 IMAD slots each;
// layer 0's twiddles are all 1 and are skipped): at the prove's sizes the
// operations bound is five to seven times the bytes bound.  The design reads
// and writes the data once a pass, in ceil(lg n / NTT_MAX_LAYERS) passes,
// and runs the products from registers on carry chains.  The products are
// chains of dependent instructions, so what matters is how many warps an SM
// holds and how evenly the blocks fill the SMs: a block holds up to
// NTT_BLOCK_ELEMS elements (256 threads, one butterfly each a layer, at
// most 20 KB of static shared memory), the best of a sweep of block sizes
// and layers a pass on the H100 (PERF.md).
//
// Built twice (_cuda.py): at 8 limbs, and at 12 (-DPT_LIMBS=12, BLS12-377's
// base field; entries pt_ntt_pass_l12 and pt_ntt_twiddle_transpose_l12),
// with twiddles and tables held as v 2^384 mod p.  The transpose is the
// same code at both widths; its tile (50.7 KB at 12 limbs, over the 48 KB
// static limit) is dynamic shared memory there.  The 12-limb ntt_pass is a
// design of its own (below the 8-limb one): a twiddle product is 144 + 156
// limb products there (>= 588 IMAD slots against 264) while a pass moves
// 1.5 times the bytes, so the operations bound leads by more.
#include "field.cuh"

PT_NAMESPACE_BEGIN

__device__ __forceinline__ uint32_t bit_reverse(uint32_t v, int bits) {
  return bits == 0 ? 0u : __brev(v) >> (32 - bits);
}

#if PT_LIMBS == 8
// The same values as poly/fft.py's NTT_MAX_LAYERS and NTT_BLOCK_ELEMS
// (tests/test_torch_fft.py holds them equal).
#define NTT_MAX_LAYERS 7
#define NTT_BLOCK_ELEMS 512
#define NTT_THREADS (NTT_BLOCK_ELEMS / 2)
// A block's groups with their padding: S (G + 1) <= NTT_BLOCK_ELEMS + S.
#define NTT_SMEM_ELEMS (NTT_BLOCK_ELEMS + (1 << NTT_MAX_LAYERS))

// x, y: [L, batch, n] (limb stride batch n; y may be x after the first
// pass).  tw: [L, n - 1] Montgomery twiddles, layer of half-size m at column
// m - 1.  pre: [L, n] Montgomery coset table or null (first pass only).
// post: [L, n] or, with post_bcast, [L, 1] Montgomery scale, or null (last
// pass only).  A block holds G = 2^lg_groups groups; groups gi >= batch Q
// of the last block are skipped.
__global__ void __launch_bounds__(NTT_THREADS)
ntt_pass_kernel(int32_t* y, const int32_t* x, const int32_t* tw, const int32_t* pre,
                const int32_t* post, int post_bcast, int64_t batch, int lg, int l0,
                int kp, int lg_groups, FieldConsts c) {
  __shared__ uint32_t sm[NTT_SMEM_ELEMS * PT_LIMBS];
  const int S = 1 << kp;
  const int G = 1 << lg_groups;
  const int pitch = G + 1;                  // odd: a warp reading s-major
  const int64_t words = (int64_t)S * pitch;  // or g-major hits 32 banks
  const int64_t n = (int64_t)1 << lg;
  const int lg_q = lg - kp;
  const int64_t Q = (int64_t)1 << lg_q;
  const int64_t total = batch * Q;
  const int64_t gbase = (int64_t)blockIdx.x * G;
  const int64_t stride = batch * n;
  const int64_t low_mask = ((int64_t)1 << l0) - 1;
  const bool first = l0 == 0;
  const int elems = G * S;

  // load (element e: s = e / G, g = e % G, so neighbouring threads read
  // neighbouring groups' s-th elements)
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const int s = e >> lg_groups, g = e & (G - 1);
    const int64_t gi = gbase + g;
    if (gi >= total) continue;
    const int64_t b = gi >> lg_q, r = gi & (Q - 1);
    const int64_t src = first ? (int64_t)bit_reverse(s, kp) * Q + r
                              : (r & low_mask) | ((r >> l0) << (l0 + kp)) | ((int64_t)s << l0);
    uint32_t v[PT_LIMBS];
    fe_load(v, x, stride, b * n + src);
    if (first && pre != nullptr) {
      uint32_t t[PT_LIMBS], sc[PT_LIMBS];
      fe_load(sc, pre, n, src);
      cc_mont_mul(t, v, sc, c);
      fe_copy(v, t);
    }
#pragma unroll
    for (int k = 0; k < PT_LIMBS; k++) sm[k * words + s * pitch + g] = v[k];
  }
  __syncthreads();

  for (int d = 0; d < kp; d++) {
    const int h = 1 << d;
    const int64_t m = (int64_t)1 << (l0 + d);
    for (int bi = threadIdx.x; bi < elems / 2; bi += blockDim.x) {
      const int q = bi >> lg_groups, g = bi & (G - 1);
      const int64_t gi = gbase + g;
      if (gi >= total) continue;
      const int se = ((q >> d) << (d + 1)) | (q & (h - 1));
      const int so = se + h;
      const int64_t j = (gi & (Q - 1) & low_mask) + ((int64_t)(se & (h - 1)) << l0);
      uint32_t ev[PT_LIMBS], ov[PT_LIMBS], w[PT_LIMBS], ow[PT_LIMBS];
#pragma unroll
      for (int k = 0; k < PT_LIMBS; k++) {
        ev[k] = sm[k * words + se * pitch + g];
        ov[k] = sm[k * words + so * pitch + g];
      }
      if (m == 1) {
        fe_copy(ow, ov);   // layer 0: every twiddle is 1
      } else {
        fe_load(w, tw, n - 1, m - 1 + j);
        cc_mont_mul(ow, ov, w, c);
      }
      cc_add_mod(ov, ev, ow, c);
      cc_sub_mod(ev, ev, ow, c);
#pragma unroll
      for (int k = 0; k < PT_LIMBS; k++) {
        sm[k * words + se * pitch + g] = ov[k];
        sm[k * words + so * pitch + g] = ev[k];
      }
    }
    __syncthreads();
  }

  // store (the first pass writes each group's S positions contiguously, so
  // there s runs fastest; later passes write like they read)
  const bool last = post != nullptr;
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    int s, g;
    if (first) {
      g = e >> kp;
      s = e & (S - 1);
    } else {
      s = e >> lg_groups;
      g = e & (G - 1);
    }
    const int64_t gi = gbase + g;
    if (gi >= total) continue;
    const int64_t b = gi >> lg_q, r = gi & (Q - 1);
    const int64_t dst = first ? ((int64_t)bit_reverse(r, lg_q) << kp) + s
                              : (r & low_mask) | ((r >> l0) << (l0 + kp)) | ((int64_t)s << l0);
    uint32_t v[PT_LIMBS];
#pragma unroll
    for (int k = 0; k < PT_LIMBS; k++) v[k] = sm[k * words + s * pitch + g];
    if (last) {
      uint32_t t[PT_LIMBS], sc[PT_LIMBS];
      if (post_bcast) fe_load(sc, post, 1, 0);
      else fe_load(sc, post, n, dst);
      cc_mont_mul(t, v, sc, c);
      fe_copy(v, t);
    }
    fe_store(y, stride, b * n + dst, v);
  }
}

#else  // PT_LIMBS == 12
// ---------------------------------------------------------------------------
// ntt_pass at 12 limbs (BLS12-377's base field Fq, p < 2^377 against
// R = 2^384): the same passes, groups, positions and twiddle indices as
// the 8-limb kernel above (poly/fft.py:ntt_plain walks them), with three
// changes.  It is bound by its products (B (n / 2) (lg n - 1) of them, 588
// IMAD slots each; the data and twiddle bytes of a 2^22 transform take a
// third of that time at 3.35 TB/s), so the changes cut the instructions
// around each product and keep enough warps an SM.
//
// 1. The products (twiddle, coset and scale) are the pair-layout product
//    and dense REDC of field.cuh (ntt_mont_mul: cc_product, then cc_redc
//    with its row-0 wait), one IMAD.WIDE.U32.X a limb product, where the
//    8-limb kernel's CIOS rows (cc_mont_mul on cc_mac_row) take an IMAD,
//    an IMAD.HI and two IADD3.X.  Without the wait ptxas overlaps the
//    REDC with the product and the transforms run ~30% slower
//    (ntt_sweep.py's builds with wait 0).  With no conditional
//    subtraction: for a < R and w < p, REDC gives a w / R mod p below
//    a w / R + p < 2p.
// 2. Lazy butterflies.  Inside a transform no value is reduced: layer ell
//    maps (e, o) to (e + t, e + 2p - t), t = o w / R mod p below 2p (on
//    layer 0, whose twiddles are 1, t = o, below 2p as every input is),
//    so no add, subtract or product takes a conditional correction.  The
//    inputs are below 2p (canonical, or a coset product), and each layer
//    adds 2p to the bound: after layer ell every value is below
//    2p (ell + 2), after a transform of lg layers below 2p (lg + 1).  The
//    caller (poly/fft.py:ntt, by lazy_ntt_fits) refuses a field or size
//    where 2 (lg + 1) (p_11 + 1) > 2^32 (p_11 = p's top limb; then every
//    value fits 384 bits) or p_11 < 2^17 (Fq allows lg <= 75).  Values
//    between passes are stored as they are: only the next pass reads them.
//    The last pass's store makes each value canonical: the scale product
//    (below 2p, as above) and one conditional subtraction where the
//    transform scales, else ntt_canonical: q = floor(v_11 / (p_11 + 1)),
//    at most floor(v / p), and v - q p below 2p (v / p - q < 1 +
//    (v_11 + p_11 + 1) / (p_11 (p_11 + 1)) < 2), then one conditional
//    subtraction.  tests/test_torch_ntt_l12.py models the butterfly, the
//    products and the last store limb by limb at the bound.
// 3. The block shape is its own: up to NTT_L12_MAX_LAYERS layers a pass
//    on up to NTT_L12_BLOCK_ELEMS elements a block in dynamic shared
//    memory (S (G + 1) elements of 48 B, allowed by the C entry above
//    48 KB), up to NTT_L12_THREADS threads a block (each takes every
//    blockDim-th butterfly of a layer), and __launch_bounds__' blocks an
//    SM NTT_L12_MIN_BLOCKS, which caps the registers.  ntt_sweep.py swept
//    them on the H100 (PERF.md): 128 threads (108 registers, no spill;
//    four blocks an SM), 7 layers and 1,024 elements (S (G + 1) 48 B =
//    55 KB at 7 layers) came within 1.3% of the best summed time, with
//    the 8-limb kernel's plan (4 passes at 2^22, where the best's 5 layers
//    make 5).  The sweep rewrites these four lines in a copy of this
//    source; poly/fft.py holds the first two (tests/test_torch_fft.py
//    holds them equal).
// ---------------------------------------------------------------------------
#define NTT_L12_MAX_LAYERS 7
#define NTT_L12_BLOCK_ELEMS 1024
#define NTT_L12_THREADS 128
#define NTT_L12_MIN_BLOCKS 2

struct NttConsts {
  FieldConsts f;
  uint32_t p2[PT_LIMBS];   // 2p
  uint32_t top1;           // p's top limb + 1: ntt_canonical's divisor
};

// r = a w / R mod p below a w / R + p (1. above).
__device__ __forceinline__ void ntt_mont_mul(uint32_t r[PT_LIMBS], const uint32_t a[PT_LIMBS],
                                             const uint32_t w[PT_LIMBS], const FieldConsts& c) {
  uint32_t e[PT_PRODUCT_LIMBS], o[PT_PRODUCT_LIMBS];
  cc_product(e, o, a, w);
  cc_redc<false>(r, e, o, c);
}

// r = a + b over 32 L bits (the caller's bound keeps it below 2^(32 L)).
__device__ __forceinline__ void cc_add_wide(uint32_t r[PT_LIMBS], const uint32_t a[PT_LIMBS],
                                            const uint32_t b[PT_LIMBS]) {
  r[0] = cc_add(a[0], b[0]);
#pragma unroll
  for (int k = 1; k < PT_LIMBS - 1; k++) r[k] = cc_addc(a[k], b[k]);
  r[PT_LIMBS - 1] = cc_addc_end(a[PT_LIMBS - 1], b[PT_LIMBS - 1]);
}

// r = a - b for a >= b.
__device__ __forceinline__ void cc_sub_wide(uint32_t r[PT_LIMBS], const uint32_t a[PT_LIMBS],
                                            const uint32_t b[PT_LIMBS]) {
  r[0] = cc_sub(a[0], b[0]);
#pragma unroll
  for (int k = 1; k < PT_LIMBS - 1; k++) r[k] = cc_subc(a[k], b[k]);
  r[PT_LIMBS - 1] = cc_subc_end(a[PT_LIMBS - 1], b[PT_LIMBS - 1]);
}

// The lazy butterfly (2. above): hi = e + t, lo = e + (2p - t), t < 2p.
__device__ __forceinline__ void ntt_butterfly(uint32_t hi[PT_LIMBS], uint32_t lo[PT_LIMBS],
                                              const uint32_t e[PT_LIMBS],
                                              const uint32_t t[PT_LIMBS], const NttConsts& c) {
  uint32_t d[PT_LIMBS];
  cc_add_wide(hi, e, t);
  cc_sub_wide(d, c.p2, t);
  cc_add_wide(lo, e, d);
}

// v mod p for v below 2p (lg + 1), the last pass's value (2. above).
__device__ __forceinline__ void ntt_canonical(uint32_t v[PT_LIMBS], const NttConsts& c) {
  const uint32_t q = v[PT_LIMBS - 1] / c.top1;
  uint32_t qp[PT_LIMBS];   // q p <= v < 2^(32 L)
#pragma unroll
  for (int k = 0; k < PT_LIMBS; k++) qp[k] = 0;
  cc_mac_row_lo<PT_LIMBS>(qp, q, c.f.p);
  cc_sub_wide(v, v, qp);
  cc_csub(v, c.f);
}

// The arguments of the 8-limb kernel (above); the shared memory is dynamic,
// S (G + 1) elements.
__global__ void __launch_bounds__(NTT_L12_THREADS, NTT_L12_MIN_BLOCKS)
ntt_pass_kernel(int32_t* y, const int32_t* x, const int32_t* tw, const int32_t* pre,
                const int32_t* post, int post_bcast, int64_t batch, int lg, int l0,
                int kp, int lg_groups, NttConsts c) {
  extern __shared__ uint32_t sm[];
  const int S = 1 << kp;
  const int G = 1 << lg_groups;
  const int pitch = G + 1;
  const int64_t words = (int64_t)S * pitch;
  const int64_t n = (int64_t)1 << lg;
  const int lg_q = lg - kp;
  const int64_t Q = (int64_t)1 << lg_q;
  const int64_t total = batch * Q;
  const int64_t gbase = (int64_t)blockIdx.x * G;
  const int64_t stride = batch * n;
  const int64_t low_mask = ((int64_t)1 << l0) - 1;
  const bool first = l0 == 0;
  const bool last = l0 + kp == lg;
  const int elems = G * S;

  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const int s = e >> lg_groups, g = e & (G - 1);
    const int64_t gi = gbase + g;
    if (gi >= total) continue;
    const int64_t b = gi >> lg_q, r = gi & (Q - 1);
    const int64_t src = first ? (int64_t)bit_reverse(s, kp) * Q + r
                              : (r & low_mask) | ((r >> l0) << (l0 + kp)) | ((int64_t)s << l0);
    uint32_t v[PT_LIMBS];
    fe_load(v, x, stride, b * n + src);
    if (first && pre != nullptr) {
      uint32_t t[PT_LIMBS], sc[PT_LIMBS];
      fe_load(sc, pre, n, src);
      ntt_mont_mul(t, v, sc, c.f);
      fe_copy(v, t);
    }
#pragma unroll
    for (int k = 0; k < PT_LIMBS; k++) sm[k * words + s * pitch + g] = v[k];
  }
  __syncthreads();

  for (int d = 0; d < kp; d++) {
    const int h = 1 << d;
    const int64_t m = (int64_t)1 << (l0 + d);
    for (int bi = threadIdx.x; bi < elems / 2; bi += blockDim.x) {
      const int q = bi >> lg_groups, g = bi & (G - 1);
      const int64_t gi = gbase + g;
      if (gi >= total) continue;
      const int se = ((q >> d) << (d + 1)) | (q & (h - 1));
      const int so = se + h;
      const int64_t j = (gi & (Q - 1) & low_mask) + ((int64_t)(se & (h - 1)) << l0);
      uint32_t ev[PT_LIMBS], ov[PT_LIMBS], t[PT_LIMBS], hi[PT_LIMBS], lo[PT_LIMBS];
#pragma unroll
      for (int k = 0; k < PT_LIMBS; k++) {
        ev[k] = sm[k * words + se * pitch + g];
        ov[k] = sm[k * words + so * pitch + g];
      }
      if (m == 1) {
        fe_copy(t, ov);   // layer 0: every twiddle is 1
      } else {
        uint32_t w[PT_LIMBS];
        fe_load(w, tw, n - 1, m - 1 + j);
        ntt_mont_mul(t, ov, w, c.f);
      }
      ntt_butterfly(hi, lo, ev, t, c);
#pragma unroll
      for (int k = 0; k < PT_LIMBS; k++) {
        sm[k * words + se * pitch + g] = hi[k];
        sm[k * words + so * pitch + g] = lo[k];
      }
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    int s, g;
    if (first) {
      g = e >> kp;
      s = e & (S - 1);
    } else {
      s = e >> lg_groups;
      g = e & (G - 1);
    }
    const int64_t gi = gbase + g;
    if (gi >= total) continue;
    const int64_t b = gi >> lg_q, r = gi & (Q - 1);
    const int64_t dst = first ? ((int64_t)bit_reverse(r, lg_q) << kp) + s
                              : (r & low_mask) | ((r >> l0) << (l0 + kp)) | ((int64_t)s << l0);
    uint32_t v[PT_LIMBS];
#pragma unroll
    for (int k = 0; k < PT_LIMBS; k++) v[k] = sm[k * words + s * pitch + g];
    if (last) {
      if (post != nullptr) {
        uint32_t t[PT_LIMBS], sc[PT_LIMBS];
        if (post_bcast) fe_load(sc, post, 1, 0);
        else fe_load(sc, post, n, dst);
        ntt_mont_mul(t, v, sc, c.f);
        cc_csub(t, c.f);
        fe_copy(v, t);
      } else {
        ntt_canonical(v, c);
      }
    }
    fe_store(y, stride, b * n + dst, v);
  }
}
#endif  // PT_LIMBS

// ntt_twiddle_transpose: the four-step FFT's middle and outer steps
// (poly/fft.py:fft_four_step), y[b, j, i] = x[b, i, j] (times tw[i, j]
// when tw is given), x [L, B, r, s] -> y [L, B, s, r].
//
// Replaces, in plonky_tpu/poly/fft.py:fft_four_step (:237-262), the
// twiddle product fops.mul(spec, inner, tw) (the TPU kernel
// fused_composite of plonky_tpu/fields/pallas_kernels.py as a modular
// multiply) and the swapaxes around it, which XLA ran as transposes.
//
// What bounds it: an element is read once (32 B), its twiddle read once
// (32 B) and written once (32 B): 96 B against one Montgomery product
// (264 IMAD slots), so at 3.35 TB/s and 1.67e13 IMAD/s the bytes bound is
// about twice the operations bound.  A transpose read or written along
// the wrong axis moves a 32-byte sector for every 4-byte word, so a block
// takes one TT_TILE x TT_TILE tile of one row of the batch through shared
// memory: its threads read the tile's rows along s (neighbouring threads,
// neighbouring words, one limb plane at a time), multiply each element by
// its twiddle in registers (cc_mont_mul, with tw held as w 2^256 mod p,
// as ntt_pass holds its twiddles), and write the tile's columns along r.
// The tile's eight limb planes are padded to TT_TILE + 1 words a row, so
// neither the row-wise writes nor the column-wise reads share a bank
// (33.8 KB of static shared memory at 8 limbs; at 12 the tile's 50.7 KB
// is dynamic shared memory, which the C entry allows the kernel first).
// Tiles at the edges are guarded, so r and s need not be multiples of
// TT_TILE and B may be any count.
#define TT_TILE 32
#define TT_ROWS 8     // threads down a tile: each moves TT_TILE / TT_ROWS elements
#define TT_TILE_BYTES (PT_LIMBS * TT_TILE * (TT_TILE + 1) * 4)

// x: [L, batch, r, s] (limb stride batch r s); y: [L, batch, s, r]; tw:
// [L, r, s] Montgomery twiddles or null.  Block t covers row b = t /
// (tiles_r tiles_s) of the batch and the tile at (r0, s0).
__global__ void __launch_bounds__(TT_TILE * TT_ROWS)
ntt_twiddle_transpose_kernel(int32_t* y, const int32_t* x, const int32_t* tw, int64_t batch,
                             int64_t r, int64_t s, int64_t tiles_s, int64_t per_row,
                             FieldConsts c) {
#if PT_LIMBS == 8
  __shared__ uint32_t tile[PT_LIMBS][TT_TILE][TT_TILE + 1];
#else
  extern __shared__ uint32_t tt_dynamic[];     // TT_TILE_BYTES
  uint32_t(*tile)[TT_TILE][TT_TILE + 1] =
      reinterpret_cast<uint32_t(*)[TT_TILE][TT_TILE + 1]>(tt_dynamic);
#endif
  const int64_t b = blockIdx.x / per_row;
  const int64_t t = blockIdx.x - b * per_row;
  const int64_t r0 = t / tiles_s * TT_TILE, s0 = t % tiles_s * TT_TILE;
  const int64_t stride = batch * r * s;
  const int64_t row = b * r * s;
  const int tx = threadIdx.x;
  for (int j = threadIdx.y; j < TT_TILE; j += TT_ROWS) {
    const int64_t i = r0 + j, k = s0 + tx;
    if (i < r && k < s) {
      uint32_t v[PT_LIMBS];
      fe_load(v, x, stride, row + i * s + k);
      if (tw != nullptr) {
        uint32_t w[PT_LIMBS], prod[PT_LIMBS];
        fe_load(w, tw, r * s, i * s + k);
        cc_mont_mul(prod, v, w, c);
        fe_copy(v, prod);
      }
#pragma unroll
      for (int l = 0; l < PT_LIMBS; l++) tile[l][j][tx] = v[l];
    }
  }
  __syncthreads();
  for (int j = threadIdx.y; j < TT_TILE; j += TT_ROWS) {
    const int64_t k = s0 + j, i = r0 + tx;
    if (i < r && k < s) {
#pragma unroll
      for (int l = 0; l < PT_LIMBS; l++) y[l * stride + row + k * r + i] = (int32_t)tile[l][tx][j];
    }
  }
}

extern "C" {

// y = x transposed over its last two axes [r, s], times tw when it is not
// null; consts: FieldSpec.kernel_consts.
int PT_ENTRY(pt_ntt_twiddle_transpose)(void* y, const void* x, const void* tw, int64_t batch,
                                       int64_t r, int64_t s, const void* consts,
                                       void* stream) {
  if (batch < 1 || r < 1 || s < 1) return (int)cudaErrorInvalidValue;
  const int64_t tiles_r = (r + TT_TILE - 1) / TT_TILE;
  const int64_t tiles_s = (s + TT_TILE - 1) / TT_TILE;
  const int64_t blocks = batch * tiles_r * tiles_s;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  FieldConsts c = field_consts_from((const uint32_t*)consts);
#if PT_LIMBS == 8
  const size_t smem = 0;
#else
  const size_t smem = TT_TILE_BYTES;
  const cudaError_t err = cudaFuncSetAttribute(
      ntt_twiddle_transpose_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
#endif
  ntt_twiddle_transpose_kernel<<<(unsigned int)blocks, dim3(TT_TILE, TT_ROWS), smem,
                                 (cudaStream_t)stream>>>(
      (int32_t*)y, (const int32_t*)x, (const int32_t*)tw, batch, r, s, tiles_s,
      tiles_r * tiles_s, c);
  return (int)cudaGetLastError();
}

#if PT_LIMBS == 8
// One pass of 2^lg_groups groups per block; consts: FieldSpec.kernel_consts.
int PT_ENTRY(pt_ntt_pass)(void* y, const void* x, const void* tw, const void* pre,
                          const void* post, int post_bcast, int64_t batch, int lg, int l0,
                          int kp, int lg_groups, const void* consts, void* stream) {
  if (kp < 1 || kp > NTT_MAX_LAYERS || l0 < 0 || l0 + kp > lg || lg_groups < 0 ||
      (1 << (kp + lg_groups)) > NTT_BLOCK_ELEMS)
    return (int)cudaErrorInvalidValue;
  const int64_t total = batch * (((int64_t)1 << lg) >> kp);
  const int64_t groups = (int64_t)1 << lg_groups;
  const int64_t blocks = (total + groups - 1) / groups;
  const int elems = 1 << (kp + lg_groups);
  const int threads = ((elems / 2 + 31) / 32) * 32;
  FieldConsts c = field_consts_from((const uint32_t*)consts);
  ntt_pass_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
      (int32_t*)y, (const int32_t*)x, (const int32_t*)tw, (const int32_t*)pre,
      (const int32_t*)post, post_bcast, batch, lg, l0, kp, lg_groups, c);
  return (int)cudaGetLastError();
}
#else
// One pass of 2^lg_groups groups per block (the 12-limb design above);
// consts: FieldSpec.kernel_consts.
int PT_ENTRY(pt_ntt_pass)(void* y, const void* x, const void* tw, const void* pre,
                          const void* post, int post_bcast, int64_t batch, int lg, int l0,
                          int kp, int lg_groups, const void* consts, void* stream) {
  if (kp < 1 || kp > NTT_L12_MAX_LAYERS || l0 < 0 || l0 + kp > lg || lg_groups < 0 ||
      (1 << (kp + lg_groups)) > NTT_L12_BLOCK_ELEMS)
    return (int)cudaErrorInvalidValue;
  NttConsts c;
  c.f = field_consts_from((const uint32_t*)consts);
  uint32_t carry = 0;
  for (int k = 0; k < PT_LIMBS; k++) {
    c.p2[k] = (c.f.p[k] << 1) | carry;
    carry = c.f.p[k] >> 31;
  }
  const uint32_t top = c.f.p[PT_LIMBS - 1];
  c.top1 = top + 1;
  const int64_t total = batch * (((int64_t)1 << lg) >> kp);
  const int64_t groups = (int64_t)1 << lg_groups;
  const int64_t blocks = (total + groups - 1) / groups;
  const int elems = 1 << (kp + lg_groups);
  int threads = ((elems / 2 + 31) / 32) * 32;
  if (threads > NTT_L12_THREADS) threads = NTT_L12_THREADS;
  const size_t smem = (size_t)PT_LIMBS * 4 * ((size_t)1 << kp) * (groups + 1);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ntt_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  ntt_pass_kernel<<<(unsigned int)blocks, threads, smem, (cudaStream_t)stream>>>(
      (int32_t*)y, (const int32_t*)x, (const int32_t*)tw, (const int32_t*)pre,
      (const int32_t*)post, post_bcast, batch, lg, l0, kp, lg_groups, c);
  return (int)cudaGetLastError();
}
#endif

}  // extern "C"

PT_NAMESPACE_END
