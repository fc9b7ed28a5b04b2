// K4: the Pippenger bucket pipeline, in two kernels.
//
// Replaces the TPU kernel fused_composite (plonky_tpu/fields/
// pallas_kernels.py) at tile 512 under force_fusion(512), instantiated as
// the segmented-scan combine _seg_combine of plonky_tpu/curves/msm.py
// (:95-102) inside _chunked_scan_parts, _seg_scan_pair and
// _seg_scan_gather: a point add plus a select on the segment-start flag,
// scanned over points sorted by window digit.  The TPU needed that
// static-shaped scan because its grid runs in order; Hopper runs threads
// independently, so the scan becomes one thread per bucket walking its own
// run of the sorted points.  The digits and the argsort per window row stay
// in torch; the combination across windows (Horner) is K2.
//
// What bounds it: every point of a window row costs one complete add
// (~3,900 32-bit multiply-adds) against 96 bytes of point and a 4-byte
// index, so accumulation is bound by the integer pipe; the
// reduction is 2 adds per bucket and likewise.  The reduction runs one
// thread per window row (a sequential running sum over 2^c buckets), so it
// keeps only a few hundred threads busy: it is bound by latency, not by
// either roofline, which a later tree reduction removes.
#include "curve.cuh"

// The kernels below call the complete add through this out-of-line copy:
// inlining 14 unrolled field multiplies at every call site in a loop
// crashed the compiler.  A call costs a few local-memory moves of the
// points, against ~3,900 multiply-adds of work.
__device__ __noinline__ void pt_add_call(Point& r, const Point& p, const Point& q,
                                         const CurveConsts& cc) {
  pt_add(r, p, q, cc);
}

// One thread per (row r, bucket j): the sum of the points order[r, s] for
// s in [starts[r, j], starts[r, j + 1]).  Bucket 0 (digit 0) is the
// identity.  px/py/pz: [8, N]; order: [R, N] int32; starts: [R, B + 1]
// int32; out: [8, R, B].
__global__ void msm_bucket_accumulate_kernel(int32_t* ox, int32_t* oy, int32_t* oz,
                                             const int32_t* px, const int32_t* py,
                                             const int32_t* pz, const int32_t* order,
                                             const int32_t* starts, int64_t rows,
                                             int64_t buckets, int64_t n, CurveConsts cc) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= rows * buckets) return;
  int64_t r = t / buckets;
  int64_t j = t - r * buckets;
  Point acc;
  pt_identity(acc);
  if (j > 0) {
    int64_t lo = starts[r * (buckets + 1) + j];
    int64_t hi = starts[r * (buckets + 1) + j + 1];
    for (int64_t s = lo; s < hi; s++) {
      int64_t idx = order[r * n + s];
      Point q;
      pt_load(q, px, py, pz, n, idx);
      pt_add_call(acc, acc, q, cc);
    }
  }
  pt_store(ox, oy, oz, rows * buckets, t, acc);
}

// One thread per row: sum_j j B_j = sum_{k >= 1} T_k with T_k = sum_{j >= k}
// B_j, by one running sum from the top bucket down.  b: [8, R, B]; out:
// [8, R].
__global__ void msm_bucket_reduce_kernel(int32_t* ox, int32_t* oy, int32_t* oz,
                                         const int32_t* bx, const int32_t* by,
                                         const int32_t* bz, int64_t rows, int64_t buckets,
                                         CurveConsts cc) {
  int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  Point running, acc;
  pt_identity(running);
  pt_identity(acc);
  for (int64_t j = buckets - 1; j >= 1; j--) {
    Point q;
    pt_load(q, bx, by, bz, rows * buckets, r * buckets + j);
    pt_add_call(running, running, q, cc);
    pt_add_call(acc, acc, running, cc);
  }
  pt_store(ox, oy, oz, rows, r, acc);
}

extern "C" {

int pt_msm_bucket_accumulate(void* ox, void* oy, void* oz, const void* px, const void* py,
                             const void* pz, const void* order, const void* starts,
                             int64_t rows, int64_t buckets, int64_t n, const void* consts,
                             void* stream) {
  CurveConsts cc = curve_consts_from((const uint32_t*)consts);
  msm_bucket_accumulate_kernel<<<pt_blocks(rows * buckets), PT_THREADS, 0,
                                 (cudaStream_t)stream>>>(
      (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (const int32_t*)px, (const int32_t*)py,
      (const int32_t*)pz, (const int32_t*)order, (const int32_t*)starts, rows, buckets, n, cc);
  return (int)cudaGetLastError();
}

int pt_msm_bucket_reduce(void* ox, void* oy, void* oz, const void* bx, const void* by,
                         const void* bz, int64_t rows, int64_t buckets, const void* consts,
                         void* stream) {
  CurveConsts cc = curve_consts_from((const uint32_t*)consts);
  msm_bucket_reduce_kernel<<<pt_blocks(rows), PT_THREADS, 0, (cudaStream_t)stream>>>(
      (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (const int32_t*)bx, (const int32_t*)by,
      (const int32_t*)bz, rows, buckets, cc);
  return (int)cudaGetLastError();
}

}  // extern "C"
