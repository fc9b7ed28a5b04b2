// K2: complete projective point add and double, one thread per point.
//
// Replaces the TPU kernel fused_composite (plonky_tpu/fields/
// pallas_kernels.py) as instantiated by plonky_tpu/curves/ops.py:
// _fused_point_jit / _fused_point_op over the bodies _add_body (RCB15
// Algorithm 7) and _double_body (Algorithm 9).  On the TPU the whole formula
// ran in VMEM as nine fused product-sums over 8-bit digits; here each
// thread keeps the three coordinates and every intermediate in registers.
//
// What bounds it: an add is 14 field multiplies (~3,900 32-bit
// multiply-adds) against 9 x 32 bytes read and 3 x 32 written, a double 9
// multiplies (~2,500): both are bound by the integer pipe, by an order of
// magnitude.  The design spends nothing on memory beyond one coalesced
// read and write per coordinate.
#include "curve.cuh"

__global__ void curve_add_kernel(int32_t* ox, int32_t* oy, int32_t* oz,
                                 const int32_t* ax, const int32_t* ay, const int32_t* az,
                                 const int32_t* bx, const int32_t* by, const int32_t* bz,
                                 int64_t n, CurveConsts cc) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Point p, q;
  pt_load(p, ax, ay, az, n, i);
  pt_load(q, bx, by, bz, n, i);
  pt_add(p, p, q, cc);
  pt_store(ox, oy, oz, n, i, p);
}

__global__ void curve_double_kernel(int32_t* ox, int32_t* oy, int32_t* oz,
                                    const int32_t* ax, const int32_t* ay, const int32_t* az,
                                    int64_t n, CurveConsts cc) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Point p;
  pt_load(p, ax, ay, az, n, i);
  pt_double(p, p, cc);
  pt_store(ox, oy, oz, n, i, p);
}

extern "C" {

int pt_curve_add(void* ox, void* oy, void* oz, const void* ax, const void* ay,
                 const void* az, const void* bx, const void* by, const void* bz,
                 int64_t n, const void* consts, void* stream) {
  CurveConsts cc = curve_consts_from((const uint32_t*)consts);
  curve_add_kernel<<<pt_blocks(n), PT_THREADS, 0, (cudaStream_t)stream>>>(
      (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (const int32_t*)ax, (const int32_t*)ay,
      (const int32_t*)az, (const int32_t*)bx, (const int32_t*)by, (const int32_t*)bz, n, cc);
  return (int)cudaGetLastError();
}

int pt_curve_double(void* ox, void* oy, void* oz, const void* ax, const void* ay,
                    const void* az, int64_t n, const void* consts, void* stream) {
  CurveConsts cc = curve_consts_from((const uint32_t*)consts);
  curve_double_kernel<<<pt_blocks(n), PT_THREADS, 0, (cudaStream_t)stream>>>(
      (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (const int32_t*)ax, (const int32_t*)ay,
      (const int32_t*)az, n, cc);
  return (int)cudaGetLastError();
}

}  // extern "C"
