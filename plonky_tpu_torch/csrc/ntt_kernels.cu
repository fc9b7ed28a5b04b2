// K3: one radix-2 NTT layer, one thread per butterfly.
//
// Replaces the TPU kernel fused_composite (plonky_tpu/fields/
// pallas_kernels.py) as instantiated by fields/ops.py:fused_elementwise
// from plonky_tpu/poly/fft.py:_fft_core, whose body `butterfly` computes
// (e + o w, e - o w) for every pair of one layer.  The bit-reversal gather
// stays a torch index; the coset scaling and the 1/n of the inverse are K1
// multiplies.
//
// What bounds it: a butterfly reads 2 elements and one twiddle and writes 2
// (160 bytes) for one field multiply (281 32-bit multiply-adds) and an add
// and a sub: 1.8 multiply-adds per byte, under the card's ~5, so it is
// bound by bytes.  The design: consecutive threads take
// consecutive j inside a group of m butterflies, so even elements, odd
// elements and twiddles are all read coalesced for m >= 32; the layer
// loop stays on the host (lg n launches), with all twiddle layers in one
// [8, n - 1] table uploaded once per size.
#include "field.cuh"

// x, y: [8, B, n] (limb stride B n).  tw: [8, n - 1] table whose layer of
// half-size m starts at column m - 1.
__global__ void ntt_stage_kernel(int32_t* y, const int32_t* x, const int32_t* tw,
                                 int64_t tw_stride, int64_t batch, int64_t n, int64_t m,
                                 FieldConsts c) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t half = n >> 1;
  if (t >= batch * half) return;
  int64_t b = t / half;
  int64_t r = t - b * half;
  int64_t g = r / m;
  int64_t j = r - g * m;
  int64_t ie = b * n + g * 2 * m + j;
  int64_t io = ie + m;
  int64_t stride = batch * n;
  uint32_t e[PT_LIMBS], o[PT_LIMBS], w[PT_LIMBS], ow[PT_LIMBS], r0[PT_LIMBS], r1[PT_LIMBS];
  fe_load(e, x, stride, ie);
  fe_load(o, x, stride, io);
  fe_load(w, tw, tw_stride, m - 1 + j);
  fe_mul(ow, o, w, c);
  fe_add(r0, e, ow, c);
  fe_sub(r1, e, ow, c);
  fe_store(y, stride, ie, r0);
  fe_store(y, stride, io, r1);
}

extern "C" {

int pt_ntt_stage(void* y, const void* x, const void* tw, int64_t tw_stride, int64_t batch,
                 int64_t n, int64_t m, const void* consts, void* stream) {
  FieldConsts c = field_consts_from((const uint32_t*)consts);
  int64_t total = batch * (n >> 1);
  ntt_stage_kernel<<<pt_blocks(total), PT_THREADS, 0, (cudaStream_t)stream>>>(
      (int32_t*)y, (const int32_t*)x, (const int32_t*)tw, tw_stride, batch, n, m, c);
  return (int)cudaGetLastError();
}

}  // extern "C"
