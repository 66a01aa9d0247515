// K1: fused (I)GDN over the channel axis of an NHWC tensor, fp32.
//
// Replaces the Pallas kernel iclr_17_compression_tpu/ops/pallas/gdn_kernel.py
// (_gdn_kernel, launched by _gdn_pallas_raw). Same contract: x is (P, C)
// pixels x channels, gamma_t = gamma^T and beta are the effective
// (already un-reparameterized) parameters, and
//   y = x * rsqrt(beta + (x*x) . gamma_t)     (inverse: x * sqrt(...))
// in one pass, with no device-memory round trip for x*x or the norm.
//
// Bound on an H100: the C x C norm pool is 2*P*C^2 fp32 operations against
// 8*P*C bytes of input and output, so at C = 128 it needs 32 operations per
// byte, above the card's fp32 ridge (67 TFLOP/s over 3.35 TB/s = 20): the
// kernel is bound by fp32 FMA throughput on the CUDA cores. The design keeps
// each block's 32 x C tile in registers (4 pixels x 8 channels a thread),
// streams gamma_t through shared memory 32 rows at a time, and writes each
// output once. The channel count is a runtime argument (C % 32 == 0, C <= 256).

#include <cuda_runtime.h>

#include "gdn_epilogue.cuh"

namespace iclr17c {

__global__ void __launch_bounds__(256)
gdn_kernel(const float* __restrict__ x, const float* __restrict__ gamma_t,
           const float* __restrict__ beta, float* __restrict__ out, long long P,
           int C, int inverse) {
  extern __shared__ __align__(16) float smem[];
  float* Bs = smem;           // BK * C
  float* Ys = smem + BK * C;  // C * LDA
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int cg = tid % (C / 8);
  const int pg = tid / (C / 8);
  const long long pix0 = static_cast<long long>(blockIdx.x) * BM;
  const int c0 = 4 * cg;
  const int c1 = C / 2 + 4 * cg;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long p = pix0 + 4 * pg + i;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 b = a;
    if (p < P) {
      a = *reinterpret_cast<const float4*>(&x[p * C + c0]);
      b = *reinterpret_cast<const float4*>(&x[p * C + c1]);
    }
    acc[i][0] = a.x; acc[i][1] = a.y; acc[i][2] = a.z; acc[i][3] = a.w;
    acc[i][4] = b.x; acc[i][5] = b.y; acc[i][6] = b.z; acc[i][7] = b.w;
  }
  gdn_epilogue(acc, gamma_t, beta, C, inverse, Bs, Ys, tid, nthreads, pg, cg);
  store_tile(acc, out, pix0, P, C, pg, cg);
}

}  // namespace iclr17c

extern "C" size_t iclr17c_gdn_smem_bytes(int C) {
  return sizeof(float) * (static_cast<size_t>(iclr17c::BK) * C +
                          static_cast<size_t>(C) * iclr17c::LDA);
}

// Launch K1 on `stream`. Returns the cudaError_t of the launch (0 = success).
extern "C" int iclr17c_gdn(const float* x, const float* gamma_t, const float* beta,
                           float* out, long long P, int C, int inverse, void* stream) {
  using namespace iclr17c;
  if (P <= 0 || C <= 0 || C % 32 != 0 || C > 256) return cudaErrorInvalidValue;
  const size_t smem = iclr17c_gdn_smem_bytes(C);
  cudaError_t err = allow_smem(gdn_kernel, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (P + BM - 1) / BM;
  gdn_kernel<<<static_cast<unsigned int>(blocks), C, smem,
               static_cast<cudaStream_t>(stream)>>>(x, gamma_t, beta, out, P, C,
                                                     inverse);
  return cudaGetLastError();
}
