// K2: torch-semantics k x k stride-s convolution with bias and an optional
// (I)GDN epilogue, NHWC, fp32, in one pass.
//
// Replaces the Pallas kernel iclr_17_compression_tpu/ops/pallas/conv_gdn_kernel.py
// (_conv_gdn_kernel, launched by conv_gdn_fused_raw; chained three times by
// analysis17_fused into the Ballé-17 encoder). The TPU version phase-stacks
// the input to fill 128 lanes and double-buffers a halo DMA; neither serves
// here. This kernel is an implicit GEMM instead:
//   M = output pixels (32 a block), N = Cout (all of it in the block, so the
//   GDN of a pixel needs no other block), K = k*k*Cin,
// with the weight in HWIO order, which is already the (K, Cout) row-major B
// matrix. Each step stages BK = 32 rows of K: the A tile gathered from the
// input with zero padding (a per-block pixel table and a per-step tap table
// turn the gather into adds), and the B tile as one contiguous copy. The
// accumulator stays in registers through bias and the GDN epilogue
// (gdn_epilogue.cuh) and is written once.
//
// Bound on an H100: the Ballé-17 stages need 1.5 to 5 GFLOP each against a
// few MB of traffic, far above the fp32 ridge (about 20 operations a byte):
// fp32 FMA throughput on the CUDA cores bounds it (TF32 tensor cores would
// break parity with the fp32 reference). Shared memory per block is about
// 40 KB at Cout = 128, so several blocks share an SM.

#include <cuda_runtime.h>

#include "gdn_epilogue.cuh"

namespace iclr17c {

__global__ void __launch_bounds__(256)
conv_gdn_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, const float* __restrict__ gamma_t,
                const float* __restrict__ beta, float* __restrict__ out, int N,
                int H, int W, int Cin, int Ho, int Wo, int C, int ksz, int stride,
                int pad, int gdn_on, int inverse) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;             // BK * LDA   A tile, [k][m]
  float* Bs = As + BK * LDA;    // BK * C     B tile, [k][n]
  float* Ys = Bs + BK * C;      // C * LDA    y*y for the GDN epilogue
  __shared__ int pn[BM], piy[BM], pix[BM];   // per output pixel: image, top, left
  __shared__ int kdy[BK], kdx[BK], kci[BK];  // per K row: tap and input channel

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int cg = tid % (C / 8);
  const int pg = tid / (C / 8);
  const int c0 = 4 * cg;
  const int c1 = C / 2 + 4 * cg;
  const long long hw_out = static_cast<long long>(Ho) * Wo;
  const long long P = hw_out * N;
  const long long pix0 = static_cast<long long>(blockIdx.x) * BM;
  const int K = ksz * ksz * Cin;

  for (int m = tid; m < BM; m += nthreads) {
    const long long p = pix0 + m;
    if (p < P) {
      const int n = static_cast<int>(p / hw_out);
      const int r = static_cast<int>(p - n * hw_out);
      pn[m] = n;
      piy[m] = (r / Wo) * stride - pad;
      pix[m] = (r % Wo) * stride - pad;
    } else {
      pn[m] = -1;
      piy[m] = 0;
      pix[m] = 0;
    }
  }

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();  // the previous step's readers are done
    for (int kk = tid; kk < BK; kk += nthreads) {
      const int kg = k0 + kk;
      if (kg < K) {
        const int t = kg / Cin;
        kci[kk] = kg - t * Cin;
        kdy[kk] = t / ksz;
        kdx[kk] = t - (t / ksz) * ksz;
      } else {
        kci[kk] = -1;
        kdy[kk] = 0;
        kdx[kk] = 0;
      }
    }
    for (int e = 4 * tid; e < BK * C; e += 4 * nthreads) {
      const int kk = e / C;
      const int kg = k0 + kk;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (kg < K)
        v = *reinterpret_cast<const float4*>(&w[static_cast<long long>(kg) * C + (e - kk * C)]);
      *reinterpret_cast<float4*>(&Bs[e]) = v;
    }
    __syncthreads();  // tap table visible
    // Consecutive threads take consecutive K rows of one pixel: for Cin >= 32
    // that is one contiguous run of input channels in device memory.
    for (int e = tid; e < BK * BM; e += nthreads) {
      const int kk = e % BK;
      const int m = e / BK;
      float v = 0.f;
      const int ci = kci[kk];
      const int n = pn[m];
      if (ci >= 0 && n >= 0) {
        const int iy = piy[m] + kdy[kk];
        const int ix = pix[m] + kdx[kk];
        if (iy >= 0 && iy < H && ix >= 0 && ix < W)
          v = x[((static_cast<long long>(n) * H + iy) * W + ix) * Cin + ci];
      }
      As[kk * LDA + m] = v;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk * LDA + 4 * pg]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk * C + c0]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk * C + c1]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

  if (bias != nullptr) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float b = bias[tile_channel(j, cg, C)];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] += b;
    }
  }
  if (gdn_on)
    gdn_epilogue(acc, gamma_t, beta, C, inverse, Bs, Ys, tid, nthreads, pg, cg);
  store_tile(acc, out, pix0, P, C, pg, cg);
}

}  // namespace iclr17c

extern "C" size_t iclr17c_conv_gdn_smem_bytes(int C) {
  using namespace iclr17c;
  return sizeof(float) * (static_cast<size_t>(BK) * LDA + static_cast<size_t>(BK) * C +
                          static_cast<size_t>(C) * LDA);
}

// Launch K2 on `stream`. x: (N, H, W, Cin); w: (ksz, ksz, Cin, C) HWIO;
// bias: (C,) or null; gamma_t (C, C) and beta (C,) are read only when gdn_on.
// out: (N, Ho, Wo, C). Returns the cudaError_t of the launch (0 = success).
extern "C" int iclr17c_conv_gdn(const float* x, const float* w, const float* bias,
                                const float* gamma_t, const float* beta, float* out,
                                int N, int H, int W, int Cin, int Ho, int Wo, int C,
                                int ksz, int stride, int pad, int gdn_on, int inverse,
                                void* stream) {
  using namespace iclr17c;
  if (N <= 0 || Ho <= 0 || Wo <= 0 || Cin <= 0 || C <= 0 || C % 32 != 0 || C > 256 ||
      ksz <= 0 || stride <= 0 || pad < 0)
    return cudaErrorInvalidValue;
  const size_t smem = iclr17c_conv_gdn_smem_bytes(C);
  cudaError_t err = allow_smem(conv_gdn_kernel, smem);
  if (err != cudaSuccess) return err;
  const long long P = static_cast<long long>(N) * Ho * Wo;
  const long long blocks = (P + BM - 1) / BM;
  conv_gdn_kernel<<<static_cast<unsigned int>(blocks), C, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      x, w, bias, gamma_t, beta, out, N, H, W, Cin, Ho, Wo, C, ksz, stride, pad,
      gdn_on, inverse);
  return cudaGetLastError();
}
