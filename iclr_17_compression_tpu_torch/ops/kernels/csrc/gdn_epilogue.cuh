// Shared tile layout and (I)GDN epilogue of the K1 and K2 kernels.
//
// A block owns BM = 32 consecutive pixels of an NHWC tensor and all C
// channels of each. It runs C threads (C % 32 == 0, C <= 256). Thread t holds a
// 4-pixel x 8-channel register tile:
//   pixels   4*pg .. 4*pg+3                    with pg = t / (C/8)
//   channels 4*cg .. 4*cg+3 and C/2+4*cg .. +3  with cg = t % (C/8)
// so that the float4 reads of a warp from a [k][C] shared row are
// contiguous (no bank conflicts) and its reads of a [k][BM] row broadcast.
//
// The GDN epilogue turns the tile y into
//   norm = beta + (y*y) . gamma_t      (gamma_t[j][i] = gamma[i][j])
//   y    = y * rsqrt(norm)             (forward)  or  y * sqrt(norm) (inverse)
// with y*y staged transposed in shared memory (Ys[c][m]) and gamma_t
// streamed through shared memory BK rows at a time, fp32 FMA on the CUDA
// cores (TF32 would break parity with the fp32 reference).

#pragma once

#include <cuda_runtime.h>

namespace iclr17c {

constexpr int BM = 32;       // pixels per block
constexpr int BK = 32;       // reduction rows staged per step
constexpr int LDA = BM + 4;  // padded row of a [k][BM] tile (keeps float4 alignment)

__device__ __forceinline__ int tile_channel(int j, int cg, int C) {
  return j < 4 ? 4 * cg + j : C / 2 + 4 * cg + (j - 4);
}

// Ys: C * LDA floats; Bs: BK * C floats. Every thread of the block must call.
// The caller has finished with Bs before the call (the first barrier inside
// the loop orders the Ys writes before their reads and the caller's last
// reads of Bs before the first gamma_t load).
__device__ __forceinline__ void gdn_epilogue(float acc[4][8],
                                             const float* __restrict__ gamma_t,
                                             const float* __restrict__ beta,
                                             int C, int inverse, float* Bs,
                                             float* Ys, int tid, int nthreads,
                                             int pg, int cg) {
  const int c0 = 4 * cg;
  const int c1 = C / 2 + 4 * cg;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    *reinterpret_cast<float4*>(&Ys[(c0 + j) * LDA + 4 * pg]) =
        make_float4(acc[0][j] * acc[0][j], acc[1][j] * acc[1][j],
                    acc[2][j] * acc[2][j], acc[3][j] * acc[3][j]);
    *reinterpret_cast<float4*>(&Ys[(c1 + j) * LDA + 4 * pg]) =
        make_float4(acc[0][4 + j] * acc[0][4 + j], acc[1][4 + j] * acc[1][4 + j],
                    acc[2][4 + j] * acc[2][4 + j], acc[3][4 + j] * acc[3][4 + j]);
  }
  float nrm[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) nrm[i][j] = 0.f;

  for (int k0 = 0; k0 < C; k0 += BK) {
    __syncthreads();
    const int nk = min(BK, C - k0);
    for (int e = 4 * tid; e < nk * C; e += 4 * nthreads)
      *reinterpret_cast<float4*>(&Bs[e]) =
          *reinterpret_cast<const float4*>(&gamma_t[(long long)k0 * C + e]);
    __syncthreads();
    for (int kk = 0; kk < nk; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&Ys[(k0 + kk) * LDA + 4 * pg]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk * C + c0]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk * C + c1]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) nrm[i][j] = fmaf(av[i], bv[j], nrm[i][j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float bt = beta[tile_channel(j, cg, C)];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float n = nrm[i][j] + bt;
      acc[i][j] = inverse ? acc[i][j] * sqrtf(n) : acc[i][j] * rsqrtf(n);
    }
  }
}

// Store the register tile to out (P x C, row-major); rows >= P are dropped.
__device__ __forceinline__ void store_tile(const float acc[4][8], float* __restrict__ out,
                                           long long pix0, long long P, int C,
                                           int pg, int cg) {
  const int c0 = 4 * cg;
  const int c1 = C / 2 + 4 * cg;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long p = pix0 + 4 * pg + i;
    if (p < P) {
      *reinterpret_cast<float4*>(&out[p * C + c0]) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(&out[p * C + c1]) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  }
}

// Dynamic shared memory above the 48 KB default needs an explicit opt-in.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace iclr17c
