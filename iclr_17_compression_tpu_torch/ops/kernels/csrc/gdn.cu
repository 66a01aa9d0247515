// K1: fused (I)GDN over the channel axis of an NHWC tensor, fp32 accuracy,
// on the tensor cores in 3xTF32. The same code, as its own kernel
// (conv_gdn_reduce_kernel), is K2's split-K reduction.
//
// Replaces the Pallas kernel iclr_17_compression_tpu/ops/pallas/gdn_kernel.py
// (_gdn_kernel, launched by _gdn_pallas_raw). Same contract: x is (P, C)
// pixels x channels, gamma_t = gamma^T and beta are the effective
// (already un-reparameterized) parameters, and
//   y = x / sqrt(beta + (x*x) . gamma_t)     (inverse: x * sqrt(...))
// in one pass, with no device-memory round trip for x*x or the norm.
//
// Bound on an H100: 2*P*C^2 operations of the norm product against 8*P*C
// bytes of input and output. Counted at the TF32 peak (three products at
// 495 TFLOP/s) the least time at C = 128 is set by the bytes (3.35 TB/s).
// mma.sync does not reach that peak (it is wgmma's), and each operand is
// split into hi and lo in the loop, so in practice the kernel is bound by
// the issue of the tensor-core products and of the splits, not the bytes.
// The design:
// - a persistent grid, the same number of tiles in every block; each block
//   loads gamma_t into shared memory once and walks 64-pixel tiles (32-pixel
//   tiles at C = 192, where two x buffers and gamma_t would not fit; at
//   C = 256, where gamma_t alone would not fit, it streams gamma_t 32 rows
//   at a time for each tile, as K2's epilogue does; past C = 256, up to
//   512, its 8 warps take the channels in passes of 256 and each pass
//   streams a 256-column window of gamma_t, the chunks summed in order);
// - x tiles double-buffered with cp.async, the next tile's copy in flight
//   while the current one is computed;
// - the norm product on the tensor cores (gdn_epilogue.cuh), x squared as it
//   is loaded into the fragments; each warp then applies the GDN to its
//   32 x 32 tile in registers and stores it, 16 bytes a thread, with no
//   barrier between warps.
// As K2's split-K reduction (conv_gdn_reduce_kernel, a kernel of its own so
// that a trace tells it from K1), the tile load sums the S partial slices
// in fixed order and adds the bias before the GDN: no atomics, so two calls
// give the same bits. The channel count is a runtime argument
// (C % 32 == 0, C <= 512 for K1, C <= 256 for the reduction).

#include <cuda_runtime.h>

#include "gdn_epilogue.cuh"

namespace iclr17c {

struct RowsArgs {
  const float* src;       // parts x (P, C)
  long long part_stride;  // floats between two parts
  const float* bias;      // (C,) or null
  const float* gamma_t;   // (C, C) or null: no GDN
  const float* beta;      // (C,)
  float* out;             // (P, C)
  long long P;
  int parts;
  int C;
  int inverse;
  int warp_rows;  // 1 or 2 warps of 32 pixels: tiles of 32 * warp_rows pixels
  int resident;   // gamma_t resident in shared memory; else streamed for each tile
};

// The rows kernels' body. kReduce: src holds `parts` slices to sum, in
// order, and the bias is added (K2's reduction); else src is x (K1).
template <bool kReduce>
__device__ __forceinline__ void gdn_rows(const RowsArgs& a) {
  extern __shared__ __align__(16) float smem[];
  const int C = a.C;
  const int lda = lda_of(C);
  const int ldb = ldb_of(C);
  const int bm = WARP_M * a.warp_rows;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = WARP_M * (warp % a.warp_rows);
  const int col0 = WARP_N * (warp / a.warp_rows);
  float* xs[2] = {smem, smem + bm * lda};
  float* gs = smem + 2 * bm * lda;  // resident gamma_t, or the 2-slot ring that streams it
  const bool gdn_on = a.gamma_t != nullptr;
  const long long tiles = (a.P + bm - 1) / bm;

  long long tile = blockIdx.x;
  if (gdn_on && a.resident) load_rows_async(gs, ldb, a.gamma_t, 0, C, C, C, tid, nthreads);
  load_rows_async(xs[0], lda, a.src, tile * bm, a.P, bm, C, tid, nthreads);
  cp_async_commit();

  for (int it = 0; tile < tiles; ++it, tile += gridDim.x) {
    float* xt = xs[it & 1];
    const long long pix0 = tile * bm;
    cp_async_wait<0>();
    __syncthreads();  // this tile has landed; the other buffer's readers are done
    if constexpr (kReduce) {
      const int units = C / 4;
      for (int e = tid; e < bm * units; e += nthreads) {
        const int m = e / units;
        const int u = e - m * units;
        const long long p = pix0 + m;
        if (p >= a.P) continue;
        float4 v = *reinterpret_cast<float4*>(xt + m * lda + 4 * u);
        const float* q = a.src + p * C + 4 * u;
#pragma unroll 4
        for (int s = 1; s < a.parts; ++s) {
          const float4 w = *reinterpret_cast<const float4*>(q + s * a.part_stride);
          v.x += w.x;
          v.y += w.y;
          v.z += w.z;
          v.w += w.w;
        }
        if (a.bias != nullptr) {
          const float4 b = *reinterpret_cast<const float4*>(a.bias + 4 * u);
          v.x += b.x;
          v.y += b.y;
          v.z += b.z;
          v.w += b.w;
        }
        *reinterpret_cast<float4*>(xt + m * lda + 4 * u) = v;
      }
      __syncthreads();
    }
    const long long next = tile + gridDim.x;
    if (next < tiles) {
      load_rows_async(xs[(it + 1) & 1], lda, a.src, next * bm, a.P, bm, C, tid, nthreads);
      cp_async_commit();
    }
    if (gdn_on) {
      // The warp's 32 x 32 tile: norm on the tensor cores, then the GDN and
      // the store straight from registers (no barrier: the buffer is reused
      // only after the next iteration's first barrier, which also orders the
      // last reads of a streaming ring before its next refill). Past
      // C = 256 the block's 8 warps take the channels in passes of 256, each
      // streaming its window of gamma_t's columns.
      const float* A = xt + row0 * lda;
      const int pass_cols = WARP_N * (nthreads / 32 / a.warp_rows);
      for (int c0 = 0; c0 < C; c0 += pass_cols) {
        const int col = c0 + col0;
        float nrm[2][4][4], y[2][4][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int r = 0; r < 4; ++r) nrm[mi][ni][r] = 0.f;
        if (a.resident) {
          for (int k0 = 0; k0 < C; k0 += BK)
            mma_chunk<true>(nrm, A + k0, lda, gs + k0 * ldb + col0, ldb, lane);
        } else {
          if (c0 > 0) __syncthreads();  // every warp is done with the last window's ring
          gdn_norm_window(nrm, A, a.gamma_t, gs, C, c0, min(pass_cols, C - c0), col0, col < C,
                          tid, nthreads, lane);
        }
        if (col < C) {
          frag_from_smem(y, A + col, lda, lane);
          gdn_apply(y, nrm, a.beta, col, a.inverse, lane);
          frag_store_global(y, a.out, pix0 + row0, a.P, C, col, lane);
        }
      }
    } else {
      store_rows(xt, lda, a.out, pix0, a.P, bm, C, tid, nthreads);
    }
  }
}

__global__ void __launch_bounds__(256, 1) gdn_rows_kernel(RowsArgs a) { gdn_rows<false>(a); }
__global__ void __launch_bounds__(256, 1) conv_gdn_reduce_kernel(RowsArgs a) {
  gdn_rows<true>(a);
}

// Tiles and shared memory of the rows kernels at C channels: gamma_t resident
// beside two x tiles of 64 pixels where that fits (C <= 128), else of 32
// pixels (C <= 192), else streamed through a 2-slot ring (C = 256) beside
// 32-pixel tiles, as a plain reduction takes them. One warp a 32-channel
// column up to C = 256; past it (K1 only, C <= 512) 8 warps that walk the
// channels in passes of 256, the ring holding a 256-column window of
// gamma_t (at C = 512: 132 KB of x tiles and 68 KB of ring, where a
// full-width ring would not fit). A block is at most 256 threads, so a
// thread may hold 255 registers.
constexpr int PASS_COLS = 256;

struct RowsPlan {
  int warp_rows;
  int resident;
  int threads;
  size_t smem;
};

static RowsPlan rows_plan(int C, bool gdn_on) {
  auto bytes = [&](int warp_rows, size_t gamma_rows, int gamma_cols) {
    return sizeof(float) *
           (2ull * WARP_M * warp_rows * lda_of(C) + gamma_rows * ldb_of(gamma_cols));
  };
  if (!gdn_on) return {1, 0, C, bytes(1, 0, C)};
  if (bytes(2, C, C) <= SMEM_LIMIT) return {2, 1, 2 * C, bytes(2, C, C)};
  if (bytes(1, C, C) <= SMEM_LIMIT) return {1, 1, C, bytes(1, C, C)};
  if (C <= PASS_COLS) return {1, 0, C, bytes(1, 2 * BK, C)};
  return {1, 0, PASS_COLS, bytes(1, 2 * BK, PASS_COLS)};
}

static bool rows_smem_set[64];
static bool reduce_smem_set[64];

cudaError_t gdn_rows_launch(const float* src, int parts, long long part_stride,
                            const float* bias, const float* gamma_t, const float* beta,
                            float* out, long long P, int C, int inverse, cudaStream_t stream) {
  // K2's reduction has partials to sum or a bias to add; K1 has neither
  const bool reduce = parts > 1 || bias != nullptr;
  if (P <= 0 || C <= 0 || C % 32 != 0 || C > (reduce ? 256 : 512) || parts < 1 ||
      (gamma_t != nullptr && beta == nullptr) || (C > 256 && gamma_t == nullptr))
    return cudaErrorInvalidValue;
  void (*kernel)(RowsArgs) = reduce ? conv_gdn_reduce_kernel : gdn_rows_kernel;
  cudaError_t err = allow_smem(kernel, reduce ? reduce_smem_set : rows_smem_set);
  if (err != cudaSuccess) return err;
  const RowsPlan plan = rows_plan(C, gamma_t != nullptr);
  const size_t smem = plan.smem;
  const int threads = plan.threads;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // a persistent grid with the same number of tiles in every block
  const long long tiles = (P + WARP_M * plan.warp_rows - 1) / (WARP_M * plan.warp_rows);
  const long long slots = 1ll * per_sm * sms;
  const long long per_block = (tiles + slots - 1) / slots;
  const long long blocks = (tiles + per_block - 1) / per_block;
  const RowsArgs a{src, part_stride, bias, gamma_t, beta, out, P, parts, C, inverse,
                   plan.warp_rows, plan.resident};
  kernel<<<static_cast<unsigned int>(blocks), threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace iclr17c

// Dynamic shared memory of K1 at C channels.
extern "C" size_t iclr17c_gdn_smem_bytes(int C) { return iclr17c::rows_plan(C, true).smem; }

// Launch K1 on `stream`. Returns the cudaError_t of the launch (0 = success).
extern "C" int iclr17c_gdn(const float* x, const float* gamma_t, const float* beta,
                           float* out, long long P, int C, int inverse, void* stream) {
  if (gamma_t == nullptr) return cudaErrorInvalidValue;
  return iclr17c::gdn_rows_launch(x, 1, 0, nullptr, gamma_t, beta, out, P, C, inverse,
                                  static_cast<cudaStream_t>(stream));
}
