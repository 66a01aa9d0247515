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
//
// bf16 storage. K2's reduction reads its fp32 partials as above and rounds
// only its store to bf16 (conv_gdn_reduce_bf16_kernel). K1 in bf16
// (gdn_rows_bf16_kernel) follows the rounding points of _gdn_kernel on a
// bf16 x: x*x rounded to bf16, gamma_t in bf16, the product accumulated in
// fp32 in one bf16 mma.sync m16n8k16 pass, beta in fp32, y = x * rsqrt(norm)
// (inverse: x * sqrt(norm)) in fp32, correctly rounded, and rounded to bf16
// once at the store. Its bound is the bytes, 4*P*C of x and y (half of
// fp32's). Its design: a persistent grid of 8-warp blocks; each block first
// stages gamma_t in shared memory as ready-made B fragments (C <= 256: at
// most 128 KB; past that the fragments are read from device memory, where
// gamma_t stays L2-resident), then each warp takes 16 pixels at a time and
// walks the channels in windows of 128, its A fragments (x squared as they
// are loaded) read straight from device memory; each lane then stores its
// y pairs, 4 bytes a store. No barrier after the staging.

#include <cuda_runtime.h>

#include "gdn_epilogue.cuh"

namespace iclr17c {

struct RowsArgs {
  const float* src;       // parts x (P, C)
  long long part_stride;  // floats between two parts
  const float* bias;      // (C,) or null
  const float* gamma_t;   // (C, C) or null: no GDN
  const float* beta;      // (C,)
  void* out;              // (P, C), fp32 or bf16 (the kernel's OutT)
  long long P;
  int parts;
  int C;
  int inverse;
  int warp_rows;  // 1 or 2 warps of 32 pixels: tiles of 32 * warp_rows pixels
  int resident;   // gamma_t resident in shared memory; else streamed for each tile
};

// The rows kernels' body. kReduce: src holds `parts` slices to sum, in
// order, and the bias is added (K2's reduction); else src is x (K1). OutT:
// the element type of out (float, or __nv_bfloat16 for the reduction of
// K2's bf16 variant).
template <bool kReduce, typename OutT>
__device__ __forceinline__ void gdn_rows(const RowsArgs& a) {
  OutT* const out = static_cast<OutT*>(a.out);
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
          frag_store_global(y, out, pix0 + row0, a.P, C, col, lane);
        }
      }
    } else {
      store_rows(xt, lda, out, pix0, a.P, bm, C, tid, nthreads);
    }
  }
}

__global__ void __launch_bounds__(256, 1) gdn_rows_kernel(RowsArgs a) {
  gdn_rows<false, float>(a);
}
__global__ void __launch_bounds__(256, 1) conv_gdn_reduce_kernel(RowsArgs a) {
  gdn_rows<true, float>(a);
}
__global__ void __launch_bounds__(256, 1) conv_gdn_reduce_bf16_kernel(RowsArgs a) {
  gdn_rows<true, __nv_bfloat16>(a);
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
static bool reduce_bf16_smem_set[64];

cudaError_t gdn_rows_launch(const float* src, int parts, long long part_stride,
                            const float* bias, const float* gamma_t, const float* beta,
                            void* out, bool out_bf16, long long P, int C, int inverse,
                            cudaStream_t stream) {
  // K2's reduction has partials to sum or a bias to add; K1 has neither
  const bool reduce = parts > 1 || bias != nullptr;
  if (P <= 0 || C <= 0 || C % 32 != 0 || C > (reduce ? 256 : 512) || parts < 1 ||
      (gamma_t != nullptr && beta == nullptr) || (C > 256 && gamma_t == nullptr) ||
      (out_bf16 && !reduce))
    return cudaErrorInvalidValue;
  void (*kernel)(RowsArgs) = !reduce ? gdn_rows_kernel
                             : out_bf16 ? conv_gdn_reduce_bf16_kernel
                                        : conv_gdn_reduce_kernel;
  cudaError_t err = allow_smem(
      kernel, !reduce ? rows_smem_set : out_bf16 ? reduce_bf16_smem_set : reduce_smem_set);
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
  return iclr17c::gdn_rows_launch(x, 1, 0, nullptr, gamma_t, beta, out, false, P, C, inverse,
                                  static_cast<cudaStream_t>(stream));
}

namespace iclr17c {

constexpr int K1B_WARPS = 8;    // warps a block
constexpr int K1B_FRAGS = 16;   // n8 fragments of a channel window: 128 channels
constexpr int K1B_RESIDENT = 256;  // C up to which gamma_t's fragments stay in shared memory

// One bf16 pair of x (two channels of one pixel) squared and rounded to
// bf16, as an mma operand register; zero for a pixel past P.
__device__ __forceinline__ uint32_t sq_pair(const uint16_t* p, bool ok) {
  if (!ok) return 0u;
  const float2 v = bf16x2_to_float2(__ldg(reinterpret_cast<const unsigned int*>(p)));
  return float2_to_bf16x2(v.x * v.x, v.y * v.y);
}

// The B fragment (two registers) of lane (g, t) for k step ks and the n8
// fragment nf of gamma_t (C x C, row k, column n), read from device memory.
__device__ __forceinline__ uint2 gamma_frag(const uint16_t* __restrict__ gamma_t, int C, int ks,
                                            int nf, int g, int t) {
  const uint16_t* q = gamma_t + static_cast<long long>(16 * ks + 2 * t) * C + 8 * nf + g;
  return make_uint2(pack_u16(__ldg(q), __ldg(q + C)), pack_u16(__ldg(q + 8 * C), __ldg(q + 9 * C)));
}

__global__ void __launch_bounds__(32 * K1B_WARPS) gdn_rows_bf16_kernel(
    const uint16_t* __restrict__ x, const uint16_t* __restrict__ gamma_t,
    const float* __restrict__ beta, uint16_t* __restrict__ out, long long P, int C,
    int inverse) {
  // gamma_t as B fragments, [k step][n8 fragment][lane], 8 bytes a lane, so
  // that a warp reads one fragment with one conflict-free 8-byte load each
  extern __shared__ __align__(16) uint2 frags_smem[];
  const bool resident = C <= K1B_RESIDENT;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int nfrags = C / 8;
  if (resident) {
    for (int i = threadIdx.x; i < (C / 16) * nfrags * 32; i += blockDim.x) {
      const int l = i & 31;
      const int f = (i >> 5) % nfrags;
      const int ks = (i >> 5) / nfrags;
      frags_smem[i] = gamma_frag(gamma_t, C, ks, f, l >> 2, l & 3);
    }
    __syncthreads();
  }
  const long long groups = (P + 15) / 16;
  const long long nwarps = static_cast<long long>(gridDim.x) * K1B_WARPS;
  for (long long grp = static_cast<long long>(blockIdx.x) * K1B_WARPS + (threadIdx.x >> 5);
       grp < groups; grp += nwarps) {
    const long long p0 = 16 * grp + g;
    const long long p1 = p0 + 8;
    const bool ok0 = p0 < P;
    const bool ok1 = p1 < P;
    const uint16_t* x0 = x + (ok0 ? p0 : 0) * C;
    const uint16_t* x1 = x + (ok1 ? p1 : 0) * C;
    for (int c0 = 0; c0 < C; c0 += 8 * K1B_FRAGS) {
      const int frags = min(8 * K1B_FRAGS, C - c0) / 8;
      const int f0 = c0 / 8;
      float acc[K1B_FRAGS][4];
#pragma unroll
      for (int f = 0; f < K1B_FRAGS; ++f)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[f][r] = 0.f;
      for (int ks = 0; ks < C / 16; ++ks) {
        const int k0 = 16 * ks;
        uint32_t a[4];
        a[0] = sq_pair(x0 + k0 + 2 * t, ok0);
        a[1] = sq_pair(x1 + k0 + 2 * t, ok1);
        a[2] = sq_pair(x0 + k0 + 2 * t + 8, ok0);
        a[3] = sq_pair(x1 + k0 + 2 * t + 8, ok1);
        const uint2* fk = frags_smem + (static_cast<long long>(ks) * nfrags + f0) * 32 + lane;
#pragma unroll
        for (int f = 0; f < K1B_FRAGS; ++f) {
          if (f < frags) {
            const uint2 bb = resident ? fk[32 * f] : gamma_frag(gamma_t, C, ks, f0 + f, g, t);
            const uint32_t b[2] = {bb.x, bb.y};
            mma_bf16(acc[f], a, b);
          }
        }
      }
#pragma unroll
      for (int f = 0; f < K1B_FRAGS; ++f) {
        if (f < frags) {
          const int col = c0 + 8 * f + 2 * t;
          const float b0 = beta[col];
          const float b1 = beta[col + 1];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (!(h ? ok1 : ok0)) continue;
            const long long off = (h ? p1 : p0) * C + col;
            const float2 v =
                bf16x2_to_float2(__ldg(reinterpret_cast<const unsigned int*>(x + off)));
            const float n0 = acc[f][2 * h] + b0;
            const float n1 = acc[f][2 * h + 1] + b1;
            const float y0 = inverse ? v.x * sqrtf(n0) : v.x * __frsqrt_rn(n0);
            const float y1 = inverse ? v.y * sqrtf(n1) : v.y * __frsqrt_rn(n1);
            *reinterpret_cast<uint32_t*>(out + off) = float2_to_bf16x2(y0, y1);
          }
        }
      }
    }
  }
}

static bool rows_bf16_smem_set[64];

}  // namespace iclr17c

// Dynamic shared memory of K1's bf16 variant at C channels: gamma_t's
// fragments where C <= 256, else none (read from device memory).
extern "C" size_t iclr17c_gdn_bf16_smem_bytes(int C) {
  return C <= iclr17c::K1B_RESIDENT ? 2ull * C * C : 0;
}

// Launch K1's bf16 variant on `stream`: x, out (P, C) bf16, gamma_t (C, C)
// bf16, beta (C,) fp32; C % 32 == 0, C <= 512. Returns the cudaError_t of
// the launch (0 = success).
extern "C" int iclr17c_gdn_bf16(const void* x, const void* gamma_t, const float* beta,
                                void* out, long long P, int C, int inverse, void* stream) {
  using namespace iclr17c;
  if (x == nullptr || gamma_t == nullptr || beta == nullptr || out == nullptr || P <= 0 ||
      C <= 0 || C % 32 != 0 || C > 512)
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(gdn_rows_bf16_kernel, rows_bf16_smem_set);
  if (err != cudaSuccess) return err;
  const size_t smem = iclr17c_gdn_bf16_smem_bytes(C);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gdn_rows_bf16_kernel,
                                                      32 * K1B_WARPS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // a persistent grid: gamma_t's fragments are staged once a block
  const long long groups = (P + 15) / 16;
  long long blocks = (groups + K1B_WARPS - 1) / K1B_WARPS;
  if (blocks > 1ll * per_sm * sms) blocks = 1ll * per_sm * sms;
  gdn_rows_bf16_kernel<<<static_cast<unsigned int>(blocks), 32 * K1B_WARPS, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(gamma_t), beta,
      static_cast<uint16_t*>(out), P, C, inverse);
  return cudaGetLastError();
}
