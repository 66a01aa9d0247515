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
// bf16 storage. K1 in bf16
// (gdn_rows_bf16_kernel) follows the rounding points of _gdn_kernel on a
// bf16 x: x*x rounded to bf16, gamma_t in bf16, the product accumulated in
// fp32 (mma.sync m16n8k16 bf16), beta in fp32, y = x * rsqrt(norm)
// (inverse: x * sqrt(norm)) in fp32 (rsqrtf, 2 ulp, as the fp32 epilogue),
// rounded to bf16 once at the store. Its bound is the bytes, 4*P*C of x and
// y: at C/2 operations a byte the norm sits below the card's ridge, so the
// design moves x and y at the memory's rate, keeps the products on mma.sync
// and the instructions and shared-memory traffic a pixel few:
// - a persistent grid of blocks of up to 8 warps, at most ceil(tiles /
//   warps) of them, so that each block stages gamma_t for a warp's worth of
//   tiles or more; a block copies beta and gamma_t (C <= 256) into shared
//   memory once, gamma_t as plain rows with 16-byte cp.async, and reads B
//   fragments from it with ldmatrix.trans, each shared by the two m16 halves
//   of a 32-pixel warp tile (16 pixels past C = 128);
// - each warp walks its own tiles through its own 2-slot ring of 16-byte
//   cp.async copies (the next tile in flight while one is computed), with
//   no block barrier after gamma_t's;
// - the instance for C rounded up to 64 unrolls the channel loops, so the
//   tile's x fragments (ldmatrix) stay in registers beside its norm: they
//   are squared and rounded for the products, y is computed from them
//   (x is read from device memory once and from shared memory once) and
//   written over x with stmatrix, then stored 16 bytes a lane;
// - past C = 256 (to 512) gamma_t's fragments are read from device memory
//   (L2-resident), the channels in windows of 256, y stored from registers.

#include <cuda_runtime.h>

#include "gdn_epilogue.cuh"
#include "hopper.cuh"

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
  float* const out = a.out;
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
  gdn_rows<false>(a);
}
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
  // two warp rows take 2·C threads: at most the 256 the kernels are built for
  if (2 * C <= 256 && bytes(2, C, C) <= SMEM_LIMIT) return {2, 1, 2 * C, bytes(2, C, C)};
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

namespace iclr17c {

constexpr int K1B_ROWS = 16;       // pixels of a warp tile: the m16 of mma.sync
constexpr int K1B_RESIDENT = 256;  // C up to which gamma_t stays in shared memory

// One bf16 pair squared in one bf16x2 multiply, rounded to nearest even:
// the exact product (16 significant bits) rounded once, as x*x in fp32
// rounded to bf16.
__device__ __forceinline__ uint32_t sq_bf16x2(uint32_t v) {
  __nv_bfloat162 h;
  *reinterpret_cast<uint32_t*>(&h) = v;
  h = __hmul2(h, h);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The B fragment (two registers) of lane (g, t) for k step ks and the n8
// fragment nf of gamma_t (C x C, row k, column n), read from device memory
// (C > K1B_RESIDENT, where gamma_t stays in L2).
__device__ __forceinline__ void gamma_frag(uint32_t (&b)[2], const uint16_t* __restrict__ gamma_t,
                                           int C, int ks, int nf, int g, int t) {
  const uint16_t* q = gamma_t + static_cast<long long>(16 * ks + 2 * t) * C + 8 * nf + g;
  b[0] = pack_u16(__ldg(q), __ldg(q + C));
  b[1] = pack_u16(__ldg(q + 8 * C), __ldg(q + 9 * C));
}

// y of one bf16 pair of x from its norm pair (fp32, beta not yet added):
// x * rsqrt(n) (inverse: x * sqrt(n), as n * rsqrt(n)) in fp32 (rsqrtf,
// 2 ulp, as the fp32 epilogue's gdn_apply), rounded to a bf16 pair once.
__device__ __forceinline__ uint32_t gdn_pair(uint32_t xpair, float n0, float n1, float2 b,
                                             int inverse) {
  const float2 v = bf16x2_to_float2(xpair);
  n0 += b.x;
  n1 += b.y;
  const float s0 = rsqrtf(n0);
  const float s1 = rsqrtf(n1);
  return float2_to_bf16x2(v.x * (inverse ? n0 * s0 : s0), v.y * (inverse ? n1 * s1 : s1));
}

// Each warp walks its own tiles of 16 MT pixels (tile = first, first +
// nwarps, ...) through its own 2-slot cp.async ring; the block shares beta
// and gamma_t. CMAX: the channels of the instance (C <= CMAX, C <= 256),
// whose loops are unrolled so that the tile's x fragments (A, from ldmatrix)
// and its norm stay in registers: y is computed from them and written over
// x with stmatrix. CMAX = 0: C past 256, gamma_t's fragments read from device
// memory, channel windows of 256 and y stored from registers.
template <int CMAX, int MT>
__global__ void __launch_bounds__(256) gdn_rows_bf16_kernel(
    const uint16_t* __restrict__ x, const uint16_t* __restrict__ gamma_t,
    const float* __restrict__ beta, uint16_t* __restrict__ out, long long P, int C,
    int inverse) {
  constexpr int ROWS = K1B_ROWS * MT;
  extern __shared__ __align__(16) uint16_t k1b_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int ldx = C + 8;  // bf16 a row of an x tile and of gamma_t in shared memory
  const int units = C / 8;  // 16-byte units of a row
  float* const sbeta = reinterpret_cast<float*>(k1b_smem);
  uint16_t* const G = k1b_smem + 2 * C;
  uint16_t* const ring = G + (CMAX > 0 ? C * ldx : 0) + warp * 2 * ROWS * ldx;
  const long long tiles = (P + ROWS - 1) / ROWS;
  const long long nwarps = static_cast<long long>(gridDim.x) * warps;
  const long long first = static_cast<long long>(blockIdx.x) * warps + warp;

  auto load_tile = [&](int slot, long long tile) {
    uint16_t* T = ring + slot * ROWS * ldx;
    for (int e = lane; e < ROWS * units; e += 32) {
      const int m = e / units;
      const int u = e - m * units;
      const long long p = tile * ROWS + m;
      const bool ok = tile < tiles && p < P;
      cp_async16(T + m * ldx + 8 * u, ok ? x + p * C + 8 * u : x, ok);
    }
  };

  for (int i = threadIdx.x; i < C; i += blockDim.x) sbeta[i] = beta[i];
  if (CMAX > 0) {
    for (int e = threadIdx.x; e < C * units; e += blockDim.x) {
      const int k = e / units;
      const int u = e - k * units;
      cp_async16(G + k * ldx + 8 * u, gamma_t + static_cast<long long>(k) * C + 8 * u, true);
    }
  }
  cp_async_commit();
  load_tile(0, first);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();  // beta and gamma_t are in shared memory, every thread's part

  int it = 0;
  for (long long tile = first; tile < tiles; tile += nwarps, ++it) {
    cp_async_wait<0>();
    __syncwarp();  // this tile has landed; every lane is done with the other slot
    load_tile((it + 1) & 1, tile + nwarps);
    cp_async_commit();
    uint16_t* const X = ring + (it & 1) * ROWS * ldx;
    const long long p0 = tile * ROWS;
    if constexpr (CMAX > 0) {
      constexpr int KS = CMAX / 16;
      constexpr int NF = CMAX / 8;
      uint32_t xf[MT][KS][4];
      float acc[MT][NF][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int f = 0; f < NF; ++f)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[mt][f][r] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        if (ks < C / 16) {
          uint32_t a2[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            ldmatrix_x4(xf[mt][ks], X + (16 * mt + (lane & 15)) * ldx + 16 * ks + 8 * (lane >> 4));
#pragma unroll
            for (int r = 0; r < 4; ++r) a2[mt][r] = sq_bf16x2(xf[mt][ks][r]);
          }
#pragma unroll
          for (int f = 0; f < NF; f += 2) {
            if (f < C / 8) {
              uint32_t b[4];
              ldmatrix_x4_trans(b, G + (16 * ks + (lane & 15)) * ldx + 8 * (f + (lane >> 4)));
              const uint32_t b0[2] = {b[0], b[1]};
              const uint32_t b1[2] = {b[2], b[3]};
#pragma unroll
              for (int mt = 0; mt < MT; ++mt) {
                mma_bf16(acc[mt][f], a2[mt], b0);
                mma_bf16(acc[mt][f + 1], a2[mt], b1);
              }
            }
          }
        }
      }
      // y over x in the tile: the A fragments' layout, one stmatrix a step
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        if (ks < C / 16) {
          const float2 be = *reinterpret_cast<const float2*>(sbeta + 16 * ks + 2 * t);
          const float2 bo = *reinterpret_cast<const float2*>(sbeta + 16 * ks + 8 + 2 * t);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const float(&e)[4] = acc[mt][2 * ks];
            const float(&o)[4] = acc[mt][2 * ks + 1];
            const uint32_t y[4] = {gdn_pair(xf[mt][ks][0], e[0], e[1], be, inverse),
                                   gdn_pair(xf[mt][ks][1], e[2], e[3], be, inverse),
                                   gdn_pair(xf[mt][ks][2], o[0], o[1], bo, inverse),
                                   gdn_pair(xf[mt][ks][3], o[2], o[3], bo, inverse)};
            stmatrix_x4(X + (16 * mt + (lane & 15)) * ldx + 16 * ks + 8 * (lane >> 4), y);
          }
        }
      }
      __syncwarp();  // the tile holds y
      for (int e = lane; e < ROWS * units; e += 32) {
        const int m = e / units;
        const int u = e - m * units;
        const long long p = p0 + m;
        if (p < P)
          *reinterpret_cast<uint4*>(out + p * C + 8 * u) =
              *reinterpret_cast<const uint4*>(X + m * ldx + 8 * u);
      }
    } else {
      // past C = 256: channel windows of 256 over the whole K each, y
      // stored from registers, 4 bytes a lane
      for (int c0 = 0; c0 < C; c0 += 256) {
        const int nf = min(256, C - c0) / 8;
        float acc[32][4];
#pragma unroll
        for (int f = 0; f < 32; ++f)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[f][r] = 0.f;
        for (int ks = 0; ks < C / 16; ++ks) {
          uint32_t a[4];
          ldmatrix_x4(a, X + (lane & 15) * ldx + 16 * ks + 8 * (lane >> 4));
#pragma unroll
          for (int r = 0; r < 4; ++r) a[r] = sq_bf16x2(a[r]);
#pragma unroll
          for (int f = 0; f < 32; ++f) {
            if (f < nf) {
              uint32_t b[2];
              gamma_frag(b, gamma_t, C, ks, c0 / 8 + f, g, t);
              mma_bf16(acc[f], a, b);
            }
          }
        }
#pragma unroll
        for (int f = 0; f < 32; ++f) {
          if (f < nf) {
            const int col = c0 + 8 * f + 2 * t;
            const float2 bb = *reinterpret_cast<const float2*>(sbeta + col);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const long long p = p0 + g + 8 * h;
              const uint32_t xp = *reinterpret_cast<const uint32_t*>(X + (g + 8 * h) * ldx + col);
              if (p < P)
                *reinterpret_cast<uint32_t*>(out + p * C + col) =
                    gdn_pair(xp, acc[f][2 * h], acc[f][2 * h + 1], bb, inverse);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

// The instance and block of K1's bf16 kernel at C channels: CMAX = C
// rounded up to 64 (0 past 256), 32-pixel warp tiles up to C = 128 (16
// past it), and up to 8 warps, as many as fit beside beta and gamma_t with
// their 2-slot rings.
struct K1bPlan {
  int cmax;
  int rows;
  int warps;
  size_t smem;
};

static K1bPlan k1b_plan(int C) {
  const int cmax = C > K1B_RESIDENT ? 0 : (C + 63) / 64 * 64;
  const int rows = cmax > 0 && cmax <= 128 ? 2 * K1B_ROWS : K1B_ROWS;
  const size_t tile = 2ull * 2 * rows * (C + 8);
  const size_t fixed = 4ull * C + (cmax > 0 ? 2ull * C * (C + 8) : 0);
  int warps = 8;
  while (warps > 0 && fixed + warps * tile > SMEM_LIMIT) --warps;
  return {cmax, rows, warps, fixed + warps * tile};
}

static bool rows_bf16_smem_set[5][64];

}  // namespace iclr17c

// Dynamic shared memory of K1's bf16 kernel at C channels.
extern "C" size_t iclr17c_gdn_bf16_smem_bytes(int C) { return iclr17c::k1b_plan(C).smem; }

// Launch K1's bf16 kernel on `stream`: x, out (P, C) bf16, gamma_t (C, C)
// bf16, beta (C,) fp32; C % 32 == 0, C <= 512. A persistent grid of
// ceil(tiles / warps) blocks at most, so that every block stages gamma_t
// for a warp's worth of 16-pixel tiles or more. Returns the cudaError_t of
// the launch (0 = success).
extern "C" int iclr17c_gdn_bf16(const void* x, const void* gamma_t, const float* beta,
                                void* out, long long P, int C, int inverse, void* stream) {
  using namespace iclr17c;
  if (x == nullptr || gamma_t == nullptr || beta == nullptr || out == nullptr || P <= 0 ||
      C <= 0 || C % 32 != 0 || C > 512)
    return cudaErrorInvalidValue;
  const K1bPlan plan = k1b_plan(C);
  if (plan.warps == 0) return cudaErrorInvalidValue;
  using Kernel = void (*)(const uint16_t*, const uint16_t*, const float*, uint16_t*, long long,
                          int, int);
  const int which = plan.cmax / 64;  // 0 (past 256) .. 4
  const Kernel kernels[5] = {gdn_rows_bf16_kernel<0, 1>, gdn_rows_bf16_kernel<64, 2>,
                             gdn_rows_bf16_kernel<128, 2>, gdn_rows_bf16_kernel<192, 1>,
                             gdn_rows_bf16_kernel<256, 1>};
  const Kernel kernel = kernels[which];
  cudaError_t err = allow_smem(kernel, rows_bf16_smem_set[which]);
  if (err != cudaSuccess) return err;
  const int threads = 32 * plan.warps;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, plan.smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long tiles = (P + plan.rows - 1) / plan.rows;
  long long blocks = (tiles + plan.warps - 1) / plan.warps;
  if (blocks > 1ll * per_sm * sms) blocks = 1ll * per_sm * sms;
  kernel<<<static_cast<unsigned int>(blocks), threads, plan.smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(gamma_t), beta,
      static_cast<uint16_t*>(out), P, C, inverse);
  return cudaGetLastError();
}
