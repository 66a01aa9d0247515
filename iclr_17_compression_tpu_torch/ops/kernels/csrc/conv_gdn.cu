// K2: torch-semantics k x k stride-s convolution with bias and an optional
// (I)GDN epilogue, NHWC, fp32 accuracy, as an implicit GEMM on the tensor
// cores in 3xTF32.
//
// Replaces the Pallas kernel iclr_17_compression_tpu/ops/pallas/conv_gdn_kernel.py
// (_conv_gdn_kernel, launched by conv_gdn_fused_raw; chained three times by
// analysis17_fused into the Ballé-17 encoder). The TPU version phase-stacks
// the input to fill 128 lanes and double-buffers a halo DMA; neither serves
// here. The GEMM is
//   M = output pixels (BM = 64 a block), N = all of Cout (<= 256, so the GDN
//   of a pixel needs no other block), K = k*k*Cin in HWIO order (dy, dx, ci),
// and the HWIO weight is already the (K, Cout) row-major B matrix.
//
// Bound on an H100: the Ballé-17 stages need 1.5 to 5 GFLOP each against a
// few MB of traffic, so they are bound by operations: about 0.05 ms for the
// three stages at 768x512 counted at the TF32 peak (three products at
// 495 TFLOP/s). mma.sync does not reach that peak (it is wgmma's), and
// each operand is split into hi and lo in the loop, so the kernel is bound
// by the issue of the tensor-core products and of the splits. What the
// design does about it:
// - the products run on the tensor cores (mma.sync m16n8k8, 3xTF32; see
//   gdn_epilogue.cuh for the arithmetic and why it keeps fp32 accuracy);
//   8 warps at Cout = 128, each a 32 x 32 tile;
// - loads are a 4-stage ring of cp.async copies, one barrier and one wait a
//   32-deep K step. With Cin % 4 == 0 a pixel's row of a step is 16-byte
//   copies (for Cin >= 32 one tap x 32 channels: 128 contiguous bytes); the
//   padding halo is zero-filled by the copy. With Cin = 3 (the RGB input of
//   stage 1) the A tile is gathered with 4-byte copies instead, which costs
//   no extra pass over the image for a zero fourth channel and needs no
//   padded weight;
// - small stages split K: the wrapper picks S splits of whole taps
//   (conv_gdn_kernel.plan_splits) so that the grid fills the SMs in whole
//   waves; each split writes an fp32 partial tile to a (S, P, Cout) scratch,
//   and conv_gdn_reduce_kernel (gdn.cu) sums the S partials in fixed order,
//   adds the bias, runs the (I)GDN and stores once: no atomics, so two calls
//   give the same bits. The planner counts the blocks an SM holds at this
//   Cout (iclr17c_conv_gdn_blocks_per_sm): two at Cout = 128, one at 192
//   and 256, where a block needs 139 and 172 KB of shared memory;
// - without a split the bias and the GDN run on the register tile
//   (gdn_epilogue.cuh), and the result is staged through shared memory for
//   16-byte stores.
// The tile was chosen with nvcc -Xptxas -v: 8 warps of 32 x 32 at Cout = 128
// fit in 127 registers a thread with no spills, so two blocks share an SM
// (107 KB of shared memory each).
//
// bf16 storage (conv_gdn_bf16_kernel, the same body instantiated for bf16):
// x and the weight are bf16, the bias, gamma_t and beta fp32, as the Pallas
// wrapper hands them (conv_gdn_kernel.py:249-261). The conv products run as
// one bf16 mma.sync m16n8k16 pass with fp32 accumulators, each 32-deep K
// step summed from zero and added to the fp32 accumulator (no hi/lo split:
// bf16 products are exact in fp32); the bias, the 3xTF32 (I)GDN epilogue and
// the split-K partials stay fp32, and the store alone rounds to bf16. The
// ring holds bf16 tiles (a 32-deep step is 64 bytes of a pixel row): with
// Cin % 8 == 0 a pixel's row of a step is four 16-byte cp.async copies of 8
// channels (a tap of the blocked conv1's Cin = 48 is six of them, so a step
// straddles taps at whole copies); with Cin = 3 (6 bytes a pixel, which no
// cp.async size divides) the A tile is gathered with ordinary loads into
// shared memory. Bound: half the bytes of fp32, and the products at the
// bf16 dense rate, so operations at the Ballé-17 stages.

#include <cuda_runtime.h>

#include "gdn_epilogue.cuh"

namespace iclr17c {

constexpr int BM = 64;      // output pixels a block: 2 warps of 32
constexpr int STAGES = 4;   // depth of the cp.async ring
constexpr int LDKH = BK + 8;  // padded row of a bf16 [m][BK] tile (80 bytes)

// bf16 [k][C] B tile rows: C + 8 elements, 16-byte aligned for C % 8 == 0.
__host__ __device__ constexpr int ldbh_of(int C) { return C + 8; }

struct ConvArgs {
  const void* x;         // (N, H, W, Cin), fp32 or bf16
  const void* w;         // (ksz, ksz, Cin, C) HWIO = (K, C), as x
  const float* bias;     // (C,) or null
  const float* gamma_t;  // (C, C) or null: no GDN
  const float* beta;     // (C,)
  void* out;             // (N, Ho, Wo, C), as x
  float* part;           // (splits, P, C) when splits > 1
  int N, H, W, Cin, Ho, Wo, C, ksz, stride, pad_h, pad_w, splits, inverse;
};

// The ring, or after the main loop the output tile and a 2-slot gamma_t
// ring, in bytes; the ring of the bf16 variant holds bf16 tiles.
template <typename T>
static size_t conv_smem_bytes(int C) {
  const size_t ring = sizeof(T) == 4
      ? 4ull * STAGES * (BM * LDK + BK * ldb_of(C))
      : 2ull * STAGES * (BM * LDKH + BK * ldbh_of(C));
  const size_t epilogue = 4ull * (static_cast<size_t>(BM) * lda_of(C) + 2ull * BK * ldb_of(C));
  return ring > epilogue ? ring : epilogue;
}

// The kernel's body for element type T: float (3xTF32 products) or
// __nv_bfloat16 (bf16 products); the epilogue is fp32 for both.
template <typename T>
__device__ __forceinline__ void conv_gdn_body(const ConvArgs& a) {
  constexpr bool kBf16 = sizeof(T) == 2;
  extern __shared__ __align__(16) float smem[];
  __shared__ int pn[BM], piy[BM], pix[BM];  // per output pixel: image, top, left

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = WARP_M * (warp & 1);
  const int col0 = WARP_N * (warp >> 1);
  const int C = a.C;
  const int Cin = a.Cin;
  const int ldb = kBf16 ? ldbh_of(C) : ldb_of(C);
  const int lda = kBf16 ? LDKH : LDK;
  const int a_tile = BM * lda;
  const int stage = a_tile + BK * ldb;  // elements of T
  const T* const xg = static_cast<const T*>(a.x);
  const long long hw = static_cast<long long>(a.Ho) * a.Wo;
  const long long P = hw * a.N;
  const long long pix0 = static_cast<long long>(blockIdx.x) * BM;

  // this split's whole taps [t0, t1) of k*k, t0 = floor(split * taps / splits)
  const int taps = a.ksz * a.ksz;
  const int split = blockIdx.y;
  const int kbeg = static_cast<int>(static_cast<long long>(split) * taps / a.splits) * Cin;
  const int kend = static_cast<int>(static_cast<long long>(split + 1) * taps / a.splits) * Cin;
  const int steps = (kend - kbeg + BK - 1) / BK;

  for (int m = tid; m < BM; m += nthreads) {
    const long long p = pix0 + m;
    if (p < P) {
      const int n = static_cast<int>(p / hw);
      const int r = static_cast<int>(p - n * hw);
      pn[m] = n;
      piy[m] = (r / a.Wo) * a.stride - a.pad_h;
      pix[m] = (r % a.Wo) * a.stride - a.pad_w;
    } else {
      pn[m] = -1;
      piy[m] = 0;
      pix[m] = 0;
    }
  }
  __syncthreads();

  // the source of input element (pixel row m, K index kg), or null for zero
  auto a_src = [&](int m, int kg, int dy, int dx, int ci) -> const T* {
    const int n = pn[m];
    const int iy = piy[m] + dy;
    const int ix = pix[m] + dx;
    if (kg >= kend || n < 0 || iy < 0 || iy >= a.H || ix < 0 || ix >= a.W) return nullptr;
    return xg + ((static_cast<long long>(n) * a.H + iy) * a.W + ix) * Cin + ci;
  };

  auto load_stage = [&](int slot, int step) {
    const int k0 = kbeg + step * BK;
    if constexpr (!kBf16) {
      float* as = smem + slot * stage;
      load_rows_async(as + a_tile, ldb, static_cast<const float*>(a.w), k0, kend, BK, C, tid,
                      nthreads);
      if (Cin % 4 == 0) {
        // 8 copies of 16 bytes a pixel row; thread tid always takes unit tid % 8
        const int u = tid & 7;
        const int kg = k0 + 4 * u;
        const int tap = kg / Cin;
        const int ci = kg - tap * Cin;
        const int dy = tap / a.ksz;
        const int dx = tap - dy * a.ksz;
        for (int m = tid >> 3; m < BM; m += nthreads >> 3) {
          const float* src = a_src(m, kg, dy, dx, ci);
          cp_async16(as + m * LDK + 4 * u, src ? src : xg, src != nullptr);
        }
      } else {
        // one 4-byte copy an element; thread tid always takes column tid % 32
        const int kk = tid & 31;
        const int kg = k0 + kk;
        const int tap = kg / Cin;
        const int ci = kg - tap * Cin;
        const int dy = tap / a.ksz;
        const int dx = tap - dy * a.ksz;
        for (int m = tid >> 5; m < BM; m += nthreads >> 5) {
          const float* src = a_src(m, kg, dy, dx, ci);
          cp_async4(as + m * LDK + kk, src ? src : xg, src != nullptr);
        }
      }
    } else {
      uint16_t* as = reinterpret_cast<uint16_t*>(smem) + slot * stage;
      load_rows_async_bf16(as + a_tile, ldb, static_cast<const uint16_t*>(a.w), k0, kend, BK, C,
                           tid, nthreads);
      if (Cin % 8 == 0) {
        // 4 copies of 16 bytes (8 channels) a pixel row; thread tid always
        // takes unit tid % 4
        const int u = tid & 3;
        const int kg = k0 + 8 * u;
        const int tap = kg / Cin;
        const int ci = kg - tap * Cin;
        const int dy = tap / a.ksz;
        const int dx = tap - dy * a.ksz;
        for (int m = tid >> 2; m < BM; m += nthreads >> 2) {
          const T* src = a_src(m, kg, dy, dx, ci);
          cp_async16(as + m * LDKH + 8 * u, src ? src : xg, src != nullptr);
        }
      } else {
        // one ordinary 2-byte load an element (no cp.async size divides a
        // 6-byte RGB pixel); thread tid always takes column tid % 32. The
        // stores are visible after the barrier that precedes this slot's step.
        const int kk = tid & 31;
        const int kg = k0 + kk;
        const int tap = kg / Cin;
        const int ci = kg - tap * Cin;
        const int dy = tap / a.ksz;
        const int dx = tap - dy * a.ksz;
        for (int m = tid >> 5; m < BM; m += nthreads >> 5) {
          const T* src = a_src(m, kg, dy, dx, ci);
          as[m * LDKH + kk] = src ? __ldg(reinterpret_cast<const unsigned short*>(src)) : 0;
        }
      }
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;

  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load_stage(s, s);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step's tiles have landed; every warp is done with step - 1
    const int ahead = step + STAGES - 1;
    if (ahead < steps) load_stage(ahead % STAGES, ahead);
    cp_async_commit();
    if constexpr (!kBf16) {
      const float* as = smem + (step % STAGES) * stage;
      mma_chunk<false>(acc, as + row0 * LDK, LDK, as + a_tile + col0, ldb, lane);
    } else {
      const uint16_t* as = reinterpret_cast<const uint16_t*>(smem) + (step % STAGES) * stage;
      mma_chunk_bf16(acc, as + row0 * LDKH, LDKH, as + a_tile + col0, ldb, lane);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free

  const int ldt = lda_of(C);
  float* tile = smem;  // [BM][ldt] fp32, then the gamma_t ring
  if (a.splits > 1) {
    frag_to_smem(acc, tile + row0 * ldt + col0, ldt, lane);
    __syncthreads();
    store_rows(tile, ldt, a.part + split * P * C, pix0, P, BM, C, tid, nthreads);
    return;
  }
  if (a.bias != nullptr) {
    const int t = lane & 3;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const float b0 = a.bias[col0 + 8 * ni + 2 * t];
      const float b1 = a.bias[col0 + 8 * ni + 2 * t + 1];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        acc[mi][ni][0] += b0;
        acc[mi][ni][1] += b1;
        acc[mi][ni][2] += b0;
        acc[mi][ni][3] += b1;
      }
    }
  }
  if (a.gamma_t != nullptr) {
    frag_to_smem(acc, tile + row0 * ldt + col0, ldt, lane);
    float nrm[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) nrm[mi][ni][r] = 0.f;
    gdn_norm_streamed(nrm, tile + row0 * ldt, a.gamma_t, tile + BM * ldt, C, col0, tid,
                      nthreads, lane);
    gdn_apply(acc, nrm, a.beta, col0, a.inverse, lane);
    __syncthreads();  // every warp has read the tile as its A operand
  }
  frag_to_smem(acc, tile + row0 * ldt + col0, ldt, lane);
  __syncthreads();
  store_rows(tile, ldt, static_cast<T*>(a.out), pix0, P, BM, C, tid, nthreads);
}

__global__ void __launch_bounds__(512) conv_gdn_kernel(ConvArgs a) { conv_gdn_body<float>(a); }
__global__ void __launch_bounds__(512) conv_gdn_bf16_kernel(ConvArgs a) {
  conv_gdn_body<__nv_bfloat16>(a);
}

static bool conv_smem_set[64];
static bool conv_bf16_smem_set[64];

// Blocks of K2 (its bf16 variant with bf16) at C output channels that one SM
// holds at once (registers, threads and shared memory), for the wrapper's
// split-K plan.
static int blocks_per_sm(int C, bool bf16) {
  if (C <= 0 || C % 32 != 0 || C > 256) return -1;
  auto kernel = bf16 ? conv_gdn_bf16_kernel : conv_gdn_kernel;
  if (allow_smem(kernel, bf16 ? conv_bf16_smem_set : conv_smem_set) != cudaSuccess) return -1;
  const size_t smem = bf16 ? conv_smem_bytes<__nv_bfloat16>(C) : conv_smem_bytes<float>(C);
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 2 * C, smem) != cudaSuccess)
    return -1;
  return per_sm;
}

// Launch K2 (its bf16 variant with bf16) on `stream`: the conv kernel, and
// for splits > 1 the reduction (conv_gdn_reduce_kernel or its bf16-storing
// variant, gdn.cu).
static int launch_conv_gdn(bool bf16, const void* x, const void* w, const float* bias,
                           const float* gamma_t, const float* beta, void* out, float* partials,
                           int splits, int N, int H, int W, int Cin, int Ho, int Wo, int C,
                           int ksz, int stride, int pad_h, int pad_w, int gdn_on, int inverse,
                           void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Ho <= 0 || Wo <= 0 || Cin <= 0 || C <= 0 ||
      C % 32 != 0 || C > 256 || ksz <= 0 || stride <= 0 || pad_h < 0 || pad_w < 0 ||
      splits < 1 ||
      splits > ksz * ksz || splits > 65535 || (splits > 1 && partials == nullptr) ||
      (gdn_on && (gamma_t == nullptr || beta == nullptr)))
    return cudaErrorInvalidValue;
  auto kernel = bf16 ? conv_gdn_bf16_kernel : conv_gdn_kernel;
  cudaError_t err = allow_smem(kernel, bf16 ? conv_bf16_smem_set : conv_smem_set);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long P = static_cast<long long>(N) * Ho * Wo;
  const long long tiles = (P + BM - 1) / BM;
  const size_t smem = bf16 ? conv_smem_bytes<__nv_bfloat16>(C) : conv_smem_bytes<float>(C);
  ConvArgs a{x, w, bias, gdn_on ? gamma_t : nullptr, beta, out, partials,
             N, H, W, Cin, Ho, Wo, C, ksz, stride, pad_h, pad_w, splits, inverse};
  kernel<<<dim3(static_cast<unsigned int>(tiles), splits), 2 * C, smem, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess || splits == 1) return err;
  return gdn_rows_launch(partials, splits, P * C, bias, gdn_on ? gamma_t : nullptr, beta, out,
                         bf16, P, C, inverse, s);
}

}  // namespace iclr17c

extern "C" size_t iclr17c_conv_gdn_smem_bytes(int C) {
  return iclr17c::conv_smem_bytes<float>(C);
}
extern "C" size_t iclr17c_conv_gdn_smem_bytes_bf16(int C) {
  return iclr17c::conv_smem_bytes<__nv_bfloat16>(C);
}

// Blocks of K2 at C output channels that one SM holds at once (registers,
// threads and shared memory), for the wrapper's split-K plan.
extern "C" int iclr17c_conv_gdn_blocks_per_sm(int C) { return iclr17c::blocks_per_sm(C, false); }
extern "C" int iclr17c_conv_gdn_blocks_per_sm_bf16(int C) {
  return iclr17c::blocks_per_sm(C, true);
}

// Launch K2 on `stream`. x: (N, H, W, Cin); w: (ksz, ksz, Cin, C) HWIO;
// bias: (C,) or null; gamma_t (C, C) and beta (C,) are read only when gdn_on.
// pad_h / pad_w: the zero padding above and below / left and right (a tile
// that carries its neighbours' columns takes pad_w = 0). out: (N, Ho, Wo, C). With splits > 1, `partials` is a (splits, N*Ho*Wo, C)
// fp32 scratch and a second launch (conv_gdn_reduce_kernel, gdn.cu) reduces it.
// Returns the cudaError_t of the launches (0 = success).
extern "C" int iclr17c_conv_gdn(const float* x, const float* w, const float* bias,
                                const float* gamma_t, const float* beta, float* out,
                                float* partials, int splits, int N, int H, int W, int Cin,
                                int Ho, int Wo, int C, int ksz, int stride, int pad_h,
                                int pad_w, int gdn_on, int inverse, void* stream) {
  return iclr17c::launch_conv_gdn(false, x, w, bias, gamma_t, beta, out, partials, splits, N,
                                  H, W, Cin, Ho, Wo, C, ksz, stride, pad_h, pad_w, gdn_on,
                                  inverse, stream);
}

// K2's bf16 variant: x, w and out bf16; bias, gamma_t, beta and the
// partials fp32; the same shapes and return.
extern "C" int iclr17c_conv_gdn_bf16(const void* x, const void* w, const float* bias,
                                     const float* gamma_t, const float* beta, void* out,
                                     float* partials, int splits, int N, int H, int W, int Cin,
                                     int Ho, int Wo, int C, int ksz, int stride, int pad_h,
                                     int pad_w, int gdn_on, int inverse, void* stream) {
  return iclr17c::launch_conv_gdn(true, x, w, bias, gamma_t, beta, out, partials, splits, N, H,
                                  W, Cin, Ho, Wo, C, ksz, stride, pad_h, pad_w, gdn_on, inverse,
                                  stream);
}
