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
// bf16 storage (conv_gdn_bf16_kernel): x and the weight are bf16, the bias,
// gamma_t and beta fp32, as the Pallas wrapper hands them
// (conv_gdn_kernel.py:249-261); products accumulate in fp32, the bias and
// the (I)GDN epilogue run in fp32 (3xTF32 norm), and the store alone
// rounds to bf16. Bound: the products at the
// bf16 dense rate (989 TFLOP/s) and the norm as three TF32 products, against
// half the bytes of fp32: operations at every stage of the port's paths. A
// kernel of its own, designed for Hopper:
// - the products are wgmma.mma_async m64n64k16 (hopper.cuh) over 64-column
//   chunks of NT = Cout rounded up to 64 (all of Cout in one block, so a
//   pixel's GDN needs no other block), both operands K-major in 128-byte-
//   swizzled shared memory; the weight comes as (Cout, K) rows
//   (conv_gdn_kernel.k_major_weight). Each 64-deep step of a chunk is summed
//   from zero in the tensor cores and added to the fp32 sums with a rounded
//   add, as the fp32 kernel sums its 32-deep chunks: carried through all of
//   K (3200 at the Ballé conv2) the tensor cores' own sum drifted by up to
//   12 bf16 ulps from the plain version where the outputs cancel;
// - a block is BM = 64 or 128 output pixels: one consumer warpgroup a 64,
//   which share each B stage, and one producer warpgroup that runs up to 4
//   stages ahead through a ring of 64-deep K steps (128 bytes of a pixel
//   row), each stage guarded by a full and an empty mbarrier: the
//   producer's 16-byte cp.async copies arrive on the full barrier as they
//   land (cp.async.mbarrier.arrive.noinc), the consumers release a stage
//   once the products that read it are done. At BM = 64 two blocks share an
//   SM up to Cout = 128; BM = 128 reads each weight step once for twice the
//   pixels, one block an SM. The wrapper picks the tile
//   (conv_gdn_kernel.tile_bf16);
// - A is the implicit im2col: with Cin % 8 == 0 a 16-byte unit of a row is
//   8 channels of one tap, and the padding halo is zero-filled by the copy;
//   with Cin = 3 (6 bytes a pixel, which no cp.async size divides) the
//   producer gathers A with ordinary 2-byte loads, and B's copies zero-fill
//   past K (the weight's rows are ldw >= K apart, ldw % 8 == 0);
// - the epilogue runs on every warpgroup (the producer joins once its ring
//   is done): the consumers stage the fp32 tile (+ bias) in the ring's
//   memory, and all warps run the (I)GDN norm with gdn_epilogue.cuh's
//   3xTF32 chunks over its 32 x 32 warp tiles, gamma_t in shared memory;
//   the result is rounded to bf16 in place and stored 16 bytes a thread;
// - K is never split: a block sums all of it in a fixed order, no partials
//   reach device memory, and two calls give the same bits.

#include <cuda_runtime.h>

#include "gdn_epilogue.cuh"
#include "hopper.cuh"

namespace iclr17c {

constexpr int BM = 64;      // output pixels a block: 2 warps of 32
constexpr int STAGES = 4;   // depth of the cp.async ring

struct ConvArgs {
  const float* x;        // (N, H, W, Cin)
  const float* w;        // (ksz, ksz, Cin, C) HWIO = (K, C)
  const float* bias;     // (C,) or null
  const float* gamma_t;  // (C, C) or null: no GDN
  const float* beta;     // (C,)
  float* out;            // (N, Ho, Wo, C)
  float* part;           // (splits, P, C) when splits > 1
  int N, H, W, Cin, Ho, Wo, C, ksz, stride, pad_h, pad_w, splits, inverse;
};

// The ring, or after the main loop the output tile and a 2-slot gamma_t
// ring, in bytes.
static size_t conv_smem_bytes(int C) {
  const size_t ring = 4ull * STAGES * (BM * LDK + BK * ldb_of(C));
  const size_t epilogue = 4ull * (static_cast<size_t>(BM) * lda_of(C) + 2ull * BK * ldb_of(C));
  return ring > epilogue ? ring : epilogue;
}

__global__ void __launch_bounds__(512) conv_gdn_kernel(ConvArgs a) {
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
  const int ldb = ldb_of(C);
  const int a_tile = BM * LDK;
  const int stage = a_tile + BK * ldb;  // floats
  const float* const xg = a.x;
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
  auto a_src = [&](int m, int kg, int dy, int dx, int ci) -> const float* {
    const int n = pn[m];
    const int iy = piy[m] + dy;
    const int ix = pix[m] + dx;
    if (kg >= kend || n < 0 || iy < 0 || iy >= a.H || ix < 0 || ix >= a.W) return nullptr;
    return xg + ((static_cast<long long>(n) * a.H + iy) * a.W + ix) * Cin + ci;
  };

  auto load_stage = [&](int slot, int step) {
    const int k0 = kbeg + step * BK;
    float* as = smem + slot * stage;
    load_rows_async(as + a_tile, ldb, a.w, k0, kend, BK, C, tid, nthreads);
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
    const float* as = smem + (step % STAGES) * stage;
    mma_chunk<false>(acc, as + row0 * LDK, LDK, as + a_tile + col0, ldb, lane);
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
  store_rows(tile, ldt, a.out, pix0, P, BM, C, tid, nthreads);
}

static bool conv_smem_set[64];

// Blocks of K2 at C output channels that one SM holds at once (registers,
// threads and shared memory), for the wrapper's split-K plan.
static int blocks_per_sm(int C) {
  if (C <= 0 || C % 32 != 0 || C > 256) return -1;
  if (allow_smem(conv_gdn_kernel, conv_smem_set) != cudaSuccess) return -1;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conv_gdn_kernel, 2 * C,
                                                    conv_smem_bytes(C)) != cudaSuccess)
    return -1;
  return per_sm;
}

// Launch K2 on `stream`: the conv kernel, and for splits > 1 the reduction
// (conv_gdn_reduce_kernel, gdn.cu).
static int launch_conv_gdn(const float* x, const float* w, const float* bias,
                           const float* gamma_t, const float* beta, float* out, float* partials,
                           int splits, int N, int H, int W, int Cin, int Ho, int Wo, int C,
                           int ksz, int stride, int pad_h, int pad_w, int gdn_on, int inverse,
                           void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Ho <= 0 || Wo <= 0 || Cin <= 0 || C <= 0 ||
      C % 32 != 0 || C > 256 || ksz <= 0 || stride <= 0 || pad_h < 0 || pad_w < 0 ||
      splits < 1 ||
      splits > ksz * ksz || splits > 65535 || (splits > 1 && partials == nullptr) ||
      (gdn_on && (gamma_t == nullptr || beta == nullptr)))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(conv_gdn_kernel, conv_smem_set);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long P = static_cast<long long>(N) * Ho * Wo;
  const long long tiles = (P + BM - 1) / BM;
  ConvArgs a{x, w, bias, gdn_on ? gamma_t : nullptr, beta, out, partials,
             N, H, W, Cin, Ho, Wo, C, ksz, stride, pad_h, pad_w, splits, inverse};
  conv_gdn_kernel<<<dim3(static_cast<unsigned int>(tiles), splits), 2 * C, conv_smem_bytes(C),
                    s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess || splits == 1) return err;
  return gdn_rows_launch(partials, splits, P * C, bias, gdn_on ? gamma_t : nullptr, beta, out,
                         P, C, inverse, s);
}

// ---------------------------------------------------------------------------
// K2 bf16: the implicit GEMM on wgmma (see the head of the file).

constexpr int BKW = 64;    // K rows of one step: 128 bytes of bf16 in a pixel row
constexpr int ROWB = 128;  // bytes of one swizzled operand row

struct ConvBf16Args {
  const uint16_t* x;     // (N, H, W, Cin) bf16
  const uint16_t* wt;    // (C, K) bf16 rows ldw apart: the HWIO weight's columns, K-major
  const float* bias;     // (C,) or null
  const float* gamma_t;  // (C, C) or null: no GDN
  const float* beta;     // (C,)
  uint16_t* out;         // (N, Ho, Wo, C) bf16
  int N, H, W, Cin, Ho, Wo, C, ksz, stride, pad_h, pad_w;
  int inverse, ldw;
};

// The shape of a block: BM / 64 consumer warpgroups of 64 output pixels
// each, which share every B stage, and one producer warpgroup; NT = C
// rounded up to 64, the N of the products. At BM = 64 two blocks share an
// SM up to NT = 128 (their rings cut to what fits twice, 128 registers a
// thread), one past it (the sums of NT / 2 and a chunk's 32 registers a
// thread); at BM = 128 one block an SM (built for NT = 128 and 192: at 384
// threads an SM gives a thread 168 registers).
template <int NT, int BM>
struct Bf16Tile {
  static constexpr int NCT = 2 * BM;         // consumer threads: 128 a warpgroup
  static constexpr int THREADS = NCT + 128;  // and the producer warpgroup's
  static constexpr int NW = THREADS / 32;
  static constexpr int A_BYTES = BM * ROWB;
  static constexpr int STAGE = A_BYTES + NT * ROWB;
  static constexpr int MIN_BLOCKS = BM == 64 && NT <= 128 ? 2 : 1;
  static constexpr int BUDGET = MIN_BLOCKS == 2 ? 110 * 1024 : 220 * 1024;
  static constexpr int STAGES = BUDGET / STAGE < 4 ? BUDGET / STAGE : 4;
  // after the main loop the ring holds the fp32 output tile [BM][C + 4]
  // and gamma_t for the (I)GDN norm: all of it up to NT = 128, else a
  // 2-slot ring of 32 rows
  static constexpr bool GAMMA_RESIDENT = NT <= 128;
  static constexpr int EPILOGUE =
      4 * (BM * lda_of(NT) + (GAMMA_RESIDENT ? NT : 2 * BK) * ldb_of(NT));
  static constexpr int SMEM = (STAGES * STAGE > EPILOGUE ? STAGES * STAGE : EPILOGUE) + 1024;
  // 32 x 32 warp tiles of the epilogue a warp runs
  static constexpr int TPW = ((BM / 32) * (NT / 32) + NW - 1) / NW;
  static_assert(STAGES >= 3, "the ring needs 3 stages");
  static_assert(BM == 64 || BM == 128, "one or two consumer warpgroups");
};

// Store rows 0 .. rows-1 of a bf16 tile O (row stride ldo elements, a
// multiple of 8) to out rows pix0 + m < P, 16 bytes a thread.
__device__ __forceinline__ void store_rows_bf16(const uint16_t* O, int ldo,
                                                uint16_t* __restrict__ out, long long pix0,
                                                long long P, int rows, int C, int tid,
                                                int nthreads) {
  const int units = C / 8;
  for (int e = tid; e < rows * units; e += nthreads) {
    const int m = e / units;
    const int u = e - m * units;
    const long long p = pix0 + m;
    if (p < P)
      *reinterpret_cast<uint4*>(out + p * C + 8 * u) =
          *reinterpret_cast<const uint4*>(O + m * ldo + 8 * u);
  }
}

template <int NT, int BM>
__global__ void __launch_bounds__(Bf16Tile<NT, BM>::THREADS, Bf16Tile<NT, BM>::MIN_BLOCKS)
    conv_gdn_bf16_kernel(ConvBf16Args a) {
  using Tile = Bf16Tile<NT, BM>;
  constexpr int STAGES = Tile::STAGES;
  constexpr int NCT = Tile::NCT;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[STAGES], empty[STAGES];
  __shared__ long long poff[BM];  // per output pixel: x offset of its top-left tap
  __shared__ int piy[BM], pix[BM];  // and that tap's row and column (far out: none)
  uint8_t* const smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int tid = threadIdx.x;
  const int C = a.C;
  const int Cin = a.Cin;
  const long long hw = static_cast<long long>(a.Ho) * a.Wo;
  const long long P = hw * a.N;
  const long long pix0 = static_cast<long long>(blockIdx.x) * BM;
  const int K = a.ksz * a.ksz * Cin;
  const int steps = (K + BKW - 1) / BKW;

  if (tid < BM) {
    const long long p = pix0 + tid;
    if (p < P) {
      const int n = static_cast<int>(p / hw);
      const int r = static_cast<int>(p - n * hw);
      const int iy = (r / a.Wo) * a.stride - a.pad_h;
      const int ix = (r % a.Wo) * a.stride - a.pad_w;
      piy[tid] = iy;
      pix[tid] = ix;
      poff[tid] = ((static_cast<long long>(n) * a.H + iy) * a.W + ix) * Cin;
    } else {
      piy[tid] = -(1 << 28);
      pix[tid] = -(1 << 28);
      poff[tid] = 0;
    }
  }
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 128);
      mbar_init(&empty[s], NCT);
    }
    fence_mbar_init();
  }
  __syncthreads();

  float acc[NT / 64][32];  // the consumers' products
  if (tid >= NCT) {
    // ---- the producer warpgroup: the ring's B and A (im2col) tiles
    const int p = tid - NCT;
    const int u = p & 7;      // the 16-byte unit (8 K values) this thread copies
    const int r0 = p >> 3;    // its rows: r0 + 16 j
    const uint32_t swz = static_cast<uint32_t>((u ^ (r0 & 7)) << 4);
    const uint16_t* const wrow = a.wt + static_cast<long long>(r0) * a.ldw;
    const long long wstep = 16ll * a.ldw;  // 16 B rows further
    if (Cin % 8 == 0) {
      // 8 channels of one tap a copy, the padding halo zero-filled; the
      // unit's K index walks as (dy, dx, ci), 64 a step
      long long off[BM / 16];
      int ry[BM / 16], rx[BM / 16];
#pragma unroll
      for (int j = 0; j < BM / 16; ++j) {
        off[j] = poff[r0 + 16 * j];
        ry[j] = piy[r0 + 16 * j];
        rx[j] = pix[r0 + 16 * j];
      }
      int kg = 8 * u;
      int tap = kg / Cin;
      int ci = kg - tap * Cin;
      int dy = tap / a.ksz;
      int dx = tap - dy * a.ksz;
      for (int step = 0; step < steps; ++step) {
        const int s = step % STAGES;
        mbar_wait(&empty[s], ((step / STAGES) & 1) ^ 1);
        uint8_t* const as = smem + s * Tile::STAGE;
        uint8_t* const bs = as + Tile::A_BYTES;
#pragma unroll
        for (int j = 0; j < NT / 16; ++j) {
          const bool ok = r0 + 16 * j < C && kg < K;
          cp_async16(bs + (r0 + 16 * j) * ROWB + swz, ok ? wrow + j * wstep + kg : a.wt, ok);
        }
        const long long tap_off = static_cast<long long>(dy * a.W + dx) * Cin + ci;
#pragma unroll
        for (int j = 0; j < BM / 16; ++j) {
          const bool ok = kg < K &&
                          static_cast<unsigned>(ry[j] + dy) < static_cast<unsigned>(a.H) &&
                          static_cast<unsigned>(rx[j] + dx) < static_cast<unsigned>(a.W);
          cp_async16(as + (r0 + 16 * j) * ROWB + swz, ok ? a.x + off[j] + tap_off : a.x, ok);
        }
        mbar_arrive_cp_async(&full[s]);
        kg += BKW;
        for (ci += BKW; ci >= Cin; ci -= Cin)
          if (++dx == a.ksz) {
            dx = 0;
            ++dy;
          }
      }
    } else {
      // Cin = 3 (6 bytes a pixel, which no cp.async size divides): B as
      // above, the copy zero-filling past K (K = 243 or 75 is no multiple
      // of 8: the weight's rows are ldw >= K apart); thread p gathers A's
      // rows p / 2 (+ 64), K columns 32 (p % 2) .. + 31 of a step, with
      // ordinary 2-byte loads, all of a row in flight at once, and stores
      // them as four 16-byte units
      const int half = p & 1;
      for (int step = 0; step < steps; ++step) {
        const int s = step % STAGES;
        mbar_wait(&empty[s], ((step / STAGES) & 1) ^ 1);
        uint8_t* const as = smem + s * Tile::STAGE;
        uint8_t* const bs = as + Tile::A_BYTES;
        const int k0 = step * BKW;
        const int kgb = k0 + 8 * u;
        const int bbytes = kgb < K ? 2 * min(8, K - kgb) : 0;
#pragma unroll
        for (int j = 0; j < NT / 16; ++j) {
          const bool ok = r0 + 16 * j < C && bbytes > 0;
          cp_async16_part(bs + (r0 + 16 * j) * ROWB + swz, ok ? wrow + j * wstep + kgb : a.wt,
                          ok ? bbytes : 0);
        }
        const int kq0 = k0 + 32 * half;
        const int tap0 = kq0 / Cin;
        const int ci0 = kq0 - tap0 * Cin;
#pragma unroll
        for (int i = 0; i < BM / 64; ++i) {
          const int m = (p >> 1) + 64 * i;
          const long long off = poff[m];
          const int ry = piy[m];
          const int rx = pix[m];
          int ci = ci0;
          int dy = tap0 / a.ksz;
          int dx = tap0 - dy * a.ksz;
          uint32_t v[16];
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            const bool ok = kq0 + e < K &&
                            static_cast<unsigned>(ry + dy) < static_cast<unsigned>(a.H) &&
                            static_cast<unsigned>(rx + dx) < static_cast<unsigned>(a.W);
            const long long at = off + static_cast<long long>(dy * a.W + dx) * Cin + ci;
            const uint32_t h =
                ok ? __ldg(reinterpret_cast<const unsigned short*>(a.x + at)) : 0u;
            v[e >> 1] = (e & 1) ? v[e >> 1] | (h << 16) : h;
            if (++ci == Cin) {
              ci = 0;
              if (++dx == a.ksz) {
                dx = 0;
                ++dy;
              }
            }
          }
#pragma unroll
          for (int q = 0; q < 4; ++q)
            *reinterpret_cast<uint4*>(as + m * ROWB + (((4 * half + q) ^ (m & 7)) << 4)) =
                make_uint4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
        }
        cp_async_wait_all();  // this thread's B copies have landed
        fence_proxy_async();  // its A stores are ordered before the products' reads
        mbar_arrive(&full[s]);
      }
    }
    cp_async_wait_all();
  } else {
    // ---- the consumer warpgroups: 64 output pixels x NT channels each
    const uint32_t a_off = static_cast<uint32_t>((tid >> 7) * 64 * ROWB);
#pragma unroll
    for (int j = 0; j < NT / 64; ++j)
#pragma unroll
      for (int r = 0; r < 32; ++r) acc[j][r] = 0.f;
    // each step's 64-deep sum of a 64-column chunk is taken in the tensor
    // cores from zero and added to acc with a rounded fp32 add: a chain
    // carried through all of K inside them (K = 3200 at the Ballé conv2)
    // drifts by up to 12 bf16 ulps at outputs that cancel
    float part[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) part[r] = 0.f;
    for (int step = 0; step < steps; ++step) {
      const int s = step % STAGES;
      mbar_wait(&full[s], (step / STAGES) & 1);
      fence_proxy_async();
      const uint8_t* const as = smem + s * Tile::STAGE;
      const uint64_t da = sw128_desc(smem_u32(as) + a_off);
      const uint64_t db = sw128_desc(smem_u32(as + Tile::A_BYTES));
#pragma unroll
      for (int j = 0; j < NT / 64; ++j) {
        fence_regs(part);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BKW / 16; ++kk)
          wgmma_m64n64k16(part, da + 2 * kk, db + 2 * kk + j * ((64 * ROWB) >> 4), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(part);
#pragma unroll
        for (int r = 0; r < 32; ++r) acc[j][r] += part[r];
      }
      mbar_arrive(&empty[s]);  // the products are done with this stage
    }
  }
  __syncthreads();  // the products are done, the last copies have landed: the ring is free

  // ---- the epilogue, in fp32, every warpgroup: bias, (I)GDN, one rounding
  // to bf16 at the store; the consumers stage their products
  const bool consumer = tid < NCT;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row = 16 * warp + g;  // and row + 8 (a consumer's: warpgroup w's rows 64 w ..)
  const bool bias_on = a.bias != nullptr;
  if (a.gamma_t == nullptr) {
    // no GDN: acc + bias rounded to bf16 pairs in a [BM][C + 8] tile
    uint16_t* O = reinterpret_cast<uint16_t*>(smem);
    const int ldo = C + 8;
    if (consumer) {
#pragma unroll
      for (int j = 0; j < NT / 64; ++j)
#pragma unroll
        for (int jb = 0; jb < 8; ++jb) {
          const int col = 64 * j + 8 * jb + 2 * t;
          if (col < C) {
            const float b0 = bias_on ? a.bias[col] : 0.f;
            const float b1 = bias_on ? a.bias[col + 1] : 0.f;
            *reinterpret_cast<uint32_t*>(O + row * ldo + col) =
                float2_to_bf16x2(acc[j][4 * jb] + b0, acc[j][4 * jb + 1] + b1);
            *reinterpret_cast<uint32_t*>(O + (row + 8) * ldo + col) =
                float2_to_bf16x2(acc[j][4 * jb + 2] + b0, acc[j][4 * jb + 3] + b1);
          }
        }
    }
    __syncthreads();
    store_rows_bf16(O, ldo, a.out, pix0, P, BM, C, tid, Tile::THREADS);
    return;
  }
  // acc (+ bias) as an fp32 [BM][C + 4] tile
  float* T = reinterpret_cast<float*>(smem);
  const int ldt = lda_of(C);
  if (consumer) {
#pragma unroll
    for (int j = 0; j < NT / 64; ++j)
#pragma unroll
      for (int jb = 0; jb < 8; ++jb) {
        const int col = 64 * j + 8 * jb + 2 * t;
        if (col < C) {
          const float b0 = bias_on ? a.bias[col] : 0.f;
          const float b1 = bias_on ? a.bias[col + 1] : 0.f;
          *reinterpret_cast<float2*>(T + row * ldt + col) =
              make_float2(acc[j][4 * jb] + b0, acc[j][4 * jb + 1] + b1);
          *reinterpret_cast<float2*>(T + (row + 8) * ldt + col) =
              make_float2(acc[j][4 * jb + 2] + b0, acc[j][4 * jb + 3] + b1);
        }
      }
  }
  __syncthreads();
  // The (I)GDN of the tile: its BM/32 x C/32 warp tiles of 32 x 32, at most
  // TPW a warp, the norm in 3xTF32 (gdn_epilogue.cuh) over gamma_t in
  // shared memory, all of it at once up to NT = 128, else streamed 32 rows
  // at a time through a 2-slot ring; then the tile is rounded to bf16 in
  // place, in the first half of each row's bytes, once every warp is done
  // reading it.
  constexpr int NW = Tile::NW;
  constexpr int TPW = Tile::TPW;
  const int ct_n = C / 32;
  const int tiles = (BM / 32) * ct_n;
  const int ldb = ldb_of(C);
  const int slot = BK * ldb;
  const int chunks = C / BK;
  float* const ring = T + BM * ldt;
  float nrm[TPW][2][4][4];
#pragma unroll
  for (int i = 0; i < TPW; ++i)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) nrm[i][mi][ni][r] = 0.f;
  load_cols_async(ring, ldb, a.gamma_t, 0, C, Tile::GAMMA_RESIDENT ? C : BK, C, 0, C, tid,
                  Tile::THREADS);
  cp_async_commit();
  for (int c = 0; c < chunks; ++c) {
    if (!Tile::GAMMA_RESIDENT || c == 0) {
      cp_async_wait<0>();
      __syncthreads();  // chunk c has landed; every warp is done with chunk c - 1
    }
    if (!Tile::GAMMA_RESIDENT && c + 1 < chunks) {
      load_cols_async(ring + ((c + 1) & 1) * slot, ldb, a.gamma_t, (c + 1) * BK, C, BK, C, 0, C,
                      tid, Tile::THREADS);
      cp_async_commit();
    }
    const float* const gc = ring + (Tile::GAMMA_RESIDENT ? c : c & 1) * slot;
#pragma unroll
    for (int i = 0; i < TPW; ++i) {
      const int q = warp + i * NW;
      if (q < tiles)
        mma_chunk<true>(nrm[i], T + 32 * (q / ct_n) * ldt + c * BK, ldt, gc + 32 * (q % ct_n),
                        ldb, lane);
    }
  }
  __syncthreads();  // every warp is done reading the tile and the ring
  uint32_t packed[TPW][2][4][2];
#pragma unroll
  for (int i = 0; i < TPW; ++i) {
    const int q = warp + i * NW;
    if (q < tiles) {
      const int ct = q % ct_n;
      float y[2][4][4];
      frag_from_smem(y, T + 32 * (q / ct_n) * ldt + 32 * ct, ldt, lane);
      gdn_apply(y, nrm[i], a.beta, 32 * ct, a.inverse, lane);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          packed[i][mi][ni][0] = float2_to_bf16x2(y[mi][ni][0], y[mi][ni][1]);
          packed[i][mi][ni][1] = float2_to_bf16x2(y[mi][ni][2], y[mi][ni][3]);
        }
    }
  }
  __syncthreads();  // every warp has read its fp32 tiles
  uint16_t* const Tb = reinterpret_cast<uint16_t*>(T);
  const int ldo = 2 * ldt;
#pragma unroll
  for (int i = 0; i < TPW; ++i) {
    const int q = warp + i * NW;
    if (q < tiles) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          uint16_t* o =
              Tb + (32 * (q / ct_n) + 16 * mi + g) * ldo + 32 * (q % ct_n) + 8 * ni + 2 * t;
          *reinterpret_cast<uint32_t*>(o) = packed[i][mi][ni][0];
          *reinterpret_cast<uint32_t*>(o + 8 * ldo) = packed[i][mi][ni][1];
        }
    }
  }
  __syncthreads();
  store_rows_bf16(Tb, ldo, a.out, pix0, P, BM, C, tid, Tile::THREADS);
}

// Run fn.run<NT, BM>() for the kernel's instance at C output channels and a
// BM-pixel tile: NT = C rounded up to 64 (B rows past C are zero); BM = 128
// is built for NT = 128 and 192.
template <typename Fn>
static cudaError_t dispatch_bf16(int C, int bm, const Fn& fn) {
  if (bm == 64) {
    switch ((C + 63) / 64) {
      case 1: return fn.template run<64, 64>();
      case 2: return fn.template run<128, 64>();
      case 3: return fn.template run<192, 64>();
      case 4: return fn.template run<256, 64>();
    }
  } else if (bm == 128) {
    switch ((C + 63) / 64) {
      case 2: return fn.template run<128, 128>();
      case 3: return fn.template run<192, 128>();
    }
  }
  return cudaErrorInvalidValue;
}

struct LaunchBf16 {
  const ConvBf16Args& a;
  long long P;
  cudaStream_t s;
  template <int NT, int BM>
  cudaError_t run() const {
    static bool smem_set[64];
    const cudaError_t err = allow_smem(conv_gdn_bf16_kernel<NT, BM>, smem_set);
    if (err != cudaSuccess) return err;
    conv_gdn_bf16_kernel<NT, BM><<<static_cast<unsigned int>((P + BM - 1) / BM),
                                   Bf16Tile<NT, BM>::THREADS, Bf16Tile<NT, BM>::SMEM, s>>>(a);
    return cudaGetLastError();
  }
};

struct SmemBf16 {
  size_t* bytes;
  template <int NT, int BM>
  cudaError_t run() const {
    *bytes = Bf16Tile<NT, BM>::SMEM;
    return cudaSuccess;
  }
};

static int launch_conv_gdn_bf16(const void* x, const void* wt, const float* bias,
                                const float* gamma_t, const float* beta, void* out, int bm,
                                int ldw, int N, int H, int W, int Cin, int Ho, int Wo, int C,
                                int ksz, int stride, int pad_h, int pad_w, int gdn_on,
                                int inverse, void* stream) {
  const int K = ksz * ksz * Cin;
  if (N <= 0 || H <= 0 || W <= 0 || Ho <= 0 || Wo <= 0 || Cin <= 0 || C <= 0 ||
      C % 32 != 0 || C > 256 || ksz <= 0 || stride <= 0 || pad_h < 0 || pad_w < 0 ||
      ldw < K || ldw % 8 != 0 || (gdn_on && (gamma_t == nullptr || beta == nullptr)))
    return cudaErrorInvalidValue;
  const ConvBf16Args a{static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(wt), bias,
                       gdn_on ? gamma_t : nullptr, beta, static_cast<uint16_t*>(out),
                       N, H, W, Cin, Ho, Wo, C, ksz, stride, pad_h, pad_w, inverse, ldw};
  return dispatch_bf16(C, bm, LaunchBf16{a, static_cast<long long>(N) * Ho * Wo,
                                         static_cast<cudaStream_t>(stream)});
}

}  // namespace iclr17c

extern "C" size_t iclr17c_conv_gdn_smem_bytes(int C) { return iclr17c::conv_smem_bytes(C); }

// Dynamic shared memory of K2's bf16 kernel at C output channels and a
// bm-pixel tile (0 for a C or bm it does not take).
extern "C" size_t iclr17c_conv_gdn_smem_bytes_bf16(int C, int bm) {
  size_t bytes = 0;
  if (C <= 0 || C % 32 != 0 || C > 256) return 0;
  iclr17c::dispatch_bf16(C, bm, iclr17c::SmemBf16{&bytes});
  return bytes;
}

// Blocks of K2 at C output channels that one SM holds at once (registers,
// threads and shared memory), for the wrapper's split-K plan.
extern "C" int iclr17c_conv_gdn_blocks_per_sm(int C) { return iclr17c::blocks_per_sm(C); }

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
  return iclr17c::launch_conv_gdn(x, w, bias, gamma_t, beta, out, partials, splits, N, H, W,
                                  Cin, Ho, Wo, C, ksz, stride, pad_h, pad_w, gdn_on, inverse,
                                  stream);
}

// K2's bf16 kernel: x and out bf16 (shapes as above); wt the weight as C
// bf16 rows ldw apart (ldw >= K = ksz*ksz*Cin, ldw % 8 == 0), row c = the
// HWIO weight's column c in (dy, dx, ci) order (what lies past K is not
// read); bias, gamma_t and beta fp32; bm the output pixels of a block, 64
// or (64 < C <= 192) 128. Returns the cudaError_t of the launch (0 = success).
extern "C" int iclr17c_conv_gdn_bf16(const void* x, const void* wt, const float* bias,
                                     const float* gamma_t, const float* beta, void* out, int bm,
                                     int ldw, int N, int H, int W, int Cin, int Ho, int Wo,
                                     int C, int ksz, int stride, int pad_h, int pad_w,
                                     int gdn_on, int inverse, void* stream) {
  return iclr17c::launch_conv_gdn_bf16(x, wt, bias, gamma_t, beta, out, bm, ldw, N, H, W, Cin,
                                       Ho, Wo, C, ksz, stride, pad_h, pad_w, gdn_on, inverse,
                                       stream);
}
