// Shared pieces of the K1 and K2 kernels: cp.async copies, the 3xTF32
// tensor-core product of one K chunk, and the (I)GDN epilogue.
//
// Tiles. A warp owns a 32-pixel x 32-channel tile of the output, held as
// 2 x 4 fragments of mma.sync.m16n8k8 (fp32 accumulators): element r of
// fragment (mi, ni) is pixel 16*mi + g + 8*(r >= 2), channel 8*ni + 2*t +
// (r & 1), with g = lane / 4 and t = lane % 4. A block is 1 or 2 warps of
// pixels times C / 32 warps of channels, so a pixel's C channels all live in
// one block and its GDN needs no other block (C % 32 == 0, C <= 256; K1
// past 256 has 8 warps walk the channels in passes of 256, C <= 512).
//
// Arithmetic: 3xTF32. Each fp32 operand is split as it is loaded into a
// fragment, hi = tf32(x) and lo = tf32(x - hi) (as cvt.rna: round to
// nearest, ties away from zero), and a product is lo*hi + hi*lo + hi*hi on
// the tensor cores, dropping only lo*lo (2^-22 relative). The tensor cores
// do not round their sums to nearest (PTX leaves mma's rounding of the
// accumulation unspecified), so a product carried through all of K = 3200
// (the Ballé-17 encoder's stage-2 depth) inside them drifts; the conv sums
// each 32-deep chunk from zero and adds it to an fp32 accumulator with a
// rounded add, which holds its tolerance against the plain version on the
// card (chip_smoke.py). One TF32 product alone is not enough: in a numpy
// emulation of the encoder stages (tests/test_torch_tf32.py) it reaches
// 6e-3 relative error where 3xTF32 stays under 1e-5.
//
// The GDN epilogue computes, for a tile y,
//   norm = beta + (y*y) . gamma_t      (gamma_t[j][i] = gamma[i][j])
//   y    = y / sqrt(norm)   (forward)  or  y * sqrt(norm)   (inverse)
// with the C x C product in 3xTF32 as above (y squared as it is loaded) and
// gamma_t read from shared memory: resident in K1 where it fits, else
// streamed 32 rows at a time (K2, and K1 at C = 256), and past C = 256 (K1
// only) streamed in column windows of 256, one pass of the block each.
//
// bf16 storage (the kernels' bf16 variants, whose products are K1's
// mma.sync m16n8k16 bf16 (mma_bf16) and K2's wgmma (hopper.cuh)): the
// epilogue (bias, norm, gdn_apply) stays fp32, and the stores round to bf16
// once. Conversions use the cuda_bf16.h intrinsics only.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace iclr17c {

constexpr int BK = 32;       // K rows of one chunk (one pipeline step)
constexpr int WARP_M = 32;   // pixels of a warp tile
constexpr int WARP_N = 32;   // channels of a warp tile
constexpr int LDK = BK + 4;  // padded row of an [m][BK] tile
constexpr size_t SMEM_LIMIT = 227 * 1024;  // dynamic shared memory a block may use

// Padded rows of shared tiles: an [m][C] tile (an mma A operand) has C + 4
// floats a row, a [k][C] tile (a B operand) C + 8, so that the fragment
// loads of a warp fall on 32 distinct banks and rows stay 16-byte aligned.
__host__ __device__ constexpr int lda_of(int C) { return C + 4; }
__host__ __device__ constexpr int ldb_of(int C) { return C + 8; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte (cg: bypass L1) and 4-byte copies to shared memory; an invalid
// source writes zeros (src-size 0) and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// hi = tf32(x), lo = tf32(x - hi), rounded to nearest with ties away from
// zero: adding half of the 13 dropped bits to the bit pattern and clearing
// them gives cvt.rna.tf32.f32's result on every finite pattern in two
// integer ops, which issue beside the mma more cheaply than the cvt.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float d[4], const uint32_t a[4], const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a . b for a 16 x 16 bf16 A fragment (a[0]: row g, k 2t..2t+1; a[1]:
// row g+8; a[2]: row g, k 2t+8..2t+9; a[3]: row g+8, k +8) and a 16 x 8 B
// fragment (b[0]: k 2t..2t+1, column g; b[1]: k 2t+8..2t+9), the lower
// half of each register the lower k; fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two bf16 bit patterns as one mma operand register, lo in the lower half.
__device__ __forceinline__ uint32_t pack_u16(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// A 32-bit word of two bf16 (lower half first) as floats.
__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t v) {
  __nv_bfloat162 h;
  *reinterpret_cast<uint32_t*>(&h) = v;
  return __bfloat1622float2(h);
}

// Two floats rounded to bf16 (to nearest even) as one 32-bit word.
__device__ __forceinline__ uint32_t float2_to_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Four consecutive channels of one pixel to device memory, 16 bytes.
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// acc += A . B over one BK-deep chunk, for one 32 x 32 warp tile, in 3xTF32. A points at the warp's first pixel row and the
// chunk's first column of an [m][k] tile (lda % 32 == 4); B at the chunk's
// first row and the warp's first channel of a [k][n] tile (ldb % 32 == 8).
// kGdn = false (the conv, K up to k*k*Cin): the chunk is summed from zero in
// the tensor cores and added to acc with a rounded fp32 add.
// kGdn = true (the GDN norm, K = C <= 512): the A operand is A*A (y*y), and
// the chunk accumulates into acc in the tensor cores directly: at this depth
// K1 stays within 3e-6 relative of its plain version on an H100
// (chip_smoke.py).
template <bool kGdn>
__device__ __forceinline__ void mma_chunk(float (&acc)[2][4][4], const float* A, int lda,
                                          const float* B, int ldb, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
  float part[2][4][4];
  if constexpr (!kGdn) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) part[mi][ni][r] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < BK; kk += 8) {
    uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const float* a = A + (16 * mi + g) * lda + kk + t;
      float v[4] = {a[0], a[8 * lda], a[4], a[8 * lda + 4]};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (kGdn) v[r] *= v[r];
        split_tf32(v[r], ah[mi][r], al[mi][r]);
      }
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const float* b = B + (kk + t) * ldb + 8 * ni + g;
      split_tf32(b[0], bh[ni][0], bl[ni][0]);
      split_tf32(b[4 * ldb], bh[ni][1], bl[ni][1]);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        float* d = kGdn ? acc[mi][ni] : part[mi][ni];
        mma_tf32(d, al[mi], bh[ni]);
        mma_tf32(d, ah[mi], bl[ni]);
        mma_tf32(d, ah[mi], bh[ni]);
      }
  }
  if constexpr (!kGdn) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mi][ni][r] += part[mi][ni][r];
  }
}

// A warp tile in fragment layout to / from an [m][c] shared tile; T points
// at the warp's first pixel row and first channel.
__device__ __forceinline__ void frag_to_smem(const float (&f)[2][4][4], float* T, int ldt,
                                             int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      float* p = T + (16 * mi + g) * ldt + 8 * ni + 2 * t;
      *reinterpret_cast<float2*>(p) = make_float2(f[mi][ni][0], f[mi][ni][1]);
      *reinterpret_cast<float2*>(p + 8 * ldt) = make_float2(f[mi][ni][2], f[mi][ni][3]);
    }
}
__device__ __forceinline__ void frag_from_smem(float (&f)[2][4][4], const float* T, int ldt,
                                               int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const float* p = T + (16 * mi + g) * ldt + 8 * ni + 2 * t;
      const float2 u = *reinterpret_cast<const float2*>(p);
      const float2 v = *reinterpret_cast<const float2*>(p + 8 * ldt);
      f[mi][ni][0] = u.x;
      f[mi][ni][1] = u.y;
      f[mi][ni][2] = v.x;
      f[mi][ni][3] = v.y;
    }
}

// Store a 32 x 32 warp tile (channels from col0) in fragment
// layout to out rows pix0 + m < P, 4 channels a thread (store4): lanes t and
// t ^ 1 swap halves so that one holds 4 channels of pixel g and the other 4
// of pixel g + 8.
__device__ __forceinline__ void frag_store_global(const float (&f)[2][4][4],
                                                  float* __restrict__ out, long long pix0,
                                                  long long P, int C, int col0, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
  const bool odd = t & 1;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      // even t keeps row g and takes its partner's row-g pair; odd t keeps row g + 8
      const float s0 = odd ? f[mi][ni][0] : f[mi][ni][2];
      const float s1 = odd ? f[mi][ni][1] : f[mi][ni][3];
      const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
      const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
      const float4 v = odd ? make_float4(r0, r1, f[mi][ni][2], f[mi][ni][3])
                           : make_float4(f[mi][ni][0], f[mi][ni][1], r0, r1);
      const long long p = pix0 + 16 * mi + g + (odd ? 8 : 0);
      if (p < P) store4(out + p * C + col0 + 8 * ni + 4 * (t >> 1), v);
    }
}

// Copy rows row0 .. row0+rows-1 of a row-major (nrows, C) array into T[m][c]
// (row stride ldt) with 16-byte cp.async; rows at or past nrows become zero.
// The caller commits the group.
__device__ __forceinline__ void load_rows_async(float* T, int ldt, const float* src,
                                                long long row0, long long nrows, int rows,
                                                int C, int tid, int nthreads) {
  const int units = C / 4;
  for (int e = tid; e < rows * units; e += nthreads) {
    const int m = e / units;
    const int u = e - m * units;
    const long long r = row0 + m;
    const bool ok = r < nrows;
    cp_async16(T + m * ldt + 4 * u, ok ? src + r * C + 4 * u : src, ok);
  }
}

// Store rows 0 .. rows-1 of T[m][c] to out rows pix0 + m < P, 4 channels a
// thread (store4).
__device__ __forceinline__ void store_rows(const float* T, int ldt, float* __restrict__ out,
                                           long long pix0, long long P, int rows, int C,
                                           int tid, int nthreads) {
  const int units = C / 4;
  for (int e = tid; e < rows * units; e += nthreads) {
    const int m = e / units;
    const int u = e - m * units;
    const long long p = pix0 + m;
    if (p < P) store4(out + p * C + 4 * u, *reinterpret_cast<const float4*>(T + m * ldt + 4 * u));
  }
}

// Copy rows row0 .. row0+rows-1, columns col_begin .. col_begin+cols-1 of
// a row-major (nrows, C) array into T[m][c] (row stride ldt) with 16-byte
// cp.async; rows at or past nrows become zero. The caller commits the group.
__device__ __forceinline__ void load_cols_async(float* T, int ldt, const float* src,
                                                long long row0, long long nrows, int rows,
                                                int C, int col_begin, int cols, int tid,
                                                int nthreads) {
  const int units = cols / 4;
  for (int e = tid; e < rows * units; e += nthreads) {
    const int m = e / units;
    const int u = e - m * units;
    const long long r = row0 + m;
    const bool ok = r < nrows;
    cp_async16(T + m * ldt + 4 * u, ok ? src + r * C + col_begin + 4 * u : src, ok);
  }
}

// nrm = (Y*Y) . gamma_t[:, c0 : c0 + cw] for one warp tile, that column
// window of gamma_t streamed from device memory 32 rows at a time through a
// 2-slot ring (2 * BK * ldb_of(cw) floats) with one barrier a chunk; the
// warp's channels are c0 + wcol .. c0 + wcol + 31 (wcol < cw). Y points at
// the warp's first pixel row of an [m][C] tile (stride lda_of(C)). Every
// thread of the block calls, and loads and waits; a warp with `active`
// false computes nothing (a last window narrower than the block). The sum
// runs over the chunks in order, so a second call gives the same bits. The
// first barrier inside also publishes the caller's writes of Y, and the
// ring must be free on entry. Waits for every cp.async group of the thread.
__device__ __forceinline__ void gdn_norm_window(float (&nrm)[2][4][4], const float* Y,
                                                const float* __restrict__ gamma_t,
                                                float* ring, int C, int c0, int cw, int wcol,
                                                bool active, int tid, int nthreads,
                                                int lane) {
  const int lda = lda_of(C);
  const int ldb = ldb_of(cw);
  const int slot = BK * ldb;
  const int chunks = C / BK;
  load_cols_async(ring, ldb, gamma_t, 0, C, BK, C, c0, cw, tid, nthreads);
  cp_async_commit();
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<0>();
    __syncthreads();  // chunk c has landed; every warp is done with chunk c-1
    if (c + 1 < chunks) {
      load_cols_async(ring + ((c + 1) & 1) * slot, ldb, gamma_t, (c + 1) * BK, C, BK, C, c0,
                      cw, tid, nthreads);
      cp_async_commit();
    }
    if (active) mma_chunk<true>(nrm, Y + c * BK, lda, ring + (c & 1) * slot + wcol, ldb, lane);
  }
}

// The whole of gamma_t's columns as one window (K2's epilogue, K1 at
// C = 256): the warp's channels are col0 .. col0 + 31.
__device__ __forceinline__ void gdn_norm_streamed(float (&nrm)[2][4][4], const float* Y,
                                                  const float* __restrict__ gamma_t,
                                                  float* ring, int C, int col0, int tid,
                                                  int nthreads, int lane) {
  gdn_norm_window(nrm, Y, gamma_t, ring, C, 0, C, col0, true, tid, nthreads, lane);
}

// y = y / sqrt(nrm + beta), or y * sqrt(nrm + beta) when inverse, for one
// warp tile whose first channel is col0 (rsqrtf: 2 ulp at most).
__device__ __forceinline__ void gdn_apply(float (&y)[2][4][4], const float (&nrm)[2][4][4],
                                          const float* __restrict__ beta, int col0,
                                          int inverse, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const float b0 = beta[col0 + 8 * ni + 2 * t];
    const float b1 = beta[col0 + 8 * ni + 2 * t + 1];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float n = nrm[mi][ni][r] + ((r & 1) ? b1 : b0);
        const float s = rsqrtf(n);
        y[mi][ni][r] *= inverse ? n * s : s;
      }
  }
}

// Launch a rows kernel of gdn.cu: out = (I)GDN(sum of `parts` (P, C)
// slices of src, `part_stride` floats apart, in order, plus bias), with the
// GDN skipped when gamma_t is null and the bias when bias is null. K1
// (gdn_rows_kernel) is parts = 1 without bias; K2's split-K reduction
// (conv_gdn_reduce_kernel) is parts = S.
cudaError_t gdn_rows_launch(const float* src, int parts, long long part_stride,
                            const float* bias, const float* gamma_t, const float* beta,
                            float* out, long long P, int C, int inverse, cudaStream_t stream);

// Raise a kernel's dynamic shared memory limit to what SMEM_LIMIT leaves
// beside its static shared memory, once a device.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, bool* done_by_device) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (done_by_device[dev]) return cudaSuccess;
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(SMEM_LIMIT - attr.sharedSizeBytes));
  if (err == cudaSuccess) done_by_device[dev] = true;
  return err;
}

}  // namespace iclr17c
