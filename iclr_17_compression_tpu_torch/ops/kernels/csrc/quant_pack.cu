// K3: quantize, clamp and pack a latent into entropy-coder symbols, fp32.
//
// Replaces the Pallas kernel
// iclr_17_compression_tpu/ops/pallas/quant_pack_kernel.py (_qp_kernel,
// launched by quantize_pack_pallas). One elementwise pass:
//   sym = clip(round_half_even(x / step), -lim, lim)
//   symbols = Sym(sym + lim),  dequantized = sym * step
// rintf rounds half to even, as jnp.round and torch.round do (roundf would
// round half away from zero and change the symbols at +-0.5); x / step is
// the IEEE division, as in the plain version. Sym is uint8_t (the Pallas
// kernel's contract, 2*lim+1 <= 256) or uint16_t (2*lim+1 <= 65536: the
// file codec's symbols at lim 32767, the range of the container's i16
// zmin/zmax header fields).
//
// Bound on an H100: 9 (or 10) bytes of traffic and no real arithmetic per
// element, so memory, and at the Ballé-17 latent size (196,608 elements,
// 1.8 MB) the launch itself. A grid-stride loop of coalesced scalar accesses.
//
// bf16 storage (quant_pack_bf16_kernel): _qp_kernel's arithmetic on a bf16
// x, where the Python floats 1/step and step meet bf16 arrays as bf16: v =
// bf16(x * bf16(1/step)) (the product of two bf16 is exact in fp32, so one
// rounding), sym = clip(rint(v), -lim, lim) with the integer lim, deq =
// bf16(sym * bf16(step)) (exact in fp32 below 2^16 symbols, one rounding).
// The wrapper passes bf16(1/step) and bf16(step) as floats. 5 (or 6) bytes
// an element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace iclr17c {

template <typename Sym>
__global__ void quant_pack_kernel(const float* __restrict__ x, Sym* __restrict__ sym,
                                  float* __restrict__ deq, long long n, float step,
                                  float lim) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float q = fminf(fmaxf(rintf(x[i] / step), -lim), lim);
    sym[i] = static_cast<Sym>(static_cast<int>(q + lim));
    deq[i] = q * step;
  }
}

template <typename Sym>
__global__ void quant_pack_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                                       Sym* __restrict__ sym, __nv_bfloat16* __restrict__ deq,
                                       long long n, float inv_step, float step, float lim) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float v = __bfloat162float(__float2bfloat16_rn(__bfloat162float(x[i]) * inv_step));
    const float q = fminf(fmaxf(rintf(v), -lim), lim);
    sym[i] = static_cast<Sym>(static_cast<int>(q + lim));
    deq[i] = __float2bfloat16_rn(q * step);
  }
}

// Blocks of a grid-stride launch over n elements, 256 threads each.
inline unsigned int qp_blocks(long long n) {
  long long blocks = (n + 255) / 256;
  if (blocks > 132 * 32) blocks = 132 * 32;
  return static_cast<unsigned int>(blocks);
}

template <typename Sym>
int launch_quant_pack_bf16(const void* x, Sym* sym, void* deq, long long n, float inv_step,
                           float step, int lim, void* stream) {
  constexpr long long kSymbols = 1LL << (8 * sizeof(Sym));
  if (n <= 0 || !(step > 0.f) || !(inv_step > 0.f) || lim < 0 || 2LL * lim + 1 > kSymbols) {
    return cudaErrorInvalidValue;
  }
  quant_pack_bf16_kernel<Sym><<<qp_blocks(n), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), sym, static_cast<__nv_bfloat16*>(deq), n, inv_step,
      step, static_cast<float>(lim));
  return cudaGetLastError();
}

template <typename Sym>
int launch_quant_pack(const float* x, Sym* sym, float* deq, long long n, float step, int lim,
                      void* stream) {
  constexpr long long kSymbols = 1LL << (8 * sizeof(Sym));
  if (n <= 0 || !(step > 0.f) || lim < 0 || 2LL * lim + 1 > kSymbols) {
    return cudaErrorInvalidValue;
  }
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  quant_pack_kernel<Sym><<<static_cast<unsigned int>(blocks), threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      x, sym, deq, n, step, static_cast<float>(lim));
  return cudaGetLastError();
}

// Does nothing: one launch of it is the floor under any kernel's time, what
// chip_smoke.py reports as launch_floor_ms and K3's bound takes when it is
// larger than the bytes' time.
__global__ void empty_kernel() {}

}  // namespace iclr17c

// Launch the empty kernel on `stream`. Returns the cudaError_t of the launch.
extern "C" int iclr17c_empty(void* stream) {
  iclr17c::empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}

// Launch K3 on `stream` with uint8 symbols: lim is an integer in [0, 127]
// (2*lim+1 symbols fit a byte). Returns the cudaError_t of the launch
// (0 = success).
extern "C" int iclr17c_quant_pack(const float* x, uint8_t* sym, float* deq, long long n,
                                  float step, int lim, void* stream) {
  return iclr17c::launch_quant_pack(x, sym, deq, n, step, lim, stream);
}

// The same with uint16 symbols: lim in [0, 32767].
extern "C" int iclr17c_quant_pack16(const float* x, uint16_t* sym, float* deq, long long n,
                                    float step, int lim, void* stream) {
  return iclr17c::launch_quant_pack(x, sym, deq, n, step, lim, stream);
}

// K3's bf16 variant: x and deq bf16, uint8 symbols; inv_step = bf16(1/step)
// and step = bf16(step) as floats.
extern "C" int iclr17c_quant_pack_bf16(const void* x, uint8_t* sym, void* deq, long long n,
                                       float inv_step, float step, int lim, void* stream) {
  return iclr17c::launch_quant_pack_bf16(x, sym, deq, n, inv_step, step, lim, stream);
}

// The same with uint16 symbols.
extern "C" int iclr17c_quant_pack16_bf16(const void* x, uint16_t* sym, void* deq, long long n,
                                         float inv_step, float step, int lim, void* stream) {
  return iclr17c::launch_quant_pack_bf16(x, sym, deq, n, inv_step, step, lim, stream);
}
