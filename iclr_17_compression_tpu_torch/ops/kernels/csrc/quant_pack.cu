// K3: quantize, clamp and pack a latent into entropy-coder symbols, fp32.
//
// Replaces the Pallas kernel
// iclr_17_compression_tpu/ops/pallas/quant_pack_kernel.py (_qp_kernel,
// launched by quantize_pack_pallas). One elementwise pass:
//   sym = clip(round_half_even(x / step), -lim, lim)
//   symbols = uint8(sym + lim),  dequantized = sym * step
// rintf rounds half to even, as jnp.round and torch.round do (roundf would
// round half away from zero and change the symbols at +-0.5); x / step is
// the IEEE division, as in the plain version.
//
// Bound on an H100: 9 bytes of traffic and no real arithmetic per element,
// so memory, and at the Ballé-17 latent size (196,608 elements, 1.8 MB) the
// launch itself. A grid-stride loop of coalesced scalar accesses.

#include <cuda_runtime.h>
#include <cstdint>

namespace iclr17c {

__global__ void quant_pack_kernel(const float* __restrict__ x, uint8_t* __restrict__ sym,
                                  float* __restrict__ deq, long long n, float step,
                                  float lim) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float q = fminf(fmaxf(rintf(x[i] / step), -lim), lim);
    sym[i] = static_cast<uint8_t>(static_cast<int>(q + lim));
    deq[i] = q * step;
  }
}

}  // namespace iclr17c

// Launch K3 on `stream`. lim is an integer in [0, 127] (2*lim+1 symbols fit
// a byte). Returns the cudaError_t of the launch (0 = success).
extern "C" int iclr17c_quant_pack(const float* x, uint8_t* sym, float* deq, long long n,
                                  float step, int lim, void* stream) {
  if (n <= 0 || !(step > 0.f) || lim < 0 || 2 * lim + 1 > 256) return cudaErrorInvalidValue;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  iclr17c::quant_pack_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      x, sym, deq, n, step, static_cast<float>(lim));
  return cudaGetLastError();
}
