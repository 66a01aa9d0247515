// rANS entropy coder, host side (the port's copy of iclr_17_compression_tpu/coding/src/rans.cc).
//
// The reference imports CompressAI's C++ rANS backend but never uses it,
// measuring rate with gzip instead (SURVEY.md §2.6). This is a from-scratch
// byte-oriented rANS implementing the standard construction (Duda 2013):
//
//   encode:  x' = floor(x / f) << k | (x mod f) + c
//   decode:  s  = sym[x & (M-1)];  x = f * (x >> k) + (x & (M-1)) - c
//
// with 32-bit state, byte renormalization, lower bound L = 1<<23, and
// frequency tables quantized to M = 1<<scale_bits. Tables are per-channel
// ("indexed" API): each element carries a table id, so one call codes a
// whole latent tensor with per-channel CDFs produced on-device by the
// BitEstimator. Encoding runs in reverse so decode emits symbols forward.
//
// C ABI for ctypes. Thread-safe (no globals).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint32_t kRansL = 1u << 23;  // lower bound of the state interval

struct EncSym {
  uint32_t freq;
  uint32_t cum;
};

}  // namespace

extern "C" {

// Encode n symbols with per-element table ids.
//   symbols   : n entries in [0, nsym)
//   table_ids : n entries in [0, ntables)
//   freqs/cums: ntables * nsym row-major; cums[t][s] = sum_{u<s} freqs[t][u];
//               sum of each row of freqs must be 1<<scale_bits, freqs > 0.
// Returns number of bytes written to out, or -1 on overflow / bad input.
int rans_encode_indexed(const int32_t* symbols, const int32_t* table_ids,
                        int64_t n, const uint32_t* freqs, const uint32_t* cums,
                        int32_t nsym, int32_t ntables, int32_t scale_bits,
                        uint8_t* out, int64_t out_capacity) {
  if (scale_bits < 1 || scale_bits > 16) return -1;
  std::vector<uint8_t> buf;
  buf.reserve(static_cast<size_t>(n) + 16);

  uint32_t x = kRansL;
  // rANS encodes in reverse symbol order.
  for (int64_t i = n - 1; i >= 0; --i) {
    const int32_t s = symbols[i];
    const int32_t t = table_ids[i];
    if (s < 0 || s >= nsym || t < 0 || t >= ntables) return -1;
    const uint32_t f = freqs[static_cast<int64_t>(t) * nsym + s];
    const uint32_t c = cums[static_cast<int64_t>(t) * nsym + s];
    if (f == 0) return -1;
    // renormalize: keep x < ((L >> scale_bits) << 8) * f after encoding
    const uint32_t x_max = ((kRansL >> scale_bits) << 8) * f;
    while (x >= x_max) {
      buf.push_back(static_cast<uint8_t>(x & 0xff));
      x >>= 8;
    }
    x = ((x / f) << scale_bits) + (x % f) + c;
  }
  // flush state (4 bytes, little-endian order reversed like the stream)
  for (int j = 0; j < 4; ++j) {
    buf.push_back(static_cast<uint8_t>(x & 0xff));
    x >>= 8;
  }
  const int64_t total = static_cast<int64_t>(buf.size());
  if (total > out_capacity) return -1;
  // stream was built back-to-front; reverse into output
  for (int64_t i = 0; i < total; ++i) out[i] = buf[total - 1 - i];
  return static_cast<int>(total);
}

// Decode n symbols (forward order). Same tables as encode.
// Returns 0 on success, -1 on error.
// ---------------------------------------------------------------------------
// Stateful streaming decoder.
//
// The autoregressive (context-model) codec cannot present all table ids up
// front: the CDF table for symbol i is chosen from symbols < i (the masked
// conv context). This object holds the rANS state between calls so the host
// raster-scan loop can alternate  "compute (mu, sigma) from decoded pixels"
// and "decode the next C symbols".  Tables are copied at create time.
// ---------------------------------------------------------------------------

namespace {

struct RansDec {
  std::vector<uint8_t> stream;
  std::vector<uint32_t> freqs;   // ntables * nsym
  std::vector<uint32_t> cums;    // ntables * nsym
  std::vector<int32_t> slot2sym; // ntables << scale_bits
  int32_t nsym = 0;
  int32_t ntables = 0;
  int32_t scale_bits = 0;
  int64_t pos = 0;
  uint32_t x = 0;
};

}  // namespace

void* rans_dec_create(const uint8_t* in, int64_t in_size,
                      const uint32_t* freqs, const uint32_t* cums,
                      int32_t nsym, int32_t ntables, int32_t scale_bits) {
  if (scale_bits < 1 || scale_bits > 16) return nullptr;
  RansDec* d = new RansDec();
  d->stream.assign(in, in + in_size);
  d->freqs.assign(freqs, freqs + static_cast<int64_t>(ntables) * nsym);
  d->cums.assign(cums, cums + static_cast<int64_t>(ntables) * nsym);
  d->nsym = nsym;
  d->ntables = ntables;
  d->scale_bits = scale_bits;
  d->slot2sym.resize(static_cast<size_t>(ntables) << scale_bits);
  for (int32_t t = 0; t < ntables; ++t) {
    int64_t base = static_cast<int64_t>(t) << scale_bits;
    for (int32_t s = 0; s < nsym; ++s) {
      const uint32_t f = d->freqs[static_cast<int64_t>(t) * nsym + s];
      const uint32_t c = d->cums[static_cast<int64_t>(t) * nsym + s];
      for (uint32_t u = 0; u < f; ++u) d->slot2sym[base + c + u] = s;
    }
  }
  d->pos = 0;
  d->x = 0;
  for (int j = 0; j < 4; ++j) {
    uint32_t b = d->pos < in_size ? d->stream[d->pos++] : 0u;
    d->x = (d->x << 8) | b;
  }
  return d;
}

// Decode the next n symbols (forward order) with the given table ids.
// Returns 0 on success, -1 on error.
int rans_dec_step(void* dec, const int32_t* table_ids, int64_t n,
                  int32_t* symbols_out) {
  RansDec* d = static_cast<RansDec*>(dec);
  if (d == nullptr) return -1;
  const uint32_t mask = (1u << d->scale_bits) - 1;
  const int64_t in_size = static_cast<int64_t>(d->stream.size());
  for (int64_t i = 0; i < n; ++i) {
    const int32_t t = table_ids[i];
    if (t < 0 || t >= d->ntables) return -1;
    const uint32_t slot = d->x & mask;
    const int32_t s =
        d->slot2sym[(static_cast<int64_t>(t) << d->scale_bits) + slot];
    const uint32_t f = d->freqs[static_cast<int64_t>(t) * d->nsym + s];
    const uint32_t c = d->cums[static_cast<int64_t>(t) * d->nsym + s];
    d->x = f * (d->x >> d->scale_bits) + slot - c;
    while (d->x < kRansL) {
      uint32_t b = d->pos < in_size ? d->stream[d->pos++] : 0u;
      d->x = (d->x << 8) | b;
    }
    symbols_out[i] = s;
  }
  return 0;
}

void rans_dec_free(void* dec) { delete static_cast<RansDec*>(dec); }

int rans_decode_indexed(const uint8_t* in, int64_t in_size,
                        const int32_t* table_ids, int64_t n,
                        const uint32_t* freqs, const uint32_t* cums,
                        int32_t nsym, int32_t ntables, int32_t scale_bits,
                        int32_t* symbols_out) {
  if (scale_bits < 1 || scale_bits > 16) return -1;
  const uint32_t mask = (1u << scale_bits) - 1;

  // Build per-table slot->symbol lookup.
  std::vector<int32_t> slot2sym(static_cast<size_t>(ntables) << scale_bits);
  for (int32_t t = 0; t < ntables; ++t) {
    int64_t base = static_cast<int64_t>(t) << scale_bits;
    for (int32_t s = 0; s < nsym; ++s) {
      const uint32_t f = freqs[static_cast<int64_t>(t) * nsym + s];
      const uint32_t c = cums[static_cast<int64_t>(t) * nsym + s];
      for (uint32_t u = 0; u < f; ++u) slot2sym[base + c + u] = s;
    }
  }

  int64_t pos = 0;
  auto next_byte = [&]() -> uint32_t {
    return pos < in_size ? in[pos++] : 0u;
  };
  // init: read 4 bytes big-state-first (mirrors encoder flush+reverse)
  uint32_t x = 0;
  for (int j = 0; j < 4; ++j) x = (x << 8) | next_byte();

  for (int64_t i = 0; i < n; ++i) {
    const int32_t t = table_ids[i];
    if (t < 0 || t >= ntables) return -1;
    const uint32_t slot = x & mask;
    const int32_t s = slot2sym[(static_cast<int64_t>(t) << scale_bits) + slot];
    const uint32_t f = freqs[static_cast<int64_t>(t) * nsym + s];
    const uint32_t c = cums[static_cast<int64_t>(t) * nsym + s];
    x = f * (x >> scale_bits) + slot - c;
    while (x < kRansL) x = (x << 8) | next_byte();
    symbols_out[i] = s;
  }
  return 0;
}

}  // extern "C"
