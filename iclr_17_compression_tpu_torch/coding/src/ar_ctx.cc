// Native library for the joint-AR host context pass: the port's copy of
// iclr_17_compression_tpu/coding/src/ar_ctx.cc, the counterpart of
// models/cheng2020.py _HostARContext.mu_sigma_batch. The sequential context
// model runs on the host because encoder and decoder must produce
// bit-identical mu/sigma. This file is that pass without the numpy
// temporaries:
//
//   - one gather of the 12 live context taps per wavefront lane,
//   - four row-major SGEMMs per wavefront (taps->ctx, ctx->conv0,
//     conv0->conv1, conv1->conv2) through OpenBLAS, dlopen'd from the scipy
//     wheel's bundled libscipy_openblas (no link-time dependency), biases
//     folded in with beta=1 on pre-filled outputs,
//   - scratch allocated once per context and reused across wavefronts.
//
// Wavefront lanes are padded to a multiple of 16 exactly as the numpy path
// pads them; padded lanes gather pixel (0,0) and are dropped.
//
// Encoder and decoder must use the same backend: this library and the numpy
// path differ in the last bits, and a stream is portable only between
// hosts whose BLAS gives identical floats. The BLAS thread count is
// OpenBLAS's default.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <dlfcn.h>

namespace {

enum CBLAS_ORDER { CblasRowMajor = 101 };
enum CBLAS_TRANSPOSE { CblasNoTrans = 111 };

using sgemm_t = void (*)(int order, int transa, int transb, int m, int n,
                         int k, float alpha, const float* a, int lda,
                         const float* b, int ldb, float beta, float* c,
                         int ldc);

struct ArCtx {
  void* blas_handle = nullptr;
  sgemm_t sgemm = nullptr;

  int m = 0;        // latent channels M
  int n_taps = 0;   // 12 live context taps
  int c0 = 0, c1 = 0, c2 = 0;  // entropy-parameters MLP widths (c2 == 2M)

  // weights (owned copies, contiguous row-major)
  float* w_taps = nullptr;  // (n_taps*m, 2m)
  float* w0_c = nullptr;    // (2m, c0)
  float* w1 = nullptr;      // (c0, c1)
  float* b1 = nullptr;      // (c1)
  float* w2 = nullptr;      // (c1, c2)
  float* b2 = nullptr;      // (c2)
  int64_t* off_r = nullptr;  // (n_taps)
  int64_t* off_c = nullptr;

  // scratch, grown on demand to the largest padded wavefront seen
  int cap = 0;
  float* taps = nullptr;  // (cap, n_taps*m)
  float* t1 = nullptr;    // (cap, 2m)
  float* x0 = nullptr;    // (cap, c0)
  float* x1 = nullptr;    // (cap, c1)
  float* x2 = nullptr;    // (cap, c2)
};

float* owned_copy(const float* src, size_t n) {
  float* p = static_cast<float*>(std::malloc(n * sizeof(float)));
  std::memcpy(p, src, n * sizeof(float));
  return p;
}

void ensure_capacity(ArCtx* ctx, int p_pad) {
  if (p_pad <= ctx->cap) return;
  std::free(ctx->taps);
  std::free(ctx->t1);
  std::free(ctx->x0);
  std::free(ctx->x1);
  std::free(ctx->x2);
  ctx->cap = p_pad;
  ctx->taps = static_cast<float*>(
      std::malloc(size_t(p_pad) * ctx->n_taps * ctx->m * sizeof(float)));
  ctx->t1 = static_cast<float*>(std::malloc(size_t(p_pad) * 2 * ctx->m * sizeof(float)));
  ctx->x0 = static_cast<float*>(std::malloc(size_t(p_pad) * ctx->c0 * sizeof(float)));
  ctx->x1 = static_cast<float*>(std::malloc(size_t(p_pad) * ctx->c1 * sizeof(float)));
  ctx->x2 = static_cast<float*>(std::malloc(size_t(p_pad) * ctx->c2 * sizeof(float)));
}

inline void leaky_relu(float* x, size_t n) {
  for (size_t i = 0; i < n; ++i) x[i] = x[i] > 0.0f ? x[i] : 0.01f * x[i];
}

}  // namespace

extern "C" {

// Returns an opaque handle, or nullptr when the BLAS .so or its sgemm
// symbol cannot be resolved (the caller raises).
void* ar_create(const char* blas_so, const float* w_taps, const float* w0_c,
                const float* w1, const float* b1, const float* w2,
                const float* b2, const int64_t* off_r, const int64_t* off_c,
                int m, int n_taps, int c0, int c1, int c2) {
  void* handle = dlopen(blas_so, RTLD_NOW | RTLD_LOCAL);
  if (!handle) return nullptr;
  auto sgemm = reinterpret_cast<sgemm_t>(dlsym(handle, "scipy_cblas_sgemm"));
  if (!sgemm) sgemm = reinterpret_cast<sgemm_t>(dlsym(handle, "cblas_sgemm"));
  if (!sgemm) {
    dlclose(handle);
    return nullptr;
  }
  ArCtx* ctx = new ArCtx();
  ctx->blas_handle = handle;
  ctx->sgemm = sgemm;
  ctx->m = m;
  ctx->n_taps = n_taps;
  ctx->c0 = c0;
  ctx->c1 = c1;
  ctx->c2 = c2;
  ctx->w_taps = owned_copy(w_taps, size_t(n_taps) * m * 2 * m);
  ctx->w0_c = owned_copy(w0_c, size_t(2) * m * c0);
  ctx->w1 = owned_copy(w1, size_t(c0) * c1);
  ctx->b1 = owned_copy(b1, c1);
  ctx->w2 = owned_copy(w2, size_t(c1) * c2);
  ctx->b2 = owned_copy(b2, c2);
  ctx->off_r = static_cast<int64_t*>(std::malloc(n_taps * sizeof(int64_t)));
  ctx->off_c = static_cast<int64_t*>(std::malloc(n_taps * sizeof(int64_t)));
  std::memcpy(ctx->off_r, off_r, n_taps * sizeof(int64_t));
  std::memcpy(ctx->off_c, off_c, n_taps * sizeof(int64_t));
  return ctx;
}

void ar_destroy(void* h) {
  if (!h) return;
  ArCtx* ctx = static_cast<ArCtx*>(h);
  std::free(ctx->w_taps);
  std::free(ctx->w0_c);
  std::free(ctx->w1);
  std::free(ctx->b1);
  std::free(ctx->w2);
  std::free(ctx->b2);
  std::free(ctx->off_r);
  std::free(ctx->off_c);
  std::free(ctx->taps);
  std::free(ctx->t1);
  std::free(ctx->x0);
  std::free(ctx->x1);
  std::free(ctx->x2);
  if (ctx->blas_handle) dlclose(ctx->blas_handle);
  delete ctx;
}

// mu/sigma for one wavefront. y_hat_pad: (hp, wp, m) zero-padded latent;
// base: (h, w, c0) per-pixel conv0 hyper+bias precompute; (ii, jj): the
// p unpadded wavefront coordinates into base. mu/sigma out: (p, m).
void ar_mu_sigma(void* h, const float* y_hat_pad, int wp, const float* base,
                 int w, const int64_t* ii, const int64_t* jj, int p,
                 float scale_bound, float* mu, float* sigma) {
  ArCtx* ctx = static_cast<ArCtx*>(h);
  const int m = ctx->m, n_taps = ctx->n_taps;
  const int c0 = ctx->c0, c1 = ctx->c1, c2 = ctx->c2;
  const int p_pad = ((p + 15) / 16) * 16;
  ensure_capacity(ctx, p_pad);

  const size_t tap_row = size_t(n_taps) * m;
  for (int l = 0; l < p_pad; ++l) {
    const int64_t r = l < p ? ii[l] : 0;
    const int64_t c = l < p ? jj[l] : 0;
    float* dst = ctx->taps + l * tap_row;
    for (int t = 0; t < n_taps; ++t)
      std::memcpy(dst + size_t(t) * m,
                  y_hat_pad + ((r + ctx->off_r[t]) * wp + c + ctx->off_c[t]) * m,
                  m * sizeof(float));
    std::memcpy(ctx->x0 + size_t(l) * c0, base + (r * w + c) * c0,
                c0 * sizeof(float));
  }

  // t1 = taps @ w_taps ; x0 += t1 @ w0_c  (x0 pre-filled with base rows,
  // which already carry conv0's hyper half and both biases)
  ctx->sgemm(CblasRowMajor, CblasNoTrans, CblasNoTrans, p_pad, 2 * m,
             int(tap_row), 1.0f, ctx->taps, int(tap_row), ctx->w_taps, 2 * m,
             0.0f, ctx->t1, 2 * m);
  ctx->sgemm(CblasRowMajor, CblasNoTrans, CblasNoTrans, p_pad, c0, 2 * m,
             1.0f, ctx->t1, 2 * m, ctx->w0_c, c0, 1.0f, ctx->x0, c0);
  leaky_relu(ctx->x0, size_t(p_pad) * c0);

  for (int l = 0; l < p_pad; ++l)
    std::memcpy(ctx->x1 + size_t(l) * c1, ctx->b1, c1 * sizeof(float));
  ctx->sgemm(CblasRowMajor, CblasNoTrans, CblasNoTrans, p_pad, c1, c0, 1.0f,
             ctx->x0, c0, ctx->w1, c1, 1.0f, ctx->x1, c1);
  leaky_relu(ctx->x1, size_t(p_pad) * c1);

  for (int l = 0; l < p_pad; ++l)
    std::memcpy(ctx->x2 + size_t(l) * c2, ctx->b2, c2 * sizeof(float));
  ctx->sgemm(CblasRowMajor, CblasNoTrans, CblasNoTrans, p_pad, c2, c1, 1.0f,
             ctx->x1, c1, ctx->w2, c2, 1.0f, ctx->x2, c2);

  for (int l = 0; l < p; ++l) {
    const float* row = ctx->x2 + size_t(l) * c2;
    float* sg = sigma + size_t(l) * m;
    float* mo = mu + size_t(l) * m;
    for (int k = 0; k < m; ++k) {
      const float a = row[k] < 0.0f ? -row[k] : row[k];
      sg[k] = a > scale_bound ? a : scale_bound;
      mo[k] = row[m + k];
    }
  }
}

}  // extern "C"
