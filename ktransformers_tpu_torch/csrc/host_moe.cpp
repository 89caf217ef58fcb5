// Host-resident routed-expert FFN: the port's own copy of the JAX
// package's csrc/host_moe.cpp, with the same arithmetic (on the same arrays
// the two libraries give the same float32 bits). Routed experts stay in
// host RAM and compute on the host CPU; only activations ([T, K] a layer)
// cross between host and card. ktransformers_tpu_torch/offload/host_moe.py
// builds it with g++ at first use and binds it with ctypes.
//
// Layout (host-optimal, independent of the card's nibble formats):
//   gate_up: [2N, K/2] uint8, row n = gate_n, row N+n = up_n.
//            byte j of a row packs codes for k=2j (low nibble) and
//            k=2j+1 (high nibble); code = q + 8, q in [-8, 7].
//   gu_scales: [2N, K/gs] float32 (per-output-row K-groups)
//   down:  [K, N/2] uint8 rows over model dim, same nibble packing
//   dn_scales: [K, N/gs]
//
// A forward groups (token, slot) pairs by expert so each active expert's
// weights stream through the cache hierarchy exactly once per call
// (GEMM over that expert's tokens), then combines with the routing
// weights. OpenMP parallelizes the output rows WITHIN one expert, over
// the threads the caller passes (each row is computed by one thread, so
// the thread count does not change a bit of the result). All math f32
// (AVX-512 via compiler vectorization). Unlike the JAX package's copy, a
// handle is the layer's own heap record (no process-wide registry), so
// layers of several models and forwards from several threads never share
// state.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#if defined(__AVX512F__)
#include <immintrin.h>
#endif

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

struct Layer {
  int E, K, N, gs_gu, gs_dn;
  const uint8_t* gu;        // [2N, K/2]
  const float* gu_scales;   // [2N, K/gs_gu]
  const uint8_t* dn;        // [K, N/2]
  const float* dn_scales;   // [K, N/gs_dn]
  int act;                  // 0 = silu, 1 = gelu_tanh
};


inline float act_fn(float g, int kind) {
  if (kind == 1) {  // gelu (tanh approx)
    const float c = 0.7978845608028654f;
    return 0.5f * g * (1.0f + std::tanh(c * (g + 0.044715f * g * g * g)));
  }
  return g / (1.0f + std::exp(-g));  // silu
}

// Dequantize one packed row [len/2 bytes] into out[len] floats.
inline void dequant_row(const uint8_t* row, const float* scales, int len,
                        int gs, float* out) {
  int n_groups = len / gs;
  for (int g = 0; g < n_groups; ++g) {
    float s = scales[g];
    const uint8_t* src = row + (g * gs) / 2;
    float* dst = out + g * gs;
#pragma omp simd
    for (int j = 0; j < gs / 2; ++j) {
      uint8_t b = src[j];
      dst[2 * j] = (float)((int)(b & 0xF) - 8) * s;
      dst[2 * j + 1] = (float)((int)(b >> 4) - 8) * s;
    }
  }
}

// y[m] = dot(w_row, x[m]) for m in [0, M); x rows are contiguous [M, len].
// Register-blocked: 8 tokens share each streamed weight vector (the naive
// per-token reduction was latency-chain-bound at ~20 GFLOP/s; 8
// accumulators run the FMA ports at full rate).
inline void dot_rows(const float* wrow, const float* x, int M, int len,
                     float* y) {
  int m0 = 0;
#if defined(__AVX512F__)
  for (; m0 + 8 <= M; m0 += 8) {
    __m512 acc0 = _mm512_setzero_ps(), acc1 = acc0, acc2 = acc0,
           acc3 = acc0, acc4 = acc0, acc5 = acc0, acc6 = acc0, acc7 = acc0;
    const float* xb = x + (size_t)m0 * len;
    int k = 0;
    for (; k + 16 <= len; k += 16) {
      __m512 wv = _mm512_loadu_ps(wrow + k);
      acc0 = _mm512_fmadd_ps(wv, _mm512_loadu_ps(xb + k), acc0);
      acc1 = _mm512_fmadd_ps(wv, _mm512_loadu_ps(xb + len + k), acc1);
      acc2 = _mm512_fmadd_ps(wv, _mm512_loadu_ps(xb + 2 * (size_t)len + k), acc2);
      acc3 = _mm512_fmadd_ps(wv, _mm512_loadu_ps(xb + 3 * (size_t)len + k), acc3);
      acc4 = _mm512_fmadd_ps(wv, _mm512_loadu_ps(xb + 4 * (size_t)len + k), acc4);
      acc5 = _mm512_fmadd_ps(wv, _mm512_loadu_ps(xb + 5 * (size_t)len + k), acc5);
      acc6 = _mm512_fmadd_ps(wv, _mm512_loadu_ps(xb + 6 * (size_t)len + k), acc6);
      acc7 = _mm512_fmadd_ps(wv, _mm512_loadu_ps(xb + 7 * (size_t)len + k), acc7);
    }
    float t[8] = {_mm512_reduce_add_ps(acc0), _mm512_reduce_add_ps(acc1),
                  _mm512_reduce_add_ps(acc2), _mm512_reduce_add_ps(acc3),
                  _mm512_reduce_add_ps(acc4), _mm512_reduce_add_ps(acc5),
                  _mm512_reduce_add_ps(acc6), _mm512_reduce_add_ps(acc7)};
    for (; k < len; ++k)
      for (int m = 0; m < 8; ++m) t[m] += wrow[k] * xb[(size_t)m * len + k];
    for (int m = 0; m < 8; ++m) y[m0 + m] = t[m];
  }
#endif
  for (; m0 < M; ++m0) {
    const float* xm = x + (size_t)m0 * len;
    float acc = 0.f;
#pragma omp simd reduction(+ : acc)
    for (int k = 0; k < len; ++k) acc += wrow[k] * xm[k];
    y[m0] = acc;
  }
}

}  // namespace

extern "C" {

// Returns a handle. Pointers are borrowed: the caller keeps the arrays
// alive until kt_hostmoe_destroy.
void* kt_hostmoe_create(int E, int K, int N, int gs_gu, int gs_dn,
                        const uint8_t* gu, const float* gu_scales,
                        const uint8_t* dn, const float* dn_scales, int act) {
  return new Layer{E, K, N, gs_gu, gs_dn, gu, gu_scales, dn, dn_scales, act};
}

void kt_hostmoe_destroy(void* h) { delete static_cast<Layer*>(h); }

// OpenMP's default team size in this process (omp_get_max_threads).
int kt_hostmoe_max_threads() {
#if defined(_OPENMP)
  return omp_get_max_threads();
#else
  return 1;
#endif
}

// x [T, K] f32, ids [T, topk] int32 (expert id, or <0 to skip),
// w [T, topk] f32 combine weights, out [T, K] f32 (OVERWRITTEN with the
// combined routed-expert output; caller adds shared expert / residual),
// computed on ``threads`` OpenMP threads.
void kt_hostmoe_forward(void* h, int T, int topk, const float* x,
                        const int32_t* ids, const float* w, float* out,
                        int threads) {
  const Layer& L = *static_cast<const Layer*>(h);
  if (threads < 1) threads = 1;
  const int K = L.K, N = L.N;
  const size_t gu_row = (size_t)K / 2;
  const size_t dn_row = (size_t)N / 2;

  memset(out, 0, sizeof(float) * (size_t)T * K);

  // bucket (token, slot) by expert
  std::vector<std::vector<int>> buckets(L.E);
  for (int t = 0; t < T; ++t)
    for (int s = 0; s < topk; ++s) {
      int e = ids[t * topk + s];
      if (e >= 0 && e < L.E && w[t * topk + s] != 0.f)
        buckets[e].push_back(t * topk + s);
    }

  std::vector<float> xg, actbuf, ybuf;
  for (int e = 0; e < L.E; ++e) {
    const auto& tok = buckets[e];
    if (tok.empty()) continue;
    const int M = (int)tok.size();
    xg.resize((size_t)M * K);
    actbuf.resize((size_t)M * N);
    ybuf.resize((size_t)M * K);
    for (int m = 0; m < M; ++m)
      memcpy(&xg[(size_t)m * K], x + (size_t)(tok[m] / topk) * K,
             sizeof(float) * K);

    const uint8_t* gu_e = L.gu + (size_t)e * 2 * N * gu_row;
    const float* gus_e = L.gu_scales + (size_t)e * 2 * N * (K / L.gs_gu);
    const uint8_t* dn_e = L.dn + (size_t)e * K * dn_row;
    const float* dns_e = L.dn_scales + (size_t)e * K * (N / L.gs_dn);

    // Token chunks OUTSIDE the row loops: a 64-token x block (64*K*4 =
    // ~1.3 MB) stays L2-resident while the quantized rows stream through
    // once per chunk; the previous nest re-read the whole activation
    // block from L3 for every one of the 2N+K weight rows.
#pragma omp parallel num_threads(threads)
    {
      std::vector<float> wrow(K > N ? K : N);
      float hg[64], hu[64], yd[64];
      for (int m0 = 0; m0 < M; m0 += 64) {
        int mc = std::min(64, M - m0);
        const float* xs = &xg[(size_t)m0 * K];
        // gate/up + activation: parallel over intermediate rows
#pragma omp for schedule(static)
        for (int n = 0; n < N; ++n) {
          dequant_row(gu_e + (size_t)n * gu_row,
                      gus_e + (size_t)n * (K / L.gs_gu), K, L.gs_gu,
                      wrow.data());
          dot_rows(wrow.data(), xs, mc, K, hg);
          dequant_row(gu_e + (size_t)(N + n) * gu_row,
                      gus_e + (size_t)(N + n) * (K / L.gs_gu), K, L.gs_gu,
                      wrow.data());
          dot_rows(wrow.data(), xs, mc, K, hu);
          for (int m = 0; m < mc; ++m)
            actbuf[(size_t)(m0 + m) * N + n] = act_fn(hg[m], L.act) * hu[m];
        }
        // down: parallel over model-dim rows (implicit barrier above
        // makes this chunk's actbuf complete)
#pragma omp for schedule(static)
        for (int k = 0; k < K; ++k) {
          dequant_row(dn_e + (size_t)k * dn_row,
                      dns_e + (size_t)k * (N / L.gs_dn), N, L.gs_dn,
                      wrow.data());
          dot_rows(wrow.data(), &actbuf[(size_t)m0 * N], mc, N, yd);
          for (int m = 0; m < mc; ++m)
            ybuf[(size_t)(m0 + m) * K + k] = yd[m];
        }
      }
    }

    // combine into out (experts sequential -> no race)
    for (int m = 0; m < M; ++m) {
      int t = tok[m] / topk;
      float cw = w[tok[m]];
      float* dst = out + (size_t)t * K;
      const float* src = &ybuf[(size_t)m * K];
#pragma omp simd
      for (int k = 0; k < K; ++k) dst[k] += cw * src[k];
    }
  }
}

}  // extern "C"
