// MLA decode attention for one new token per sequence: the fused kernel
// (first) and, at the end of the file, the plain flash decode over a cache
// that already holds the current token (mla_decode_attention).
//
// mla_decode_fused replaces ktransformers_tpu/ops/pallas/mla_decode.py:mla_decode_fused
// (body _fused_kernel). One launch does the kv_a RMSNorm of the current
// token's compressed kv, the rope of q_pe and k_pe as a [dr, dr] rotation,
// and online-softmax attention in absorbed form
//   score = (qn . ckv + qp . kpe) * scale
// over the `lengths[b]` cached tokens PLUS the current token. `lengths`
// excludes the current token (unlike mla_decode_attention's, which
// includes it). The normed ckv and roped kpe of the current token are
// returned; the caller writes them into the cache.
//
// Bound: the cache bytes of the valid rows (lengths[b] * (R + dr) * 2 for
// bf16). Design: one block per (batch, group of HG heads). Each of the 8
// warps streams every 8th cache row (16-byte loads, a whole 1 KB ckv row
// per warp) and keeps its own running max / sum / context for its HG heads
// in registers; warp 0 is seeded with the current token (m = s_cur, l = 1,
// acc = ckv_new). The warps' states are merged in shared memory at the
// end (online_softmax.cuh, shared with paged_attention.cu). Splitting the
// sequence over more blocks (flash-decoding) is later work. Shapes:
// R = 512, dr = 64, H a multiple of HG (DeepSeek MLA).
#include "online_softmax.cuh"

namespace {

using namespace kt_mla;

template <typename T>
__global__ void __launch_bounds__(32 * NW)
    mla_decode_fused_kernel(const T* __restrict__ qn, const T* __restrict__ qp,
                            const T* __restrict__ kvraw,
                            const float* __restrict__ gamma,
                            const float* __restrict__ rot,
                            const T* __restrict__ ckv,
                            const T* __restrict__ kpe,
                            const int* __restrict__ lengths, int H, int S,
                            float scale, float eps, T* __restrict__ ctx,
                            T* __restrict__ ckv_new, T* __restrict__ kpe_new) {
  __shared__ float kv_s[R + DR];      // raw current kv
  __shared__ float ckvn_s[R];         // normed current ckv
  __shared__ float kpen_s[DR];        // roped current kpe
  __shared__ float qn_s[HG][R];
  __shared__ float qp_s[HG][DR];      // roped q_pe
  __shared__ float red_s[NW];
  __shared__ float scur_s[HG];
  __shared__ float m_s[NW][HG];
  __shared__ float l_s[NW][HG];
  __shared__ float acc_s[HG][R];

  const int b = blockIdx.x;
  const int h0 = blockIdx.y * HG;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int len = lengths[b];
  const float* rb = rot + (size_t)b * DR * DR;

  // --- current token: kv_a RMSNorm + rope ---
  float ss = 0.f;
  for (int i = tid; i < R + DR; i += 32 * NW) {
    const float v = to_f(kvraw[(size_t)b * (R + DR) + i]);
    kv_s[i] = v;
    if (i < R) ss += v * v;
  }
  ss = warp_sum(ss);
  if (lane == 0) red_s[warp] = ss;
  for (int i = tid; i < HG * R; i += 32 * NW) {
    const int h = i / R, r = i % R;
    qn_s[h][r] = to_f(qn[((size_t)b * H + h0 + h) * R + r]);
  }
  __syncthreads();
  float ms = 0.f;
#pragma unroll
  for (int w = 0; w < NW; ++w) ms += red_s[w];
  ms /= (float)R;
  const float inv = rsqrtf(ms + eps);
  for (int i = tid; i < R; i += 32 * NW) ckvn_s[i] = kv_s[i] * inv * gamma[i];
  if (tid < DR) {
    float acc = 0.f;
    for (int i = 0; i < DR; ++i) acc += kv_s[R + i] * rb[i * DR + tid];
    kpen_s[tid] = acc;
  }
  {  // HG * DR == 256 threads: one roped q_pe element each
    const int h = tid / DR, j = tid % DR;
    const T* q = qp + ((size_t)b * H + h0 + h) * DR;
    float acc = 0.f;
    for (int i = 0; i < DR; ++i) acc += to_f(q[i]) * rb[i * DR + j];
    qp_s[h][j] = acc;
  }
  __syncthreads();
  if (warp < HG) {
    float part = 0.f;
    for (int r = lane; r < R; r += 32) part += qn_s[warp][r] * ckvn_s[r];
    for (int j = lane; j < DR; j += 32) part += qp_s[warp][j] * kpen_s[j];
    part = warp_sum(part);
    if (lane == 0) scur_s[warp] = part * scale;
  }
  if (blockIdx.y == 0) {
    for (int i = tid; i < R; i += 32 * NW)
      from_f(ckv_new + (size_t)b * R + i, ckvn_s[i]);
    if (tid < DR) from_f(kpe_new + (size_t)b * DR + tid, kpen_s[tid]);
  }
  __syncthreads();

  // --- per-warp online softmax over cache rows warp, warp + NW, ... ---
  // lane owns ckv columns [8*lane, 8*lane+8) and [256 + 8*lane, ...)
  // and kpe columns 2*lane, 2*lane + 1.
  float qreg[HG][16];
  float preg[HG][2];
  load_query_regs(qn_s, qp_s, lane, qreg, preg);
  float m[HG], l[HG], acc[HG][16];
#pragma unroll
  for (int h = 0; h < HG; ++h) {
    if (warp == 0) {
      m[h] = scur_s[h];
      l[h] = 1.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[h][i] = ckvn_s[8 * lane + i];
        acc[h][8 + i] = ckvn_s[256 + 8 * lane + i];
      }
    } else {
      m[h] = NEG_INF;
      l[h] = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[h][i] = 0.f;
    }
  }
  for (int s = warp; s < len; s += NW) {
    const T* crow = ckv + ((size_t)b * S + s) * R;
    const T* prow = kpe + ((size_t)b * S + s) * DR;
    softmax_row(crow, prow, lane, scale, qreg, preg, m, l, acc);
  }

  // --- merge the warps' states ---
  merge_and_store(m, l, acc, m_s, l_s, acc_s,
                  ctx + ((size_t)b * H + h0) * R);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (qn, qp, kvraw, ckv, kpe and the outputs
// share it; gamma and rot are float32). Returns the cudaError_t.
extern "C" int kt_mla_decode_fused(const void* qn, const void* qp,
                                   const void* kvraw, const void* gamma,
                                   const void* rot, const void* ckv,
                                   const void* kpe, const void* lengths,
                                   int B, int H, int S, float scale,
                                   float eps, int dtype, void* ctx,
                                   void* ckv_new, void* kpe_new,
                                   void* stream) {
  if (H % HG != 0) return (int)cudaErrorInvalidValue;
  dim3 grid(B, H / HG);
  dim3 block(32 * NW);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* rt = static_cast<const float*>(rot);
  const int* ln = static_cast<const int*>(lengths);
  if (dtype == 1) {
    using T = __nv_bfloat16;
    mla_decode_fused_kernel<T><<<grid, block, 0, st>>>(
        static_cast<const T*>(qn), static_cast<const T*>(qp),
        static_cast<const T*>(kvraw), g, rt, static_cast<const T*>(ckv),
        static_cast<const T*>(kpe), ln, H, S, scale, eps,
        static_cast<T*>(ctx), static_cast<T*>(ckv_new),
        static_cast<T*>(kpe_new));
  } else {
    mla_decode_fused_kernel<float><<<grid, block, 0, st>>>(
        static_cast<const float*>(qn), static_cast<const float*>(qp),
        static_cast<const float*>(kvraw), g, rt,
        static_cast<const float*>(ckv), static_cast<const float*>(kpe), ln,
        H, S, scale, eps, static_cast<float*>(ctx),
        static_cast<float*>(ckv_new), static_cast<float*>(kpe_new));
  }
  return (int)cudaGetLastError();
}

// ---- mla_decode_attention: the decode attention without the prologue ----
//
// Replaces ktransformers_tpu/ops/pallas/mla_decode.py:mla_decode_attention
// (body _kernel): one query token per sequence over a contiguous compressed
// cache whose row of the current token is already written, so `lengths`
// INCLUDES the current token (mla_decode_fused's excludes it). qn is the
// absorbed query, qp the roped one. No row at or past lengths[b] is read.
// A sequence with no live row gives zeros. Bound: the bytes of the live
// rows. Design: as mla_paged_decode with the rows in place: one block per
// (sequence, HG heads), 8 warps stride over the rows with their own online
// softmax state (online_softmax.cuh) and merge in shared memory.
namespace {

template <typename T>
__global__ void __launch_bounds__(32 * NW)
    mla_decode_attention_kernel(const T* __restrict__ qn,
                                const T* __restrict__ qp,
                                const T* __restrict__ ckv,
                                const T* __restrict__ kpe,
                                const int* __restrict__ lengths, int H, int S,
                                float scale, T* __restrict__ out) {
  __shared__ float qn_s[HG][R];
  __shared__ float qp_s[HG][DR];
  __shared__ float m_s[NW][HG];
  __shared__ float l_s[NW][HG];
  __shared__ float acc_s[HG][R];

  const int b = blockIdx.x;
  const int h0 = blockIdx.y * HG;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int len = max(0, min(lengths[b], S));

  for (int i = tid; i < HG * R; i += 32 * NW)
    qn_s[i / R][i % R] = to_f(qn[((size_t)b * H + h0) * R + i]);
  for (int i = tid; i < HG * DR; i += 32 * NW)
    qp_s[i / DR][i % DR] = to_f(qp[((size_t)b * H + h0) * DR + i]);
  __syncthreads();

  float qreg[HG][16];
  float preg[HG][2];
  load_query_regs(qn_s, qp_s, lane, qreg, preg);
  float m[HG], l[HG], acc[HG][16];
#pragma unroll
  for (int h = 0; h < HG; ++h) {
    m[h] = NEG_INF;
    l[h] = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[h][i] = 0.f;
  }
  for (int s = warp; s < len; s += NW) {
    const size_t row = (size_t)b * S + s;
    softmax_row(ckv + row * R, kpe + row * DR, lane, scale, qreg, preg, m, l,
                acc);
  }
  merge_and_store(m, l, acc, m_s, l_s, acc_s, out + ((size_t)b * H + h0) * R);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (qn, qp, ckv, kpe and out share it).
extern "C" int kt_mla_decode_attention(const void* qn, const void* qp,
                                       const void* ckv, const void* kpe,
                                       const void* lengths, int B, int H,
                                       int S, float scale, int dtype,
                                       void* out, void* stream) {
  if (H % HG != 0) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  dim3 grid(B, H / HG);
  dim3 block(32 * NW);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ln = static_cast<const int*>(lengths);
  if (dtype == 1) {
    using T = __nv_bfloat16;
    mla_decode_attention_kernel<T><<<grid, block, 0, st>>>(
        static_cast<const T*>(qn), static_cast<const T*>(qp),
        static_cast<const T*>(ckv), static_cast<const T*>(kpe), ln, H, S,
        scale, static_cast<T*>(out));
  } else {
    mla_decode_attention_kernel<float><<<grid, block, 0, st>>>(
        static_cast<const float*>(qn), static_cast<const float*>(qp),
        static_cast<const float*>(ckv), static_cast<const float*>(kpe), ln,
        H, S, scale, static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}
