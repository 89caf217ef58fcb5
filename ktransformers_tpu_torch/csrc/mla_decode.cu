// Fused MLA decode attention for one new token per sequence.
//
// Replaces ktransformers_tpu/ops/pallas/mla_decode.py:mla_decode_fused
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
// end. Splitting the sequence over more blocks (flash-decoding) is later
// work. Shapes: R = 512, dr = 64, H a multiple of HG (DeepSeek MLA).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int R = 512;
constexpr int DR = 64;
constexpr int HG = 4;
constexpr int NW = 8;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// 8 consecutive elements starting at p (16-byte aligned for bf16).
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float o[8]) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float o[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

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
#pragma unroll
  for (int h = 0; h < HG; ++h) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      qreg[h][i] = qn_s[h][8 * lane + i];
      qreg[h][8 + i] = qn_s[h][256 + 8 * lane + i];
    }
    preg[h][0] = qp_s[h][2 * lane];
    preg[h][1] = qp_s[h][2 * lane + 1];
  }
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
    float c[16], p2[2];
    load8(crow + 8 * lane, c);
    load8(crow + 256 + 8 * lane, c + 8);
    p2[0] = to_f(prow[2 * lane]);
    p2[1] = to_f(prow[2 * lane + 1]);
#pragma unroll
    for (int h = 0; h < HG; ++h) {
      float part = preg[h][0] * p2[0] + preg[h][1] * p2[1];
#pragma unroll
      for (int i = 0; i < 16; ++i) part += qreg[h][i] * c[i];
      const float sc = warp_sum(part) * scale;
      const float m_new = fmaxf(m[h], sc);
      const float corr = expf(m[h] - m_new);
      const float p = expf(sc - m_new);
      l[h] = l[h] * corr + p;
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[h][i] = acc[h][i] * corr + p * c[i];
      m[h] = m_new;
    }
  }

  // --- merge the warps' states ---
  if (lane == 0) {
#pragma unroll
    for (int h = 0; h < HG; ++h) {
      m_s[warp][h] = m[h];
      l_s[warp][h] = l[h];
    }
  }
  for (int i = tid; i < HG * R; i += 32 * NW) acc_s[i / R][i % R] = 0.f;
  __syncthreads();
  float mt[HG], lt[HG];
#pragma unroll
  for (int h = 0; h < HG; ++h) {
    mt[h] = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mt[h] = fmaxf(mt[h], m_s[w][h]);
    lt[h] = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) lt[h] += l_s[w][h] * expf(m_s[w][h] - mt[h]);
  }
  for (int w = 0; w < NW; ++w) {
    if (warp == w) {
#pragma unroll
      for (int h = 0; h < HG; ++h) {
        const float f = expf(m[h] - mt[h]);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc_s[h][8 * lane + i] += acc[h][i] * f;
          acc_s[h][256 + 8 * lane + i] += acc[h][8 + i] * f;
        }
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < HG * R; i += 32 * NW) {
    const int h = i / R, r = i % R;
    from_f(ctx + ((size_t)b * H + h0 + h) * R + r,
           acc_s[h][r] / fmaxf(lt[h], 1e-30f));
  }
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
