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
// end (online_softmax.cuh, shared with paged_attention.cu). Shapes:
// R = 512, dr = 64, H a multiple of HG (DeepSeek MLA). bf16 calls take
// mla_decode_split_kernel (the end of this file), which splits the
// sequence over blocks; float32 calls keep this kernel.
#include "mla_mma.cuh"
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


// ---- mla_decode_split_kernel: the bf16 mla_decode_fused, split over the
// cached rows ----
//
// Replaces ktransformers_tpu/ops/pallas/mla_decode.py:mla_decode_fused
// (body _fused_kernel) for bf16 operands; computes what the first version
// above computes. Bound: the bytes of the live cache rows, lengths[b] *
// (R + dr) * 2, read once. The first version ran one block per (sequence,
// 4 heads): 4 blocks at one sequence of 16 heads, every row read once per
// head group, float32 FMAs. Here:
// - the grid is (B, splits + 1, ceil(H / 16)). Block (b, s, t), s <
//   splits, takes the rows [s * span, (s + 1) * span) of sequence b (cut at
//   lengths[b]) for the 16 heads 16 t .. 16 t + 15 (missing heads zero), so
//   each row is read once a head tile; splits and span are a pure function
//   of (B, S, H) and the SM count (ops/cuda/mla_decode.py:
//   decode_split_plan): lengths live on the card and are never read on the
//   host. Block s = splits does the current token alone, beside the
//   others: the kv_a RMSNorm of its ckv, the rope of k_pe (f32 rotation),
//   its score (f32 dots) and the state m = s_cur, l = 1, acc = normed ckv;
//   that block of head tile 0 writes ckv_new and kpe_new;
// - every block copies its small operands (the rotation, q_pe, the raw kv
//   and gamma) into shared memory with cp.async beside its query rows and
//   first key tile, and ropes q_pe there (f32, then bf16 into its rows);
// - the 16 heads are the 16 rows of one mma.sync tile (mla_mma.cuh, RG =
//   1): tiles of 64 rows staged once in a two-stage cp.async ring, the
//   scores of 8 keys a warp over depth 576, P V into 64 columns a warp;
//   rows past the split's end are zero-filled, never read;
// - each block with a state writes (m, l, acc[16][512]) to part (a split
//   with no row writes nothing: the merge reads splits 0 .. ceil(lengths[b]
//   / span) - 1 and the current token's) and arrives on the (sequence, head
//   tile) counter; the last block to arrive merges the states in a fixed
//   order (weights exp2(m_i - M) / L) and sets the counter back to 0. One
//   launch, the same bits on every call.
// Shared memory: query rows 16 x 1168 B, the ring 2 x 64 x 1168 B, scores
// 16 x 72 x 4 B, the small operands 21 KB, the current token's vectors and
// the merge weights 10 KB: 200 KB, one block an SM. (Inside kt_mla_mma, so
// that R, DR and NEG_INF name its constants and not online_softmax.cuh's.)
//
// kCurrentToken = false is the bf16 mla_decode_attention (row 6, replacing
// ktransformers_tpu/ops/pallas/mla_decode.py:mla_decode_attention, body
// _kernel): the cache already holds the current token, lengths[b] counts
// it, and qp comes roped, so there is no current-token block, no kv_a norm,
// no rope and no ckv_new / kpe_new: grid (B, splits, ceil(H / 16)), q_pe
// copied straight into the query rows, the merge over the splits that hold
// a row (a sequence of length 0 gives zeros). It replaces the first
// version above (one block per (sequence, 4 heads), 8 warps striding over
// the rows with float32 FMAs), which float32 calls keep.
namespace kt_mla_mma {
namespace split {

// staged with the query rows: rotation [DR][DR] f32, q_pe [HT][DR] bf16,
// raw kv [D] bf16 and gamma [R] f32 (the current token's block)
constexpr int ROT_OFF = Tl::SMEM;
constexpr int QP_OFF = ROT_OFF + DR * DR * 4;
constexpr int KV_OFF = QP_OFF + HT * DR * 2;
constexpr int GAMMA_OFF = KV_OFF + D * 2;
constexpr int F_OFF = GAMMA_OFF + R * 4;
// floats from F_OFF: ckvn [R], kpen [DR], q_pe roped [HT][DR], s_cur [HT],
// warp sums [NWARP], merge weights [MAX_SPLITS + 1][HT]
constexpr int F_FLOATS = R + DR + HT * DR + HT + NWARP + W_FLOATS;
constexpr int SMEM = F_OFF + F_FLOATS * 4;

template <bool kCurrentToken>
__global__ void __launch_bounds__(THREADS, 1)
    mla_decode_split_kernel(const bf16* __restrict__ qn,
                            const bf16* __restrict__ qp,
                            const bf16* __restrict__ kvraw,
                            const float* __restrict__ gamma,
                            const float* __restrict__ rot,
                            const bf16* __restrict__ ckv,
                            const bf16* __restrict__ kpe,
                            const int* __restrict__ lengths, int H, int S,
                            int span, float scale, float eps,
                            float* __restrict__ part, int* __restrict__ cnt,
                            bf16* __restrict__ ctx, bf16* __restrict__ ckv_new,
                            bf16* __restrict__ kpe_new) {
  extern __shared__ __align__(128) uint8_t smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = q_s + Tl::ROWS * LDS;
  float* s_s = reinterpret_cast<float*>(smem + Tl::Q_BYTES + 2 * Tl::K_BYTES);
  float* rot_s = reinterpret_cast<float*>(smem + ROT_OFF);
  bf16* qp_s = reinterpret_cast<bf16*>(smem + QP_OFF);
  bf16* kv_s = reinterpret_cast<bf16*>(smem + KV_OFF);
  float* gamma_s = reinterpret_cast<float*>(smem + GAMMA_OFF);
  float* ckvn_s = reinterpret_cast<float*>(smem + F_OFF);
  float* kpen_s = ckvn_s + R;
  float* qpf_s = kpen_s + DR;
  float* scur_s = qpf_s + HT * DR;
  float* red_s = scur_s + HT;
  float* w_s = red_s + NWARP;

  const int b = blockIdx.x, sp = blockIdx.y, ht = blockIdx.z;
  // with the current token, block y = splits takes it alone
  constexpr int CUR = kCurrentToken ? 1 : 0;
  const int splits = gridDim.y - CUR;
  const bool cur = kCurrentToken && sp == splits;
  const int h0 = ht * HT;
  const int nh = min(HT, H - h0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(max(lengths[b], 0), S);
  const int start = sp * span;
  const int end = cur ? start : min(len, start + span);
  const int nt = end > start ? (end - start + TK - 1) / TK : 0;
  const float sl = scale * LOG2E;
  const size_t seq = (size_t)b * S;
  const size_t pair = (size_t)b * gridDim.z + ht;
  float* rec = part + (pair * (splits + CUR) + sp) * REC;

  if (cur || nt > 0) {
    // the small operands and the qn rows, then the first key tile; without
    // the current token q_pe comes roped and goes straight to its rows
    if (kCurrentToken) {
      const float* rb = rot + (size_t)b * DR * DR;
      for (int i = tid; i < DR * DR / 4; i += THREADS)
        kt_mma::cp_async16(rot_s + 4 * i, rb + 4 * i, true);
    }
    for (int i = tid; i < HT * (DR / 8); i += THREADS) {
      const int h = i / (DR / 8), ch = i % (DR / 8);
      const bool ok = h < nh;
      kt_mma::cp_async16(
          kCurrentToken ? qp_s + h * DR + ch * 8 : q_s + h * LDS + R + ch * 8,
          qp + ((size_t)b * H + h0 + (ok ? h : 0)) * DR + ch * 8, ok);
    }
    for (int i = tid; i < HT * (R / 8); i += THREADS) {
      const int h = i / (R / 8), ch = i % (R / 8);
      const bool ok = h < nh;
      kt_mma::cp_async16(
          q_s + h * LDS + ch * 8,
          qn + ((size_t)b * H + h0 + (ok ? h : 0)) * R + ch * 8, ok);
    }
    if (cur) {
      for (int i = tid; i < D / 8; i += THREADS)
        kt_mma::cp_async16(kv_s + 8 * i, kvraw + (size_t)b * D + 8 * i, true);
      for (int i = tid; i < R / 4; i += THREADS)
        kt_mma::cp_async16(gamma_s + 4 * i, gamma + 4 * i, true);
    }
    kt_mma::cp_async_commit();
    auto keys = [&](bf16* dst, int k0) {
      stage_rows<TK>(dst, [&](int r, const bf16*& c, const bf16*& p) {
        const int pos = k0 + r;
        const bool ok = pos < end;
        const size_t row = seq + (ok ? pos : 0);
        c = ckv + row * R;
        p = kpe + row * DR;
        return ok;
      });
    };
    if (nt > 0) keys(k_s, start);
    kt_mma::cp_async_commit();
    kt_mma::cp_async_wait<1>();
    __syncthreads();
    if (kCurrentToken) {
      // q_pe @ rot in float32: thread (head tid / 16, 4 columns)
      const int h = tid >> 4, j0 = (tid & 15) * 4;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 16
      for (int k = 0; k < DR; ++k) {
        const float x = __bfloat162float(qp_s[h * DR + k]);
        const float4 r4 = *reinterpret_cast<const float4*>(rot_s + k * DR + j0);
        a.x += x * r4.x;
        a.y += x * r4.y;
        a.z += x * r4.z;
        a.w += x * r4.w;
      }
      *reinterpret_cast<float4*>(qpf_s + h * DR + j0) = a;
      __nv_bfloat162* d =
          reinterpret_cast<__nv_bfloat162*>(q_s + h * LDS + R + j0);
      d[0] = __floats2bfloat162_rn(a.x, a.y);
      d[1] = __floats2bfloat162_rn(a.z, a.w);
    }
    if (cur) {
      float ss = 0.f;
      for (int i = tid; i < R; i += THREADS) {
        const float v = __bfloat162float(kv_s[i]);
        ss += v * v;
      }
      ss = kt_mla::warp_sum(ss);
      if (lane == 0) red_s[warp] = ss;
      __syncthreads();
      float ms = 0.f;
#pragma unroll
      for (int w = 0; w < NWARP; ++w) ms += red_s[w];
      const float inv = rsqrtf(ms / (float)R + eps);
      for (int i = tid; i < R; i += THREADS)
        ckvn_s[i] = __bfloat162float(kv_s[i]) * inv * gamma_s[i];
      if (tid < DR) {
        float a = 0.f;
#pragma unroll 16
        for (int k = 0; k < DR; ++k)
          a += __bfloat162float(kv_s[R + k]) * rot_s[k * DR + tid];
        kpen_s[tid] = a;
      }
      __syncthreads();
      for (int h = warp; h < HT; h += NWARP) {
        float a = 0.f;
        for (int r = lane; r < R; r += 32)
          a += __bfloat162float(q_s[h * LDS + r]) * ckvn_s[r];
        for (int j = lane; j < DR; j += 32) a += qpf_s[h * DR + j] * kpen_s[j];
        a = kt_mla::warp_sum(a);
        if (lane == 0) scur_s[h] = a * sl;
      }
      if (ht == 0) {
        for (int i = tid; i < R; i += THREADS)
          ckv_new[(size_t)b * R + i] = __float2bfloat16(ckvn_s[i]);
        if (tid < DR)
          kpe_new[(size_t)b * DR + tid] = __float2bfloat16(kpen_s[tid]);
      }
      __syncthreads();
      if (tid < HT) {
        rec[tid] = scur_s[tid];
        rec[HT + tid] = 1.f;
      }
      for (int i = tid; i < HT * R / 4; i += THREADS)
        reinterpret_cast<float4*>(rec + 2 * HT)[i] =
            reinterpret_cast<const float4*>(ckvn_s)[i % (R / 4)];
    } else {
      State<1, TK> st;
      st.clear();
      const int lim[2] = {end, end};
      walk<1, TK>(q_s, k_s, s_s, start, nt, sl, lim, keys, st);
      store_state(st, rec);
    }
  }
  if (!arrive_last(cnt + pair, splits + CUR)) return;
#if !KT_MLA_CUT_MERGE  // ops/cuda/breakdown.py: the merge compiled out
  // the states to merge, in this order: the splits that start below
  // lengths[b] (0 .. live - 1), then the current token's (index splits);
  // no state at all (length 0, no current token) gives zeros
  const int live = min(splits, (len + span - 1) / span);
  merge_states(part + pair * (splits + CUR) * REC, live + CUR,
               [=](int i) { return i < live ? i : splits; }, w_s, nh,
               ctx + ((size_t)b * H + h0) * R);
#endif
  if (tid == 0) cnt[pair] = 0;  // ready for the next launch
}

}  // namespace split
}  // namespace kt_mla_mma

// The bf16 mla_decode_fused on mla_decode_split_kernel: operands as
// kt_mla_decode_fused; `splits` blocks of `span` rows a sequence and head
// tile (splits * span >= S, 1 <= splits <= MAX_SPLITS, span a multiple of
// 16) and one for the current token; part holds B * ceil(H / 16) *
// (splits + 1) * REC floats, cnt B * ceil(H / 16) ints, zero on entry
// (left zero).
extern "C" int kt_mla_decode_split(const void* qn, const void* qp,
                                   const void* kvraw, const void* gamma,
                                   const void* rot, const void* ckv,
                                   const void* kpe, const void* lengths,
                                   int B, int H, int S, int splits, int span,
                                   float scale, float eps, void* part,
                                   void* cnt, void* ctx, void* ckv_new,
                                   void* kpe_new, void* stream) {
  namespace K = kt_mla_mma::split;
  if (B <= 0 || H <= 0 || S <= 0 || splits < 1 || splits > K::MAX_SPLITS ||
      span <= 0 || span % 16 || (long long)splits * span < S ||
      part == nullptr || cnt == nullptr)
    return (int)cudaErrorInvalidValue;
  static int ready_dev = -1;
  cudaError_t err = kt_mma::allow_smem(K::mla_decode_split_kernel<true>,
                                       K::SMEM, &ready_dev);
  if (err != cudaSuccess) return (int)err;
  using T = __nv_bfloat16;
  dim3 grid(B, splits + 1, (H + K::HT - 1) / K::HT);
  K::mla_decode_split_kernel<true><<<grid, kt_mla_mma::THREADS, K::SMEM,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(qn), static_cast<const T*>(qp),
      static_cast<const T*>(kvraw), static_cast<const float*>(gamma),
      static_cast<const float*>(rot), static_cast<const T*>(ckv),
      static_cast<const T*>(kpe), static_cast<const int*>(lengths), H, S,
      span, scale, eps, static_cast<float*>(part), static_cast<int*>(cnt),
      static_cast<T*>(ctx), static_cast<T*>(ckv_new),
      static_cast<T*>(kpe_new));
  return (int)cudaGetLastError();
}

// The bf16 mla_decode_attention on mla_decode_split_kernel<false>: operands
// as kt_mla_decode_attention (lengths count the current token, qp roped);
// `splits` blocks of `span` rows a sequence and head tile (splits * span >=
// S, 1 <= splits <= MAX_SPLITS, span a multiple of 16); part holds B *
// ceil(H / 16) * splits * REC floats, cnt B * ceil(H / 16) ints, zero on
// entry (left zero).
extern "C" int kt_mla_decode_attention_split(
    const void* qn, const void* qp, const void* ckv, const void* kpe,
    const void* lengths, int B, int H, int S, int splits, int span,
    float scale, void* part, void* cnt, void* out, void* stream) {
  namespace K = kt_mla_mma::split;
  if (B <= 0 || H <= 0 || S <= 0 || splits < 1 || splits > K::MAX_SPLITS ||
      span <= 0 || span % 16 || (long long)splits * span < S ||
      part == nullptr || cnt == nullptr)
    return (int)cudaErrorInvalidValue;
  static int ready_dev = -1;
  cudaError_t err = kt_mma::allow_smem(K::mla_decode_split_kernel<false>,
                                       K::SMEM, &ready_dev);
  if (err != cudaSuccess) return (int)err;
  using T = __nv_bfloat16;
  dim3 grid(B, splits, (H + K::HT - 1) / K::HT);
  K::mla_decode_split_kernel<false><<<grid, kt_mla_mma::THREADS, K::SMEM,
                                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(qn), static_cast<const T*>(qp), nullptr, nullptr,
      nullptr, static_cast<const T*>(ckv), static_cast<const T*>(kpe),
      static_cast<const int*>(lengths), H, S, span, scale, 0.f,
      static_cast<float*>(part), static_cast<int*>(cnt), static_cast<T*>(out),
      nullptr, nullptr);
  return (int)cudaGetLastError();
}
