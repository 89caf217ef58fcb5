// GQA attention straight off a paged KV pool.
//
// Replaces ktransformers_tpu/ops/pallas/paged_attention.py:gqa_paged_decode
// (body _gqa_kernel) and :gqa_paged_prefill (body _gqa_prefill_kernel).
// Pools are k and v [P, page, Hkv, D] (k roped); a sequence's token at
// position pos lives in row pos % page of page tables[b, pos / page]. Query
// head h reads KV head h / G, G = H / Hkv, so one block serves the G query
// heads of one KV head and every K / V row it stages is read once for all
// of them. Rows at or past the live length are never read: pages are
// recycled without clearing and may hold anything. A query with no live key
// gives zeros. With window > 0 a query at position qpos sees only keys
// kpos > qpos - window. Sums, softmax and the context are float32 on either
// pool type (float32 or bfloat16).
//
// gqa_paged_decode: one query token per sequence, `lengths` INCLUDES the
// current token (its KV is already in the pages), so qpos = lengths - 1.
// Bound: the bytes of the live rows, lengths[b] * Hkv * D * 2 elements. The
// key range of a sequence is split into SPLIT_KEYS-long pieces, one block of
// D threads per (sequence, KV head, piece), so a long sequence no longer
// sets the time alone (B * Hkv = 64 blocks at the serving shape, for 132
// SMs; 8 pieces of a 2,048-token pool make 512). A block walks its piece in
// tiles of DEC_TK: all threads stage the K and V rows of a tile (through the
// page table, 16-byte loads) as float32 in shared memory, score the G x
// DEC_TK pairs, each warp runs the online softmax of up to HPW heads over
// the tile (a lane per key; G <= GMAX = 16, GLM-4.5-Air's 12 included), and
// thread t adds P V into column t of every head. With
// one piece the block writes the output; with more, each writes its
// (max, sum, context) and gqa_decode_combine_kernel merges them. That
// kernel keeps float32 calls; bf16 calls take gqa_decode_split_kernel (the
// end of this file), one launch on the tensor cores.
//
// gqa_paged_prefill: S new tokens per chunk, already written to the pages;
// `lengths` is the OLD cached length (chunk excluded), `valid` the live new
// tokens. Query row s sees keys kpos <= lengths + s and kpos < lengths +
// valid; rows s >= valid are padding, see every live key and stay finite.
// The G * S query rows of one KV head are flattened position-major (row =
// s * G + g), so a block's TQ rows are TQ / G positions of all G heads and
// every staged K / V tile serves all of them. Bound at the serving shapes:
// the f32 FMAs of the two products. Per key tile of TK:
//   A: scores = Q K^T   (4 x 2 outputs a thread, float4 over the depth),
//   B: online softmax   (warp w owns rows 8w..8w+7, one key per lane),
//   C: acc += P V       (8 rows x 4 columns a thread, in registers).
// That kernel keeps float32 calls; bf16 calls take gqa_prefill_mma_kernel
// (the end of this file) on the tensor cores.
//
// Head dims D = 128 and 256 (Qwen3-Next's full-attention layers): every
// kernel is a template on D, instantiated for both; the C entry points take
// D and refuse any other. At D = 256 the first decode takes D threads (a
// column each, two heads' softmax a warp) and its tiles in dynamic shared
// memory, the first prefill four columns a lane twice.
#include <type_traits>

#include "mma_sm90.cuh"
#include "online_softmax.cuh"

namespace {

using kt_mla::from_f;
using kt_mla::load8;
using kt_mla::NEG_INF;
using kt_mla::to_f;
using kt_mla::warp_max;
using kt_mla::warp_sum;

// Row `pos` of KV head kh of a sequence whose page table is tb.
template <int D>
__device__ __forceinline__ size_t kv_offset(const int* __restrict__ tb,
                                            int pos, int page, int Hkv,
                                            int kh) {
  const size_t row = (size_t)__ldg(tb + pos / page) * page + pos % page;
  return (row * Hkv + kh) * D;
}

template <typename T>
__device__ __forceinline__ void load8_or_zero(const T* p, bool live,
                                              float o[8]) {
  if (live) {
    load8(p, o);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = 0.f;
  }
}

// ---- decode ----

constexpr int DEC_TK = 32;      // keys per staged tile (a lane each in B)
constexpr int GMAX = 16;        // query heads per KV head
constexpr int SPLIT_KEYS = 256; // keys of one piece (8 tiles)

template <int D>
struct Dec {
  static constexpr int DC = D / 8;        // 8-element chunks of a row
  static constexpr int THREADS = D;       // thread t owns output column t
  static constexpr int WARPS = THREADS / 32;
  static constexpr int HPW = GMAX / WARPS;  // heads whose softmax a warp runs
  static constexpr int KLD = D + 1;       // k tile row stride: distinct banks
  // q [GMAX][D], k [DEC_TK][KLD], v [DEC_TK][D], p [GMAX][DEC_TK], corr and
  // l [GMAX], floats
  static constexpr int SMEM =
      (GMAX * D + DEC_TK * KLD + DEC_TK * D + GMAX * DEC_TK + 2 * GMAX) * 4;
};

// part: per (sequence, KV head, piece) G maxima, G sums and G x D context
// sums (unnormalized), float32; read only when there is more than one piece.
template <typename T, int D>
__global__ void __launch_bounds__(Dec<D>::THREADS)
    gqa_paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                            const T* __restrict__ vp,
                            const int* __restrict__ tables,
                            const int* __restrict__ lengths, int H, int Hkv,
                            int page, int pmax, int window, float scale,
                            T* __restrict__ out, float* __restrict__ part) {
  constexpr int DC = Dec<D>::DC, DEC_THREADS = Dec<D>::THREADS;
  constexpr int DEC_WARPS = Dec<D>::WARPS, HPW = Dec<D>::HPW;
  constexpr int KLD = Dec<D>::KLD;
  extern __shared__ __align__(16) float dsm[];
  float* q_s = dsm;                      // [GMAX][D]
  float* k_s = q_s + GMAX * D;           // [DEC_TK][KLD]
  float* v_s = k_s + DEC_TK * KLD;       // [DEC_TK][D]
  float* p_s = v_s + DEC_TK * D;         // [GMAX][DEC_TK]
  float* corr_s = p_s + GMAX * DEC_TK;   // [GMAX]
  float* l_s = corr_s + GMAX;            // [GMAX]

  const int b = blockIdx.x, kh = blockIdx.y, piece = blockIdx.z;
  const int G = H / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = max(0, min(lengths[b], page * pmax));
  // this block's keys: the live (and in-window) ones of its piece
  const int kbeg = max(window > 0 ? max(0, len - window) : 0,
                       piece * SPLIT_KEYS);
  const int kend = min(len, (piece + 1) * SPLIT_KEYS);
  const int* tb = tables + (size_t)b * pmax;
  const size_t qoff = ((size_t)b * H + (size_t)kh * G) * D;

  for (int i = tid; i < G * D; i += DEC_THREADS)
    q_s[i] = to_f(q[qoff + i]);

  // warp w runs the softmax state of heads w + j * DEC_WARPS, j < HPW
  float m[HPW], l[HPW];
#pragma unroll
  for (int j = 0; j < HPW; ++j) {
    m[j] = NEG_INF;
    l[j] = 0.f;
  }
  float acc[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) acc[g] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += DEC_TK) {
    const int kn = min(DEC_TK, kend - k0);
    __syncthreads();  // q_s is staged / the previous tile is consumed
    for (int c = tid; c < DEC_TK * DC; c += DEC_THREADS) {
      const int r = c / DC, col = (c % DC) * 8;
      const size_t off =
          r < kn ? kv_offset<D>(tb, k0 + r, page, Hkv, kh) + col : 0;
      float kv[8], vv[8];
      load8_or_zero(kp + off, r < kn, kv);
      load8_or_zero(vp + off, r < kn, vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        k_s[r * KLD + col + j] = kv[j];
        v_s[r * D + col + j] = vv[j];
      }
    }
    __syncthreads();

    // scores of the G x DEC_TK (head, key) pairs
    for (int i = tid; i < G * DEC_TK; i += DEC_THREADS) {
      const int g = i / DEC_TK, k = i % DEC_TK;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(q_s[g * D + d], k_s[k * KLD + d], s);
      p_s[g * DEC_TK + k] = s * scale;
    }
    __syncthreads();

    // online softmax over the tile: lane = key
#pragma unroll
    for (int j = 0; j < HPW; ++j) {
      const int g = warp + j * DEC_WARPS;
      if (g < G) {
        const bool ok = lane < kn;
        const float sc = ok ? p_s[g * DEC_TK + lane] : NEG_INF;
        const float m_new = fmaxf(m[j], warp_max(sc));
        const float p = ok ? expf(sc - m_new) : 0.f;
        const float corr = expf(m[j] - m_new);
        l[j] = l[j] * corr + warp_sum(p);
        m[j] = m_new;
        p_s[g * DEC_TK + lane] = p;
        if (lane == 0) corr_s[g] = corr;
      }
    }
    __syncthreads();

    // acc[g] (column tid) = acc * corr + sum_k p[g][k] v[k][tid]
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < G) {
        float a = acc[g] * corr_s[g];
        for (int k = 0; k < kn; ++k)
          a = fmaf(p_s[g * DEC_TK + k], v_s[k * D + tid], a);
        acc[g] = a;
      }
    }
  }

  if (gridDim.z > 1) {
    // this piece's state: [G] maxima, [G] sums, [G][D] context sums
    float* pp = part + (((size_t)b * Hkv + kh) * gridDim.z + piece) * G *
                           (D + 2);
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < HPW; ++j) {
        const int g = warp + j * DEC_WARPS;
        if (g < G) {
          pp[g] = m[j];
          pp[G + g] = l[j];
        }
      }
    }
#pragma unroll
    for (int g = 0; g < GMAX; ++g)
      if (g < G) pp[2 * G + (size_t)g * D + tid] = acc[g];
    return;
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < HPW; ++j)
      if (warp + j * DEC_WARPS < G) l_s[warp + j * DEC_WARPS] = l[j];
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
    if (g < G)
      from_f(out + qoff + (size_t)g * D + tid, acc[g] / fmaxf(l_s[g], 1e-30f));
}

// Merge the pieces of one (sequence, KV head): thread t owns column t of
// each of its G heads. A head with no key in any piece gives zeros.
template <typename T, int D>
__global__ void __launch_bounds__(Dec<D>::THREADS)
    gqa_decode_combine_kernel(const float* __restrict__ part, int H, int Hkv,
                              int pieces, T* __restrict__ out) {
  const int b = blockIdx.x, kh = blockIdx.y, tid = threadIdx.x;
  const int G = H / Hkv;
  const float* pp = part + ((size_t)b * Hkv + kh) * pieces * G * (D + 2);
  const size_t stride = (size_t)G * (D + 2);
  for (int g = 0; g < G; ++g) {
    float mt = NEG_INF;
    for (int p = 0; p < pieces; ++p) mt = fmaxf(mt, pp[p * stride + g]);
    float lt = 0.f, a = 0.f;
    for (int p = 0; p < pieces; ++p) {
      const float f = expf(pp[p * stride + g] - mt);
      lt += pp[p * stride + G + g] * f;
      a += pp[p * stride + 2 * G + (size_t)g * D + tid] * f;
    }
    from_f(out + ((size_t)b * H + (size_t)kh * G + g) * D + tid,
           a / fmaxf(lt, 1e-30f));
  }
}

// ---- prefill ----

constexpr int PF_THREADS = 256;
constexpr int TQ = 64;          // query rows per block (8 a warp in B and C)
constexpr int TK = 32;          // keys per staged tile
constexpr int SLD = TK + 1;

template <int D>
struct Pf {
  static constexpr int DC = D / 8;
  static constexpr int QLD = D + 4;  // q / k row stride in floats: QLD / 4
                                     // odd, so float4 reads of 8 rows hit 8
                                     // bank groups
  static constexpr int NC = D / 128;  // float4 columns a lane in C
  static constexpr size_t SMEM =
      (size_t)(TQ * QLD + TK * QLD + TK * D + TQ * SLD + TK * TQ) *
      sizeof(float);
};

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  acc = fmaf(a.w, b.w, acc);
  return acc;
}

__device__ __forceinline__ void store8(float* dst, const float v[8]) {
  float4* d = reinterpret_cast<float4*>(dst);
  d[0] = make_float4(v[0], v[1], v[2], v[3]);
  d[1] = make_float4(v[4], v[5], v[6], v[7]);
}

template <typename T, int D>
__global__ void __launch_bounds__(PF_THREADS)
    gqa_paged_prefill_kernel(const T* __restrict__ q,
                             const T* __restrict__ kp,
                             const T* __restrict__ vp,
                             const int* __restrict__ tables,
                             const int* __restrict__ lengths,
                             const int* __restrict__ valid, int H, int Hkv,
                             int S, int page, int pmax, int window,
                             float scale, T* __restrict__ out) {
  constexpr int DC = Pf<D>::DC, QLD = Pf<D>::QLD, NC = Pf<D>::NC;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;               // [TQ][QLD]
  float* k_s = q_s + TQ * QLD;     // [TK][QLD]
  float* v_s = k_s + TK * QLD;     // [TK][D]
  float* s_s = v_s + TK * D;       // [TQ][SLD] scores
  float* pt_s = s_s + TQ * SLD;    // [TK][TQ] probabilities, transposed

  const int q0 = blockIdx.x * TQ;  // first flattened row (s * G + g)
  const int kh = blockIdx.y;
  const int c = blockIdx.z;
  const int G = H / Hkv;
  const int rows = G * S;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int old_len = max(lengths[c], 0);
  const int total = min(old_len + max(valid[c], 0), page * pmax);
  const int* tb = tables + (size_t)c * pmax;
  // row s * G + g is query head kh * G + g at position s of [C, H, S, D]
  auto row_offset = [&](int flat) {
    const int s = flat / G, g = flat % G;
    return (((size_t)c * H + (size_t)kh * G + g) * S + s) * D;
  };

  // query tile (rows past G * S are zero and never stored)
  for (int i = tid; i < TQ * DC; i += PF_THREADS) {
    const int r = i / DC, col = (i % DC) * 8;
    const bool live = q0 + r < rows;
    float v[8];
    load8_or_zero(q + (live ? row_offset(q0 + r) + col : 0), live, v);
    store8(q_s + r * QLD + col, v);
  }

  // warp w owns rows 8w .. 8w+7 in phases B and C; lane owns columns
  // 4 * (lane + 32 j) .. + 3, j < NC, in C
  float m[8], l[8];
  float4 acc[8][NC];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // keys the tile's rows can see: causal limit of its last position, window
  // start of its first
  const int s_first = q0 / G;
  const int s_last = (min(q0 + TQ, rows) - 1) / G;
  const int limit = min(total, old_len + s_last + 1);
  const int kstart =
      window > 0 ? max(0, old_len + s_first - window + 1) : 0;
  const int ty = tid >> 4, tx = tid & 15;  // A: rows 4ty..4ty+3, keys tx,
                                           // tx + 16

  for (int k0 = kstart; k0 < limit; k0 += TK) {
    const int kn = min(TK, limit - k0);
    __syncthreads();  // q_s is staged / the previous tile's C is done
    for (int i = tid; i < TK * DC; i += PF_THREADS) {
      const int r = i / DC, col = (i % DC) * 8;
      const size_t off =
          r < kn ? kv_offset<D>(tb, k0 + r, page, Hkv, kh) + col : 0;
      float kv[8], vv[8];
      load8_or_zero(kp + off, r < kn, kv);
      load8_or_zero(vp + off, r < kn, vv);
      store8(k_s + r * QLD + col, kv);
      store8(v_s + r * D + col, vv);
    }
    __syncthreads();

    // A: scores
    {
      float sc[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[i][0] = sc[i][1] = 0.f;
      const float4* ka = reinterpret_cast<const float4*>(k_s + tx * QLD);
      const float4* kb =
          reinterpret_cast<const float4*>(k_s + (tx + 16) * QLD);
#pragma unroll 4
      for (int d = 0; d < D / 4; ++d) {
        const float4 b0 = ka[d], b1 = kb[d];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 a =
              reinterpret_cast<const float4*>(q_s + (4 * ty + i) * QLD)[d];
          sc[i][0] = dot4(a, b0, sc[i][0]);
          sc[i][1] = dot4(a, b1, sc[i][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s_s[(4 * ty + i) * SLD + tx] = sc[i][0] * scale;
        s_s[(4 * ty + i) * SLD + tx + 16] = sc[i][1] * scale;
      }
    }
    __syncthreads();

    // B: online softmax, one key per lane
    float corr[8];
    const int kpos = k0 + lane;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = 8 * warp + i;
      const int qpos = old_len + (q0 + r) / G;
      const bool ok = lane < kn && kpos <= qpos && kpos < total &&
                      (window <= 0 || kpos > qpos - window);
      const float sc = ok ? s_s[r * SLD + lane] : NEG_INF;
      const float m_new = fmaxf(m[i], warp_max(sc));
      const float p = ok ? expf(sc - m_new) : 0.f;
      corr[i] = expf(m[i] - m_new);
      l[i] = l[i] * corr[i] + warp_sum(p);
      m[i] = m_new;
      pt_s[lane * TQ + r] = p;
    }
    __syncwarp();

    // C: acc = acc * corr + P V
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        acc[i][j].x *= corr[i];
        acc[i][j].y *= corr[i];
        acc[i][j].z *= corr[i];
        acc[i][j].w *= corr[i];
      }
    }
    for (int k = 0; k < kn; ++k) {
      const float4 pa = *reinterpret_cast<const float4*>(pt_s + k * TQ +
                                                         8 * warp);
      const float4 pb = *reinterpret_cast<const float4*>(pt_s + k * TQ +
                                                         8 * warp + 4);
      const float pr[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float4 v =
            reinterpret_cast<const float4*>(v_s + k * D)[lane + 32 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i][j].x = fmaf(pr[i], v.x, acc[i][j].x);
          acc[i][j].y = fmaf(pr[i], v.y, acc[i][j].y);
          acc[i][j].z = fmaf(pr[i], v.z, acc[i][j].z);
          acc[i][j].w = fmaf(pr[i], v.w, acc[i][j].w);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int flat = q0 + 8 * warp + i;
    if (flat >= rows) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      T* o = out + row_offset(flat) + 4 * (lane + 32 * j);
      from_f(o, acc[i][j].x * inv);
      from_f(o + 1, acc[i][j].y * inv);
      from_f(o + 2, acc[i][j].z * inv);
      from_f(o + 3, acc[i][j].w * inv);
    }
  }
}

template <typename T, int D>
int launch_decode(const void* q, const void* k, const void* v,
                  const int* tables, const int* lengths, int B, int H,
                  int Hkv, int page, int pmax, int window, float scale,
                  void* out, float* part, cudaStream_t st) {
  auto kernel = gqa_paged_decode_kernel<T, D>;
  static int ready_dev = -1;
  cudaError_t err = kt_mma::allow_smem(kernel, Dec<D>::SMEM, &ready_dev);
  if (err != cudaSuccess) return (int)err;
  const int pieces = (page * pmax + SPLIT_KEYS - 1) / SPLIT_KEYS;
  dim3 grid(B, Hkv, pieces);
  kernel<<<grid, Dec<D>::THREADS, Dec<D>::SMEM, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), tables, lengths, H, Hkv, page, pmax, window,
      scale, static_cast<T*>(out), part);
  if (pieces > 1) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    gqa_decode_combine_kernel<T, D><<<dim3(B, Hkv), Dec<D>::THREADS, 0,
                                      st>>>(part, H, Hkv, pieces,
                                            static_cast<T*>(out));
  }
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_prefill(const void* q, const void* k, const void* v,
                   const int* tables, const int* lengths, const int* valid,
                   int C, int H, int Hkv, int S, int page, int pmax,
                   int window, float scale, void* out, cudaStream_t st) {
  auto kernel = gqa_paged_prefill_kernel<T, D>;
  // raise the dynamic shared memory limit once per instantiation and device
  static int ready_dev = -1;
  cudaError_t err = kt_mma::allow_smem(kernel, (int)Pf<D>::SMEM, &ready_dev);
  if (err != cudaSuccess) return (int)err;
  const int G = H / Hkv;
  dim3 grid((G * S + TQ - 1) / TQ, Hkv, C);
  kernel<<<grid, PF_THREADS, Pf<D>::SMEM, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), tables, lengths, valid, H, Hkv, S, page, pmax,
      window, scale, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

template <typename T>
struct Tag {
  using type = T;
};

}  // namespace

// Pieces of the key range a decode call splits a sequence into; the caller
// allocates B * Hkv * pieces * (H / Hkv) * (D + 2) floats of scratch when
// there is more than one.
extern "C" int kt_gqa_decode_pieces(int page, int pmax) {
  return (page * pmax + SPLIT_KEYS - 1) / SPLIT_KEYS;
}

// dtype: 0 float32, 1 bfloat16 (q, both pools and out share it); D: 128 or
// 256. q [B, H, D], pools [P, page, Hkv, D], tables [B, pmax] int32,
// lengths [B] int32 (valid KV length, current token included), out [B, H,
// D], part the scratch above. Returns the cudaError_t.
extern "C" int kt_gqa_paged_decode(const void* q, const void* k_pages,
                                   const void* v_pages, const void* tables,
                                   const void* lengths, int B, int H, int Hkv,
                                   int page, int pmax, int window, float scale,
                                   int dtype, int D, void* out, void* part,
                                   void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > GMAX || page <= 0 || pmax <= 0 ||
      (D != 128 && D != 256))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lengths);
  float* pt = static_cast<float*>(part);
  auto go = [&](auto tag, auto dim) {
    using T = typename decltype(tag)::type;
    return launch_decode<T, decltype(dim)::value>(
        q, k_pages, v_pages, tb, ln, B, H, Hkv, page, pmax, window, scale,
        out, pt, st);
  };
  using D128 = std::integral_constant<int, 128>;
  using D256 = std::integral_constant<int, 256>;
  if (dtype == 1)
    return D == 128 ? go(Tag<__nv_bfloat16>(), D128())
                    : go(Tag<__nv_bfloat16>(), D256());
  return D == 128 ? go(Tag<float>(), D128()) : go(Tag<float>(), D256());
}

// q [C, H, S, D] (roped), tables [C, pmax], lengths [C] OLD cached length,
// valid [C] live new tokens, out [C, H, S, D]; D 128 or 256.
extern "C" int kt_gqa_paged_prefill(const void* q, const void* k_pages,
                                    const void* v_pages, const void* tables,
                                    const void* lengths, const void* valid,
                                    int C, int H, int Hkv, int S, int page,
                                    int pmax, int window, float scale,
                                    int dtype, int D, void* out,
                                    void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || page <= 0 || pmax <= 0 || S <= 0 ||
      (D != 128 && D != 256))
    return (int)cudaErrorInvalidValue;
  if (C == 0 || H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lengths);
  const int* vl = static_cast<const int*>(valid);
  auto go = [&](auto tag, auto dim) {
    using T = typename decltype(tag)::type;
    return launch_prefill<T, decltype(dim)::value>(
        q, k_pages, v_pages, tb, ln, vl, C, H, Hkv, S, page, pmax, window,
        scale, out, st);
  };
  using D128 = std::integral_constant<int, 128>;
  using D256 = std::integral_constant<int, 256>;
  if (dtype == 1)
    return D == 128 ? go(Tag<__nv_bfloat16>(), D128())
                    : go(Tag<__nv_bfloat16>(), D256());
  return D == 128 ? go(Tag<float>(), D128()) : go(Tag<float>(), D256());
}

// ---- gqa_prefill_mma_kernel: the bf16 gqa_paged_prefill on tensor cores ----
//
// Replaces ktransformers_tpu/ops/pallas/paged_attention.py:gqa_paged_prefill
// (body _gqa_prefill_kernel) for bf16 operands; computes what
// gqa_paged_prefill_kernel computes (query row s sees keys kpos <= lengths +
// s, kpos < lengths + valid and, with a window, kpos > lengths + s -
// window; a row with no key gives zeros; padding rows s >= valid see every
// live key in their window). Bound at the serving shapes: the bf16
// operations of the two products, 4 * H * live pairs * D, against the
// bytes of the live rows. The first version ran float32 FMAs on K / V
// tiles staged as float32. Here:
// - one block per (chunk, KV head, ROWS flattened query rows), row = s * G
//   + g (G = H / Hkv) as in the first version, so a 16-row mma row group
//   is 16 / G positions of the G heads and every staged K / V tile serves
//   all of them; G need not divide 16: each row carries its own position,
//   causal limit and window. ROWS = 64 or 128 by
//   ops/cuda/paged_attention.py:gqa_prefill_plan; row tiles are numbered
//   from the end of the chunk, so the longest walks start first;
// - the block walks key tiles of TK = 64 from its window start (rounded
//   down to a tile) to its causal limit min(live, old + last position +
//   1). Each tile's K and V rows of the block's KV head (256 B at stride
//   Hkv * D in the pool) are copied through the page table with 16-byte
//   cp.async into a three-stage ring (bf16; the query rows are staged in
//   the third stage, free until tile 2 is issued); rows past the limit
//   are zero-filled and never read, so P V never meets 0 x NaN from a
//   recycled page. One barrier a tile: wait for tile t, barrier, issue
//   tile t + 2 into the stage tile t - 1 used, compute tile t;
// - the FlashAttention-2 layout, kept because D = 128 fits one warp: a
//   warp owns 16 query rows outright (its Q fragments stay in registers
//   for the whole walk, 32 registers, from ldmatrix once), runs mma.sync
//   m16n8k16 bf16 for Q K^T (B from ldmatrix on the key rows) into n8
//   score tiles in registers, the online softmax in log2 units in float32
//   (quad shuffles, no shared memory), P rounded to bf16 in registers as
//   the A operand of P V (B from ldmatrix.trans on the V rows) into 16 n8
//   tiles = all 128 columns (64 float32 accumulators). MLA's mla_mma.cuh
//   must split its 512 output columns over the warps of a row group and
//   hand the scores round through shared memory; at D = 128 nothing is
//   shared but the staged tiles;
// - 8 warps a block either way: at 128 rows each warp owns a row group
//   (KSP = 1); at 64 rows two warps share a row group (KSP = 2), each
//   taking 32 keys of every tile with its own softmax state, and the pair
//   is merged through shared memory at the end, so that the mixed step's
//   128 blocks (one an SM) still give each SM 8 warps to hide the copies'
//   and products' latency. A warp whose rows all lie outside its keys of
//   a tile (before their window or past their causal limit) skips its
//   products for that tile.
// Row stride of a staged row: LDS = 136 values, 272 bytes = 17 16-byte
// units (odd), so the 8 rows of an ldmatrix 8x8 hit 8 distinct bank groups.
// Shared memory: the ring, 3 x (K + V) x 64 x 272 B = 102 KB. ptxas
// (sm_90a): 180 registers at KSP = 2, 213 at KSP = 1, no spill; one block
// an SM.
// At D = 256 (Qwen3-Next) a warp's 16 rows hold 128 float32 accumulators a
// thread: the layout stays (a warp owns its rows and all 256 columns, so
// nothing but the tiles is shared), and two things make room for them.
// The query fragments (64 registers at D = 256) are not held: they are read
// from the staged query rows by ldmatrix at each k16 step of every tile,
// and those rows stay staged, after the ring. The tiles hold TK = 32 keys
// (LDS = 264, 528 B = 33 units), so that ring (3 x (K + V) x 32 x 528 B =
// 99 KB) and query rows (128 x 528 B = 66 KB, or 33 KB at 64 rows) fit the
// block's 227 KB together; at 64 rows each warp of a pair takes 16 keys of
// a tile.
// (KT_GQA_CUT_MMA and KT_GQA_CUT_SOFTMAX compile the products and the
// exponentials out for ops/cuda/breakdown.py; the loads stay live.)
namespace kt_gqa_mma {

using bf16 = __nv_bfloat16;

constexpr int STAGES = 3;        // ring stages of K + V tiles
constexpr int THREADS = 256;
constexpr int NWARP = THREADS / 32;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// Shapes of one head dim. At D = 128 a tile holds TK = 64 keys and a warp's
// query fragments stay in registers for the walk (QREG); at D = 256 (a
// warp's 16 rows then hold 128 float32 accumulators a thread) a tile holds
// 32 keys, so that the ring and the query rows of 128 rows fit the block's
// shared memory beside each other, and the fragments are read again from
// the staged query rows at every tile (ldmatrix), 64 registers fewer.
template <int D>
struct Dim {
  static constexpr int CH = D / 8;        // 16-byte copies a row
  static constexpr int LDS = D + 8;       // staged row stride (bf16 values)
  static constexpr int TK = D == 128 ? 64 : 32;  // keys a tile
  static constexpr int DK = D / 16;       // k16 steps of Q K^T
  static constexpr int NO = D / 8;        // n8 output tiles
  static constexpr int TILE = TK * LDS;   // one staged K or V tile (values)
  static constexpr int STAGE = 2 * TILE;  // one stage: K then V (values)
  static constexpr int RING = STAGES * STAGE * 2;  // bytes
  static constexpr bool QREG = D == 128;
};

// KSP warps share each of the block's row groups, each KW keys of a tile
template <int D, int KSP>
struct Shape {
  using Dm = Dim<D>;
  static constexpr int RGN = NWARP / KSP;  // row groups a block
  static constexpr int ROWS = 16 * RGN;
  static constexpr int KW = Dm::TK / KSP;  // keys a warp scores a tile
  static constexpr int NS = KW / 8;        // its n8 score tiles
  static constexpr int KS = KW / 16;       // its k16 steps of P V
  // the query rows: in the ring's last stage (free until tile 2 is issued)
  // with QREG, else after the ring
  static constexpr int SMEM =
      Dm::RING + (Dm::QREG ? 0 : ROWS * Dm::LDS * 2);
  static_assert(!Dm::QREG || ROWS * Dm::LDS <= Dm::STAGE,
                "query rows fit one stage");
  static_assert(KS >= 1 && NS % 2 == 0, "whole k16 steps a warp");
  static_assert((KSP - 1) * 32 * (4 + 4 * Dm::NO) * 4 * RGN <= Dm::RING,
                "the merge's states fit the ring");
  static_assert(SMEM <= 232448, "a block's shared memory");
};

template <int D, int KSP>
__global__ void __launch_bounds__(THREADS, 1)
    gqa_prefill_mma_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ kp,
                           const bf16* __restrict__ vp,
                           const int* __restrict__ tables,
                           const int* __restrict__ lengths,
                           const int* __restrict__ valid, int H, int Hkv,
                           int S, int page, int pmax, int window, float scale,
                           bf16* __restrict__ out) {
  using Sh = Shape<D, KSP>;
  using Dm = Dim<D>;
  constexpr int CH = Dm::CH, LDS = Dm::LDS, TK = Dm::TK, DK = Dm::DK;
  constexpr int NO = Dm::NO, TILE = Dm::TILE, STAGE = Dm::STAGE;
  extern __shared__ __align__(128) uint8_t smem[];
  // stage st: K [TK][LDS] at st * STAGE, then V [TK][LDS]
  bf16* ring = reinterpret_cast<bf16*>(smem);
  bf16* q_s = ring + (Dm::QREG ? (STAGES - 1) : STAGES) * STAGE;  // [ROWS][LDS]

  const int r0 = (gridDim.x - 1 - blockIdx.x) * Sh::ROWS;
  const int kh = blockIdx.y, c = blockIdx.z;
  const int G = H / Hkv;
  const int rows = G * S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = warp % Sh::RGN, part = warp / Sh::RGN;
  const int g = lane >> 2, qd = lane & 3;
  const int old = max(lengths[c], 0);
  const int total = min(old + max(valid[c], 0), page * pmax);
  const int* tb = tables + (size_t)c * pmax;
  // row fr is query head kh * G + fr % G at position fr / G of [C, H, S, D]
  auto row_offset = [&](int fr) {
    return (((size_t)c * H + (size_t)kh * G + fr % G) * S + fr / G) * D;
  };

  // the block's keys: from its first row's window start to its last row's
  // causal limit
  const int limit =
      min(total, old + (min(r0 + Sh::ROWS, rows) - 1) / G + 1);
  const int kbeg = window > 0 ? max(0, old + r0 / G - window + 1) : 0;
  const int first = kbeg / TK * TK;
  const int nt = kbeg < limit ? (limit - first + TK - 1) / TK : 0;

  // this thread's rows g and g + 8 of its row group: keys lo[e] <= kpos <
  // hi[e]
  const int w0 = r0 + 16 * rg;
  int lo[2], hi[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int fr = w0 + g + 8 * e;
    const int qpos = old + fr / G;
    hi[e] = fr < rows ? min(total, qpos + 1) : 0;
    lo[e] = window > 0 ? qpos - window + 1 : 0;
  }
  // the row group's keys: the union of its rows'
  const int whi =
      w0 < rows ? min(total, old + (min(w0 + 16, rows) - 1) / G + 1) : 0;
  const int wlo = window > 0 ? old + w0 / G - window + 1 : 0;

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[NO][4];
#pragma unroll
  for (int t = 0; t < NO; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[t][i] = 0.f;

  if (nt > 0) {
    for (int i = tid; i < Sh::ROWS * CH; i += THREADS) {
      const int r = i / CH, ch = i - r * CH;
      const bool ok = r0 + r < rows;
      kt_mma::cp_async16(q_s + r * LDS + ch * 8,
                         q + (ok ? row_offset(r0 + r) : 0) + ch * 8, ok);
    }
  }
  // K and V rows of positions k0 .. k0 + TK into ring stage st
  auto stage = [&](int st, int k0) {
    for (int i = tid; i < TK * CH; i += THREADS) {
      const int r = i / CH, ch = i - r * CH;
      const int pos = k0 + r;
      const bool ok = pos < limit;
      const size_t off =
          ok ? (((size_t)__ldg(tb + pos / page) * page + pos % page) * Hkv +
                kh) * D + ch * 8
             : 0;
      bf16* dst = ring + st * STAGE + r * LDS + ch * 8;
      kt_mma::cp_async16(dst, kp + off, ok);
      kt_mma::cp_async16(dst + TILE, vp + off, ok);
    }
  };
  // group 0: the query rows and tile 0; group 1: tile 1; then one group a
  // tile (empty past the last), so that wait<1> at tile t means tile t
  if (nt > 0) stage(0, first);
  kt_mma::cp_async_commit();
  if (nt > 1) stage(1, first + TK);
  kt_mma::cp_async_commit();

  const float sl = scale * LOG2E;
  // the warp's query fragments: in registers for the walk (QREG) or read
  // again at every tile from its staged rows
  const bf16* qa = q_s + (16 * rg + (lane & 15)) * LDS + (lane >> 4) * 8;
  uint32_t qf[Dm::QREG ? DK : 1][4];
  for (int t = 0; t < nt; ++t) {
    const int k0 = first + t * TK;
    kt_mma::cp_async_wait<1>();
    __syncthreads();  // tile t landed; every warp is done with tile t - 1
    if constexpr (Dm::QREG) {
      if (t == 0) {
#pragma unroll
        for (int d = 0; d < DK; ++d) kt_mma::ldmatrix_x4(qf[d], qa + 16 * d);
        __syncthreads();  // every warp holds its query rows: q_s is free
      }
    }
    if (t + 2 < nt) stage((t + 2) % STAGES, k0 + 2 * TK);
    kt_mma::cp_async_commit();
    const int kb = k0 + part * Sh::KW;  // this warp's keys kb .. kb + KW
    if (kb >= whi || kb + Sh::KW <= wlo) continue;
    const bf16* kc = ring + (t % STAGES) * STAGE + part * Sh::KW * LDS;
    const bf16* vc = kc + TILE;

    // scores: sc[n][j], row g + 8 (j >> 1), key kb + 8 n + 2 qd + (j & 1)
    float sc[Sh::NS][4];
#pragma unroll
    for (int n = 0; n < Sh::NS; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[n][i] = 0.f;
    // one x4 of B covers 16 keys x 16 depth: two n8 tiles
    const bf16* kr =
        kc + ((lane & 7) + ((lane >> 4) << 3)) * LDS + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int d = 0; d < DK; ++d) {
      uint32_t qd4[4];
      if constexpr (Dm::QREG) {
#pragma unroll
        for (int i = 0; i < 4; ++i) qd4[i] = qf[d][i];
      } else {
        kt_mma::ldmatrix_x4(qd4, qa + 16 * d);
      }
#pragma unroll
      for (int p = 0; p < Sh::NS / 2; ++p) {
        uint32_t b[4];
        kt_mma::ldmatrix_x4(b, kr + p * 16 * LDS + 16 * d);
#if KT_GQA_CUT_MMA
        sc[2 * p][0] += __uint_as_float((qd4[0] ^ b[0]) & 0x3f7fffffu);
        sc[2 * p + 1][1] += __uint_as_float((qd4[1] ^ b[3]) & 0x3f7fffffu);
#else
        kt_mma::mma_bf16_16816(sc[2 * p], qd4, b[0], b[1]);
        kt_mma::mma_bf16_16816(sc[2 * p + 1], qd4, b[2], b[3]);
#endif
      }
    }

    // online softmax of rows g, g + 8 (log2 units), P in place
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float mx = NEG_INF;
#pragma unroll
      for (int n = 0; n < Sh::NS; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int kpos = kb + 8 * n + 2 * qd + j;
          sc[n][2 * e + j] *= sl;
          if (kpos >= lo[e] && kpos < hi[e])
            mx = fmaxf(mx, sc[n][2 * e + j]);
        }
      const float m_new = fmaxf(m[e], kt_mma::quad_max(mx));
      const float corr = exp2f(m[e] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < Sh::NS; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int kpos = kb + 8 * n + 2 * qd + j;
          const bool ok = kpos >= lo[e] && kpos < hi[e];
#if KT_GQA_CUT_SOFTMAX
          const float p = ok ? sc[n][2 * e + j] - m_new : 0.f;
#else
          const float p = ok ? exp2f(sc[n][2 * e + j] - m_new) : 0.f;
#endif
          sc[n][2 * e + j] = p;
          sum += p;
        }
      l[e] = l[e] * corr + kt_mma::quad_sum(sum);
      m[e] = m_new;
#pragma unroll
      for (int o = 0; o < NO; ++o) {
        acc[o][2 * e] *= corr;
        acc[o][2 * e + 1] *= corr;
      }
    }

    // acc += P V: P (bf16) from the score tiles, V by ldmatrix.trans
    const bf16* vb = vc + (lane & 15) * LDS + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < Sh::KS; ++kk) {
      uint32_t pa[4];
      pa[0] = kt_mma::pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
      pa[1] = kt_mma::pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
      pa[2] = kt_mma::pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      pa[3] = kt_mma::pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
      for (int p = 0; p < NO / 2; ++p) {
        uint32_t b[4];
        kt_mma::ldmatrix_x4_trans(b, vb + kk * 16 * LDS + p * 16);
#if KT_GQA_CUT_MMA
        acc[2 * p][0] += __uint_as_float((pa[0] ^ b[0]) & 0x3f7fffffu);
        acc[2 * p + 1][1] += __uint_as_float((pa[1] ^ b[3]) & 0x3f7fffffu);
#else
        kt_mma::mma_bf16_16816(acc[2 * p], pa, b[0], b[1]);
        kt_mma::mma_bf16_16816(acc[2 * p + 1], pa, b[2], b[3]);
#endif
      }
    }
  }

  if constexpr (KSP == 2) {
    // the second warp of each row group hands its state (m, l, acc) to the
    // first through the ring, which no copy targets any more
    float* st_s = reinterpret_cast<float*>(smem) +
                  (size_t)(rg * 32 + lane) * (4 + 4 * NO);
    kt_mma::cp_async_wait<0>();
    __syncthreads();
    if (part == 1) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        st_s[e] = m[e];
        st_s[2 + e] = l[e];
      }
#pragma unroll
      for (int o = 0; o < NO; ++o)
        *reinterpret_cast<float4*>(st_s + 4 + 4 * o) =
            make_float4(acc[o][0], acc[o][1], acc[o][2], acc[o][3]);
    }
    __syncthreads();
    if (part == 1) return;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float m1 = st_s[e], l1 = st_s[2 + e];
      const float mm = fmaxf(m[e], m1);
      const float a0 = exp2f(m[e] - mm), a1 = exp2f(m1 - mm);
      l[e] = l[e] * a0 + l1 * a1;
#pragma unroll
      for (int o = 0; o < NO; ++o) {
        acc[o][2 * e] = acc[o][2 * e] * a0 + st_s[4 + 4 * o + 2 * e] * a1;
        acc[o][2 * e + 1] =
            acc[o][2 * e + 1] * a0 + st_s[4 + 4 * o + 2 * e + 1] * a1;
      }
    }
  }

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int fr = w0 + g + 8 * e;
    if (fr >= rows) continue;
    const float inv = 1.f / fmaxf(l[e], 1e-30f);
    bf16* o = out + row_offset(fr) + 2 * qd;
#pragma unroll
    for (int t = 0; t < NO; ++t)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * t) =
          __floats2bfloat162_rn(acc[t][2 * e] * inv, acc[t][2 * e + 1] * inv);
  }
}

template <int D, int KSP>
int launch(const void* q, const void* k, const void* v, const int* tables,
           const int* lengths, const int* valid, int C, int H, int Hkv,
           int S, int page, int pmax, int window, float scale, void* out,
           cudaStream_t st) {
  using Sh = Shape<D, KSP>;
  auto kernel = gqa_prefill_mma_kernel<D, KSP>;
  static int ready_dev = -1;
  cudaError_t err = kt_mma::allow_smem(kernel, Sh::SMEM, &ready_dev);
  if (err != cudaSuccess) return (int)err;
  const int rows = H / Hkv * S;
  dim3 grid((rows + Sh::ROWS - 1) / Sh::ROWS, Hkv, C);
  kernel<<<grid, THREADS, Sh::SMEM, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), tables, lengths, valid, H, Hkv, S, page,
      pmax, window, scale, static_cast<bf16*>(out));
  return (int)cudaGetLastError();
}

}  // namespace kt_gqa_mma

// The bf16 gqa_paged_prefill on gqa_prefill_mma_kernel: operands as
// kt_gqa_paged_prefill (bf16 only); rows = 64 (two warps a row group, the
// keys of a tile split between them) or 128 (a warp a row group) flattened
// query rows a block; D = 128 or 256.
extern "C" int kt_gqa_prefill_mma(const void* q, const void* k_pages,
                                  const void* v_pages, const void* tables,
                                  const void* lengths, const void* valid,
                                  int C, int H, int Hkv, int S, int page,
                                  int pmax, int window, float scale, int rows,
                                  int D, void* out, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || page <= 0 || pmax <= 0 || S <= 0 ||
      (rows != 64 && rows != 128) || (D != 128 && D != 256))
    return (int)cudaErrorInvalidValue;
  if (C == 0 || H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lengths);
  const int* vl = static_cast<const int*>(valid);
#define KT_GQA_PREFILL(DIM, KSP)                                              \
  kt_gqa_mma::launch<DIM, KSP>(q, k_pages, v_pages, tb, ln, vl, C, H, Hkv, S, \
                               page, pmax, window, scale, out, st)
  if (D == 128)
    return rows == 64 ? KT_GQA_PREFILL(128, 2) : KT_GQA_PREFILL(128, 1);
  return rows == 64 ? KT_GQA_PREFILL(256, 2) : KT_GQA_PREFILL(256, 1);
#undef KT_GQA_PREFILL
}

// ---- gqa_decode_split_kernel: the bf16 gqa_paged_decode, split over the
// keys, on tensor cores ----
//
// Replaces ktransformers_tpu/ops/pallas/paged_attention.py:gqa_paged_decode
// (body _gqa_kernel) for bf16 operands; computes what
// gqa_paged_decode_kernel + gqa_decode_combine_kernel compute (query head
// h of sequence b sees keys kpos < lengths[b] and, with a window, kpos >=
// lengths[b] - window; no key gives zeros). Bound: the bytes of the K and
// V rows in the window, read once. The first version staged K and V as
// float32, scored with scalar FMAs, ran a softmax of a lane per key, added
// P V column by column and merged its pieces in a second launch: 10.7x its
// byte bound at the serving batch. Here:
// - the grid is (B, splits, Hkv); `splits` is a pure function of the
//   shapes (ops/cuda/paged_attention.py:gqa_decode_split_plan: the most
//   whose blocks fit the card at once, 4 at Mixtral's serving batch), and
//   block (b, s, kh) cuts the keys of sequence b it may
//   see, [kbeg, len) with kbeg = max(0, len - window) under a window, into
//   `splits` runs of `chunk` = max(TK, ceil((len - kbeg) / splits) rounded
//   up to 16) keys (split_chunk), from the length on the card: every split
//   of a long window does work and no split lies outside it; the splits
//   past the last key hold none and write nothing;
// - the G = H / Hkv query heads of the KV head are the rows of one m16 row
//   group (G <= 16; rows past G are zero, never stored), their Q fragments
//   in registers for the whole walk; the block walks its keys in tiles of
//   TK = 64, each tile's K and V rows of the KV head (256 B each, at stride
//   Hkv * D in the pool) copied through the page table with 16-byte
//   cp.async into a three-stage ring (two tiles in flight while one is
//   computed), rows past the split's end zero-filled and never read
//   (recycled pages may hold NaN);
// - 4 warps split each tile's keys, 16 a warp, each with its own softmax
//   state (m, l in log2 units, acc for all 128 columns): Q K^T and P V on
//   bf16 mma.sync m16n8k16, P rounded to bf16 in registers. After the walk
//   the warps' states meet in warp order through shared memory; with one
//   split that is the output, with more the block writes the merged state
//   to its record (m [16], l [16], acc [16][128] floats) and arrives on the
//   (sequence, KV head) counter; the last block to arrive merges the
//   records of the splits that hold a key in split order (weights
//   exp2(m_i - M) / L; each thread a column of every head, the heads'
//   loads of a record in flight together), writes the G rows and sets the
//   counter back. One launch, no combine kernel, the same bits on every
//   call.
// Shared memory: the query rows 16 x 272 B, the ring 3 x (K + V) x 64 x
// 272 B: 106 KB, two blocks an SM. At D = 256 the same walk: the query rows
// 16 x 528 B and the ring 3 x (K + V) x 64 x 528 B, 206 KB, one block an
// SM; the query fragments are read from the staged rows at each k16 step
// instead of held (the accumulators of 256 columns take 128 registers a
// thread), a record holds acc [16][256], and the merge's threads take two
// columns of each head apiece.
// (KT_GQA_CUT_MMA and KT_GQA_CUT_SOFTMAX compile the products and the
// exponentials out, KT_GQA_CUT_MERGE the cross-split merge, for
// ops/cuda/breakdown.py.)
namespace kt_gqa_mma {
namespace decode {

constexpr int THREADS = 128;
constexpr int NW = THREADS / 32;
constexpr int TK = 64;                // keys a tile
constexpr int KW = TK / NW;           // keys a warp of each tile: 16
constexpr int HT = 16;                // query rows: one mma row group
constexpr int UNIT = 16;              // a split's keys: a multiple of this
constexpr int MAX_SPLITS = 32;        // one merge record a lane
constexpr int SD = 3;                 // ring stages of K + V tiles
static_assert(KW == 16, "a warp's keys: one k16 step of P V");

// Shapes of one head dim: at D = 128 two blocks an SM and the query
// fragments in registers; at D = 256 (211 KB of shared memory) one block an
// SM, the fragments read again from the staged query rows at each k16 step
// (the accumulators of all 256 columns take 128 registers a thread).
template <int D>
struct Dec {
  static constexpr int CH = D / 8;
  static constexpr int LDS = D + 8;
  static constexpr int DK = D / 16;
  static constexpr int NO = D / 8;
  static constexpr int TILE = TK * LDS;
  static constexpr int STAGE = 2 * TILE;
  static constexpr int REC = 2 * HT + HT * D;  // m [HT], l [HT], acc [HT][D]
  static constexpr int ST = 4 + 4 * NO;        // a lane's share of a state
  static constexpr int Q_BYTES = HT * LDS * 2;
  static constexpr int RING_BYTES = SD * STAGE * 2;
  static constexpr int SMEM = Q_BYTES + RING_BYTES;
  static constexpr bool QREG = D == 128;
  static constexpr int MIN_BLOCKS = D == 128 ? 2 : 1;
  static_assert((NW - 1) * 32 * ST * 4 <= RING_BYTES,
                "the warps' states fit the ring");
  static_assert(MAX_SPLITS * HT * 4 <= RING_BYTES, "the weights fit the ring");
  static_assert(SMEM <= 232448, "a block's shared memory");
};

// Keys a split takes of n live keys (ops/cuda/paged_attention.py:
// gqa_decode_split_rows).
__device__ __forceinline__ int split_chunk(int n, int splits) {
  const int per = (n + splits - 1) / splits;
  return max(TK, (per + UNIT - 1) / UNIT * UNIT);
}

template <int D>
__global__ void __launch_bounds__(THREADS, Dec<D>::MIN_BLOCKS)
    gqa_decode_split_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ kp,
                            const bf16* __restrict__ vp,
                            const int* __restrict__ tables,
                            const int* __restrict__ lengths, int H, int Hkv,
                            int page, int pmax, int window, float scale,
                            float* __restrict__ part, int* __restrict__ cnt,
                            bf16* __restrict__ out) {
  using Dc = Dec<D>;
  constexpr int CH = Dc::CH, LDS = Dc::LDS, DK = Dc::DK, NO = Dc::NO;
  constexpr int TILE = Dc::TILE, STAGE = Dc::STAGE, REC = Dc::REC;
  constexpr int ST = Dc::ST;
  extern __shared__ __align__(128) uint8_t smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);                 // [HT][LDS]
  bf16* ring = reinterpret_cast<bf16*>(smem + Dc::Q_BYTES);  // SD x (K, V)
  float* f_s = reinterpret_cast<float*>(smem + Dc::Q_BYTES);  // after walk

  const int b = blockIdx.x, sp = blockIdx.y, kh = blockIdx.z;
  const int splits = gridDim.y;
  const int G = H / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, qd = lane & 3;
  const int len = min(max(lengths[b], 0), page * pmax);
  const int kbeg = window > 0 ? max(0, len - window) : 0;
  const int n = len - kbeg;
  const int chunk = split_chunk(n, splits);
  const int start = kbeg + sp * chunk;
  const int end = min(len, start + chunk);
  const int nt = end > start ? (end - start + TK - 1) / TK : 0;
  const int* tb = tables + (size_t)b * pmax;
  const size_t pair = (size_t)b * Hkv + kh;
  const size_t qrow = (size_t)b * H + (size_t)kh * G;  // the first head

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[NO][4];
#pragma unroll
  for (int t = 0; t < NO; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[t][i] = 0.f;

  if (nt > 0) {
    for (int i = tid; i < HT * CH; i += THREADS) {
      const int r = i / CH, ch = i - r * CH;
      const bool ok = r < G;
      kt_mma::cp_async16(q_s + r * LDS + ch * 8,
                         q + (qrow + (ok ? r : 0)) * D + ch * 8, ok);
    }
    // K and V rows of positions k0 .. k0 + TK into ring stage st
    auto stage = [&](int st, int k0) {
      for (int i = tid; i < TK * CH; i += THREADS) {
        const int r = i / CH, ch = i - r * CH;
        const int pos = k0 + r;
        const bool ok = pos < end;
        const size_t off =
            ok ? (((size_t)__ldg(tb + pos / page) * page + pos % page) * Hkv +
                  kh) * D + ch * 8
               : 0;
        bf16* dst = ring + st * STAGE + r * LDS + ch * 8;
        kt_mma::cp_async16(dst, kp + off, ok);
        kt_mma::cp_async16(dst + TILE, vp + off, ok);
      }
    };
    // group s < SD - 1: tile s (group 0 with the query rows); then one
    // group a tile (empty past the last), so that wait<SD - 2> at tile t
    // means tile t landed
#pragma unroll
    for (int st = 0; st < SD - 1; ++st) {
      if (st < nt) stage(st, start + st * TK);
      kt_mma::cp_async_commit();
    }

    const float sl = scale * LOG2E;
    const bf16* qa = q_s + (lane & 15) * LDS + (lane >> 4) * 8;
    uint32_t qf[Dc::QREG ? DK : 1][4];
    for (int t = 0; t < nt; ++t) {
      const int k0 = start + t * TK;
      kt_mma::cp_async_wait<SD - 2>();
      __syncthreads();  // tile t landed; every warp is done with tile t - 1
      if constexpr (Dc::QREG) {
        if (t == 0) {
#pragma unroll
          for (int d = 0; d < DK; ++d) kt_mma::ldmatrix_x4(qf[d], qa + 16 * d);
        }
      }
      if (t + SD - 1 < nt) stage((t + SD - 1) % SD, k0 + (SD - 1) * TK);
      kt_mma::cp_async_commit();
      const int kb = k0 + warp * KW;  // this warp's keys kb .. kb + KW
      if (kb < end) {
        const bf16* kc = ring + (t % SD) * STAGE + warp * KW * LDS;
        const bf16* vc = kc + TILE;
        // scores: sc[n][j], row g + 8 (j >> 1), key kb + 8 n + 2 qd + (j & 1)
        float sc[2][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[0][i] = sc[1][i] = 0.f;
        // one x4 of B covers the warp's 16 keys x 16 depth: two n8 tiles
        const bf16* kr = kc + ((lane & 7) + ((lane >> 4) << 3)) * LDS +
                         ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int d = 0; d < DK; ++d) {
          uint32_t qd4[4];
          if constexpr (Dc::QREG) {
#pragma unroll
            for (int i = 0; i < 4; ++i) qd4[i] = qf[d][i];
          } else {
            kt_mma::ldmatrix_x4(qd4, qa + 16 * d);
          }
          uint32_t bk[4];
          kt_mma::ldmatrix_x4(bk, kr + 16 * d);
#if KT_GQA_CUT_MMA
          sc[0][0] += __uint_as_float((qd4[0] ^ bk[0]) & 0x3f7fffffu);
          sc[1][1] += __uint_as_float((qd4[1] ^ bk[3]) & 0x3f7fffffu);
#else
          kt_mma::mma_bf16_16816(sc[0], qd4, bk[0], bk[1]);
          kt_mma::mma_bf16_16816(sc[1], qd4, bk[2], bk[3]);
#endif
        }
        // online softmax of rows g, g + 8 (log2 units), P in place
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float mx = NEG_INF;
#pragma unroll
          for (int nn = 0; nn < 2; ++nn)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              sc[nn][2 * e + j] *= sl;
              if (kb + 8 * nn + 2 * qd + j < end)
                mx = fmaxf(mx, sc[nn][2 * e + j]);
            }
          const float m_new = fmaxf(m[e], kt_mma::quad_max(mx));
          const float corr = exp2f(m[e] - m_new);
          float sum = 0.f;
#pragma unroll
          for (int nn = 0; nn < 2; ++nn)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const bool ok = kb + 8 * nn + 2 * qd + j < end;
#if KT_GQA_CUT_SOFTMAX
              const float p = ok ? sc[nn][2 * e + j] - m_new : 0.f;
#else
              const float p = ok ? exp2f(sc[nn][2 * e + j] - m_new) : 0.f;
#endif
              sc[nn][2 * e + j] = p;
              sum += p;
            }
          l[e] = l[e] * corr + kt_mma::quad_sum(sum);
          m[e] = m_new;
#pragma unroll
          for (int o = 0; o < NO; ++o) {
            acc[o][2 * e] *= corr;
            acc[o][2 * e + 1] *= corr;
          }
        }
        // acc += P V: P (bf16) from the score tiles, V by ldmatrix.trans
        uint32_t pa[4];
        pa[0] = kt_mma::pack_bf16(sc[0][0], sc[0][1]);
        pa[1] = kt_mma::pack_bf16(sc[0][2], sc[0][3]);
        pa[2] = kt_mma::pack_bf16(sc[1][0], sc[1][1]);
        pa[3] = kt_mma::pack_bf16(sc[1][2], sc[1][3]);
        const bf16* vb = vc + (lane & 15) * LDS + (lane >> 4) * 8;
#pragma unroll
        for (int p = 0; p < NO / 2; ++p) {
          uint32_t bv[4];
          kt_mma::ldmatrix_x4_trans(bv, vb + p * 16);
#if KT_GQA_CUT_MMA
          acc[2 * p][0] += __uint_as_float((pa[0] ^ bv[0]) & 0x3f7fffffu);
          acc[2 * p + 1][1] += __uint_as_float((pa[1] ^ bv[3]) & 0x3f7fffffu);
#else
          kt_mma::mma_bf16_16816(acc[2 * p], pa, bv[0], bv[1]);
          kt_mma::mma_bf16_16816(acc[2 * p + 1], pa, bv[2], bv[3]);
#endif
        }
      }
    }
    kt_mma::cp_async_wait<0>();
    __syncthreads();  // every warp is done with the ring
  }

  // the warps' states meet in warp order (the ring is free: every copy
  // landed and every warp passed the walk's last barrier)
  float* st_s = f_s + (size_t)lane * ST;  // warp w's at + (w - 1) * 32 * ST
  if (warp > 0) {
    float* mine = st_s + (size_t)(warp - 1) * 32 * ST;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      mine[e] = m[e];
      mine[2 + e] = l[e];
    }
#pragma unroll
    for (int o = 0; o < NO; ++o)
      *reinterpret_cast<float4*>(mine + 4 + 4 * o) =
          make_float4(acc[o][0], acc[o][1], acc[o][2], acc[o][3]);
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float mm = m[e];
#pragma unroll
      for (int w = 1; w < NW; ++w)
        mm = fmaxf(mm, st_s[(size_t)(w - 1) * 32 * ST + e]);
      const float a0 = exp2f(m[e] - mm);
      float ll = l[e] * a0;
#pragma unroll
      for (int o = 0; o < NO; ++o) {
        acc[o][2 * e] *= a0;
        acc[o][2 * e + 1] *= a0;
      }
#pragma unroll
      for (int w = 1; w < NW; ++w) {
        const float* sw = st_s + (size_t)(w - 1) * 32 * ST;
        const float aw = exp2f(sw[e] - mm);
        ll += sw[2 + e] * aw;
#pragma unroll
        for (int o = 0; o < NO; ++o) {
          acc[o][2 * e] += sw[4 + 4 * o + 2 * e] * aw;
          acc[o][2 * e + 1] += sw[4 + 4 * o + 2 * e + 1] * aw;
        }
      }
      m[e] = mm;
      l[e] = ll;
    }
    if (splits == 1) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int h = g + 8 * e;
        if (h >= G) continue;
        const float inv = 1.f / fmaxf(l[e], 1e-30f);
        bf16* o = out + (qrow + h) * D + 2 * qd;
#pragma unroll
        for (int t = 0; t < NO; ++t)
          *reinterpret_cast<__nv_bfloat162*>(o + 8 * t) =
              __floats2bfloat162_rn(acc[t][2 * e] * inv,
                                    acc[t][2 * e + 1] * inv);
      }
    } else if (nt > 0) {  // this split's record
      float* rec = part + (pair * splits + sp) * REC;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int h = g + 8 * e;
        if (qd == 0) {
          rec[h] = m[e];
          rec[HT + h] = l[e];
        }
        float* a = rec + 2 * HT + h * D + 2 * qd;
#pragma unroll
        for (int t = 0; t < NO; ++t)
          *reinterpret_cast<float2*>(a + 8 * t) =
              make_float2(acc[t][2 * e], acc[t][2 * e + 1]);
      }
    }
  }
  if (splits == 1) return;
  if (!kt_mma::arrive_last(cnt + pair, splits)) return;
#if !KT_GQA_CUT_MERGE
  // the splits that hold a key, in split order: weights exp2(m_i - M) / L
  // per head (a lane a record), then thread tid sums columns tid, tid +
  // THREADS, ... of each head; none gives zeros
  const int live = n > 0 ? (n + chunk - 1) / chunk : 0;
  const float* base = part + pair * splits * REC;
  float* w_s = f_s;  // [MAX_SPLITS][HT]
  for (int h = warp; h < G; h += NW) {
    const bool ok = lane < live;
    const float* ri = base + (size_t)(ok ? lane : 0) * REC;
    const float mi = ok ? __ldcg(ri + h) : NEG_INF;
    const float li = ok ? __ldcg(ri + HT + h) : 0.f;
    const float mx = kt_mla::warp_max(mi);
    const float wi = ok ? exp2f(mi - mx) : 0.f;
    const float inv = 1.f / fmaxf(kt_mla::warp_sum(li * wi), 1e-30f);
    if (ok) w_s[lane * HT + h] = wi * inv;
  }
  __syncthreads();
  // per record, the G heads' loads in flight together
#pragma unroll
  for (int c0 = 0; c0 < D; c0 += THREADS) {
    float o[HT];
#pragma unroll
    for (int h = 0; h < HT; ++h) o[h] = 0.f;
    for (int i = 0; i < live; ++i) {
      const float* col = base + (size_t)i * REC + 2 * HT + c0 + tid;
      float v[HT];
#pragma unroll
      for (int h = 0; h < HT; ++h) v[h] = h < G ? __ldcg(col + h * D) : 0.f;
#pragma unroll
      for (int h = 0; h < HT; ++h)
        if (h < G) o[h] += w_s[i * HT + h] * v[h];
    }
#pragma unroll
    for (int h = 0; h < HT; ++h)
      if (h < G) out[(qrow + h) * D + c0 + tid] = __float2bfloat16(o[h]);
  }
#endif
  if (tid == 0) cnt[pair] = 0;  // ready for the next launch
}

template <int D>
int launch_split(const void* q, const void* k_pages, const void* v_pages,
                 const void* tables, const void* lengths, int B, int H,
                 int Hkv, int page, int pmax, int window, int splits,
                 float scale, void* part, void* cnt, void* out,
                 cudaStream_t st) {
  static int ready_dev = -1;
  cudaError_t err = kt_mma::allow_smem(gqa_decode_split_kernel<D>,
                                       Dec<D>::SMEM, &ready_dev);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, splits, Hkv);
  gqa_decode_split_kernel<D><<<grid, THREADS, Dec<D>::SMEM, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_pages),
      static_cast<const bf16*>(v_pages), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), H, Hkv, page, pmax, window, scale,
      static_cast<float*>(part), static_cast<int*>(cnt),
      static_cast<bf16*>(out));
  return (int)cudaGetLastError();
}

}  // namespace decode
}  // namespace kt_gqa_mma

// The bf16 gqa_paged_decode on gqa_decode_split_kernel: operands as
// kt_gqa_paged_decode (bf16 only, H / Hkv <= 16, D = 128 or 256); `splits`
// blocks a (sequence, KV head), 1 <= splits <= 32; part holds B * Hkv *
// splits * (2 * 16 + 16 * D) floats and cnt B * Hkv ints, zero on entry
// (left zero); both may be null with one split.
extern "C" int kt_gqa_decode_split(const void* q, const void* k_pages,
                                   const void* v_pages, const void* tables,
                                   const void* lengths, int B, int H, int Hkv,
                                   int page, int pmax, int window, int splits,
                                   float scale, int D, void* part, void* cnt,
                                   void* out, void* stream) {
  namespace K = kt_gqa_mma::decode;
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > K::HT || page <= 0 ||
      pmax <= 0 || splits < 1 || splits > K::MAX_SPLITS || Hkv > 65535 ||
      (D != 128 && D != 256) ||
      (splits > 1 && (part == nullptr || cnt == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return K::launch_split<128>(q, k_pages, v_pages, tables, lengths, B, H,
                                Hkv, page, pmax, window, splits, scale, part,
                                cnt, out, st);
  return K::launch_split<256>(q, k_pages, v_pages, tables, lengths, B, H, Hkv,
                              page, pmax, window, splits, scale, part, cnt,
                              out, st);
}
