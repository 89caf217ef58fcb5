// Tensor-core core of the three bf16 MLA attention kernels:
// mla_decode.cu's mla_decode_split_kernel (row 5, mla_decode_fused) and
// paged_attention.cu's mla_paged_decode_split_kernel (row 12,
// mla_paged_decode) and mla_prefill_mma_kernel (row 14, mla_paged_prefill).
//
// Absorbed MLA: score = (qn . ckv + qp . kpe) * scale over a depth of
// D = 512 + 64, value = ckv. A block holds RG row groups of 16 query rows
// (bf16, [qn | qp] a row) in shared memory and walks the keys in tiles of
// TK positions, each staged once as [ckv | kpe] rows (bf16, 16-byte
// cp.async, rows the kernel must not read zero-filled) in a two-stage
// ring. The ckv part of the staged tile is also the V operand: no second
// copy. Per tile, with 8 warps:
//   scores: warp (rg, cw) runs mma.sync m16n8k16 for its row group's 16
//           rows against KW = TK / CW keys (CW = 8 / RG warps share a row
//           group), A from ldmatrix_x4 on the query rows, B from ldmatrix
//           on the key rows; the float32 scores, times scale * log2(e), go
//           to shared memory, so each is computed once;
//   softmax: every warp of the row group reads all TK scores of its rows
//           in the A-fragment layout, masks key kpos >= lim[row], and
//           keeps the running max / sum in float32 (identical in the CW
//           warps: same inputs, same order);
//   P V:    P rounded to bf16 (registers) times the staged ckv rows
//           (ldmatrix_x4_trans), into the warp's COLS = 512 / CW output
//           columns, float32 accumulators in registers.
// Row stride of a staged row: LDS = 584 values, 1168 bytes = 73 16-byte
// units (odd), so the 8 rows of an ldmatrix 8x8 hit 8 distinct bank groups.
// (KT_MLA_CUT_MMA and KT_MLA_CUT_SOFTMAX compile the products and the
// exponentials out for ops/cuda/breakdown.py; the loads stay live.)
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"
#include "online_softmax.cuh"

namespace kt_mla_mma {

using bf16 = __nv_bfloat16;

constexpr int R = 512;          // compressed kv width: the value
constexpr int DR = 64;          // rope width
constexpr int D = R + DR;       // score depth
constexpr int CHUNKS = D / 8;   // 16-byte copies a staged row
constexpr int LDS = D + 8;      // staged row stride (bf16 values)
constexpr int THREADS = 256;
constexpr int NWARP = THREADS / 32;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int RG, int TK>
struct Tile {
  static constexpr int ROWS = 16 * RG;    // query rows of a block
  static constexpr int CW = NWARP / RG;   // warps sharing a row group
  static constexpr int COLS = R / CW;     // output columns a warp owns
  static constexpr int NTO = COLS / 8;    // its n8 output tiles
  static constexpr int KW = TK / CW;      // keys a warp scores a tile
  static constexpr int NTS = KW / 8;      // its n8 score tiles
  static constexpr int KS = TK / 16;      // k16 steps of P V a tile
  static constexpr int SLD = TK + 8;      // score row stride (floats)
  static constexpr int Q_BYTES = ROWS * LDS * 2;
  static constexpr int K_BYTES = TK * LDS * 2;  // one ring stage
  static constexpr int S_BYTES = ROWS * SLD * 4;
  static constexpr int SMEM = Q_BYTES + 2 * K_BYTES + S_BYTES;
  static_assert(NWARP % RG == 0 && KW % 8 == 0 && NTO % 2 == 0 &&
                    (NTS == 1 || NTS % 2 == 0) && TK % 16 == 0,
                "tile shape");
};

// A thread's share of the softmax state: rows g = lane / 4 and g + 8 of its
// warp's row group (m in log2 units), and acc[t][c] = row g + 8 * (c / 2),
// column cw * COLS + 8 t + 2 (lane % 4) + c % 2.
template <int RG, int TK>
struct State {
  float m[2], l[2];
  float acc[Tile<RG, TK>::NTO][4];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      m[e] = NEG_INF;
      l[e] = 0.f;
    }
#pragma unroll
    for (int t = 0; t < Tile<RG, TK>::NTO; ++t)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[t][c] = 0.f;
  }
};

// Stage ROWS [ckv | kpe] rows into dst (stride LDS) with cp.async; src(r,
// c, p) sets row r's ckv and kpe pointers and returns whether the row may
// be read. A row that may not is zero-filled: no byte of it is read (c and
// p must still point at mapped memory).
template <int ROWS, class Src>
__device__ __forceinline__ void stage_rows(bf16* __restrict__ dst, Src src) {
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, ch = i - r * CHUNKS;
    const bf16* c;
    const bf16* p;
    const bool ok = src(r, c, p);
    const bf16* from = ch < R / 8 ? c + ch * 8 : p + (ch - R / 8) * 8;
    kt_mma::cp_async16(dst + r * LDS + ch * 8, from, ok);
  }
}

using kt_mma::pack_bf16;
using kt_mma::quad_max;
using kt_mma::quad_sum;

// Scores of the staged key tile k_s against the query rows q_s, times sl,
// into s_s [ROWS][SLD]. Block-wide (each warp its part); no barrier.
template <int RG, int TK>
__device__ __forceinline__ void tile_scores(const bf16* __restrict__ q_s,
                                            const bf16* __restrict__ k_s,
                                            float* __restrict__ s_s,
                                            float sl) {
  using T = Tile<RG, TK>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = warp / T::CW, cw = warp % T::CW;
  const int kb = cw * T::KW;
  float c[T::NTS][4];
#pragma unroll
  for (int t = 0; t < T::NTS; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[t][i] = 0.f;
  const bf16* qa = q_s + (rg * 16 + (lane & 15)) * LDS + (lane >> 4) * 8;
  if constexpr (T::NTS == 1) {
    // one x4 of B covers 8 keys x 32 depth: two k16 steps, into two
    // accumulators (two dependency chains), added at the end
    const bf16* kr = k_s + (kb + (lane & 7)) * LDS + (lane >> 3) * 8;
    float c1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 6
    for (int d = 0; d < D; d += 32) {
      uint32_t a0[4], a1[4], b[4];
      kt_mma::ldmatrix_x4(a0, qa + d);
      kt_mma::ldmatrix_x4(a1, qa + d + 16);
      kt_mma::ldmatrix_x4(b, kr + d);
#if KT_MLA_CUT_MMA
      c[0][0] += __uint_as_float((a0[0] ^ b[0]) & 0x3f7fffffu);
      c1[1] += __uint_as_float((a1[1] ^ b[3]) & 0x3f7fffffu);
#else
      kt_mma::mma_bf16_16816(c[0], a0, b[0], b[1]);
      kt_mma::mma_bf16_16816(c1, a1, b[2], b[3]);
#endif
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) c[0][i] += c1[i];
  } else {
    // one x4 of B covers 16 keys x 16 depth: two n8 tiles
    const bf16* kr = k_s + (kb + (lane & 7) + ((lane >> 4) << 3)) * LDS +
                     ((lane >> 3) & 1) * 8;
#pragma unroll 4
    for (int d = 0; d < D; d += 16) {
      uint32_t a[4];
      kt_mma::ldmatrix_x4(a, qa + d);
#pragma unroll
      for (int p = 0; p < T::NTS / 2; ++p) {
        uint32_t b[4];
        kt_mma::ldmatrix_x4(b, kr + p * 16 * LDS + d);
#if KT_MLA_CUT_MMA
        c[2 * p][0] += __uint_as_float((a[0] ^ b[0]) & 0x3f7fffffu);
        c[2 * p + 1][1] += __uint_as_float((a[1] ^ b[3]) & 0x3f7fffffu);
#else
        kt_mma::mma_bf16_16816(c[2 * p], a, b[0], b[1]);
        kt_mma::mma_bf16_16816(c[2 * p + 1], a, b[2], b[3]);
#endif
      }
    }
  }
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int t = 0; t < T::NTS; ++t) {
    float* s0 = s_s + (rg * 16 + g) * T::SLD + kb + 8 * t + 2 * q;
    *reinterpret_cast<float2*>(s0) = make_float2(c[t][0] * sl, c[t][1] * sl);
    *reinterpret_cast<float2*>(s0 + 8 * T::SLD) =
        make_float2(c[t][2] * sl, c[t][3] * sl);
  }
}

// Online-softmax update of st with the tile's scores (keys k0 .. k0 + TK;
// row g + 8 e sees keys kpos < lim[e]), then acc += P V with V the ckv part
// of k_s. Block-wide; no barrier.
template <int RG, int TK>
__device__ __forceinline__ void tile_update(const float* __restrict__ s_s,
                                            const bf16* __restrict__ k_s,
                                            int k0, const int (&lim)[2],
                                            State<RG, TK>& st) {
  using T = Tile<RG, TK>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = warp / T::CW, cw = warp % T::CW;
  const int g = lane >> 2, q = lane & 3;
  // x[kk][e][j]: row g + 8 e, key k0 + 16 kk + 2 q + (j & 1) + 8 (j >> 1)
  float x[T::KS][2][4];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float* sr = s_s + (rg * 16 + g + 8 * e) * T::SLD + 2 * q;
#pragma unroll
    for (int kk = 0; kk < T::KS; ++kk) {
      const float2 lo = *reinterpret_cast<const float2*>(sr + 16 * kk);
      const float2 hi = *reinterpret_cast<const float2*>(sr + 16 * kk + 8);
      x[kk][e][0] = lo.x;
      x[kk][e][1] = lo.y;
      x[kk][e][2] = hi.x;
      x[kk][e][3] = hi.y;
    }
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    float mx = NEG_INF;
#pragma unroll
    for (int kk = 0; kk < T::KS; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + 16 * kk + 2 * q + (j & 1) + 8 * (j >> 1);
        if (kpos < lim[e]) mx = fmaxf(mx, x[kk][e][j]);
      }
    const float m_new = fmaxf(st.m[e], quad_max(mx));
    const float corr = exp2f(st.m[e] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int kk = 0; kk < T::KS; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + 16 * kk + 2 * q + (j & 1) + 8 * (j >> 1);
#if KT_MLA_CUT_SOFTMAX
        const float p = kpos < lim[e] ? x[kk][e][j] - m_new : 0.f;
#else
        const float p = kpos < lim[e] ? exp2f(x[kk][e][j] - m_new) : 0.f;
#endif
        x[kk][e][j] = p;
        sum += p;
      }
    st.l[e] = st.l[e] * corr + quad_sum(sum);
    st.m[e] = m_new;
#pragma unroll
    for (int t = 0; t < T::NTO; ++t) {
      st.acc[t][2 * e] *= corr;
      st.acc[t][2 * e + 1] *= corr;
    }
  }
  const bf16* vb = k_s + (lane & 15) * LDS + cw * T::COLS + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < T::KS; ++kk) {
    uint32_t pa[4];
    pa[0] = pack_bf16(x[kk][0][0], x[kk][0][1]);
    pa[1] = pack_bf16(x[kk][1][0], x[kk][1][1]);
    pa[2] = pack_bf16(x[kk][0][2], x[kk][0][3]);
    pa[3] = pack_bf16(x[kk][1][2], x[kk][1][3]);
#pragma unroll
    for (int p = 0; p < T::NTO / 2; ++p) {
      uint32_t b[4];
      kt_mma::ldmatrix_x4_trans(b, vb + kk * 16 * LDS + p * 16);
#if KT_MLA_CUT_MMA
      st.acc[2 * p][0] += __uint_as_float((pa[0] ^ b[0]) & 0x3f7fffffu);
      st.acc[2 * p + 1][1] += __uint_as_float((pa[1] ^ b[3]) & 0x3f7fffffu);
#else
      kt_mma::mma_bf16_16816(st.acc[2 * p], pa, b[0], b[1]);
      kt_mma::mma_bf16_16816(st.acc[2 * p + 1], pa, b[2], b[3]);
#endif
    }
  }
}

// The key walk: tiles k = first, first + TK, ... (nt of them) staged by
// keys(dst, k0) into the two-stage ring at k_s, each scored and folded into
// st. The caller has committed the copies of the query rows and of tile 0
// (as its latest group). Ends with every thread past its last read of
// shared memory.
template <int RG, int TK, class Keys>
__device__ __forceinline__ void walk(const bf16* __restrict__ q_s,
                                     bf16* __restrict__ k_s,
                                     float* __restrict__ s_s, int first,
                                     int nt, float sl, const int (&lim)[2],
                                     Keys keys, State<RG, TK>& st) {
  for (int t = 0; t < nt; ++t) {
    const int k0 = first + t * TK;
    bf16* cur = k_s + (t & 1) * TK * LDS;
    if (t + 1 < nt) {
      keys(k_s + ((t + 1) & 1) * TK * LDS, k0 + TK);
      kt_mma::cp_async_commit();
      kt_mma::cp_async_wait<1>();
    } else {
      kt_mma::cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and the query rows) landed
    tile_scores<RG, TK>(q_s, cur, s_s, sl);
    __syncthreads();  // every score of the tile written
    tile_update<RG, TK>(s_s, cur, k0, lim, st);
    __syncthreads();  // s_s and this stage free again
  }
  kt_mma::cp_async_wait<0>();
}

// ---- split-KV decode: a split's state record and the in-launch merge
// (mla_decode.cu's mla_decode_split_kernel, paged_attention.cu's
// mla_paged_decode_split_kernel). A block (sequence, split, head tile of
// HT heads) walks its rows with RG = 1, writes (m, l, acc) to its record
// and arrives on the (sequence, head tile) counter; the last block to
// arrive merges the records in a fixed order and sets the counter back.
namespace split {

constexpr int TK = 64;          // rows a key tile
constexpr int HT = 16;          // heads a block: one mma row group
constexpr int MAX_SPLITS = 32;  // ops/cuda/mla_decode.py:DECODE_MAX_SPLITS
constexpr int REC = 2 * HT + HT * R;  // a state: m [HT], l [HT], acc [HT][R]
constexpr int MAX_RECS = MAX_SPLITS + 1;  // the splits and a current token
constexpr int SLOTS = (MAX_RECS + 31) / 32;  // merge records a lane
constexpr int W_FLOATS = MAX_RECS * HT;      // the merge weights
using Tl = Tile<1, TK>;

// The block's state (walked with RG = 1) into its record.
__device__ __forceinline__ void store_state(const State<1, TK>& st,
                                            float* __restrict__ rec) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int h = g + 8 * e;
    if (warp == 0 && q == 0) {
      rec[h] = st.m[e];
      rec[HT + h] = st.l[e];
    }
    float* a = rec + 2 * HT + h * R + warp * Tl::COLS + 2 * q;
#pragma unroll
    for (int t = 0; t < Tl::NTO; ++t)
      *reinterpret_cast<float2*>(a + 8 * t) =
          make_float2(st.acc[t][2 * e], st.acc[t][2 * e + 1]);
  }
}

using kt_mma::arrive_last;

// Merge n records (record i at base + rec(i) * REC, in the order i = 0 ..
// n - 1) with weights exp2(m_i - M) / L into out [nh][R] (bf16); w_s holds
// W_FLOATS floats of shared memory. n = 0 gives zeros. Block-wide.
template <class Rec>
__device__ __forceinline__ void merge_states(const float* __restrict__ base,
                                             int n, Rec rec,
                                             float* __restrict__ w_s, int nh,
                                             bf16* __restrict__ out) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int h = warp; h < HT; h += NWARP) {
    float mi[SLOTS], li[SLOTS];
    float mx = NEG_INF;
#pragma unroll
    for (int k = 0; k < SLOTS; ++k) {
      const int i = lane + 32 * k;
      const bool ok = i < n;
      const float* ri = base + (size_t)rec(ok ? i : 0) * REC;
      mi[k] = ok ? __ldcg(ri + h) : NEG_INF;
      li[k] = ok ? __ldcg(ri + HT + h) : 0.f;
      mx = fmaxf(mx, mi[k]);
    }
    mx = kt_mla::warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < SLOTS; ++k) {
      mi[k] = lane + 32 * k < n ? exp2f(mi[k] - mx) : 0.f;
      sum += li[k] * mi[k];
    }
    const float inv = 1.f / fmaxf(kt_mla::warp_sum(sum), 1e-30f);
#pragma unroll
    for (int k = 0; k < SLOTS; ++k)
      if (lane + 32 * k < n) w_s[(lane + 32 * k) * HT + h] = mi[k] * inv;
  }
  __syncthreads();
  // 16 threads a head, eight float4 of columns each (c4 = c0 + 16 j)
  const int h = tid >> 4, c0 = tid & 15;
  if (h >= nh) return;
  float4 o[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
  for (int i = 0; i < n; ++i) {
    const float w = w_s[i * HT + h];
    const float4* src = reinterpret_cast<const float4*>(
                            base + (size_t)rec(i) * REC + 2 * HT + h * R) +
                        c0;
    float4 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = __ldcg(src + 16 * j);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[j].x += w * v[j].x;
      o[j].y += w * v[j].y;
      o[j].z += w * v[j].z;
      o[j].w += w * v[j].w;
    }
  }
  bf16* orow = out + (size_t)h * R;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    __nv_bfloat162* d =
        reinterpret_cast<__nv_bfloat162*>(orow + 4 * (c0 + 16 * j));
    d[0] = __floats2bfloat162_rn(o[j].x, o[j].y);
    d[1] = __floats2bfloat162_rn(o[j].z, o[j].w);
  }
}

}  // namespace split

}  // namespace kt_mla_mma
