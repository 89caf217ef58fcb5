// The split-K W4A8 GEMV (w4a8_matmul.cu's kt_w4a8_gemv): every W4A8 call
// of one row a tile. It replaces w4a8_rows_kernel<1> (w4a8_core.cuh) for
// ktransformers_tpu/ops/pallas/w4a8_matmul.py:dense_w4a8_matmul at M = 1
// (single-user decode), :gathered_w4a8_matmul (decode MoE experts too wide
// for the fused FFN) and the down launch of :gathered_w4a8_ffn and of
// :dense_w4a8_ffn at M = 1. The arithmetic is w4a8_core.cuh's: for each
// scale group g, val = (qa . u)*sa + (qb . braw)*sb - t and
// y[n] += val * s[g, n], u = braw & 15, the int8 dots on __dp4a.
//
// Bound: the weight bytes of the experts the rows use (K/2 * N int8 plus
// the f32 group scales), read once. The first version ran 128 columns a
// block with 4-byte loads: 16-29 blocks for DeepSeek-V2-Lite's decode
// projections on 132 SMs, and one tile per row, so rows routed to one
// expert read its bytes once each. Here:
// - a block owns BN = 256 columns: 16 threads along the columns, each with
//   one 16-byte load a storage row (CPT = 16 columns), and LANES = 8 row
//   lanes; a lane walks a contiguous run of units of UNIT = 8 storage rows
//   and meets the activation's K-bytes through transpose4x4 + __dp4a;
// - the storage rows are cut into `splits` runs of whole scale groups
//   (blockIdx.z; 64 storage rows at group 128, 48 at 96) so that the grid
//   fills the card (ops/cuda/w4a8_matmul.py:w4a8_gemv_plan). A lane sums a
//   group's int dots over its units and scales them once; the lane that
//   holds the group's first unit subtracts t. The lanes meet in shared
//   memory, the splits through f32 partials in the same launch: the last
//   block of a (column block, tile) pair to finish, found with the pair's
//   counter (zero between launches: that block sets it back), adds them in
//   split order. One launch, no memset, the same bits on every call;
// - tiles are keyed by expert, not by row: each expert's rows are cut into
//   chunks of RB (1, or 2 where experts repeat), and tile j takes the j-th
//   (expert, chunk) pair, experts in order of first appearance in ids,
//   found by scanning ids (R <= MAX_ROWS) in shared memory; a tile past the
//   last pair exits at once. A block reads its expert's bytes once for all
//   its rows, and the tiles of one expert sit next to each other in the
//   grid, so their blocks run together and share those bytes through L2.
//   A dense call is one tile: ids = [0], one expert.
// - the activation prep is folded in (XT float or bf16; groups of up to
//   128): a block quantizes just the scale groups of its split for its
//   tile's rows (split_acts: prep_units, four (row, group) units a warp)
//   into shared memory, the bits of the prep launch it replaces, and walks
//   them there; the wrapper folds where that is at most 16 (row, group)
//   units a block (w4a8_matmul.py:gemv_folds). XT = int8_t reads the codes
//   of a prep launch (the FFN's down reads those its gate_up's requant
//   wrote).
// - zero points (int4_gz): the lane holding a group's first unit also
//   subtracts xs * z[g, n] (xs: the row's group sum of x), where it
//   subtracts t; a per-channel group (all of K, one group) is cut inside
//   the group into splits of whole units (w4a8_matmul.py:split_k_plan): the
//   int32 dots of a run times the row scales are its share of the group's
//   value, and t and the zero term are taken once, by that lane.
// (The KT_W4GEMV_CUT_* switches compile parts out for ops/cuda/breakdown.py.)
#pragma once

#include <type_traits>

#include "mma_sm90.cuh"
#include "w4a8_core.cuh"

namespace kt {
namespace w4gv {

constexpr int TX = 16;               // threads along the columns
constexpr int LANES = 8;             // row lanes (threadIdx.x / TX)
constexpr int THREADS = TX * LANES;  // 128
constexpr int CPT = 16;              // columns a thread: 16 bytes a row
constexpr int BN = TX * CPT;         // 256 columns a block
constexpr int UNIT = 8;              // storage rows a step
constexpr int MAX_ROWS = THREADS;    // rows of a call: one id a thread
// dynamic shared memory a folded launch may take for its activations, and
// the largest half group it folds (prep_units: two values a lane)
constexpr int MAX_ACTS_SMEM = 160 * 1024;
constexpr int FOLD_GS2 = 64;

// The rows of tile j: the experts of ids[0..R) in order of first
// appearance, each cut into chunks of RB of its rows (in row order), the
// (expert, chunk) pairs numbered in that order; tile j takes pair j. Sets
// *expert (-1 past the last pair) and rows[0..*nrows). Block-wide; ends
// synchronised.
template <int RB>
__device__ __forceinline__ void tile_rows(const int* __restrict__ ids, int R,
                                          int j, int* ids_s, int* rows,
                                          int* wsum, int* expert, int* chunk,
                                          int* nrows) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int id = t < R ? ids[t] : -1;
  ids_s[t] = id;
  if (t == 0) *expert = -1;
  __syncthreads();
  // the first row of each expert counts the expert's rows and chunks
  bool first = t < R;
  for (int r = 0; r < t && first; ++r) first = ids_s[r] != id;
  int chunks = 0;
  if (first) {
    int n = 0;
    for (int r = t; r < R; ++r) n += ids_s[r] == id;
    chunks = (n + RB - 1) / RB;
  }
  int incl = chunks;  // inclusive prefix of the chunks over the threads
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  int start = incl - chunks;
  for (int w = 0; w < warp; ++w) start += wsum[w];
  if (first && j >= start && j < start + chunks) {
    *expert = id;
    *chunk = j - start;
  }
  __syncthreads();
  const int e = *expert, c = *chunk;
  const bool mine = t < R && e >= 0 && id == e;
  const unsigned bal = __ballot_sync(0xffffffffu, mine);
  if (lane == 0) wsum[warp] = __popc(bal);
  __syncthreads();
  int rank = __popc(bal & ((1u << lane) - 1u)), total = 0;
  for (int w = 0; w < THREADS / 32; ++w) {
    rank += w < warp ? wsum[w] : 0;
    total += wsum[w];
  }
  if (mine && rank >= c * RB && rank < (c + 1) * RB) rows[rank - c * RB] = t;
  if (t == 0) *nrows = min(RB, total - c * RB);
  __syncthreads();
}

// The scaled group sums of one lane: acc[m][c] += (pa*sa + pb*sb - t? [-
// xs? * z])*s (the zero term where the weight has zero points: ZP).
template <int RB, bool ZP>
__device__ __forceinline__ void flush_group(const int pa[RB][CPT],
                                            const int pb[RB][CPT],
                                            const float sam[RB],
                                            const float sbm[RB],
                                            const float tm[RB],
                                            const float xm[RB],
                                            const float sc[CPT],
                                            const float zc[CPT], int nr,
                                            float acc[RB][CPT]) {
#pragma unroll
  for (int m = 0; m < RB; ++m) {
    if (m < nr) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        float val =
            (float)pa[m][c] * sam[m] + (float)pb[m][c] * sbm[m] - tm[m];
        if constexpr (ZP) val -= xm[m] * zc[c];
        acc[m][c] += val * sc[c];
      }
    }
  }
}

// The units [l0, l1) of row lane ly in split s: the K2 / UNIT units are
// cut into granules of `gran` units (one scale group), split s takes
// granules [G s / S, G (s + 1) / S) and each of the LANES lanes a
// contiguous run of its split's units.
__device__ __forceinline__ void lane_run(int K2, int gran, int splits, int s,
                                         int ly, int& l0, int& l1) {
  const int ngran = K2 / UNIT / gran;
  const int u0 = gran * (int)((long long)ngran * s / splits);
  const int u1 = gran * (int)((long long)ngran * (s + 1) / splits);
  l0 = u0 + (u1 - u0) * ly / LANES;
  l1 = u0 + (u1 - u0) * (ly + 1) / LANES;
}

// The sum of p[q * stride] over the splits q in split order, sixteen
// splits' loads in flight at once (the partials another block wrote: read
// through L2).
__device__ __forceinline__ float split_sum(const float* p, int splits,
                                           size_t stride) {
  float v = 0.f;
  for (int q0 = 0; q0 < splits; q0 += 16) {
    float pv[16];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      pv[j] = q0 + j < splits ? __ldcg(p + (size_t)(q0 + j) * stride) : 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) v += pv[j];
  }
  return v;
}

// The scale groups [g0, g1) of split s (a granule of `gran` units is one
// scale group where the kernel folds the prep in: the launch checks it).
__device__ __forceinline__ void split_groups(int ng, int splits, int s,
                                             int& g0, int& g1) {
  g0 = (int)((long long)ng * s / splits);
  g1 = (int)((long long)ng * (s + 1) / splits);
}

// Where a walk finds the activation of tile row m: its codes at qa + coff[m]
// + r and qb + coff[m] + r (r a storage row), its scales at sa / sb / t / xs
// + soff[m] + g (g a scale group; xs only where the weight has zeros).
// kSmem: the codes and scales lie in shared memory (split_acts quantized
// them there), else in global memory (a prep launch or the FFN's gate_up
// wrote them).
template <int RB, bool kSmem>
struct Acts {
  const int8_t* qa;
  const int8_t* qb;
  const float* sa;
  const float* sb;
  const float* t;
  const float* xs;
  int coff[RB], soff[RB];
};

template <bool kSmem, typename T>
__device__ __forceinline__ T load_act(const T* p) {
  if constexpr (kSmem) return *p;
  else return __ldg(p);
}

// Bytes of shared memory split_acts takes for RB rows of ng_split scale
// groups of gs2 storage rows: the codes qa, qb and the scales sa, sb, t, xs.
__host__ __device__ constexpr int acts_bytes(int rb, int ng_split, int gs2) {
  return rb * ng_split * (2 * gs2 + 4 * 4);
}

// The activations of a walk over scale groups [g0, g1) for the tile rows
// row[m], m < nr. XT = int8_t: the codes a prep launch wrote (a.qa .. a.t,
// global memory). XT float or bf16: the kernel folds the prep in, quantizing
// those groups of its rows of a.x into smem (acts_bytes of it) with
// prep_units (four (row, group) units at a time a warp), so no prep launch
// runs and the codes are the prep's bits. Block-wide (every thread calls
// it); ends synchronised when it quantizes.
template <int RB, typename XT>
__device__ __forceinline__ auto split_acts(const W4A8Args& a,
                                           const int (&row)[RB], int nr,
                                           int g0, int g1, uint8_t* smem) {
  constexpr bool kFold = !std::is_same<XT, int8_t>::value;
  Acts<RB, kFold> v;
  if constexpr (!kFold) {
    v.qa = a.qa;
    v.qb = a.qb;
    v.sa = a.sa;
    v.sb = a.sb;
    v.t = a.t;
    v.xs = a.xs;
#pragma unroll
    for (int m = 0; m < RB; ++m) {
      v.coff[m] = row[m] * a.K2;
      v.soff[m] = row[m] * a.ng;
    }
  } else {
    const int ng = g1 - g0, len = ng * a.gs2;
    int8_t* qa = reinterpret_cast<int8_t*>(smem);
    int8_t* qb = qa + RB * len;
    float* sa = reinterpret_cast<float*>(qb + RB * len);
    float* sb = sa + RB * ng;
    float* t = sb + RB * ng;
    float* xs = t + RB * ng;
    const XT* x = static_cast<const XT*>(a.x);
    const int gs2 = a.gs2;
    const size_t ld = (size_t)2 * a.K2;
    prep_units<4, XT>(
        nr * ng, THREADS / 32, gs2,
        [&](int u, const XT*& xr, int8_t*& ca, int8_t*& cb) {
          const int m = u / ng, j = u - m * ng;
          xr = x + row[m] * ld + (size_t)(g0 + j) * 2 * gs2;
          ca = qa + m * len + j * gs2;
          cb = qb + m * len + j * gs2;
        },
        [&](int u, float s_a, float s_b, float tt, float sx) {
          sa[u] = s_a;  // u = m * ng + j
          sb[u] = s_b;
          t[u] = tt;
          xs[u] = sx;
        });
    __syncthreads();
    v.qa = qa;
    v.qb = qb;
    v.sa = sa;
    v.sb = sb;
    v.t = t;
    v.xs = xs;
#pragma unroll
    for (int m = 0; m < RB; ++m) {
      v.coff[m] = m * len - g0 * a.gs2;
      v.soff[m] = m * ng - g0;
    }
  }
  return v;
}

// The K walk of one row lane: units [l0, l1) of UNIT storage rows of the
// expert at we / se / ze (its weight, scales and zero points or null,
// offset to the thread's first of CPT columns) against the activations of
// the tile's rows m < nr (acts: split_acts) into acc. A lane sums a group's
// int dots over its units and scales them once; the lane that holds the
// group's first unit subtracts t (and xs * z: ZP, a separate instantiation
// so that the walk without zero points keeps its registers). Shared by
// w4a8_gemv_kernel and w4a8_ffn.cu's w4a8_ffn_gemv_kernel.
template <int RB, bool kSmem, bool ZP>
__device__ __forceinline__ void lane_walk(const W4A8Args& a,
                                          const int8_t* __restrict__ we,
                                          const float* __restrict__ se,
                                          const float* __restrict__ ze,
                                          const Acts<RB, kSmem>& act, int nr,
                                          int l0, int l1,
                                          float (&acc)[RB][CPT]) {
  int pa[RB][CPT], pb[RB][CPT];
  float sc[CPT], zc[CPT], sam[RB], sbm[RB], tm[RB], xm[RB];
  constexpr bool hasz = ZP;
  int gcur = -1;
  for (int u = l0; u < l1; ++u) {
    const int r0 = u * UNIT;
    const int g = r0 / a.gs2;
    if (g != gcur) {
      if (gcur >= 0)
        flush_group<RB, ZP>(pa, pb, sam, sbm, tm, xm, sc, zc, nr, acc);
      gcur = g;
      const float4* s4 =
          reinterpret_cast<const float4*>(se + (size_t)g * a.N);
#pragma unroll
      for (int q = 0; q < CPT / 4; ++q) {
        const float4 v = __ldg(s4 + q);
        sc[4 * q] = v.x; sc[4 * q + 1] = v.y;
        sc[4 * q + 2] = v.z; sc[4 * q + 3] = v.w;
      }
      // the lane holding the group's first unit subtracts t (and xs * z)
      const bool with_t = r0 == g * a.gs2;
      if constexpr (hasz) {
        const float4* z4 =
            reinterpret_cast<const float4*>(ze + (size_t)g * a.N);
#pragma unroll
        for (int q = 0; q < CPT / 4; ++q) {
          const float4 v = __ldg(z4 + q);
          zc[4 * q] = v.x; zc[4 * q + 1] = v.y;
          zc[4 * q + 2] = v.z; zc[4 * q + 3] = v.w;
        }
      }
#pragma unroll
      for (int m = 0; m < RB; ++m) {
        const int ri = act.soff[m] + g;
        sam[m] = load_act<kSmem>(act.sa + ri);
        sbm[m] = load_act<kSmem>(act.sb + ri);
        tm[m] = with_t ? load_act<kSmem>(act.t + ri) : 0.f;
        xm[m] = hasz && with_t ? load_act<kSmem>(act.xs + ri) : 0.f;
#pragma unroll
        for (int c = 0; c < CPT; ++c) pa[m][c] = pb[m][c] = 0;
      }
    }
    uint4 wd[UNIT];
#pragma unroll
    for (int j = 0; j < UNIT; ++j)
      wd[j] = __ldg(reinterpret_cast<const uint4*>(
          we + (size_t)(r0 + j) * a.N));
    int a4[RB][2], b4[RB][2];
#pragma unroll
    for (int m = 0; m < RB; ++m) {
      const int ro = act.coff[m] + r0;
      const int2 va =
          load_act<kSmem>(reinterpret_cast<const int2*>(act.qa + ro));
      const int2 vb =
          load_act<kSmem>(reinterpret_cast<const int2*>(act.qb + ro));
      a4[m][0] = va.x; a4[m][1] = va.y;
      b4[m][0] = vb.x; b4[m][1] = vb.y;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // storage rows 4h .. 4h + 3
      const uint4* w4 = wd + 4 * h;
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // columns 4q .. 4q + 3
        int wrow[4], wcol[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint4 v = w4[j];
          wrow[j] = (int)(q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z
                                                              : v.w);
        }
#if !KT_W4GEMV_CUT_DECODE
        transpose4x4(wrow, wcol);
#pragma unroll
        for (int m = 0; m < RB; ++m) {
          if (m < nr) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              pa[m][4 * q + c] = __dp4a(a4[m][h], wcol[c] & 0x0F0F0F0F,
                                        pa[m][4 * q + c]);
              pb[m][4 * q + c] =
                  __dp4a(b4[m][h], wcol[c], pb[m][4 * q + c]);
            }
          }
        }
#else
        // the loads stay live; one xor a loaded word
#pragma unroll
        for (int m = 0; m < RB; ++m)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            pa[m][4 * q + c] ^= wrow[c] ^ a4[m][h] ^ b4[m][h];
#endif
      }
    }
  }
  if (gcur >= 0)
    flush_group<RB, ZP>(pa, pb, sam, sbm, tm, xm, sc, zc, nr, acc);
}

}  // namespace w4gv

// y[row, n] for the rows of tile blockIdx.y (up to RB rows of one expert)
// over split blockIdx.z of the storage rows; grid = (ceil(N / BN), tiles,
// splits), THREADS threads, tiles at least the number of (expert, chunk)
// pairs (ops/cuda/w4a8_matmul.py:gemv_tile_count). A split covers granules
// [G s / S, G (s+1) / S) of `gran` units (gran * UNIT = one scale group's
// storage rows) and each lane a contiguous run of its split's units. With
// one split the block stores y; with more, part[row][split][N] holds the
// partials and cnt[tile][column block] the counters. XT = int8_t reads the
// codes of a prep launch (a.qa .. a.t); XT = float or bf16 (OutT) folds the
// prep in: the block quantizes its split's scale groups of its rows of a.x
// into dynamic shared memory (split_acts), then walks as before.
template <int RB, typename XT, typename OutT, bool ZP>
__global__ void __launch_bounds__(w4gv::THREADS, RB == 1 ? 4 : 3)
    w4a8_gemv_kernel(W4A8Args a, const int* __restrict__ ids, int R,
                     int splits, int gran, float* __restrict__ part,
                     int* __restrict__ cnt, OutT* __restrict__ out) {
  constexpr int TX = w4gv::TX, LANES = w4gv::LANES, THREADS = w4gv::THREADS;
  constexpr int CPT = w4gv::CPT, BN = w4gv::BN;
  constexpr int MAX_ROWS = w4gv::MAX_ROWS;
  constexpr bool kFold = !std::is_same<XT, int8_t>::value;
  __shared__ __align__(16) float red[LANES][RB][BN];
  __shared__ int ids_s[MAX_ROWS], rows_s[RB], wsum[THREADS / 32];
  __shared__ int expert_s, chunk_s, nrows_s;
  extern __shared__ __align__(16) uint8_t acts_s[];
  w4gv::tile_rows<RB>(ids, R, blockIdx.y, ids_s, rows_s, wsum, &expert_s,
                      &chunk_s, &nrows_s);
  const int e = expert_s;
  if (e < 0) return;  // past the last (expert, chunk) pair (block-uniform)
  const int nr = nrows_s;
  const int tx = threadIdx.x % TX, ly = threadIdx.x / TX;
  const int n0 = blockIdx.x * BN;
  const int col = n0 + tx * CPT;
  const int s = blockIdx.z;
  int l0, l1, g0, g1;
  w4gv::lane_run(a.K2, gran, splits, s, ly, l0, l1);
  w4gv::split_groups(a.ng, splits, s, g0, g1);
  const int8_t* we = a.w + (size_t)e * a.K2 * a.N + col;
  const float* se = a.s + (size_t)e * a.ng * a.N + col;
  const float* ze = ZP ? a.z + (size_t)e * a.ng * a.N + col : nullptr;
  constexpr int PER = BN / THREADS;  // output columns a thread stores

  int row[RB];
#pragma unroll
  for (int m = 0; m < RB; ++m) row[m] = rows_s[m < nr ? m : 0];
  float acc[RB][CPT];
#pragma unroll
  for (int m = 0; m < RB; ++m)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[m][c] = 0.f;

  const auto act = w4gv::split_acts<RB, XT>(a, row, nr, g0, g1, acts_s);
  if (col < a.N && l0 < l1)
    w4gv::lane_walk<RB, kFold, ZP>(a, we, se, ze, act, nr, l0, l1, acc);

#pragma unroll
  for (int m = 0; m < RB; ++m)
#pragma unroll
    for (int q = 0; q < CPT / 4; ++q)
      reinterpret_cast<float4*>(&red[ly][m][tx * CPT])[q] =
          make_float4(acc[m][4 * q], acc[m][4 * q + 1], acc[m][4 * q + 2],
                      acc[m][4 * q + 3]);
  __syncthreads();
#pragma unroll
  for (int m = 0; m < RB; ++m) {
    if (m >= nr) break;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int cc = threadIdx.x + i * THREADS;
      const int n = n0 + cc;
      float v = 0.f;
#pragma unroll
      for (int y = 0; y < LANES; ++y) v += red[y][m][cc];
      if (n < a.N) {
        if (splits > 1)
          part[((size_t)row[m] * splits + s) * a.N + n] = v;
        else
          store_out(out + (size_t)row[m] * a.N + n, v);
      }
    }
  }
  if (splits == 1) return;
#if !KT_W4GEMV_CUT_REDUCE
  int* c = cnt + (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  if (!kt_mma::arrive_last(c, splits)) return;
  // the partials of the tile's rows in split order, sixteen splits' loads
  // in flight at once
#pragma unroll
  for (int m = 0; m < RB; ++m) {
    if (m >= nr) break;
    const float* p0 = part + (size_t)row[m] * splits * a.N;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int n = n0 + threadIdx.x + i * THREADS;
      if (n >= a.N) continue;
      store_out(out + (size_t)row[m] * a.N + n,
                w4gv::split_sum(p0 + n, splits, a.N));
    }
  }
  if (threadIdx.x == 0) *c = 0;  // ready for the next launch
#endif
}

template <typename XT, typename OutT, bool ZP>
cudaError_t launch_gemv_z(const W4A8Args& a, const int* ids, int R, int tiles,
                          int splits, int gran, int rb, float* part, int* cnt,
                          OutT* out, cudaStream_t stream) {
  constexpr int BN = w4gv::BN, THREADS = w4gv::THREADS;
  constexpr bool kFold = !std::is_same<XT, int8_t>::value;
  if (kFold && (gran * w4gv::UNIT != a.gs2 || a.gs2 > w4gv::FOLD_GS2))
    return cudaErrorInvalidValue;
  const int smem =
      kFold ? w4gv::acts_bytes(rb, (a.ng + splits - 1) / splits, a.gs2) : 0;
  if (smem > w4gv::MAX_ACTS_SMEM) return cudaErrorInvalidValue;
  dim3 grid((a.N + BN - 1) / BN, tiles, splits);
  static int ready_dev[2] = {-1, -1};
  cudaError_t err = cudaSuccess;
  switch (rb) {
    case 1:
      if (kFold)
        err = kt_mma::allow_smem(w4a8_gemv_kernel<1, XT, OutT, ZP>,
                                 w4gv::MAX_ACTS_SMEM, &ready_dev[0]);
      if (err != cudaSuccess) return err;
      w4a8_gemv_kernel<1, XT, OutT, ZP><<<grid, THREADS, smem, stream>>>(
          a, ids, R, splits, gran, part, cnt, out);
      break;
    case 2:
      if (kFold)
        err = kt_mma::allow_smem(w4a8_gemv_kernel<2, XT, OutT, ZP>,
                                 w4gv::MAX_ACTS_SMEM, &ready_dev[1]);
      if (err != cudaSuccess) return err;
      w4a8_gemv_kernel<2, XT, OutT, ZP><<<grid, THREADS, smem, stream>>>(
          a, ids, R, splits, gran, part, cnt, out);
      break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// R rows (R <= MAX_ROWS) through expert ids[r] of w [E, K2, N] (a dense
// call: R = 1, ids = [0]), in `tiles` tiles of up to rb rows (1 or 2). N a
// multiple of 16, gs2 of UNIT, K2 of gs2; splits >= 1 runs of `gran` units
// (part: R * splits * N floats, cnt: ceil(N / BN) * tiles ints, zero on
// entry). XT: as w4a8_gemv_kernel; a folded launch takes gran * UNIT = gs2.
// The instantiation with the zero term where a.z is given.
template <typename XT, typename OutT>
cudaError_t launch_gemv(const W4A8Args& a, const int* ids, int R, int tiles,
                        int splits, int gran, int rb, float* part, int* cnt,
                        OutT* out, cudaStream_t stream) {
  return a.z ? launch_gemv_z<XT, OutT, true>(a, ids, R, tiles, splits, gran,
                                             rb, part, cnt, out, stream)
             : launch_gemv_z<XT, OutT, false>(a, ids, R, tiles, splits, gran,
                                              rb, part, cnt, out, stream);
}

}  // namespace kt
