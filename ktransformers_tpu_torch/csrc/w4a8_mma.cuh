// The W4A8 matmul on the int8 tensor cores (w4a8_matmul.cu's
// kt_w4a8_mma): replaces ktransformers_tpu/ops/pallas/w4a8_matmul.py:
// dense_w4a8_matmul and :grouped_w4a8_matmul from 2 rows on (the
// crossover: it beats the first version at every M measured from 2 up;
// M = 1 and the gathered entry keep w4a8_rows_kernel). The arithmetic of
// w4a8_core.cuh, for tiles of up to BM = 64 rows of one expert.
//
// For each scale group g, val = (qa . u)*sa + (qb . braw)*sb - t and
// y[n] += val * s[g, n], u = braw & 15. Both dots are int8 x int8 with
// int32 sums, so mma.sync m16n8k32 (and m16n8k16 for the last 16 bytes of
// a group of 96) s8 gives the integers __dp4a gives; only the order of
// the f32 sum over groups is the kernel's own.
//
// Pipeline: a stage is one scale group (gs/2 = 64 bytes of K at group 128,
// 48 at group 96). A ring of STAGES = 4 stages holds the tile's qa and qb
// rows [BM][gs/2], the raw weight bytes [gs/2][BN] and the group's sa, sb,
// t (per row) and s (per column), filled by cp.async three groups ahead.
// A block owns BN = 64 output columns (two blocks an SM at 128 registers
// a thread; blocks of 128 columns need 172 and run one an SM). Eight
// warps (2 x 4) own 32 x 16 outputs each:
// int32 fragments for the group, then an epilogue in registers that
// scales them into f32 accumulators.
//
// Operand layout: s8 mma operands must be K-major; qa / qb rows are, the
// stored weight [K/2, N] is N-major and is not repacked (the FFN kernels,
// the transposed SFT kernel and the plain versions read it so).
// ldmatrix.trans moves 16-bit elements, so a 16-bit element of a weight
// row is a pair of adjacent columns: each lane addresses the rows of its
// 8 x 8 matrix in the order k = 0 1 4 5 8 9 12 13 (and + 2), so that a
// thread receives k = 4q .. 4q + 3 for the column pair, and two
// __byte_perm split the pair into the B fragments of two n8 tiles (even
// and odd columns). Output column 2j (+ 1) of a 16-column chunk is column
// j of the even (odd) tile, so a thread ends up owning 4 adjacent columns.
// The raw tile's 16-byte chunks are XOR-swizzled by row so that these
// ldmatrix rows hit distinct banks.
//
// Scale groups other than 128 and 96 (ops/cuda/w4a8_matmul.py:mma_takes):
// - 32 and 16 (GGUF Q4_K / Q4_1 / Q4_0 and Q2_K blocks): a stage is KC = 32
//   bytes of K, GPS = 2 or 4 groups. A group of 32 is 16 bytes of each half,
//   one m16n8k16 step; a group of 16 is 8 bytes, half an m16n8k16 step: the
//   step runs twice on the same B fragments, each time with the A fragment
//   of the other group's lanes zeroed (lanes 4q, 4q + 1 hold k bytes 0-7,
//   4q + 2, 4q + 3 bytes 8-15), so each group's int32 sums are its own and
//   are scaled in its own epilogue, in group order;
// - one group of all K (per-channel int4, GS2 = 0 here: K/2 = 1024 to 9216
//   bytes): a stage is KC = 64 bytes, the int32 sums run over every stage
//   (|pb| <= 127 * 128 * K/2 < 2^31 for K <= 18432) and the one epilogue
//   reads the rows' sa, sb, t, xs and the columns' s, z from device memory
//   after the K loop; the copies past K/2 are zero-filled. It reads a prep
//   launch's codes (a group wider than 128 never folds).
// Zero points (int4_gz): each group's epilogue also subtracts xs * z[g, n]
// (the ring holds the group's z beside s, and xs beside sa, sb, t); without
// z the epilogue is the one it was.
//
// Bound: the weight bytes at the grouped shapes (each expert's bytes read
// once per 64 rows), operations at the dense prefill shapes; the group
// epilogue (2 conversions and 3 FMAs per output and group) costs about as
// much as the mma. A warp skips the dots and the epilogue of its 16-row
// halves that lie past the tile's rows (a decode batch of 8 uses one of
// the four).
//
// The activation prep folded in (XT float or bf16, below the wrapper's
// crossover, w4a8_matmul.py:folds): before its K loop a block quantizes its
// tile's live rows of x, every scale group, into an A tile after the ring
// (fold_tile: prep_units, four (row, group) units a warp, while the ring's
// first weight groups are in flight), then runs the same loop on it, and on
// further column blocks (a folded grid keeps its blocks resident and each
// walks ceil(N / BN / resident) column blocks with its one A tile). The
// blocks of a tile still quantize it again each: at two to a few rows that
// hides under the ring's first copies, past the crossover it costs more
// than the prep launch it saves. The A tile holds the tile's rows rounded
// up to 16 (arows) x K/2 bytes twice: up to 64 rows at K = 2048, 16 at
// K = 10944.
#pragma once

#include <type_traits>

#include "mma_sm90.cuh"
#include "w4a8_core.cuh"

namespace kt {
namespace w4mma {

constexpr int BM = 64;        // rows a tile
constexpr int BN = 64;        // output columns a block
constexpr int STAGES = 4;     // depth of the cp.async ring
constexpr int THREADS = 256;  // 8 warps: 2 along M x 4 along N

// The ring's stages. GS2: the scale group's bytes of each half (64 at group
// 128, 48 at 96, 16 at 32, 8 at 16), 0 for one group of all K (WIDE). A
// stage holds KC bytes of K: one group at 128 and 96, GPS = KC / GS2 groups
// at 32 and 16 (SMALL), a piece of the one group (WIDE). It holds the raw
// weight bytes [KC][BN] and, for each of its groups, the columns' s (and z
// with zero points); where the kernel reads a prep launch's codes (XT =
// int8_t) also the stage's qa and qb rows [BM][LDA] and each group's sa,
// sb, t (and xs with zero points) per row. Without zero points a stage is
// the layout the kernel had before the zero term (the fold crossovers
// depend on its bytes). Where it folds the prep in (XT float or bf16) the
// codes of every group lie in the A tile after the ring (fold_bytes). WIDE
// stages hold codes and weights only.
template <int GS2, typename XT>
struct Shape {
  static constexpr bool FOLD = !std::is_same<XT, int8_t>::value;
  static constexpr bool WIDE = GS2 == 0;
  static constexpr bool SMALL = GS2 > 0 && GS2 < 32;
  static constexpr int KC = WIDE ? 64 : SMALL ? 32 : GS2;  // bytes of K
  static constexpr int GPS = SMALL ? KC / GS2 : 1;         // groups a stage
  // qa / qb tile row stride: an odd number of 16-byte chunks keeps the
  // ldmatrix rows on distinct banks
  static constexpr int LDA = (KC / 16) % 2 ? KC : KC + 16;
  static constexpr int A_BYTES = BM * LDA;
  static constexpr int CODE_BYTES = FOLD ? 0 : 2 * A_BYTES;  // qa, qb
  static constexpr int W_BYTES = KC * BN;
  // a group's row floats (sa, sb, t[, xs]) and column floats (s[, z])
  __host__ __device__ static constexpr int rf(bool z) {
    return WIDE || FOLD ? 0 : (z ? 4 : 3) * BM;
  }
  __host__ __device__ static constexpr int cf(bool z) {
    return WIDE ? 0 : (z ? 2 : 1) * BN;
  }
  __host__ __device__ static constexpr int stage(bool z) {
    return CODE_BYTES + W_BYTES + GPS * (rf(z) + cf(z)) * 4;
  }
  __host__ __device__ static constexpr int smem(bool z) {  // the ring
    return STAGES * stage(z);
  }
  static constexpr int WN = BN / 4;   // columns a warp
  static constexpr int P = WN / 16;   // 16-column chunks a warp
};

// The most shared memory a block may take (the H100's 227 KB).
constexpr int MAX_SMEM = 232448;

// Row stride of a folded A tile over K/2 bytes: an odd number of 16-byte
// chunks (distinct banks for the ldmatrix rows).
__host__ __device__ constexpr int fold_ld(int k2) {
  return (k2 / 16) % 2 ? k2 : k2 + 16;
}

// Bytes of a folded A tile of arows rows: qa, qb [arows][fold_ld] and sa,
// sb, t (and xs where the weight has zero points) [arows][ng].
__host__ __device__ constexpr int fold_bytes(int arows, int k2, int ng,
                                             bool hasz) {
  return 2 * arows * fold_ld(k2) + (hasz ? 4 : 3) * arows * ng * 4;
}

// The folded prep of a tile: its nrows live rows of x (from row0) quantized,
// every scale group, into the A tile at A (fold_bytes(arows, K2, ng)) by
// nwarps warps, N (row, group) units at a time a warp (prep_units: four in
// this kernel, whose 128 registers a thread would spill eight; eight in the
// FFN kernel's 16 warps). Ends unsynchronised (the K loop's first barrier
// orders it).
template <int N, typename XT>
__device__ __forceinline__ void fold_tile(const W4A8Args& a, int row0,
                                          int nrows, int arows, int nwarps,
                                          uint8_t* A) {
  const int ld = fold_ld(a.K2), ng = a.ng, gs2 = a.gs2;
  const size_t k = (size_t)2 * a.K2;
  int8_t* qa = reinterpret_cast<int8_t*>(A);
  int8_t* qb = qa + arows * ld;
  float* f = reinterpret_cast<float*>(qb + arows * ld);
  const XT* x = static_cast<const XT*>(a.x) + (size_t)row0 * k;
  prep_units<N, XT>(
      nrows * ng, nwarps, gs2,
      [&](int u, const XT*& xr, int8_t*& ca, int8_t*& cb) {
        const int m = u / ng, g = u - m * ng;
        xr = x + m * k + (size_t)g * 2 * gs2;
        ca = qa + m * ld + g * gs2;
        cb = qb + m * ld + g * gs2;
      },
      [&](int u, float s_a, float s_b, float t, float sx) {
        f[u] = s_a;  // u = m * ng + g
        f[arows * ng + u] = s_b;
        f[2 * arows * ng + u] = t;
        if (a.z) f[3 * arows * ng + u] = sx;
      });
}

// Where the K loop finds the A operand: the codes qa / qb of the stage's
// first byte, rows of stride ld, and a row's sa, sb, t, xs of a group at
// f[row * fs], f[fp + row * fs], f[2 fp + row * fs], f[3 fp + row * fs]
// (group_floats): the folded A tile's (arows rows at A), or the ring slot's
// (unfolded).
struct AView {
  const uint8_t* qa;
  const uint8_t* qb;
  int ld;
  const float* f;
  int fs, fp;
};

// The A view of stage st (its first group g0 = st * GPS).
template <int GS2, typename XT>
__device__ __forceinline__ AView a_view(const W4A8Args& a, int st, int arows,
                                        const uint8_t* A,
                                        const uint8_t* slot) {
  using S = Shape<GS2, XT>;
  if constexpr (S::FOLD) {
    const int ld = fold_ld(a.K2);
    return {A + st * S::KC, A + arows * ld + st * S::KC, ld,
            reinterpret_cast<const float*>(A + 2 * arows * ld) +
                st * S::GPS,
            a.ng, arows * a.ng};
  } else {
    return {slot, slot + S::A_BYTES, S::LDA,
            reinterpret_cast<const float*>(slot + S::CODE_BYTES +
                                           S::W_BYTES),
            1, BM};
  }
}

// The row floats of group gi of a stage in the A view.
template <int GS2, typename XT>
__device__ __forceinline__ const float* group_floats(const AView& av,
                                                     int gi, bool hasz) {
  using S = Shape<GS2, XT>;
  return S::FOLD ? av.f + gi : av.f + gi * S::rf(hasz);
}

// 16-byte chunk c of weight row k in the swizzled raw tile: the rows an
// ldmatrix reads (k = 0 1 4 5 8 9 12 13, or those + 2) land on 8
// distinct 16-byte bank groups (a 64-byte row spans 4 of them, the next
// row the other 4)
__device__ __forceinline__ int wchunk(int k, int c) {
  return c ^ ((k >> 2) & 3);
}

// Issue the copies of stage st into a ring slot (ZP: the weight has zero
// points).
template <int GS2, typename XT, bool ZP>
__device__ __forceinline__ void load_stage(const W4A8Args& a, int e,
                                           int row0, int nrows, int n0,
                                           int st, uint8_t* slot) {
  using S = Shape<GS2, XT>;
  constexpr int CPW = BN / 16;   // 16-byte chunks of a weight row
  const int t = threadIdx.x;
  const int kb = st * S::KC;     // the stage's first storage row
  if constexpr (!S::FOLD) {
    constexpr int CPR = S::KC / 16;  // 16-byte chunks of a qa row
    for (int i = t; i < BM * CPR; i += THREADS) {
      const int m = i / CPR, q = i % CPR;
      const bool ok = m < nrows && (!S::WIDE || kb + q * 16 < a.K2);
      const size_t off = ok ? (size_t)(row0 + m) * a.K2 + kb + q * 16 : 0;
      kt_mma::cp_async16(slot + m * S::LDA + q * 16, a.qa + off, ok);
      kt_mma::cp_async16(slot + S::A_BYTES + m * S::LDA + q * 16, a.qb + off,
                         ok);
    }
  }
  uint8_t* wd = slot + S::CODE_BYTES;
  for (int i = t; i < S::KC * CPW; i += THREADS) {
    const int k = i / CPW, c = i % CPW;
    const int n = n0 + c * 16;
    const bool ok = n < a.N && (!S::WIDE || kb + k < a.K2);
    kt_mma::cp_async16(
        wd + k * BN + wchunk(k, c) * 16,
        a.w + ((size_t)e * a.K2 + (ok ? kb + k : 0)) * a.N + (ok ? n : 0),
        ok);
  }
  if constexpr (!S::WIDE) {
    float* f = reinterpret_cast<float*>(wd + S::W_BYTES);
    const int g0 = st * S::GPS;
    // each group's row floats sa, sb, t (and xs)
    constexpr int rf = S::rf(ZP), nrf = S::GPS * rf;
    for (int i = t; i < nrf; i += THREADS) {
      const int gi = i / rf, which = (i % rf) / BM, m = i % BM;
      const float* src = which == 0 ? a.sa : which == 1 ? a.sb
                         : which == 2 ? a.t : a.xs;
      const bool ok = m < nrows;
      kt_mma::cp_async4(
          f + i, ok ? src + (size_t)(row0 + m) * a.ng + g0 + gi : a.sa, ok);
    }
    // each group's column floats s (and z)
    constexpr int cf = S::cf(ZP), ncf = S::GPS * cf / 4;
    for (int i = t; i < ncf; i += THREADS) {
      const int gi = i / (cf / 4), which = (i % (cf / 4)) / (BN / 4);
      const int c = i % (BN / 4), n = n0 + 4 * c;
      const bool ok = n < a.N;
      const float* src = which == 0 ? a.s : a.z;
      kt_mma::cp_async16(
          f + nrf + gi * cf + which * BN + 4 * c,
          ok ? src + ((size_t)e * a.ng + g0 + gi) * a.N + n : a.s, ok);
    }
  }
}

// Issue the copies of group g into a ring slot.
template <int GS2, typename XT>
__device__ __forceinline__ void load_group(const W4A8Args& a, int e,
                                           int row0, int nrows, int n0,
                                           int g, uint8_t* slot) {
  using S = Shape<GS2, XT>;
  constexpr int CPW = BN / 16;   // 16-byte chunks of a weight row
  const int t = threadIdx.x;
  if constexpr (!S::FOLD) {
    constexpr int CPR = GS2 / 16;  // 16-byte chunks of a qa row
    for (int i = t; i < BM * CPR; i += THREADS) {
      const int m = i / CPR, q = i % CPR;
      const bool ok = m < nrows;
      const size_t off =
          (size_t)(row0 + (ok ? m : 0)) * a.K2 + (size_t)g * GS2 + q * 16;
      kt_mma::cp_async16(slot + m * S::LDA + q * 16, a.qa + off, ok);
      kt_mma::cp_async16(slot + S::A_BYTES + m * S::LDA + q * 16, a.qb + off,
                         ok);
    }
  }
  uint8_t* wd = slot + S::CODE_BYTES;
  for (int i = t; i < GS2 * CPW; i += THREADS) {
    const int k = i / CPW, c = i % CPW;
    const int n = n0 + c * 16;
    const bool ok = n < a.N;
    kt_mma::cp_async16(
        wd + k * BN + wchunk(k, c) * 16,
        a.w + ((size_t)e * a.K2 + (size_t)g * GS2 + k) * a.N + (ok ? n : 0),
        ok);
  }
  float* f = reinterpret_cast<float*>(wd + S::W_BYTES);
  constexpr int RF = S::FOLD ? 0 : 3 * BM;  // the rows' sa, sb, t
  if (t < RF) {
    const int which = t / BM, m = t % BM;
    const float* src = which == 0 ? a.sa : which == 1 ? a.sb : a.t;
    const bool ok = m < nrows;
    kt_mma::cp_async4(f + t, src + (size_t)(row0 + (ok ? m : 0)) * a.ng + g,
                      ok);
  } else if (t < RF + BN / 4) {
    const int c = t - RF;
    const int n = n0 + 4 * c;
    const bool ok = n < a.N;
    kt_mma::cp_async16(f + RF + 4 * c,
                       a.s + ((size_t)e * a.ng + g) * a.N + (ok ? n : 0), ok);
  }
}

// Issue the copies of stage st: load_group at one group of 128 or 96
// without zero points (the group's floats in one pass of the block's
// threads), else load_stage.
template <int GS2, typename XT, bool ZP>
__device__ __forceinline__ void issue_stage(const W4A8Args& a, int e,
                                            int row0, int nrows, int n0,
                                            int st, uint8_t* slot) {
  using S = Shape<GS2, XT>;
  if constexpr (S::GPS == 1 && !S::WIDE && !ZP)
    load_group<GS2, XT>(a, e, row0, nrows, n0, st, slot);
  else
    load_stage<GS2, XT, ZP>(a, e, row0, nrows, n0, st, slot);
}

// B fragments of a column pair from one ldmatrix.x4.trans result: r[0] /
// r[1] hold k = 4q, 4q+1 / 4q+2, 4q+3 of (even, odd) columns.
__device__ __forceinline__ void split_pair(uint32_t r0, uint32_t r1,
                                           uint32_t& even, uint32_t& odd) {
  even = __byte_perm(r0, r1, 0x6420);
  odd = __byte_perm(r0, r1, 0x7531);
}

// One m16n8k32 step over bytes [kk, kk + 32) of the stage: the warp's live
// 16-row halves into pa / pb (n8 tile nt = 2p: even columns of chunk p, 2p +
// 1: odd ones).
template <int P>
__device__ __forceinline__ void step_k32(const AView& av,
                                         const uint8_t* wt, int kk, int wm,
                                         int wn, int live,
                                         int (&pa)[2][2 * P][4],
                                         int (&pb)[2][2 * P][4]) {
  const uint32_t LO = 0x0F0F0F0Fu;
  const int lane = threadIdx.x & 31;
  const int jm = lane >> 3, jr = lane & 7;
  const int krow = (jm & 1) * 2 + (jr >> 1) * 4 + (jr & 1);
  uint32_t fa[2][4], fb[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (i >= live) break;
    const int ro =
        (wm * 32 + i * 16 + (lane & 15)) * av.ld + kk + (lane >> 4) * 16;
    kt_mma::ldmatrix_x4(fa[i], av.qa + ro);
    kt_mma::ldmatrix_x4(fb[i], av.qb + ro);
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    // matrices: k rows 0-15 (pi0, pi1), then 16-31
    const int k = kk + (jm >> 1) * 16 + krow;
    uint32_t r[4];
    kt_mma::ldmatrix_x4_trans(r, wt + k * BN + wchunk(k, wn * P + p) * 16);
    uint32_t e0, o0, e1, o1;
    split_pair(r[0], r[1], e0, o0);
    split_pair(r[2], r[3], e1, o1);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (i >= live) break;
      kt_mma::mma_s8_16832(pa[i][2 * p], fa[i], e0 & LO, e1 & LO);
      kt_mma::mma_s8_16832(pa[i][2 * p + 1], fa[i], o0 & LO, o1 & LO);
      kt_mma::mma_s8_16832(pb[i][2 * p], fb[i], e0, e1);
      kt_mma::mma_s8_16832(pb[i][2 * p + 1], fb[i], o0, o1);
    }
  }
}

// One m16n8k16 step over bytes [kk, kk + 16) of the stage. half < 0: all of
// it; half 0 / 1: only k bytes 0-7 / 8-15 (a group of 16: the A fragment of
// the lanes that hold the other 8 bytes is zeroed).
template <int P>
__device__ __forceinline__ void step_k16(const AView& av,
                                         const uint8_t* wt, int kk, int wm,
                                         int wn, int live, int half,
                                         int (&pa)[2][2 * P][4],
                                         int (&pb)[2][2 * P][4]) {
  const uint32_t LO = 0x0F0F0F0Fu;
  const int lane = threadIdx.x & 31;
  const int jm = lane >> 3, jr = lane & 7;
  const int krow = (jm & 1) * 2 + (jr >> 1) * 4 + (jr & 1);
  const bool keep = half < 0 || ((lane >> 1) & 1) == half;
  uint32_t fa[2][2], fb[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (i >= live) break;
    const int ro = (wm * 32 + i * 16 + (lane & 15)) * av.ld + kk;
    kt_mma::ldmatrix_x2(fa[i], av.qa + ro);
    kt_mma::ldmatrix_x2(fb[i], av.qb + ro);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      fa[i][j] = keep ? fa[i][j] : 0u;
      fb[i][j] = keep ? fb[i][j] : 0u;
    }
  }
  // matrices: (chunk 0: pi0, pi1), (chunk 1: pi0, pi1); with one chunk a
  // warp the second pair repeats the first
  const int k = kk + krow;
  const int ch = wn * P + ((jm >> 1) < P ? (jm >> 1) : 0);
  uint32_t r[4];
  kt_mma::ldmatrix_x4_trans(r, wt + k * BN + wchunk(k, ch) * 16);
  uint32_t ev[2], od[2];
  split_pair(r[0], r[1], ev[0], od[0]);
  split_pair(r[2], r[3], ev[1], od[1]);
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (i >= live) break;
      kt_mma::mma_s8_16816(pa[i][2 * p], fa[i], ev[p] & LO);
      kt_mma::mma_s8_16816(pa[i][2 * p + 1], fa[i], od[p] & LO);
      kt_mma::mma_s8_16816(pb[i][2 * p], fb[i], ev[p]);
      kt_mma::mma_s8_16816(pb[i][2 * p + 1], fb[i], od[p]);
    }
}

// A group's epilogue: fragment element c of tile nt is row lane/4 + 8(c/2)
// and column 4*(lane%4) + 2*(c%2) + nt%2 of chunk nt/2; rf: the group's
// row floats (AView strides fs / fp), cs: its columns' s then z (BN each;
// z and the rows' xs only where ZP).
template <int P, bool ZP>
__device__ __forceinline__ void group_epilogue(
    const int (&pa)[2][2 * P][4], const int (&pb)[2][2 * P][4],
    const float* rf, int fs, int fp, const float* cs, int wm, int wn,
    int live, float (&acc)[2][P][2][4]) {
  constexpr bool hasz = ZP;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (i >= live) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wm * 32 + i * 16 + (lane >> 2) + h * 8;
      const float* fr = rf + row * fs;
      const float sam = fr[0], sbm = fr[fp], tm = fr[2 * fp];
      const float xm = hasz ? fr[3 * fp] : 0.f;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int cc = wn * (BN / 4) + p * 16 + 4 * (lane & 3);
        const float4 s4 = *reinterpret_cast<const float4*>(cs + cc);
        const float sc[4] = {s4.x, s4.y, s4.z, s4.w};
        float zc[4] = {0.f, 0.f, 0.f, 0.f};
        if (hasz) {
          const float4 z4 = *reinterpret_cast<const float4*>(cs + BN + cc);
          zc[0] = z4.x; zc[1] = z4.y; zc[2] = z4.z; zc[3] = z4.w;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int nt = 2 * p + (c & 1), fc = 2 * h + (c >> 1);
          float val = (float)pa[i][nt][fc] * sam + (float)pb[i][nt][fc] * sbm -
                      tm;
          if (hasz) val -= xm * zc[c];
          acc[i][p][h][c] += val * sc[c];
        }
      }
    }
  }
}

template <int P>
__device__ __forceinline__ void zero_sums(int (&pa)[2][2 * P][4],
                                          int (&pb)[2][2 * P][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int nt = 0; nt < 2 * P; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) pa[i][nt][c] = pb[i][nt][c] = 0;
}

// The kernel. GS2 as Shape's; ZP: the weight has zero points (the zero
// term, a separate instantiation). At groups of 128 and 96 without zero
// points the branches on SMALL, WIDE and ZP compile away to one group a
// stage, its copies load_group's (issue_stage). arows: the rows of a
// folded A tile (a multiple of 16, at least the tile's rows); unused with
// XT = int8_t.
template <int GS2, typename XT, typename OutT, bool ZP>
__global__ void __launch_bounds__(THREADS, 2)
    w4a8_mma_kernel(W4A8Args a, int arows, OutT* __restrict__ out) {
  using S = Shape<GS2, XT>;
  constexpr int P = S::P;
  extern __shared__ __align__(128) uint8_t smem[];
  const int tile = blockIdx.y;
  const int nrows = a.tile_rows[tile];
  if (nrows <= 0) return;  // dead tile (block-uniform)
  const int row0 = a.tile_row0[tile];
  const int e = a.tile_expert[tile];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  constexpr bool hasz = ZP;
  // the warp's 16-row halves that hold a live row (warp-uniform)
  const int live = min(2, max(0, (nrows - wm * 32 + 15) / 16));
  // the stages of the K loop
  const int nst = S::WIDE ? (a.K2 + S::KC - 1) / S::KC : a.ng / S::GPS;
  constexpr int stage = S::stage(ZP);  // bytes of a ring stage
  uint8_t* A = smem + S::smem(ZP);  // the folded A tile
  // A folded launch walks column blocks blockIdx.x, + gridDim.x, ... with
  // the one A tile it quantized; an unfolded one its own column block.
  const int ncb = S::FOLD ? (a.N + BN - 1) / BN : blockIdx.x + 1;
  for (int cb = blockIdx.x; cb < ncb; cb += gridDim.x) {
    const int n0 = cb * BN;
    if (cb != blockIdx.x) __syncthreads();  // the ring is free again

    // acc[i][p][h][c]: row wm*32 + i*16 + lane/4 + 8h, column
    // n0 + wn*WN + p*16 + 4*(lane%4) + c
    float acc[2][P][2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][p][h][c] = 0.f;
    // WIDE: the one group's int sums, over every stage
    int pw[2][2 * P][4], qw[2][2 * P][4];
    if constexpr (S::WIDE) zero_sums<P>(pw, qw);

#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      if (st < nst)
        issue_stage<GS2, XT, ZP>(a, e, row0, nrows, n0, st,
                                 smem + st * stage);
      kt_mma::cp_async_commit();
    }
    if constexpr (S::FOLD)
      if (cb == blockIdx.x)
        fold_tile<4, XT>(a, row0, nrows, arows, THREADS / 32, A);
    for (int st = 0; st < nst; ++st) {
      kt_mma::cp_async_wait<STAGES - 2>();
      __syncthreads();  // stage st landed; stage st - 1 fully consumed
      const int nx = st + STAGES - 1;
      if (nx < nst)
        issue_stage<GS2, XT, ZP>(a, e, row0, nrows, n0, nx,
                                 smem + (nx % STAGES) * stage);
      kt_mma::cp_async_commit();
      if (live == 0) continue;  // no live row: copies and barriers only
      const uint8_t* slot = smem + (st % STAGES) * stage;
      const uint8_t* wt = slot + S::CODE_BYTES;
      const AView av = a_view<GS2, XT>(a, st, arows, A, slot);
      if constexpr (S::WIDE) {
#pragma unroll
        for (int kk = 0; kk < S::KC; kk += 32)
          step_k32<P>(av, wt, kk, wm, wn, live, pw, qw);
      } else {
        // the columns' s (and z) of the stage's groups
        const float* cs = reinterpret_cast<const float*>(wt + S::W_BYTES) +
                          S::GPS * S::rf(hasz);
        int pa[2][2 * P][4], pb[2][2 * P][4];
        if constexpr (!S::SMALL) {  // one group a stage
          zero_sums<P>(pa, pb);
#pragma unroll
          for (int kk = 0; kk + 32 <= GS2; kk += 32)
            step_k32<P>(av, wt, kk, wm, wn, live, pa, pb);
          if (GS2 % 32)  // the last 16 bytes of a group of 96
            step_k16<P>(av, wt, GS2 - 16, wm, wn, live, -1, pa, pb);
          group_epilogue<P, ZP>(pa, pb, group_floats<GS2, XT>(av, 0, ZP),
                                av.fs, av.fp, cs, wm, wn, live, acc);
        } else {
#pragma unroll
          for (int gi = 0; gi < S::GPS; ++gi) {
            zero_sums<P>(pa, pb);
            if (GS2 == 16)  // a group of 32: one k16 step
              step_k16<P>(av, wt, gi * 16, wm, wn, live, -1, pa, pb);
            else  // a group of 16: half a k16 step
              step_k16<P>(av, wt, (gi >> 1) * 16, wm, wn, live, gi & 1, pa,
                          pb);
            group_epilogue<P, ZP>(
                pa, pb, group_floats<GS2, XT>(av, gi, ZP), av.fs, av.fp,
                cs + gi * S::cf(ZP), wm, wn, live, acc);
          }
        }
      }
    }
    if constexpr (S::WIDE) {
      // the one group's epilogue, its floats read from device memory
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (i >= live) break;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = wm * 32 + i * 16 + (lane >> 2) + h * 8;
          if (row >= nrows) continue;
          const size_t ri = (size_t)(row0 + row);
          const float sam = a.sa[ri], sbm = a.sb[ri], tm = a.t[ri];
          const float xm = hasz ? a.xs[ri] : 0.f;
#pragma unroll
          for (int p = 0; p < P; ++p) {
            const int col = n0 + wn * S::WN + p * 16 + 4 * (lane & 3);
            if (col >= a.N) continue;
            const size_t wi = (size_t)e * a.N + col;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int nt = 2 * p + (c & 1), fc = 2 * h + (c >> 1);
              float val = (float)pw[i][nt][fc] * sam +
                          (float)qw[i][nt][fc] * sbm - tm;
              if (hasz) val -= xm * __ldg(a.z + wi + c);
              acc[i][p][h][c] += val * __ldg(a.s + wi + c);
            }
          }
        }
      }
    }

#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int col = n0 + wn * S::WN + p * 16 + 4 * (lane & 3);
      if (col >= a.N) continue;  // N % 16 == 0: the 4 columns in or out
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = wm * 32 + i * 16 + (lane >> 2) + h * 8;
          if (row >= nrows) continue;
          OutT* o = out + (size_t)(row0 + row) * a.N + col;
#pragma unroll
          for (int c = 0; c < 4; ++c) store_out(o + c, acc[i][p][h][c]);
        }
    }
  }
}

template <int GS2, typename XT, typename OutT, bool ZP>
cudaError_t launch_zp(const W4A8Args& a, int ntiles, int arows, OutT* out,
                      cudaStream_t stream) {
  static int ready_dev = -1;
  using S = Shape<GS2, XT>;
  if (!S::WIDE && a.ng % S::GPS) return cudaErrorInvalidValue;
  const int smem =
      S::smem(ZP) + (S::FOLD ? fold_bytes(arows, a.K2, a.ng, ZP) : 0);
  if (S::FOLD && (arows < 16 || arows > BM || arows % 16 || smem > MAX_SMEM))
    return cudaErrorInvalidValue;
  cudaError_t err = kt_mma::allow_smem(w4a8_mma_kernel<GS2, XT, OutT, ZP>,
                                       MAX_SMEM, &ready_dev);
  if (err != cudaSuccess) return err;
  // a folded launch keeps its blocks resident (one or two an SM) and lets
  // each walk several column blocks with its one quantized A tile
  int cols = (a.N + BN - 1) / BN;
  if (S::FOLD) {
    static int sms = 0;
    if (sms == 0) {
      int dev = 0;
      err = cudaGetDevice(&dev);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
      if (err != cudaSuccess) return err;
    }
    const int resident = sms * (2 * (smem + 1024) <= MAX_SMEM ? 2 : 1);
    const int walk = (cols + resident - 1) / resident;  // a tile's share
    cols = (cols + walk - 1) / walk;
  }
  dim3 grid(cols, ntiles);
  w4a8_mma_kernel<GS2, XT, OutT, ZP><<<grid, THREADS, smem, stream>>>(a, arows,
                                                                      out);
  return cudaGetLastError();
}

// The instantiation with the zero term where a.z is given.
template <int GS2, typename XT, typename OutT>
cudaError_t launch_gs(const W4A8Args& a, int ntiles, int arows, OutT* out,
                      cudaStream_t stream) {
  return a.z ? launch_zp<GS2, XT, OutT, true>(a, ntiles, arows, out, stream)
             : launch_zp<GS2, XT, OutT, false>(a, ntiles, arows, out, stream);
}

}  // namespace w4mma

// gs2 = 64 (group 128), 48 (96), 16 (32) or 8 (16), K/2 a multiple of 32
// at the last two; or one group of all K (ng = 1, codes of a prep launch);
// N a multiple of 16; K/2 a multiple of 16 bytes. XT = int8_t reads a prep
// launch's codes; float or bf16 folds the prep in, into an A tile of arows
// rows (a multiple of 16, at least every tile's rows, at most 64;
// w4mma::fold_bytes within MAX_SMEM beside the ring).
template <typename XT, typename OutT>
cudaError_t launch_mma(const W4A8Args& a, int ntiles, int arows, OutT* out,
                       cudaStream_t stream) {
  if (a.N % 16 || a.K2 % 16 || ntiles > 65535) return cudaErrorInvalidValue;
  switch (a.gs2) {
    case 64:
      return w4mma::launch_gs<64, XT, OutT>(a, ntiles, arows, out, stream);
    case 48:
      return w4mma::launch_gs<48, XT, OutT>(a, ntiles, arows, out, stream);
    case 16:
      return w4mma::launch_gs<16, XT, OutT>(a, ntiles, arows, out, stream);
    case 8:
      return w4mma::launch_gs<8, XT, OutT>(a, ntiles, arows, out, stream);
    default:
      if constexpr (std::is_same<XT, int8_t>::value)
        if (a.ng == 1)
          return w4mma::launch_gs<0, XT, OutT>(a, ntiles, arows, out, stream);
      return cudaErrorInvalidValue;
  }
}

}  // namespace kt
