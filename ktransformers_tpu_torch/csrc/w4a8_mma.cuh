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
constexpr int STAGES = 4;     // depth of the cp.async ring (groups)
constexpr int THREADS = 256;  // 8 warps: 2 along M x 4 along N

// The ring's stages. A stage holds the raw weight bytes of one scale group
// [gs/2][BN] and its s (per column); where the kernel reads a prep launch's
// codes (XT = int8_t) also the group's qa and qb rows [BM][LDA] and sa, sb,
// t (per row). Where it folds the prep in (XT float or bf16) the codes of
// every group lie in the A tile after the ring (fold_bytes).
template <int GS2, typename XT>
struct Shape {
  static constexpr bool FOLD = !std::is_same<XT, int8_t>::value;
  // qa / qb tile row stride: an odd number of 16-byte chunks keeps the
  // ldmatrix rows on distinct banks
  static constexpr int LDA = (GS2 / 16) % 2 ? GS2 : GS2 + 16;
  static constexpr int A_BYTES = BM * LDA;
  static constexpr int CODE_BYTES = FOLD ? 0 : 2 * A_BYTES;  // qa, qb
  static constexpr int W_BYTES = GS2 * BN;
  static constexpr int F_FLOATS = (FOLD ? 0 : 3 * BM) + BN;  // [sa, sb, t,] s
  static constexpr int STAGE = CODE_BYTES + W_BYTES + F_FLOATS * 4;
  static constexpr int SMEM = STAGES * STAGE;  // the ring
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
// sb, t [arows][ng].
__host__ __device__ constexpr int fold_bytes(int arows, int k2, int ng) {
  return 2 * arows * fold_ld(k2) + 3 * arows * ng * 4;
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
      [&](int u, float s_a, float s_b, float t) {
        f[u] = s_a;  // u = m * ng + g
        f[arows * ng + u] = s_b;
        f[2 * arows * ng + u] = t;
      });
}

// Where the K loop finds the A operand of scale group g: qa / qb rows of
// stride ld, and a row's sa, sb, t at f[row * fs], f[fp + row * fs],
// f[2 fp + row * fs]: the folded A tile's (arows rows at A), or the ring
// slot's codes (unfolded).
struct AView {
  const uint8_t* qa;
  const uint8_t* qb;
  int ld;
  const float* f;
  int fs, fp;
};

template <int GS2, typename XT>
__device__ __forceinline__ AView a_view(const W4A8Args& a, int g, int arows,
                                        const uint8_t* A,
                                        const uint8_t* slot) {
  using S = Shape<GS2, XT>;
  if constexpr (S::FOLD) {
    const int ld = fold_ld(a.K2);
    return {A + g * GS2, A + arows * ld + g * GS2, ld,
            reinterpret_cast<const float*>(A + 2 * arows * ld) + g, a.ng,
            arows * a.ng};
  } else {
    return {slot, slot + S::A_BYTES, S::LDA,
            reinterpret_cast<const float*>(slot + S::CODE_BYTES +
                                           S::W_BYTES),
            1, BM};
  }
}

// 16-byte chunk c of weight row k in the swizzled raw tile: the rows an
// ldmatrix reads (k = 0 1 4 5 8 9 12 13, or those + 2) land on 8
// distinct 16-byte bank groups (a 64-byte row spans 4 of them, the next
// row the other 4)
__device__ __forceinline__ int wchunk(int k, int c) {
  return c ^ ((k >> 2) & 3);
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

// B fragments of a column pair from one ldmatrix.x4.trans result: r[0] /
// r[1] hold k = 4q, 4q+1 / 4q+2, 4q+3 of (even, odd) columns.
__device__ __forceinline__ void split_pair(uint32_t r0, uint32_t r1,
                                           uint32_t& even, uint32_t& odd) {
  even = __byte_perm(r0, r1, 0x6420);
  odd = __byte_perm(r0, r1, 0x7531);
}

// arows: the rows of a folded A tile (a multiple of 16, at least the
// tile's rows); unused with XT = int8_t.
template <int GS2, typename XT, typename OutT>
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
  const uint32_t LO = 0x0F0F0F0Fu;
  // the warp's 16-row halves that hold a live row (warp-uniform)
  const int live = min(2, max(0, (nrows - wm * 32 + 15) / 16));
  const int jm = lane >> 3, jr = lane & 7;
  // this lane's ldmatrix.trans row inside a 16-row k block
  const int krow = (jm & 1) * 2 + (jr >> 1) * 4 + (jr & 1);
  uint8_t* A = smem + S::SMEM;  // the folded A tile
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

#pragma unroll
    for (int g = 0; g < STAGES - 1; ++g) {
      if (g < a.ng)
        load_group<GS2, XT>(a, e, row0, nrows, n0, g, smem + g * S::STAGE);
      kt_mma::cp_async_commit();
    }
    if constexpr (S::FOLD)
      if (cb == blockIdx.x)
        fold_tile<4, XT>(a, row0, nrows, arows, THREADS / 32, A);
    for (int g = 0; g < a.ng; ++g) {
      kt_mma::cp_async_wait<STAGES - 2>();
      __syncthreads();  // group g landed; group g - 1 fully consumed
      const int nx = g + STAGES - 1;
      if (nx < a.ng)
        load_group<GS2, XT>(a, e, row0, nrows, n0, nx,
                            smem + (nx % STAGES) * S::STAGE);
      kt_mma::cp_async_commit();
      if (live == 0) continue;  // no live row: copies and barriers only
      const uint8_t* slot = smem + (g % STAGES) * S::STAGE;
      const uint8_t* wt = slot + S::CODE_BYTES;
      const float* fs = reinterpret_cast<const float*>(wt + S::W_BYTES) +
                        (S::FOLD ? 0 : 3 * BM);  // the columns' s
      const AView av = a_view<GS2, XT>(a, g, arows, A, slot);

      // pa[i][nt], pb[i][nt]: n8 tile nt = 2p (even columns of chunk p) or
      // 2p + 1 (odd ones)
      int pa[2][2 * P][4], pb[2][2 * P][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int nt = 0; nt < 2 * P; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) pa[i][nt][c] = pb[i][nt][c] = 0;

#pragma unroll
      for (int kk = 0; kk + 32 <= GS2; kk += 32) {
        uint32_t fa[2][4], fb[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (i >= live) break;
          const int ro = (wm * 32 + i * 16 + (lane & 15)) * av.ld + kk +
                         (lane >> 4) * 16;
          kt_mma::ldmatrix_x4(fa[i], av.qa + ro);
          kt_mma::ldmatrix_x4(fb[i], av.qb + ro);
        }
#pragma unroll
        for (int p = 0; p < P; ++p) {
          // matrices: k rows 0-15 (pi0, pi1), then 16-31
          const int k = kk + (jm >> 1) * 16 + krow;
          uint32_t r[4];
          kt_mma::ldmatrix_x4_trans(
              r, wt + k * BN + wchunk(k, wn * P + p) * 16);
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
      if (GS2 % 32) {  // the last 16 bytes of a group of 96
        const int kk = GS2 - 16;
        uint32_t fa[2][2], fb[2][2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (i >= live) break;
          const int ro = (wm * 32 + i * 16 + (lane & 15)) * av.ld + kk;
          kt_mma::ldmatrix_x2(fa[i], av.qa + ro);
          kt_mma::ldmatrix_x2(fb[i], av.qb + ro);
        }
        // matrices: (chunk 0: pi0, pi1), (chunk 1: pi0, pi1); with one
        // chunk a warp the second pair repeats the first
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

      // group epilogue: fragment element c of tile nt is row lane/4 + 8(c/2)
      // and column 4*(lane%4) + 2*(c%2) + nt%2 of chunk nt/2
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (i >= live) break;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = wm * 32 + i * 16 + (lane >> 2) + h * 8;
          const float* fr = av.f + row * av.fs;
          const float sam = fr[0], sbm = fr[av.fp], tm = fr[2 * av.fp];
#pragma unroll
          for (int p = 0; p < P; ++p) {
            const float4 s4 = *reinterpret_cast<const float4*>(
                fs + wn * S::WN + p * 16 + 4 * (lane & 3));
            const float sc[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int nt = 2 * p + (c & 1), fc = 2 * h + (c >> 1);
              const float val = (float)pa[i][nt][fc] * sam +
                                (float)pb[i][nt][fc] * sbm - tm;
              acc[i][p][h][c] += val * sc[c];
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

template <int GS2, typename XT, typename OutT>
cudaError_t launch_gs(const W4A8Args& a, int ntiles, int arows, OutT* out,
                      cudaStream_t stream) {
  static int ready_dev = -1;
  using S = Shape<GS2, XT>;
  const int smem = S::SMEM + (S::FOLD ? fold_bytes(arows, a.K2, a.ng) : 0);
  if (S::FOLD && (arows < 16 || arows > BM || arows % 16 || smem > MAX_SMEM))
    return cudaErrorInvalidValue;
  cudaError_t err = kt_mma::allow_smem(w4a8_mma_kernel<GS2, XT, OutT>,
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
  w4a8_mma_kernel<GS2, XT, OutT><<<grid, THREADS, smem, stream>>>(a, arows,
                                                                   out);
  return cudaGetLastError();
}

}  // namespace w4mma

// gs2 = 64 (group 128) or 48 (group 96); N a multiple of 16; K/2 a
// multiple of 16 bytes. XT = int8_t reads a prep launch's codes; float or
// bf16 folds the prep in, into an A tile of arows rows (a multiple of 16,
// at least every tile's rows, at most 64; w4mma::fold_bytes within
// MAX_SMEM beside the ring).
template <typename XT, typename OutT>
cudaError_t launch_mma(const W4A8Args& a, int ntiles, int arows, OutT* out,
                       cudaStream_t stream) {
  if (a.N % 16 || a.K2 % 16 || ntiles > 65535) return cudaErrorInvalidValue;
  switch (a.gs2) {
    case 64:
      return w4mma::launch_gs<64, XT, OutT>(a, ntiles, arows, out, stream);
    case 48:
      return w4mma::launch_gs<48, XT, OutT>(a, ntiles, arows, out, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace kt
