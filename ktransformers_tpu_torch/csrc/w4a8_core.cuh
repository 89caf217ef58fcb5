// W4A8 core shared by w4a8_matmul.cu and w4a8_ffn.cu.
//
// Weights are int4 (one group of all K), int4_g or int4_gz in the
// offset-lo encoding (quant/w4a8.py): each int8 byte braw = 16*hi + (lo + 8),
// u = braw & 15. Activations come as per (row, scale group) int8 codes qa,
// qb with float scales sa, sb, the correction t = 8*sum(x_lo) and the group
// sum xs = sum(x) (w4a8_prep; prep_group below, run by a launch of
// w4a8_prep_kernel ahead of the consumer or by the consumer itself, which
// then reads x). For output column n and group g:
//
//   val = (qa . u)*sa + (qb . braw)*sb - t [- xs * z[g, n]];
//   y[n] += val * s[g, n]
//
// which is _w4a8_group_acc of ktransformers_tpu/ops/pallas/w4a8_matmul.py;
// the zero term is there where the weight has zero points (int4_gz: z not
// null). Without z no kernel reads xs, and the arithmetic is the one it had
// before the zero term.
//
// Work unit: a "tile" of up to MR rows that share one expert (tile_expert,
// tile_row0, tile_rows, built on the device by the Python wrapper). A block
// is 32 x KW threads: threadIdx.x owns 4 adjacent output columns (one
// 4-byte load per weight row, 128 contiguous bytes per warp), threadIdx.y
// walks the scale groups g = y, y + KW, ... The int8 dots run on __dp4a:
// four weight rows of four columns are transposed in registers with
// __byte_perm so each column's four K-bytes meet the activation's four
// K-bytes in one instruction. The K-slices are summed through shared memory
// at the end. One kernel serves decode (MR = 1) and prefill tiles (MR = 4
// or 8); the weight bytes of a tile are read once per tile.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace kt {

constexpr int KW = 8;          // K-slices (warps along threadIdx.y)
constexpr int CPT = 4;         // output columns per thread
constexpr int BN = 32 * CPT;   // output columns per block

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct W4A8Args {
  const int8_t* qa;   // [R, K2]
  const int8_t* qb;   // [R, K2]
  const float* sa;    // [R, ng]
  const float* sb;    // [R, ng]
  const float* t;     // [R, ng]
  const float* xs;    // [R, ng] sum of x over the group (read where z)
  const void* x;      // [R, 2 K2] float or bf16 rows of a launch that
                      // quantizes them itself (qa .. t unused then)
  const int8_t* w;    // [E, K2, N] offset-lo packed int4
  const float* s;     // [E, ng, N]
  const float* z;     // [E, ng, N] zero points, or null (no zero term)
  const int* tile_expert;
  const int* tile_row0;
  const int* tile_rows;
  int K2, N, ng, gs2;
};

// Transpose four rows (w[0..3], 4 columns each) into four columns
// (col[c] byte j = row j, column c).
__device__ __forceinline__ void transpose4x4(const int w[4], int col[4]) {
  const int lo01 = __byte_perm(w[0], w[1], 0x5140);
  const int lo23 = __byte_perm(w[2], w[3], 0x5140);
  const int hi01 = __byte_perm(w[0], w[1], 0x7362);
  const int hi23 = __byte_perm(w[2], w[3], 0x7362);
  col[0] = __byte_perm(lo01, lo23, 0x5410);
  col[1] = __byte_perm(lo01, lo23, 0x7632);
  col[2] = __byte_perm(hi01, hi23, 0x5410);
  col[3] = __byte_perm(hi01, hi23, 0x7632);
}

// Accumulate, over the groups this thread's K-slice owns, the f32 partial
// sums of NC column-quads (column offsets cols[q]) for the tile's rows.
template <int MR, int NQ>
__device__ __forceinline__ void w4a8_accumulate(
    const W4A8Args& a, int e, int row0, int nrows, const int cols[NQ],
    float acc[MR][NQ * CPT]) {
  const int8_t* we = a.w + (size_t)e * a.K2 * a.N;
  const float* se = a.s + (size_t)e * a.ng * a.N;
  const float* ze = a.z ? a.z + (size_t)e * a.ng * a.N : nullptr;
  for (int g = threadIdx.y; g < a.ng; g += KW) {
    int pa[MR][NQ * CPT];
    int pb[MR][NQ * CPT];
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int c = 0; c < NQ * CPT; ++c) pa[m][c] = pb[m][c] = 0;
    const int kbase = g * a.gs2;
    for (int kk = 0; kk < a.gs2; kk += 4) {
      int wcol[NQ][4];
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        int wrow[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wrow[j] = __ldg(reinterpret_cast<const int*>(
              we + (size_t)(kbase + kk + j) * a.N + cols[q]));
        transpose4x4(wrow, wcol[q]);
      }
#pragma unroll
      for (int m = 0; m < MR; ++m) {
        if (m < nrows) {
          const size_t ro = (size_t)(row0 + m) * a.K2 + kbase + kk;
          const int a4 = __ldg(reinterpret_cast<const int*>(a.qa + ro));
          const int b4 = __ldg(reinterpret_cast<const int*>(a.qb + ro));
#pragma unroll
          for (int q = 0; q < NQ; ++q)
#pragma unroll
            for (int c = 0; c < CPT; ++c) {
              const int braw = wcol[q][c];
              pa[m][q * CPT + c] =
                  __dp4a(a4, braw & 0x0F0F0F0F, pa[m][q * CPT + c]);
              pb[m][q * CPT + c] = __dp4a(b4, braw, pb[m][q * CPT + c]);
            }
        }
      }
    }
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      if (m < nrows) {
        const size_t ri = (size_t)(row0 + m) * a.ng + g;
        const float sam = a.sa[ri], sbm = a.sb[ri], tm = a.t[ri];
        const float xm = a.z ? a.xs[ri] : 0.f;
#pragma unroll
        for (int q = 0; q < NQ; ++q)
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            const size_t wi = (size_t)g * a.N + cols[q] + c;
            const float sc = se[wi];
            float val = (float)pa[m][q * CPT + c] * sam +
                        (float)pb[m][q * CPT + c] * sbm - tm;
            if (a.z) val -= xm * ze[wi];
            acc[m][q * CPT + c] += val * sc;
          }
      }
    }
  }
}

// y[row, n] = sum_g val * s  for the tile's rows and this block's BN
// columns; OutT is float or __nv_bfloat16. grid = (ceil(N / BN), tiles).
template <int MR, typename OutT>
__global__ void __launch_bounds__(32 * KW)
    w4a8_rows_kernel(W4A8Args a, OutT* __restrict__ out) {
  __shared__ float red[KW][MR][BN];
  const int tile = blockIdx.y;
  const int nrows = a.tile_rows[tile];
  if (nrows <= 0) return;  // dead tile (block-uniform)
  const int row0 = a.tile_row0[tile];
  const int e = a.tile_expert[tile];
  const int col = blockIdx.x * BN + threadIdx.x * CPT;
  float acc[MR][CPT];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[m][c] = 0.f;
  if (col < a.N) {
    const int cols[1] = {col};
    w4a8_accumulate<MR, 1>(a, e, row0, nrows, cols, acc);
  }
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      red[threadIdx.y][m][threadIdx.x * CPT + c] = acc[m][c];
  __syncthreads();
  const int tid = threadIdx.y * 32 + threadIdx.x;
  for (int idx = tid; idx < MR * BN; idx += 32 * KW) {
    const int m = idx / BN, cc = idx % BN;
    const int n = blockIdx.x * BN + cc;
    if (m < nrows && n < a.N) {
      float v = 0.f;
#pragma unroll
      for (int y = 0; y < KW; ++y) v += red[y][m][cc];
      store_out(out + (size_t)(row0 + m) * a.N + n, v);
    }
  }
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The activation prep of quant/w4a8.py:w4a8_prep for N (row, scale group)
// units of x at once, held by one warp: unit n's gs = 2 gs2 values start at
// xr[n] (gs2 <= 32 J); a = lo - hi/16 and b = hi/16 (lo = xr[n][j], hi =
// xr[n][gs2 + j]) are quantized to int8 on their own absmax/127 scales
// (round half to even), t = 8*sum(lo), sx = sum(lo + hi) (the zero term's
// group sum). The codes go to qa[n][j], qb[n][j] (global or shared memory);
// every lane returns s_a[n], s_b[n], t[n] and sx[n].
// Each lane loads its values (j = lane, lane + 32, ...) once, all N units'
// at a time, and keeps them in registers. This is the one copy of the
// prep's arithmetic: w4a8_prep_kernel (N = 1) and every kernel that folds
// the prep in (w4a8_gemv.cuh, w4a8_mma.cuh, w4a8_ffn.cu, through
// prep_units) call it, so the codes and scales are the same bits whichever
// runs it: the division by the scale (not a reciprocal), rintf, the clamp
// to +-127, each lane's sums over its j in increasing order, then one
// __shfl_xor tree. The N units only interleave, to overlap their
// latencies; each one's operations and their order are those of a unit
// alone.
template <int N, int J, typename InT>
__device__ __forceinline__ void prep_group(const InT* const (&xr)[N],
                                           int gs2, int8_t* const (&qa)[N],
                                           int8_t* const (&qb)[N],
                                           float (&s_a)[N], float (&s_b)[N],
                                           float (&t)[N], float (&sx)[N]) {
  const int lane = threadIdx.x & 31;
  float lo[N][J], hi[N][J];
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int i = 0; i < J; ++i) {
      const int j = lane + 32 * i;
      lo[n][i] = j < gs2 ? to_float(xr[n][j]) : 0.f;
      hi[n][i] = j < gs2 ? to_float(xr[n][gs2 + j]) : 0.f;
    }
  float amax_a[N], amax_b[N], slo[N], ssum[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    amax_a[n] = amax_b[n] = slo[n] = ssum[n] = 0.f;
#pragma unroll
    for (int i = 0; i < J; ++i) {
      if (lane + 32 * i < gs2) {
        amax_a[n] = fmaxf(amax_a[n], fabsf(lo[n][i] - hi[n][i] / 16.0f));
        amax_b[n] = fmaxf(amax_b[n], fabsf(hi[n][i] / 16.0f));
        slo[n] += lo[n][i];
        ssum[n] += lo[n][i] + hi[n][i];
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int n = 0; n < N; ++n) {
      amax_a[n] = fmaxf(amax_a[n], __shfl_xor_sync(0xffffffffu, amax_a[n], o));
      amax_b[n] = fmaxf(amax_b[n], __shfl_xor_sync(0xffffffffu, amax_b[n], o));
      slo[n] += __shfl_xor_sync(0xffffffffu, slo[n], o);
      ssum[n] += __shfl_xor_sync(0xffffffffu, ssum[n], o);
    }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    s_a[n] = fmaxf(amax_a[n], 1e-8f) / 127.0f;
    s_b[n] = fmaxf(amax_b[n], 1e-8f) / 127.0f;
    t[n] = 8.0f * slo[n];
    sx[n] = ssum[n];
#pragma unroll
    for (int i = 0; i < J; ++i) {
      const int j = lane + 32 * i;
      if (j < gs2) {
        qa[n][j] = (int8_t)fminf(
            fmaxf(rintf((lo[n][i] - hi[n][i] / 16.0f) / s_a[n]), -127.f),
            127.f);
        qb[n][j] = (int8_t)fminf(
            fmaxf(rintf((hi[n][i] / 16.0f) / s_b[n]), -127.f), 127.f);
      }
    }
  }
}

// Units 0 .. n - 1 of a folded prep (scale groups of gs2 <= 64 pairs),
// shared by the nwarps warps of a block, N at a time a warp (prep_group):
// unit(u, xr, qa, qb) sets unit u's values and code destinations, store(u,
// s_a, s_b, t, sx) takes its scales and sums (lane 0). A warp short of N units
// repeats its first one (the same bits to the same places). Ends
// unsynchronised.
template <int N, typename InT, class Unit, class Store>
__device__ __forceinline__ void prep_units(int n, int nwarps, int gs2,
                                           Unit unit, Store store) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int u0 = warp * N; u0 < n; u0 += nwarps * N) {
    const InT* xr[N];
    int8_t* qa[N];
    int8_t* qb[N];
    float s_a[N], s_b[N], t[N], sx[N];
#pragma unroll
    for (int k = 0; k < N; ++k)
      unit(u0 + k < n ? u0 + k : u0, xr[k], qa[k], qb[k]);
    prep_group<N, 2, InT>(xr, gs2, qa, qb, s_a, s_b, t, sx);
    if (lane == 0)
#pragma unroll
      for (int k = 0; k < N; ++k)
        if (u0 + k < n) store(u0 + k, s_a[k], s_b[k], t[k], sx[k]);
  }
}

// The prep as a launch of its own, one warp per (row, group): x [M, K] ->
// qa, qb [M, K/2], sa, sb, t and (where xs is not null) xs [M, K/gs];
// gs/2 <= 32 J.
template <int J, typename InT>
__global__ void w4a8_prep_kernel(const InT* __restrict__ x, int M, int K,
                                 int gs, int8_t* __restrict__ qa,
                                 int8_t* __restrict__ qb,
                                 float* __restrict__ sa,
                                 float* __restrict__ sb,
                                 float* __restrict__ t,
                                 float* __restrict__ xs) {
  const int ng = K / gs, gs2 = gs / 2;
  const int unit = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (unit >= M * ng) return;
  const int m = unit / ng, g = unit % ng;
  const size_t o0 = (size_t)m * (K / 2) + (size_t)g * gs2;
  const InT* xr[1] = {x + (size_t)m * K + (size_t)g * gs};
  int8_t* const ca[1] = {qa + o0};
  int8_t* const cb[1] = {qb + o0};
  float s_a[1], s_b[1], tt[1], sx[1];
  prep_group<1, J, InT>(xr, gs2, ca, cb, s_a, s_b, tt, sx);
  if ((threadIdx.x & 31) == 0) {
    sa[(size_t)m * ng + g] = s_a[0];
    sb[(size_t)m * ng + g] = s_b[0];
    t[(size_t)m * ng + g] = tt[0];
    if (xs) xs[(size_t)m * ng + g] = sx[0];
  }
}

// The GLU of the FFN kernels on float32: silu, relu or gelu of the gate
// times the up value (ops/pallas/w4a8_matmul.py:_glu).
__device__ __forceinline__ float glu(float g, float u, int act) {
  if (act == 0) return g * (1.0f / (1.0f + expf(-g))) * u;  // silu
  if (act == 1) return fmaxf(g, 0.0f) * u;                   // relu
  return 0.5f * g * (1.0f + erff(g * 0.70710678118654752f)) * u;  // gelu
}

// The prep of groups too wide for a warp (a per-channel int4 weight's group
// is all of K: 2048 to 18432), one block of BLOCK_PREP threads a (row,
// group): thread i takes j = i, i + BLOCK_PREP, ... of the half group, the
// block reduces amax, sum(lo) and sum(x) (each warp's __shfl_xor tree, then
// warp 0 over the warps in order), then writes the codes with prep_group's
// arithmetic (division by the scale, rintf, clamp to +-127). Two passes over
// x, the second from L2; the same bits on every call. GLU: the values are
// glu(h[row][j], h[row][inter + j], act) of a float32 gate_up output h [M,
// 2 inter] (K = inter: the requant of an FFN whose down group no block holds)
// instead of x [M, K].
constexpr int BLOCK_PREP = 256;

template <typename InT, bool GLU>
__device__ __forceinline__ float prep_value(const InT* __restrict__ x,
                                            size_t row, int K, int col,
                                            int act) {
  if constexpr (GLU) {
    const float* h = reinterpret_cast<const float*>(x) + row * 2 * K;
    return glu(h[col], h[K + col], act);
  } else {
    return to_float(x[row * K + col]);
  }
}

template <typename InT, bool GLU>
__global__ void __launch_bounds__(BLOCK_PREP)
    w4a8_prep_block_kernel(const InT* __restrict__ x, int K, int gs, int act,
                           int8_t* __restrict__ qa, int8_t* __restrict__ qb,
                           float* __restrict__ sa, float* __restrict__ sb,
                           float* __restrict__ t, float* __restrict__ xs) {
  __shared__ float red[4][BLOCK_PREP / 32];
  __shared__ float fin[4];
  const int ng = K / gs, gs2 = gs / 2;
  const size_t m = blockIdx.x / ng;
  const int g = blockIdx.x % ng;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = g * gs;
  float amax_a = 0.f, amax_b = 0.f, slo = 0.f, ssum = 0.f;
  for (int j = threadIdx.x; j < gs2; j += BLOCK_PREP) {
    const float lo = prep_value<InT, GLU>(x, m, K, c0 + j, act);
    const float hi = prep_value<InT, GLU>(x, m, K, c0 + gs2 + j, act);
    amax_a = fmaxf(amax_a, fabsf(lo - hi / 16.0f));
    amax_b = fmaxf(amax_b, fabsf(hi / 16.0f));
    slo += lo;
    ssum += lo + hi;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    amax_a = fmaxf(amax_a, __shfl_xor_sync(0xffffffffu, amax_a, o));
    amax_b = fmaxf(amax_b, __shfl_xor_sync(0xffffffffu, amax_b, o));
    slo += __shfl_xor_sync(0xffffffffu, slo, o);
    ssum += __shfl_xor_sync(0xffffffffu, ssum, o);
  }
  if (lane == 0) {
    red[0][warp] = amax_a;
    red[1][warp] = amax_b;
    red[2][warp] = slo;
    red[3][warp] = ssum;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    for (int w = 0; w < BLOCK_PREP / 32; ++w) {
      v[0] = fmaxf(v[0], red[0][w]);
      v[1] = fmaxf(v[1], red[1][w]);
      v[2] += red[2][w];
      v[3] += red[3][w];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) fin[i] = v[i];
  }
  __syncthreads();
  const float s_a = fmaxf(fin[0], 1e-8f) / 127.0f;
  const float s_b = fmaxf(fin[1], 1e-8f) / 127.0f;
  const size_t o0 = m * (K / 2) + (size_t)g * gs2;
  for (int j = threadIdx.x; j < gs2; j += BLOCK_PREP) {
    const float lo = prep_value<InT, GLU>(x, m, K, c0 + j, act);
    const float hi = prep_value<InT, GLU>(x, m, K, c0 + gs2 + j, act);
    qa[o0 + j] =
        (int8_t)fminf(fmaxf(rintf((lo - hi / 16.0f) / s_a), -127.f), 127.f);
    qb[o0 + j] = (int8_t)fminf(fmaxf(rintf((hi / 16.0f) / s_b), -127.f),
                               127.f);
  }
  if (threadIdx.x == 0) {
    const size_t si = m * ng + g;
    sa[si] = s_a;
    sb[si] = s_b;
    t[si] = 8.0f * fin[2];
    if (xs) xs[si] = fin[3];
  }
}

// The block prep over M rows (grid: one block a (row, group)).
template <typename InT, bool GLU>
cudaError_t launch_prep_block(const InT* x, int M, int K, int gs, int act,
                              int8_t* qa, int8_t* qb, float* sa, float* sb,
                              float* t, float* xs, cudaStream_t stream) {
  const long long units = (long long)M * (K / gs);
  if (units <= 0) return cudaSuccess;
  if (units > 0x7fffffffLL || K % gs || gs % 2) return cudaErrorInvalidValue;
  w4a8_prep_block_kernel<InT, GLU><<<(unsigned)units, BLOCK_PREP, 0,
                                     stream>>>(x, K, gs, act, qa, qb, sa, sb,
                                               t, xs);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch_rows(const W4A8Args& a, int ntiles, int mr, OutT* out,
                        cudaStream_t stream) {
  dim3 grid((a.N + BN - 1) / BN, ntiles);
  dim3 block(32, KW);
  switch (mr) {
    case 1: w4a8_rows_kernel<1, OutT><<<grid, block, 0, stream>>>(a, out); break;
    case 4: w4a8_rows_kernel<4, OutT><<<grid, block, 0, stream>>>(a, out); break;
    case 8: w4a8_rows_kernel<8, OutT><<<grid, block, 0, stream>>>(a, out); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace kt
