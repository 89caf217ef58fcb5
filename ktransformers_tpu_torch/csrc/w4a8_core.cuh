// W4A8 core shared by w4a8_matmul.cu and w4a8_ffn.cu.
//
// Weights are int4_g in the offset-lo encoding (quant/w4a8.py): each int8
// byte braw = 16*hi + (lo + 8), u = braw & 15. Activations come as per
// (row, scale group) int8 codes qa, qb with float scales sa, sb and the
// correction t = 8*sum(x_lo) (w4a8_prep). For output column n and group g:
//
//   val = (qa . u)*sa + (qb . braw)*sb - t;   y[n] += val * s[g, n]
//
// which is _w4a8_group_acc of ktransformers_tpu/ops/pallas/w4a8_matmul.py.
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
  const int8_t* w;    // [E, K2, N] offset-lo packed int4
  const float* s;     // [E, ng, N]
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
#pragma unroll
        for (int q = 0; q < NQ; ++q)
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            const float sc = se[(size_t)g * a.N + cols[q] + c];
            const float val = (float)pa[m][q * CPT + c] * sam +
                              (float)pb[m][q * CPT + c] * sbm - tm;
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

// Activation prep of quant/w4a8.py:w4a8_prep, one warp per (row, group):
// a = x_lo - x_hi/16 and b = x_hi/16 quantized to int8 on their own
// absmax/127 scales (round half to even), t = 8*sum(x_lo). Two passes over
// the group's gs elements (the second one hits L1).
template <typename InT>
__global__ void w4a8_prep_kernel(const InT* __restrict__ x, int M, int K,
                                 int gs, int8_t* __restrict__ qa,
                                 int8_t* __restrict__ qb,
                                 float* __restrict__ sa,
                                 float* __restrict__ sb,
                                 float* __restrict__ t) {
  const int ng = K / gs, gs2 = gs / 2;
  const int unit = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (unit >= M * ng) return;
  const int lane = threadIdx.x & 31;
  const int m = unit / ng, g = unit % ng;
  const InT* xr = x + (size_t)m * K + (size_t)g * gs;
  float amax_a = 0.f, amax_b = 0.f, slo = 0.f;
  for (int j = lane; j < gs2; j += 32) {
    const float lo = to_float(xr[j]), hi = to_float(xr[gs2 + j]);
    amax_a = fmaxf(amax_a, fabsf(lo - hi / 16.0f));
    amax_b = fmaxf(amax_b, fabsf(hi / 16.0f));
    slo += lo;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    amax_a = fmaxf(amax_a, __shfl_xor_sync(0xffffffffu, amax_a, o));
    amax_b = fmaxf(amax_b, __shfl_xor_sync(0xffffffffu, amax_b, o));
    slo += __shfl_xor_sync(0xffffffffu, slo, o);
  }
  const float s_a = fmaxf(amax_a, 1e-8f) / 127.0f;
  const float s_b = fmaxf(amax_b, 1e-8f) / 127.0f;
  const size_t o0 = (size_t)m * (K / 2) + (size_t)g * gs2;
  for (int j = lane; j < gs2; j += 32) {
    const float lo = to_float(xr[j]), hi = to_float(xr[gs2 + j]);
    qa[o0 + j] = (int8_t)fminf(fmaxf(rintf((lo - hi / 16.0f) / s_a), -127.f),
                               127.f);
    qb[o0 + j] = (int8_t)fminf(fmaxf(rintf((hi / 16.0f) / s_b), -127.f),
                               127.f);
  }
  if (lane == 0) {
    sa[(size_t)m * ng + g] = s_a;
    sb[(size_t)m * ng + g] = s_b;
    t[(size_t)m * ng + g] = 8.0f * slo;
  }
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
