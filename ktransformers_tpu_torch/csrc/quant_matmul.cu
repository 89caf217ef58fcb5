// Matmul with the weight decoded inside the kernel: y = x @ W for int8,
// fp8 (e4m3fn), int4 / int4_g / int4_gz (group-split nibbles, optional zero
// points, optional offset-lo encoding), mxfp4 (e2m1 nibbles) and mxfp8
// (e4m3fn) weights, the last two with ue8m0 power-of-two scales per group.
//
// Replaces ktransformers_tpu/ops/pallas/quant_matmul.py:quant_matmul,
// :gathered_quant_matmul and :grouped_quant_matmul. The three differ only
// in which expert a row uses, so they share kernels over a row-tile map
// (tile_expert, tile_row0, tile_rows: up to MR rows of one expert, built on
// the device by the Python wrappers; a tile with rows = 0 is skipped).
//
// Arithmetic, as the Pallas bodies have it:
//   int8 / fp8:  y = (sum_k x[k] * code[k, n]) * scale[n]   (scale after)
//   the others:  w = decode(code[k, n]) rounded to x's dtype, y = sum x * w
//     int4 kinds: w = (code - zero[g, n]) * scale[g, n]
//     mxfp4:      w = e2m1(code) * 2^(e[g, n] - 127)
//     mxfp8:      w = e4m3(code) * 2^(e[g, n] - 127)
// with f32 accumulation and one cast to x's dtype at the end. Nibble kinds
// keep row g*G + r of group g in the low nibble of byte row g*G/2 + r and
// row g*G + G/2 + r in the high nibble, so the kernels read x at those two
// columns and need no split pass over the activations.
//
// Three kernels; the wrappers (ops/cuda/quant_matmul.py:route) pick one by
// a fixed rule:
//
// quant_gemv_kernel, one-row dense calls (single-user decode) and every
// gathered call (one row a tile): a split-K GEMV. Bound: the weight bytes of
// the experts the rows use, each read once. The first version ran
// ceil(N / 128) blocks a row, 16-29 on 132 SMs at DeepSeek-V2-Lite's
// decode widths, too few to pull the memory's rate. Here a block of 16 x 8
// threads owns 256 columns and one split of the storage rows: a thread
// loads 16 bytes (16 columns) of a storage row with neighbouring threads on
// neighbouring columns, eight rows at a time (int8 keeps the next eight in
// flight too), decodes in registers and accumulates 16 columns in f32; the
// 8 row lanes meet in shared memory; the splits (ops/cuda/quant_matmul.py:
// gemv_plan, about two blocks an SM) meet in the same launch through f32
// partials and a per-(column block, tile) counter, the last block summing
// them in split order, so the result is the same on every call. (The
// KT_GEMV_CUT_* switches compile parts out for ops/cuda/breakdown.py.)
//
// quant_rows_kernel, the first version: float32 activations of several
// rows (whose roundings bf16 tensor cores would change; tiles of MR = 8
// rows), shapes the other two refuse, and a measurement hook. A block is
// 32 x KW
// threads; threadIdx.x owns 4 adjacent output columns (one 4-byte load per
// storage row, 128 contiguous bytes a warp), threadIdx.y walks "units" of
// `unit` consecutive storage rows that share one scale row, four rows at a
// time, decoding in registers and accumulating with f32 FMAs; the KW
// partial sums meet in shared memory.
//
// quant_mma_kernel, bf16 activations of 2 rows or more on the dense and grouped
// entries (the crossover: on the H100 it beats the first version at every M
// measured from 2 on, even where most of its 64 tile rows are padding): a block
// owns a tile of BM = 64 rows of one expert and BN = 128 output columns (64
// where a grid of 128-column blocks would leave SMs idle, the wrapper's choice)
// and walks K in stages of 32 activation columns (32 storage rows, or 16 of a
// nibble kind with both halves), so a stage lies inside one scale group (the
// group's storage rows must be a multiple of 16 or 32: layer 0's down
// projection, group 96, has 48). A ring of STAGES = 4 stages of raw weight
// bytes, x rows and the group's scales is filled by cp.async three stages
// ahead; the threads decode a stage into a bf16 tile [32][BN] in shared memory,
// then eight warps (2 x 4, 32 x BN/4 outputs each) multiply it with the x tile
// on the tensor cores (ldmatrix, ldmatrix.trans, mma.sync m16n8k16 bf16 with
// f32 accumulators). Every operand is a bf16 value the Pallas body also forms
// (the int8 and e4m3 codes are exact in bf16), so only the order of the f32
// sums differs. Columns past N (N = 3648 is no multiple of 128) and rows past
// the tile are zero-filled by the copies and never stored. Bound: operations at
// the dense prefill shapes (2 M N K over the bf16 rate), the weight bytes of
// the experts used at the grouped shapes; each weight tile is read and decoded
// once per 64 rows.
//
// Plain C interface, built with nvcc and loaded through ctypes
// (ops/cuda/_build.py). Returns the cudaError_t of the launch.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int KW = 8;         // K-slices (warps along threadIdx.y)
constexpr int CPT = 4;        // output columns per thread
constexpr int BN = 32 * CPT;  // output columns per block

enum Kind { K_INT8 = 0, K_FP8 = 1, K_INT4 = 2, K_MXFP4 = 3, K_MXFP8 = 4 };

struct Args {
  const void* x;            // [R, K] float or bf16
  const uint8_t* w;         // [E, KR, N] storage rows
  const void* s;            // [E, SG, N] float scales or uint8 exponents
  const float* z;           // [E, SG, N] zero points, or null
  const int* tile_expert;
  const int* tile_row0;
  const int* tile_rows;
  int K;     // activation columns
  int KR;    // storage rows (K, or K/2 for nibble kinds)
  int N;
  int SG;    // rows of the scale tensor (>= the true group count)
  int rpg;   // storage rows per scale group
  int unit;  // storage rows per work unit; divides rpg, multiple of 4
  int flip;  // int4: xor of the low nibble before the -8 (8, or 0 when
             // the data is in the offset-lo encoding)
};

template <int KIND>
struct Traits {
  static constexpr bool nibble = KIND == K_INT4 || KIND == K_MXFP4;
  static constexpr bool post_scale = KIND == K_INT8 || KIND == K_FP8;
};

__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// four consecutive activations (16- / 8-byte aligned)
__device__ __forceinline__ void load4(const float* p, float o[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float o[4]) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}

// A small unsigned integer (< 2^23) as a float, exactly: placed in the
// mantissa of 2^23 and 2^23 subtracted (integer-to-float conversion runs at
// a quarter of the FMA rate).
__device__ __forceinline__ float small_uint_to_float(uint32_t v) {
  return __uint_as_float(0x4B000000u | v) - 8388608.f;
}

// float8_e4m3fn: the exponent and mantissa fields placed at the top of a
// float's give value * 2^-120 (a subnormal code gives a float subnormal, so
// the product is exact); 0x7f / 0xff are NaN.
__device__ __forceinline__ float e4m3_to_float(uint32_t b) {
  const float v =
      __uint_as_float(((b & 0x80u) << 24) | ((b & 0x7fu) << 20)) * 0x1p120f;
  return (b & 0x7fu) == 0x7fu ? __int_as_float(0x7fc00000) : v;
}

// e2m1 code [s e1 e0 m]: twice the magnitude is 0 1 2 3 4 6 8 12.
__device__ __forceinline__ float e2m1_to_float(uint32_t c) {
  const float mag =
      0.5f * small_uint_to_float((0xC8643210u >> ((c & 7u) * 4u)) & 15u);
  return (c & 8u) ? -mag : mag;
}

// ue8m0 exponent -> 2^(e - 127) from the float's bits: exact for 1..254,
// 0 for e = 0, inf for 255.
__device__ __forceinline__ float ue8m0_to_float(uint32_t e) {
  return __uint_as_float(e << 23);
}

// Scale (and zero point) of group g for this thread's 4 columns.
template <int KIND>
__device__ __forceinline__ void load_scale(const Args& a, int e, int g,
                                           int col, float sc[CPT],
                                           float zp[CPT]) {
  const size_t off = ((size_t)e * a.SG + g) * a.N + col;
  if (KIND == K_INT4) {
    const float4 v =
        __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(a.s) + off));
    sc[0] = v.x; sc[1] = v.y; sc[2] = v.z; sc[3] = v.w;
    if (a.z != nullptr) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(a.z + off));
      zp[0] = q.x; zp[1] = q.y; zp[2] = q.z; zp[3] = q.w;
    } else {
      zp[0] = zp[1] = zp[2] = zp[3] = 0.f;
    }
  } else if (KIND == K_MXFP4 || KIND == K_MXFP8) {
    const uint32_t v = __ldg(reinterpret_cast<const uint32_t*>(
        static_cast<const uint8_t*>(a.s) + off));
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      sc[c] = ue8m0_to_float((v >> (8 * c)) & 0xffu);
      zp[c] = 0.f;
    }
  } else {
#pragma unroll
    for (int c = 0; c < CPT; ++c) { sc[c] = 1.f; zp[c] = 0.f; }
  }
}

// One storage byte -> the weight(s) it holds, in x's dtype precision.
// Byte kinds give lo only; nibble kinds give lo (low nibble) and hi.
template <int KIND, typename XT>
__device__ __forceinline__ void decode(uint32_t b, float sc, float zp,
                                       int flip, float& lo, float& hi) {
  if (KIND == K_INT8) {
    lo = (float)(int)(int8_t)b;
  } else if (KIND == K_FP8) {
    lo = e4m3_to_float(b);
  } else if (KIND == K_MXFP8) {
    lo = round_to(e4m3_to_float(b) * sc, XT());
  } else if (KIND == K_INT4) {
    const float l = small_uint_to_float((b & 15u) ^ (uint32_t)flip) - 8.f;
    const float h = small_uint_to_float(((b >> 4) & 15u) ^ 8u) - 8.f;
    lo = round_to((l - zp) * sc, XT());
    hi = round_to((h - zp) * sc, XT());
  } else {  // K_MXFP4
    lo = round_to(e2m1_to_float(b & 15u) * sc, XT());
    hi = round_to(e2m1_to_float((b >> 4) & 15u) * sc, XT());
  }
}

// y[row, n] for the tile's rows and this block's BN columns.
// grid = (ceil(N / BN), tiles).
template <int KIND, int MR, typename XT>
__global__ void __launch_bounds__(32 * KW)
    quant_rows_kernel(Args a, XT* __restrict__ out) {
  __shared__ float red[KW][MR][BN];
  const int tile = blockIdx.y;
  const int nrows = a.tile_rows[tile];
  if (nrows <= 0) return;  // dead tile (block-uniform)
  const int row0 = a.tile_row0[tile];
  const int e = a.tile_expert[tile];
  const int col = blockIdx.x * BN + threadIdx.x * CPT;
  constexpr bool nibble = Traits<KIND>::nibble;

  float acc[MR][CPT];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[m][c] = 0.f;

  if (col < a.N) {
    const uint8_t* we = a.w + (size_t)e * a.KR * a.N + col;
    const XT* xb = static_cast<const XT*>(a.x) + (size_t)row0 * a.K;
    const int nunits = a.KR / a.unit;
    for (int u = threadIdx.y; u < nunits; u += KW) {
      const int r0 = u * a.unit;
      const int g = r0 / a.rpg;
      float sc[CPT], zp[CPT];
      load_scale<KIND>(a, e, g, col, sc, zp);
      // activation columns of storage row r0 (and of its high nibbles)
      const int xlo = nibble ? g * 2 * a.rpg + (r0 - g * a.rpg) : r0;
      const int xhi = xlo + a.rpg;
#pragma unroll 2
      for (int q = 0; q < a.unit; q += 4) {
        uint32_t wd[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wd[j] = __ldg(reinterpret_cast<const uint32_t*>(
              we + (size_t)(r0 + q + j) * a.N));
        float wl[4][CPT], wh[4][CPT];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < CPT; ++c)
            decode<KIND, XT>((wd[j] >> (8 * c)) & 0xffu, sc[c], zp[c],
                             a.flip, wl[j][c], wh[j][c]);
#pragma unroll
        for (int m = 0; m < MR; ++m) {
          if (m < nrows) {
            const XT* xr = xb + (size_t)m * a.K;
            float xv[4];
            load4(xr + xlo + q, xv);
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int c = 0; c < CPT; ++c)
                acc[m][c] = fmaf(xv[j], wl[j][c], acc[m][c]);
            if (nibble) {
              load4(xr + xhi + q, xv);
#pragma unroll
              for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int c = 0; c < CPT; ++c)
                  acc[m][c] = fmaf(xv[j], wh[j][c], acc[m][c]);
            }
          }
        }
      }
    }
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
      if (Traits<KIND>::post_scale)
        v *= static_cast<const float*>(a.s)[(size_t)e * a.SG * a.N + n];
      store_out(out + (size_t)(row0 + m) * a.N + n, v);
    }
  }
}

// ------------------------------------------------ one-row kernel (GEMV)

namespace gv {

constexpr int TX = 16;              // threads along the columns
constexpr int LANES = 8;            // row lanes (threadIdx.x / TX)
constexpr int THREADS = TX * LANES;
constexpr int CPT = 16;             // columns a thread: one 16-byte load a row
constexpr int BN = TX * CPT;        // 256 columns a block
constexpr int UNIT = 8;             // storage rows a step: 8 loads in flight

}  // namespace gv

// 16 scales (and zero points) of group g for columns col .. col + 15.
template <int KIND>
__device__ __forceinline__ void load_scale16(const Args& a, int e, int g,
                                             int col, float sc[gv::CPT],
                                             float zp[gv::CPT]) {
  const size_t off = ((size_t)e * a.SG + g) * a.N + col;
  if (KIND == K_INT4) {
    const float4* s4 =
        reinterpret_cast<const float4*>(static_cast<const float*>(a.s) + off);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 v = __ldg(s4 + q);
      sc[4 * q] = v.x; sc[4 * q + 1] = v.y;
      sc[4 * q + 2] = v.z; sc[4 * q + 3] = v.w;
      const float4 w =
          a.z != nullptr
              ? __ldg(reinterpret_cast<const float4*>(a.z + off) + q)
              : make_float4(0.f, 0.f, 0.f, 0.f);
      zp[4 * q] = w.x; zp[4 * q + 1] = w.y;
      zp[4 * q + 2] = w.z; zp[4 * q + 3] = w.w;
    }
  } else if (KIND == K_MXFP4 || KIND == K_MXFP8) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(
        static_cast<const uint8_t*>(a.s) + off));
    const uint32_t wd[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int c = 0; c < gv::CPT; ++c) {
      sc[c] = ue8m0_to_float((wd[c >> 2] >> (8 * (c & 3))) & 0xffu);
      zp[c] = 0.f;
    }
  } else {
#pragma unroll
    for (int c = 0; c < gv::CPT; ++c) { sc[c] = 1.f; zp[c] = 0.f; }
  }
}

// eight consecutive activations (16-byte aligned)
__device__ __forceinline__ void load8(const float* p, float o[8]) {
  load4(p, o);
  load4(p + 4, o + 4);
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float o[8]) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t wd[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&wd[q]));
    o[2 * q] = f.x;
    o[2 * q + 1] = f.y;
  }
}

// Byte c of a word of int8 codes as a float, exactly: the code + 128 is
// placed in the mantissa of 2^23 (one byte permute and one add, where a
// conversion instruction runs at a quarter of the FMA rate).
__device__ __forceinline__ float int8_byte(uint32_t biased, int c) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7440u + c)) -
         8388736.f;  // 2^23 + 128
}

// y[row, n] for one row (a tile of one row) and the block's BN columns,
// over split blockIdx.z of the storage rows. grid = (ceil(N / BN), tiles,
// splits), THREADS threads. A split covers granules [G s / S, G (s+1) / S)
// of `gran` units (UNIT storage rows each; a granule is a whole scale group
// where the wrapper found enough groups, else one unit), and each lane a
// contiguous run of its split's units, so a lane loads a group's scales
// once. With one split the block stores y; with more, each writes its f32
// partial sums to part[tile][split][N] and the last block of a (column
// block, tile) pair to finish, found with the pair's counter in cnt (zero
// between launches: that block sets it back), adds the partials in split
// order, scales (int8 / fp8), casts and stores: one launch, no atomics on
// data, the same bits on every call.
template <int KIND, typename XT>
__global__ void __launch_bounds__(gv::THREADS)
    quant_gemv_kernel(Args a, int splits, int gran, float* __restrict__ part,
                      int* __restrict__ cnt, XT* __restrict__ out) {
  constexpr int TX = gv::TX, LANES = gv::LANES, THREADS = gv::THREADS;
  constexpr int CPT = gv::CPT, BN = gv::BN, UNIT = gv::UNIT;
  constexpr bool nibble = Traits<KIND>::nibble;
  constexpr bool scaled_groups = KIND == K_INT4 || KIND == K_MXFP4 ||
                                 KIND == K_MXFP8;
  __shared__ __align__(16) float red[LANES][BN];
  __shared__ int last;
  const int tile = blockIdx.y;
  if (a.tile_rows[tile] <= 0) return;  // dead tile (block-uniform)
  const int row0 = a.tile_row0[tile];
  const int e = a.tile_expert[tile];
  const int tx = threadIdx.x % TX, ly = threadIdx.x / TX;
  const int col = blockIdx.x * BN + tx * CPT;
  const int s = blockIdx.z;
  const int ngran = a.KR / UNIT / gran;
  const int u0 = gran * (int)((long long)ngran * s / splits);
  const int u1 = gran * (int)((long long)ngran * (s + 1) / splits);
  const int l0 = u0 + (u1 - u0) * ly / LANES;
  const int l1 = u0 + (u1 - u0) * (ly + 1) / LANES;

  float acc[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) acc[c] = 0.f;

  if (col < a.N) {
    const uint8_t* we = a.w + (size_t)e * a.KR * a.N + col;
    const XT* xr = static_cast<const XT*>(a.x) + (size_t)row0 * a.K;
    float sc[CPT], zp[CPT];
    int gcur = -1;
    if (!scaled_groups) load_scale16<KIND>(a, e, 0, col, sc, zp);
    // int8 issues the next unit's loads before this unit's FMAs; the other
    // kinds, whose decode keeps the loads covered, spend no registers on it
    // (they lose occupancy, measured on the H100)
    constexpr bool prefetch = KIND == K_INT8;
    uint4 nx[UNIT];
    if (prefetch && l0 < l1) {
#pragma unroll
      for (int j = 0; j < UNIT; ++j)
        nx[j] = __ldg(reinterpret_cast<const uint4*>(
            we + (size_t)(l0 * UNIT + j) * a.N));
    }
    for (int u = l0; u < l1; ++u) {
      const int r0 = u * UNIT;
      const int g = r0 / a.rpg;
      uint4 wd[UNIT];
#pragma unroll
      for (int j = 0; j < UNIT; ++j)
        wd[j] = prefetch ? nx[j]
                         : __ldg(reinterpret_cast<const uint4*>(
                               we + (size_t)(r0 + j) * a.N));
      if (prefetch && u + 1 < l1) {
#pragma unroll
        for (int j = 0; j < UNIT; ++j)
          nx[j] = __ldg(reinterpret_cast<const uint4*>(
              we + (size_t)(r0 + UNIT + j) * a.N));
      }
      if (scaled_groups && g != gcur) {
        load_scale16<KIND>(a, e, g, col, sc, zp);
        gcur = g;
      }
      // activation columns of storage row r0 (and of its high nibbles)
      const int xlo = nibble ? g * 2 * a.rpg + (r0 - g * a.rpg) : r0;
      float xl[UNIT], xh[UNIT];
      load8(xr + xlo, xl);
      if (nibble) load8(xr + xlo + a.rpg, xh);
#pragma unroll
      for (int j = 0; j < UNIT; ++j) {
        const uint32_t w4[4] = {wd[j].x, wd[j].y, wd[j].z, wd[j].w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#if !KT_GEMV_CUT_DECODE
          if (KIND == K_INT8) {
            const uint32_t biased = w4[q] ^ 0x80808080u;
#pragma unroll
            for (int b = 0; b < 4; ++b)
              acc[4 * q + b] =
                  fmaf(xl[j], int8_byte(biased, b), acc[4 * q + b]);
          } else {
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              const int c = 4 * q + b;
              float lo, hi;
              decode<KIND, XT>((w4[q] >> (8 * b)) & 0xffu, sc[c], zp[c],
                               a.flip, lo, hi);
              acc[c] = fmaf(xl[j], lo, acc[c]);
              if (nibble) acc[c] = fmaf(xh[j], hi, acc[c]);
            }
          }
#else
          // the loads stay live; no decode, one add a word
          acc[4 * q] += __uint_as_float(w4[q] & 0x3fffffffu) * xl[j] +
                        (nibble ? xh[j] : 0.f);
#endif
        }
      }
    }
  }

#pragma unroll
  for (int q = 0; q < CPT / 4; ++q)
    reinterpret_cast<float4*>(&red[ly][tx * CPT])[q] =
        make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                    acc[4 * q + 3]);
  __syncthreads();
  const int n0 = blockIdx.x * BN;
  const float* ps = static_cast<const float*>(a.s) + (size_t)e * a.SG * a.N;
  float v[BN / THREADS];
#pragma unroll
  for (int i = 0; i < BN / THREADS; ++i) {
    const int cc = threadIdx.x + i * THREADS;
    v[i] = 0.f;
#pragma unroll
    for (int y = 0; y < LANES; ++y) v[i] += red[y][cc];
  }
  if (splits > 1) {
#if !KT_GEMV_CUT_REDUCE
    float* pt = part + ((size_t)tile * splits + s) * a.N;
#pragma unroll
    for (int i = 0; i < BN / THREADS; ++i) {
      const int n = n0 + threadIdx.x + i * THREADS;
      if (n < a.N) pt[n] = v[i];
    }
    __threadfence();
    __syncthreads();
    int* c = cnt + (size_t)tile * gridDim.x + blockIdx.x;
    if (threadIdx.x == 0) last = atomicAdd(c, 1) == splits - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    // the partials in split order, sixteen splits' loads in flight at once
    const float* p0 = part + (size_t)tile * splits * a.N;
#pragma unroll
    for (int i = 0; i < BN / THREADS; ++i) v[i] = 0.f;
    for (int q0 = 0; q0 < splits; q0 += 16) {
      float pv[BN / THREADS][16];
#pragma unroll
      for (int i = 0; i < BN / THREADS; ++i) {
        const int n = n0 + threadIdx.x + i * THREADS;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          pv[i][j] = n < a.N && q0 + j < splits
                         ? __ldcg(p0 + (size_t)(q0 + j) * a.N + n)
                         : 0.f;
      }
#pragma unroll
      for (int i = 0; i < BN / THREADS; ++i)
#pragma unroll
        for (int j = 0; j < 16; ++j) v[i] += pv[i][j];
    }
    if (threadIdx.x == 0) *c = 0;  // ready for the next launch
#endif
  }
#pragma unroll
  for (int i = 0; i < BN / THREADS; ++i) {
    const int n = n0 + threadIdx.x + i * THREADS;
    if (n < a.N)
      store_out(out + (size_t)row0 * a.N + n,
                Traits<KIND>::post_scale ? v[i] * ps[n] : v[i]);
  }
}

// ------------------------------------------------ tensor-core kernel

namespace tc {

constexpr int BM = 64;        // rows a tile
constexpr int BK = 32;        // activation columns a stage
constexpr int STAGES = 4;     // depth of the cp.async ring
constexpr int THREADS = 256;  // 8 warps: 2 along M x 4 along N
constexpr int LDX = BK + 8;   // x tile row stride in bf16 (80 bytes)
constexpr int X_BYTES = BM * LDX * 2;

// BN output columns a block: 128, or 64 where the 128-column grid leaves
// SMs idle (the wrapper picks; twice the blocks, two of them an SM)
template <int BN>
struct Cfg {
  static constexpr int LDB = BN + 8;     // decoded tile row stride in bf16
  static constexpr int W_BYTES = BK * BN;  // raw weight bytes a stage, max
  static constexpr int S_BYTES = BN * 4;   // one scale (or exponent) row
  static constexpr int STAGE = W_BYTES + X_BYTES + 2 * S_BYTES;
  static constexpr int SMEM = STAGES * STAGE + BK * LDB * 2;
  static constexpr int WN = BN / 4;      // columns a warp
  static constexpr int NT = WN / 8;      // n8 tiles a warp
};

template <int KIND>
struct Stage {
  // storage rows a stage: 32 activation columns either way
  static constexpr int SR = Traits<KIND>::nibble ? 16 : 32;
  // raw bytes a thread decodes: 32 x BN values over 256 threads
  template <int BN>
  static constexpr int VB = Traits<KIND>::nibble ? BN / 16 : BN / 8;
};

}  // namespace tc

// Issue the copies of stage st (storage rows st*SR ..) into a ring slot:
// the raw weight bytes [SR][BN], the x tile [BM][BK] (for a nibble kind
// the low-nibble columns, then the high-nibble ones) and the group's scale
// row (int4: scales, then zero points; MX: exponents).
template <int KIND, int BN>
__device__ __forceinline__ void mma_load_stage(const Args& a, int e, int row0,
                                               int nrows, int n0, int st,
                                               uint8_t* slot) {
  using C = tc::Cfg<BN>;
  constexpr bool nib = Traits<KIND>::nibble;
  constexpr int SR = tc::Stage<KIND>::SR;
  constexpr int CPR = BN / 16;  // 16-byte chunks of a weight row
  const int t = threadIdx.x;
  const int r0 = st * SR;
  const int g = r0 / a.rpg;
  if (t < SR * CPR) {
    const int row = t / CPR, c = t % CPR;
    const int n = n0 + c * 16;
    const bool ok = n < a.N;
    kt_mma::cp_async16(
        slot + row * BN + c * 16,
        a.w + ((size_t)e * a.KR + r0 + row) * a.N + (ok ? n : 0), ok);
  }
  {
    const int m = t >> 2, q = t & 3;
    int col = r0 + q * 8;
    if (nib) {
      const int xlo = g * 2 * a.rpg + (r0 - g * a.rpg);
      col = q < 2 ? xlo + q * 8 : xlo + a.rpg + (q - 2) * 8;
    }
    const bool ok = m < nrows;
    kt_mma::cp_async16(
        slot + C::W_BYTES + (m * tc::LDX + q * 8) * 2,
        static_cast<const __nv_bfloat16*>(a.x) +
            (size_t)(row0 + (ok ? m : 0)) * a.K + col,
        ok);
  }
  uint8_t* sdst = slot + C::W_BYTES + tc::X_BYTES;
  const size_t off = ((size_t)e * a.SG + g) * a.N;
  if (KIND == K_INT4) {
    constexpr int Q = BN / 4;  // 16-byte chunks of a float row
    if (t < Q) {
      const int n = n0 + t * 4;
      const bool ok = n < a.N;
      kt_mma::cp_async16(sdst + t * 16,
                         static_cast<const float*>(a.s) + off + (ok ? n : 0),
                         ok);
    } else if (t < 2 * Q && a.z != nullptr) {
      const int n = n0 + (t - Q) * 4;
      const bool ok = n < a.N;
      kt_mma::cp_async16(sdst + C::S_BYTES + (t - Q) * 16,
                         a.z + off + (ok ? n : 0), ok);
    }
  } else if (KIND == K_MXFP4 || KIND == K_MXFP8) {
    if (t < CPR) {
      const int n = n0 + t * 16;
      const bool ok = n < a.N;
      kt_mma::cp_async16(
          sdst + t * 16,
          static_cast<const uint8_t*>(a.s) + off + (ok ? n : 0), ok);
    }
  }
}

// Decode a landed stage into Bs [BK][LDB] bf16: row k of Bs is
// activation column k of the stage (nibble kinds: rows 0-15 the low
// nibbles of the 16 storage rows, rows 16-31 the high ones). A thread
// decodes VB consecutive raw bytes of one row.
template <int KIND, int BN>
__device__ __forceinline__ void mma_decode_stage(const Args& a,
                                                 const uint8_t* slot,
                                                 __nv_bfloat16* Bs) {
  using C = tc::Cfg<BN>;
  constexpr int VB = tc::Stage<KIND>::template VB<BN>;
  constexpr int TPR = BN / VB;  // threads a raw row
  const int t = threadIdx.x;
  const int row = t / TPR, c = (t % TPR) * VB;
  const uint8_t* sm = slot + C::W_BYTES + tc::X_BYTES;
  uint32_t wd[VB / 4];
#pragma unroll
  for (int j = 0; j < VB / 4; ++j)
    wd[j] = *reinterpret_cast<const uint32_t*>(slot + row * BN + c + 4 * j);
  if (!Traits<KIND>::nibble) {
    uint32_t ed[VB / 4];
#pragma unroll
    for (int j = 0; j < VB / 4; ++j)
      ed[j] = KIND == K_MXFP8
                  ? *reinterpret_cast<const uint32_t*>(sm + c + 4 * j)
                  : 0u;
    __align__(16) __nv_bfloat16 o[VB];
#pragma unroll
    for (int j = 0; j < VB; ++j) {
      const uint32_t b = (wd[j >> 2] >> (8 * (j & 3))) & 0xffu;
      const uint32_t ex = (ed[j >> 2] >> (8 * (j & 3))) & 0xffu;
      const float sc = KIND == K_MXFP8 ? ue8m0_to_float(ex) : 1.f;
      float lo, hi;
      decode<KIND, __nv_bfloat16>(b, sc, 0.f, a.flip, lo, hi);
      o[j] = __float2bfloat16(lo);
    }
#pragma unroll
    for (int j = 0; j < VB / 8; ++j)
      reinterpret_cast<uint4*>(Bs + row * C::LDB + c)[j] =
          reinterpret_cast<const uint4*>(o)[j];
  } else {
    float sc[VB], zp[VB];
    if (KIND == K_INT4) {
      const float* fs = reinterpret_cast<const float*>(sm) + c;
#pragma unroll
      for (int j = 0; j < VB; ++j) {
        sc[j] = fs[j];
        zp[j] = a.z != nullptr ? fs[BN + j] : 0.f;
      }
    } else {
#pragma unroll
      for (int j = 0; j < VB; ++j) {
        sc[j] = ue8m0_to_float(sm[c + j]);
        zp[j] = 0.f;
      }
    }
    __align__(16) __nv_bfloat16 lo8[VB], hi8[VB];
#pragma unroll
    for (int j = 0; j < VB; ++j) {
      const uint32_t b = (wd[j >> 2] >> (8 * (j & 3))) & 0xffu;
      float lo, hi;
      decode<KIND, __nv_bfloat16>(b, sc[j], zp[j], a.flip, lo, hi);
      lo8[j] = __float2bfloat16(lo);
      hi8[j] = __float2bfloat16(hi);
    }
    // VB bf16 = 2 VB bytes: 16 (BN 128) or 8 (BN 64)
#pragma unroll
    for (int j = 0; j < VB / 2; ++j) {
      reinterpret_cast<uint32_t*>(Bs + row * C::LDB + c)[j] =
          reinterpret_cast<const uint32_t*>(lo8)[j];
      reinterpret_cast<uint32_t*>(Bs + (16 + row) * C::LDB + c)[j] =
          reinterpret_cast<const uint32_t*>(hi8)[j];
    }
  }
}

// y[row, n] for a tile of up to BM rows of one expert and BN columns, x
// and y bf16. grid = (ceil(N / BN), tiles), THREADS threads, SMEM bytes.
template <int KIND, int BN>
__global__ void __launch_bounds__(tc::THREADS, 2)
    quant_mma_kernel(Args a, __nv_bfloat16* __restrict__ out) {
  using C = tc::Cfg<BN>;
  constexpr int NT = C::NT;
  extern __shared__ __align__(128) uint8_t smem[];
  const int tile = blockIdx.y;
  const int nrows = a.tile_rows[tile];
  if (nrows <= 0) return;  // dead tile (block-uniform)
  const int row0 = a.tile_row0[tile];
  const int e = a.tile_expert[tile];
  const int n0 = blockIdx.x * BN;
  const int nst = a.KR / tc::Stage<KIND>::SR;
  __nv_bfloat16* Bs =
      reinterpret_cast<__nv_bfloat16*>(smem + tc::STAGES * C::STAGE);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 1, wn = warp >> 1;  // a warp's 32 x WN outputs

  float acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

#pragma unroll
  for (int st = 0; st < tc::STAGES - 1; ++st) {
    if (st < nst)
      mma_load_stage<KIND, BN>(a, e, row0, nrows, n0, st,
                               smem + st * C::STAGE);
    kt_mma::cp_async_commit();
  }
  for (int st = 0; st < nst; ++st) {
    kt_mma::cp_async_wait<tc::STAGES - 2>();
    __syncthreads();  // stage st landed; stage st - 1 fully consumed
    const uint8_t* slot = smem + (st % tc::STAGES) * C::STAGE;
    const int nx = st + tc::STAGES - 1;  // into the slot stage st - 1 used
    if (nx < nst)
      mma_load_stage<KIND, BN>(a, e, row0, nrows, n0, nx,
                               smem + (nx % tc::STAGES) * C::STAGE);
    kt_mma::cp_async_commit();
    mma_decode_stage<KIND, BN>(a, slot, Bs);
    __syncthreads();
    const __nv_bfloat16* Xs =
        reinterpret_cast<const __nv_bfloat16*>(slot + C::W_BYTES);
#pragma unroll
    for (int kk = 0; kk < tc::BK; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        kt_mma::ldmatrix_x4(
            af[i], Xs + (wm * 32 + i * 16 + (lane & 15)) * tc::LDX + kk +
                       (lane >> 4) * 8);
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        uint32_t bf[4];
        kt_mma::ldmatrix_x4_trans(
            bf, Bs + (kk + (lane & 15)) * C::LDB + wn * C::WN + p * 16 +
                    (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          kt_mma::mma_bf16_16816(acc[i][2 * p], af[i], bf[0], bf[1]);
          kt_mma::mma_bf16_16816(acc[i][2 * p + 1], af[i], bf[2], bf[3]);
        }
      }
    }
  }

  // acc[i][j][c]: row wm*32 + i*16 + lane/4 (+8 for c >= 2), column
  // n0 + wn*WN + j*8 + (lane%4)*2 + c%2
  const float* ps = static_cast<const float*>(a.s) + (size_t)e * a.SG * a.N;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = n0 + wn * C::WN + j * 8 + (lane & 3) * 2;
    if (col >= a.N) continue;  // N % 16 == 0: both columns in or out
    float s0 = 1.f, s1 = 1.f;
    if (Traits<KIND>::post_scale) {
      s0 = ps[col];
      s1 = ps[col + 1];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm * 32 + i * 16 + (lane >> 2) + h * 8;
        if (row < nrows)
          *reinterpret_cast<__nv_bfloat162*>(
              out + (size_t)(row0 + row) * a.N + col) =
              __floats2bfloat162_rn(acc[i][j][2 * h] * s0,
                                    acc[i][j][2 * h + 1] * s1);
      }
  }
}

template <int KIND, int BN>
cudaError_t launch_mma_bn(const Args& a, int ntiles, __nv_bfloat16* out,
                          cudaStream_t st) {
  static int ready_dev = -1;
  cudaError_t err = kt_mma::allow_smem(quant_mma_kernel<KIND, BN>,
                                       tc::Cfg<BN>::SMEM, &ready_dev);
  if (err != cudaSuccess) return err;
  dim3 grid((a.N + BN - 1) / BN, ntiles);
  quant_mma_kernel<KIND, BN>
      <<<grid, tc::THREADS, tc::Cfg<BN>::SMEM, st>>>(a, out);
  return cudaGetLastError();
}

template <int KIND>
cudaError_t launch_mma(const Args& a, int ntiles, int bn,
                       __nv_bfloat16* out, cudaStream_t st) {
  if (bn == 128) return launch_mma_bn<KIND, 128>(a, ntiles, out, st);
  if (bn == 64) return launch_mma_bn<KIND, 64>(a, ntiles, out, st);
  return cudaErrorInvalidValue;
}

template <int KIND, typename XT>
cudaError_t launch_mr(const Args& a, int ntiles, int mr, XT* out,
                      cudaStream_t st) {
  dim3 grid((a.N + BN - 1) / BN, ntiles);
  dim3 block(32, KW);
  if (mr == 1)
    quant_rows_kernel<KIND, 1, XT><<<grid, block, 0, st>>>(a, out);
  else if (mr == 8)
    quant_rows_kernel<KIND, 8, XT><<<grid, block, 0, st>>>(a, out);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

template <int KIND, typename XT>
cudaError_t launch_gemv(const Args& a, int ntiles, int splits, int gran,
                        float* part, int* cnt, XT* out, cudaStream_t st) {
  dim3 grid((a.N + gv::BN - 1) / gv::BN, ntiles, splits);
  quant_gemv_kernel<KIND, XT>
      <<<grid, gv::THREADS, 0, st>>>(a, splits, gran, part, cnt, out);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t gemv_kind(const Args& a, int kind, int ntiles, int splits,
                      int gran, float* part, int* cnt, XT* out,
                      cudaStream_t st) {
  switch (kind) {
    case K_INT8:
      return launch_gemv<K_INT8, XT>(a, ntiles, splits, gran, part, cnt, out,
                                     st);
    case K_FP8:
      return launch_gemv<K_FP8, XT>(a, ntiles, splits, gran, part, cnt, out,
                                    st);
    case K_INT4:
      return launch_gemv<K_INT4, XT>(a, ntiles, splits, gran, part, cnt, out,
                                     st);
    case K_MXFP4:
      return launch_gemv<K_MXFP4, XT>(a, ntiles, splits, gran, part, cnt,
                                      out, st);
    case K_MXFP8:
      return launch_gemv<K_MXFP8, XT>(a, ntiles, splits, gran, part, cnt,
                                      out, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename XT>
cudaError_t launch_kind(const Args& a, int kind, int ntiles, int mr, XT* out,
                        cudaStream_t st) {
  switch (kind) {
    case K_INT8: return launch_mr<K_INT8, XT>(a, ntiles, mr, out, st);
    case K_FP8: return launch_mr<K_FP8, XT>(a, ntiles, mr, out, st);
    case K_INT4: return launch_mr<K_INT4, XT>(a, ntiles, mr, out, st);
    case K_MXFP4: return launch_mr<K_MXFP4, XT>(a, ntiles, mr, out, st);
    case K_MXFP8: return launch_mr<K_MXFP8, XT>(a, ntiles, mr, out, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// kind: 0 int8, 1 fp8, 2 int4 / int4_g / int4_gz, 3 mxfp4, 4 mxfp8.
// x_bf16: x and out are bfloat16 (1) or float32 (0). z may be null.
extern "C" int kt_quant_rows(const void* x, const void* w, const void* s,
                             const void* z, const void* tile_expert,
                             const void* tile_row0, const void* tile_rows,
                             int ntiles, int mr, int kind, int k, int kr,
                             int n, int sg, int rpg, int unit, int flip,
                             int x_bf16, void* out, void* stream) {
  if (ntiles <= 0) return 0;
  if (n % CPT || k % 4 || unit <= 0 || unit % 4 || rpg % unit || kr % rpg)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x;
  a.w = static_cast<const uint8_t*>(w);
  a.s = s;
  a.z = static_cast<const float*>(z);
  a.tile_expert = static_cast<const int*>(tile_expert);
  a.tile_row0 = static_cast<const int*>(tile_row0);
  a.tile_rows = static_cast<const int*>(tile_rows);
  a.K = k;
  a.KR = kr;
  a.N = n;
  a.SG = sg;
  a.rpg = rpg;
  a.unit = unit;
  a.flip = flip;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return (int)launch_kind(a, kind, ntiles, mr,
                            static_cast<__nv_bfloat16*>(out), st);
  return (int)launch_kind(a, kind, ntiles, mr, static_cast<float*>(out), st);
}

static bool aligned16(const void* p) {
  return ((uintptr_t)p & 15u) == 0;
}

// The tensor-core kernel (bf16 x and out): the same operands as
// kt_quant_rows, tiles of up to 64 rows, bn = 128 or 64 columns a block.
// Takes N a multiple of 16, K a multiple of 8, rpg a multiple of the
// stage's storage rows (16 for the nibble kinds, 32 otherwise) and 16-byte
// aligned operands.
extern "C" int kt_quant_mma(const void* x, const void* w, const void* s,
                            const void* z, const void* tile_expert,
                            const void* tile_row0, const void* tile_rows,
                            int ntiles, int bn, int kind, int k, int kr,
                            int n, int sg, int rpg, int flip, void* out,
                            void* stream) {
  if (ntiles <= 0) return 0;
  const int sr = (kind == K_INT4 || kind == K_MXFP4) ? 16 : 32;
  if (n % 16 || k % 8 || rpg <= 0 || rpg % sr || kr % rpg ||
      ntiles > 65535 || !aligned16(x) || !aligned16(w) || !aligned16(s) ||
      (z != nullptr && !aligned16(z)) || ((uintptr_t)out & 3u))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x;
  a.w = static_cast<const uint8_t*>(w);
  a.s = s;
  a.z = static_cast<const float*>(z);
  a.tile_expert = static_cast<const int*>(tile_expert);
  a.tile_row0 = static_cast<const int*>(tile_row0);
  a.tile_rows = static_cast<const int*>(tile_rows);
  a.K = k;
  a.KR = kr;
  a.N = n;
  a.SG = sg;
  a.rpg = rpg;
  a.unit = 0;
  a.flip = flip;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<__nv_bfloat16*>(out);
  switch (kind) {
    case K_INT8: return (int)launch_mma<K_INT8>(a, ntiles, bn, o, st);
    case K_FP8: return (int)launch_mma<K_FP8>(a, ntiles, bn, o, st);
    case K_INT4: return (int)launch_mma<K_INT4>(a, ntiles, bn, o, st);
    case K_MXFP4: return (int)launch_mma<K_MXFP4>(a, ntiles, bn, o, st);
    case K_MXFP8: return (int)launch_mma<K_MXFP8>(a, ntiles, bn, o, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The one-row kernel (GEMV): the operands of kt_quant_rows with tiles of one
// row, split over `splits` runs of the storage rows (granules of `gran`
// units of 8 rows). part holds splits * ntiles * n floats and cnt
// ceil(n / 256) * ntiles ints, zero on entry and on return; both may be null
// with one split. Takes N a multiple of 16, K of 8, rpg of 8 and 16-byte
// aligned operands.
extern "C" int kt_quant_gemv(const void* x, const void* w, const void* s,
                             const void* z, const void* tile_expert,
                             const void* tile_row0, const void* tile_rows,
                             int ntiles, int splits, int gran, int kind,
                             int k, int kr, int n, int sg, int rpg, int flip,
                             int x_bf16, void* part, void* cnt, void* out,
                             void* stream) {
  if (ntiles <= 0) return 0;
  if (n % 16 || k % 8 || rpg <= 0 || rpg % gv::UNIT || kr % rpg ||
      splits < 1 || splits > 65535 || gran < 1 || (kr / gv::UNIT) % gran ||
      splits > kr / gv::UNIT / gran || ntiles > 65535 ||
      (splits > 1 && (part == nullptr || cnt == nullptr)) || !aligned16(x) ||
      !aligned16(w) || !aligned16(s) || (z != nullptr && !aligned16(z)))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x;
  a.w = static_cast<const uint8_t*>(w);
  a.s = s;
  a.z = static_cast<const float*>(z);
  a.tile_expert = static_cast<const int*>(tile_expert);
  a.tile_row0 = static_cast<const int*>(tile_row0);
  a.tile_rows = static_cast<const int*>(tile_rows);
  a.K = k;
  a.KR = kr;
  a.N = n;
  a.SG = sg;
  a.rpg = rpg;
  a.unit = gv::UNIT;
  a.flip = flip;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  int* c = static_cast<int*>(cnt);
  if (x_bf16)
    return (int)gemv_kind(a, kind, ntiles, splits, gran, p, c,
                          static_cast<__nv_bfloat16*>(out), st);
  return (int)gemv_kind(a, kind, ntiles, splits, gran, p, c,
                        static_cast<float*>(out), st);
}
