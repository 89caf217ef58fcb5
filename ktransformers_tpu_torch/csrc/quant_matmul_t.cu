// Transposed matmul with the weight decoded inside the kernel: the input
// gradient dx = dy @ W^T of y = x @ W, for a packed [K, N] weight of the
// kinds of quant_matmul.cu (int8, fp8, int4 / int4_g / int4_gz also in the
// offset-lo encoding, mxfp4, mxfp8). The base weights of LoRA SFT are
// frozen, so this is the only gradient their matmuls need.
//
// Replaces ktransformers_tpu/ops/pallas/quant_matmul_t.py:quant_matmul_t
// (dense) and :grouped_quant_matmul_t (per-row experts). Like
// quant_matmul.cu, each kernel serves every entry over a row-tile map
// (tile_expert, tile_row0, tile_rows: up to BM rows of one expert, built on
// the device by the Python wrappers; rows = 0 is a dead tile): consecutive
// rows of one weight (dense), one row a tile (gathered), or rows sorted by
// expert (grouped).
//
// Arithmetic, as the Pallas bodies have it (f32 accumulation, dx f32):
//   int8 / fp8:  dx[m, k] = sum_n bf16(dy[m, n] * s[n]) * code[k, n]
//   the others:  dx[m, k] = sum_n bf16(dy[m, n]) * bf16(w[k, n])
//     int4 kinds: w = (code - zero[g, n]) * scale[g, n]
//     mxfp4 / mxfp8: w = e2m1 / e4m3(code) * 2^(e[g, n] - 127)
// Both operands are bf16 values (int8 and e4m3 codes are exact in bf16), so
// the products run on the tensor cores (bf16 in, f32 accumulate) with the
// Pallas kernel's roundings. N is the contraction
// axis: columns past N are stored as zeros in both staged tiles, so nothing
// past the end is read (the JAX package zero-pads to its block width
// instead, _pad_n). Nibble kinds keep row g*G + r of group g in the low
// nibble of storage row g*G/2 + r and row g*G + G/2 + r in the high nibble;
// a block decodes both halves of its storage rows and writes each to its
// column of dx (the JAX package's merge_int4_halves is only that layout).
//
// Two kernels; the wrappers (ops/cuda/quant_matmul_t.py:route) pick one by
// a fixed rule.
//
// quant_wgmma_t_kernel, every call whose shapes it takes (N a multiple of
// 16). Bound: operations at the SFT step's dense shapes (2 M N K at the
// bf16 tensor rate), the weight bytes at the grouped ones. A block owns a
// tile of BM = 128 dy rows (dense calls of more than 64 rows) or 64, and BV
// = 256 or 128 dx columns, and walks its split of the contraction N in
// 64-column stages: every thread copies (cp.async, tracked by an mbarrier a
// slot) the stage's raw weight bytes, scale rows and dy rows (bf16 dy
// straight into the 128-byte-swizzled tile the wgmma reads), then decodes
// the weight into a swizzled bf16 tile; each warpgroup multiplies its 64 dy
// rows with it (wgmma m64nBVk16, both operands K-major in shared memory,
// f32 accumulators in registers). The contraction is split where that
// shortens the launch (quant_matmul_t.py:t_plan); the splits meet in the
// same launch through f32 partials and a per-(column block, tile) counter,
// summed in split order by the last block. (The KT_T_CUT_* switches compile
// parts out for ops/cuda/breakdown.py.)
//
// quant_rows_t_kernel, the first version (shapes the wgmma kernel refuses,
// and a measurement hook): a block owns BM = 64 rows of dy and BV = 64
// columns of dx and walks all of N in stages of NC = 64 columns: the
// threads load the stage's dy rows (rounded to bf16, times the scale for
// int8 / fp8) and weight bytes (decoded to bf16) into shared memory while
// the next stage's raw bytes are on their way to registers; eight warps
// (4 x 2) multiply the two tiles with ldmatrix + mma.sync.
//
// Both dy rows and weight rows are contiguous along N, so every global load
// is coalesced.
//
// Plain C interface, built with nvcc and loaded through ctypes
// (ops/cuda/_build.py). Returns the cudaError_t of the launch.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int BM = 64;          // dy rows per tile
constexpr int BV = 64;          // dx columns per block
constexpr int NC = 64;          // contraction columns per stage
constexpr int LDS = NC + 8;     // shared row stride in bf16 (144 bytes)
constexpr int THREADS = 256;
constexpr int WORDS = NC / 4;   // 4-byte words of a stage's row

enum Kind { K_INT8 = 0, K_FP8 = 1, K_INT4 = 2, K_MXFP4 = 3, K_MXFP8 = 4 };

struct Args {
  const void* dy;           // [R, N] float or bf16
  const uint8_t* w;         // [E, KR, N] storage rows
  const void* s;            // [E, SG, N] float scales or uint8 exponents
  const float* z;           // [E, SG, N] zero points, or null
  const int* tile_expert;
  const int* tile_row0;
  const int* tile_rows;
  int K;     // columns of dx
  int KR;    // storage rows (K, or K/2 for nibble kinds)
  int N;
  int SG;    // rows of the scale tensor (>= the true group count)
  int rpg;   // storage rows per scale group
  int flip;  // int4: xor of the low nibble before the -8 (8, or 0 when
             // the data is in the offset-lo encoding)
};

template <int KIND>
struct Traits {
  static constexpr bool nibble = KIND == K_INT4 || KIND == K_MXFP4;
  static constexpr bool dy_scaled = KIND == K_INT8 || KIND == K_FP8;
  static constexpr int SR = nibble ? BV / 2 : BV;  // storage rows a block
  // 4-byte weight words a thread stages: SR rows x WORDS / THREADS
  static constexpr int WPT = SR * WORDS / THREADS;
};

// A small unsigned integer (< 2^23) as a float, exactly (no conversion
// instruction): placed in the mantissa of 2^23, 2^23 subtracted.
__device__ __forceinline__ float small_uint_to_float(uint32_t v) {
  return __uint_as_float(0x4B000000u | v) - 8388608.f;
}

// float8_e4m3fn: the fields placed at the top of a float's give value *
// 2^-120, exactly (subnormal codes give float subnormals); 0x7f / 0xff are
// NaN.
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

// ue8m0 exponent -> 2^(e - 127) from the float's bits.
__device__ __forceinline__ float ue8m0_to_float(uint32_t e) {
  return __uint_as_float(e << 23);
}

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

// 4 values rounded to bf16, stored as 8 bytes
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// The raw global bytes of one stage a thread stages: dy values of 4 rows
// (4 columns each) and weight words of WPT storage rows (4 columns each),
// with the scales (and zero points) they need. Thread t always covers
// the 4 columns n0 + 4 * (t % WORDS).
template <int KIND>
struct Raw {
  float dy[4][4];
  float ds[4];                        // int8 / fp8: the column scales
  uint32_t w[Traits<KIND>::WPT];
  float sc[Traits<KIND>::WPT][4];     // int4: scales; MX: decoded exponents
  float zp[Traits<KIND>::WPT][4];     // int4_gz: zero points
};

template <int KIND, typename DT>
__device__ __forceinline__ void load_stage(const Args& a, int e, int row0,
                                           int nrows, int r0, int n0,
                                           Raw<KIND>& raw) {
  using T = Traits<KIND>;
  const int t = threadIdx.x;
  const int n = n0 + 4 * (t % WORDS);
  const bool ncol = n < a.N;  // N % 4 == 0: the 4 columns are all in or out
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int m = t / WORDS + j * (THREADS / WORDS);
    if (ncol && m < nrows) {
      load4(static_cast<const DT*>(a.dy) + (size_t)(row0 + m) * a.N + n,
            raw.dy[j]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) raw.dy[j][c] = 0.f;
    }
  }
  if (T::dy_scaled) {
    if (ncol) {
      load4(static_cast<const float*>(a.s) + (size_t)e * a.SG * a.N + n,
            raw.ds);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) raw.ds[c] = 0.f;
    }
  }
#pragma unroll
  for (int j = 0; j < T::WPT; ++j) {
    const int r = r0 + t / WORDS + j * (THREADS / WORDS);
    const bool live = ncol && r < a.KR;
    raw.w[j] = live ? __ldg(reinterpret_cast<const uint32_t*>(
                          a.w + ((size_t)e * a.KR + r) * a.N + n))
                    : 0u;
    const size_t off = ((size_t)e * a.SG + (live ? r / a.rpg : 0)) * a.N + n;
    if (KIND == K_INT4) {
      if (live) {
        load4(static_cast<const float*>(a.s) + off, raw.sc[j]);
        if (a.z != nullptr) {
          load4(a.z + off, raw.zp[j]);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c) raw.zp[j][c] = 0.f;
        }
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) raw.sc[j][c] = raw.zp[j][c] = 0.f;
      }
    } else if (KIND == K_MXFP4 || KIND == K_MXFP8) {
      const uint32_t ex = live ? __ldg(reinterpret_cast<const uint32_t*>(
                                     static_cast<const uint8_t*>(a.s) + off))
                               : 0u;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        raw.sc[j][c] = ue8m0_to_float((ex >> (8 * c)) & 0xffu);
    }
  }
}

// Decode a stage into the shared tiles: As[m][n] = bf16 dy (times the
// column scale for int8 / fp8); Bs[v][n] = bf16 weight of dx column v of
// the block (nibble kinds: v < SR the low nibbles of storage row v, v >= SR
// the high ones).
template <int KIND>
__device__ __forceinline__ void store_stage(const Args& a,
                                            const Raw<KIND>& raw,
                                            __nv_bfloat16* As,
                                            __nv_bfloat16* Bs) {
  using T = Traits<KIND>;
  const int t = threadIdx.x;
  const int c4 = 4 * (t % WORDS);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int m = t / WORDS + j * (THREADS / WORDS);
    float v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      v[c] = T::dy_scaled ? raw.dy[j][c] * raw.ds[c] : raw.dy[j][c];
    store4(As + m * LDS + c4, v);
  }
#pragma unroll
  for (int j = 0; j < T::WPT; ++j) {
    const int sr = t / WORDS + j * (THREADS / WORDS);
    float lo[4], hi[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint32_t b = (raw.w[j] >> (8 * c)) & 0xffu;
      if (KIND == K_INT8) {
        lo[c] = (float)(int)(int8_t)b;
      } else if (KIND == K_FP8) {
        lo[c] = e4m3_to_float(b);
      } else if (KIND == K_MXFP8) {
        lo[c] = e4m3_to_float(b) * raw.sc[j][c];
      } else if (KIND == K_INT4) {
        const int l = (int)((b & 15u) ^ (uint32_t)a.flip) - 8;
        const int h = (int)(((b >> 4) & 15u) ^ 8u) - 8;
        lo[c] = ((float)l - raw.zp[j][c]) * raw.sc[j][c];
        hi[c] = ((float)h - raw.zp[j][c]) * raw.sc[j][c];
      } else {  // K_MXFP4
        lo[c] = e2m1_to_float(b & 15u) * raw.sc[j][c];
        hi[c] = e2m1_to_float((b >> 4) & 15u) * raw.sc[j][c];
      }
    }
    store4(Bs + sr * LDS + c4, lo);
    if (T::nibble) store4(Bs + (T::SR + sr) * LDS + c4, hi);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// dx rows of one tile for the block's BV columns.
// grid = (ceil(KR / SR), tiles), block = THREADS.
template <int KIND, typename DT>
__global__ void __launch_bounds__(THREADS)
    quant_rows_t_kernel(Args a, float* __restrict__ dx) {
  using T = Traits<KIND>;
  __shared__ __align__(16) __nv_bfloat16 As[BM * LDS];
  __shared__ __align__(16) __nv_bfloat16 Bs[BV * LDS];
  const int tile = blockIdx.y;
  const int nrows = a.tile_rows[tile];
  if (nrows <= 0) return;  // dead tile (block-uniform)
  const int row0 = a.tile_row0[tile];
  const int e = a.tile_expert[tile];
  const int r0 = blockIdx.x * T::SR;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 3, wv = warp >> 2;  // 16 rows x 32 columns a warp

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

  Raw<KIND> raw;
  load_stage<KIND, DT>(a, e, row0, nrows, r0, 0, raw);
  for (int n0 = 0; n0 < a.N; n0 += NC) {
    store_stage<KIND>(a, raw, As, Bs);
    __syncthreads();
    if (n0 + NC < a.N)  // the next stage's bytes travel during the products
      load_stage<KIND, DT>(a, e, row0, nrows, r0, n0 + NC, raw);
#pragma unroll
    for (int kk = 0; kk < NC; kk += 16) {
      uint32_t af[4];
      ldmatrix_x4(af, As + (wm * 16 + (lane & 15)) * LDS + kk +
                          (lane >> 4) * 8);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t bf[4];
        ldmatrix_x4(bf, Bs + (wv * 32 + p * 16 + (lane >> 4) * 8 +
                              (lane & 7)) * LDS +
                            kk + ((lane >> 3) & 1) * 8);
        mma_bf16(acc[2 * p], af, bf[0], bf[1]);
        mma_bf16(acc[2 * p + 1], af, bf[2], bf[3]);
      }
    }
    __syncthreads();
  }

  // acc[i][c]: row wm*16 + lane/4 (+8 for c >= 2), block column
  // wv*32 + i*8 + (lane%4)*2 + c%2
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int m = wm * 16 + (lane >> 2) + (c >> 1) * 8;
      const int v = wv * 32 + i * 8 + (lane & 3) * 2 + (c & 1);
      const int half = T::nibble && v >= T::SR;
      const int r = r0 + v - half * T::SR;
      if (m < nrows && r < a.KR) {
        int col = r;
        if (T::nibble) {
          const int g = r / a.rpg;
          col = g * 2 * a.rpg + (r - g * a.rpg) + half * a.rpg;
        }
        dx[(size_t)(row0 + m) * a.K + col] = acc[i][c];
      }
    }
}

template <int KIND, typename DT>
cudaError_t launch(const Args& a, int ntiles, float* dx, cudaStream_t st) {
  dim3 grid((a.KR + Traits<KIND>::SR - 1) / Traits<KIND>::SR, ntiles);
  quant_rows_t_kernel<KIND, DT><<<grid, THREADS, 0, st>>>(a, dx);
  return cudaGetLastError();
}

// ------------------------------------------------ wgmma kernel

namespace wg {

constexpr int NC = 64;        // contraction columns a stage (128-byte rows)
constexpr int THREADS = 256;  // two warpgroups
constexpr int GMAX = 9;       // scale groups a block's storage rows may span
constexpr int ROWB = NC * 2;  // bytes of a swizzled bf16 row
constexpr int B_RING = 3;     // decoded weight tiles

// A block owns BM dy rows x BV dx columns: 128 x 256 (one block an SM; dy
// is read once per 256 dx columns and the weight once per 128 rows) or 64 x
// 128 (two blocks an SM). Shared memory: a ring of RING slots of copied
// bytes (the dy tile in its swizzled bf16 place, the raw weight bytes, the
// stage's scale rows) and a ring of B_RING decoded weight tiles: 208-213 KB
// at 128 rows, at most 112 KB at 64.
template <int KIND, int BM>
struct Cfg {
  static constexpr int BV = BM == 128 ? 256 : 128;  // the wgmma's N
  static constexpr int ACC = BV / 2;  // accumulators a consumer thread
  static constexpr int SR = Traits<KIND>::nibble ? BV / 2 : BV;
  static constexpr int A_BYTES = BM * ROWB;      // dy tile, swizzled bf16
  static constexpr int B_BYTES = BV * ROWB;      // weight tile, swizzled bf16
  static constexpr int W_BYTES = SR * NC;        // raw weight bytes
  static constexpr int S_BYTES = GMAX * NC * 4;  // a stage's scale rows
  static constexpr int RAW =
      (A_BYTES + W_BYTES + 2 * S_BYTES + 1023) / 1024 * 1024;
  // copy slots: 4 where they fit (the W4A8 weights of the SFT step at 128
  // rows), else 3
  static constexpr int RING = BM == 128 && Traits<KIND>::nibble ? 4 : 3;
  static constexpr int SMEM = RING * RAW + B_RING * B_BYTES + 1024;
  static constexpr int CT = BM / 64 * 128;        // consumer threads
};

// byte offset of 16-byte chunk c of row r in a swizzled tile
__device__ __forceinline__ int swz(int r, int c) {
  return r * ROWB + ((c ^ (r & 7)) << 4);
}

}  // namespace wg

// Issue the copies of stage `stage` (contraction columns stage * NC ..) into
// a copy slot, then arrive on the slot's barrier when they land: the raw
// weight bytes [SR][NC] (every thread), the dy tile straight into its
// swizzled bf16 place when dy is bf16 (warpgroup w copies rows 64w ..
// 64w + 63, the rows only its own wgmma reads), and the scale rows of the
// block's groups g0 .. g0 + ng - 1 for the stage's columns (int4: scales,
// then zero points; MX: exponents; int8 / fp8: the column scales of dy).
template <int KIND, int BM, typename DT>
__device__ __forceinline__ void wg_issue(const Args& a, int e, int row0,
                                         int nrows, int r0, int g0, int ng,
                                         int stage, uint8_t* slot,
                                         uint64_t* bar) {
  using C = wg::Cfg<KIND, BM>;
  const int t = threadIdx.x;
  const int n0 = stage * wg::NC;
  uint8_t* W = slot + C::A_BYTES;
  uint8_t* S = W + C::W_BYTES;
  for (int q = t; q < C::SR * 4; q += wg::THREADS) {
    const int row = q >> 2, c = q & 3;
    const int r = r0 + row, n = n0 + 16 * c;
    const bool ok = r < a.KR && n < a.N;
    kt_mma::cp_async16(
        W + row * wg::NC + 16 * c,
        ok ? a.w + ((size_t)e * a.KR + r) * a.N + n : a.w, ok);
  }
  if (sizeof(DT) == 2 && (t >> 7) < BM / 64) {
    const __nv_bfloat16* dy = static_cast<const __nv_bfloat16*>(a.dy);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = (t & 127) + 128 * i;
      const int row = 64 * (t >> 7) + (q >> 3), c = q & 7;
      const int n = n0 + 8 * c;
      const bool ok = row < nrows && n < a.N;
      kt_mma::cp_async16(slot + wg::swz(row, c),
                         ok ? dy + (size_t)(row0 + row) * a.N + n : dy, ok);
    }
  }
  if (Traits<KIND>::dy_scaled) {
    if (t < 16) {
      const int n = n0 + 4 * t;
      const bool ok = n < a.N;
      const float* s = static_cast<const float*>(a.s) + (size_t)e * a.SG * a.N;
      kt_mma::cp_async16(S + 16 * t, ok ? s + n : s, ok);
    }
  } else if (KIND == K_INT4) {
    for (int q = t; q < ng * 32; q += wg::THREADS) {
      const bool zero = q >= ng * 16;
      if (zero && a.z == nullptr) break;
      const int qq = zero ? q - ng * 16 : q;
      const int g = qq >> 4, c = qq & 15;
      const int n = n0 + 4 * c;
      const bool ok = n < a.N;
      const float* src = (zero ? a.z : static_cast<const float*>(a.s)) +
                         ((size_t)e * a.SG + g0 + g) * a.N;
      kt_mma::cp_async16(S + (zero ? C::S_BYTES : 0) + g * wg::NC * 4 + 16 * c,
                         ok ? src + n : src, ok);
    }
  } else {  // MX: one exponent byte a column
    if (t < ng * 4) {
      const int g = t >> 2, c = t & 3;
      const int n = n0 + 16 * c;
      const bool ok = n < a.N;
      const uint8_t* src = static_cast<const uint8_t*>(a.s) +
                           ((size_t)e * a.SG + g0 + g) * a.N;
      kt_mma::cp_async16(S + g * wg::NC + 16 * c, ok ? src + n : src, ok);
    }
  }
  kt_mma::cp_async_arrive(bar);
}

// 8 floats -> 8 bf16 in one 16-byte chunk
__device__ __forceinline__ uint4 pack8(const float v[8]) {
  uint4 o;
  uint32_t* u = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    u[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return o;
}

// Decode chunk q (16 raw bytes: storage row q / 4, contraction columns
// 16 (q % 4) ..) of a landed stage into B[v][n] (a tile of the decoded
// ring), the bf16 weight of dx column v of the block (nibble kinds: v < SR
// the low nibbles of storage row v, v >= SR the high ones), from the raw
// bytes and the stage's scale rows.
template <int KIND, int BM>
__device__ __forceinline__ void wg_decode_chunk(const Args& a, int r0, int g0,
                                                const uint8_t* slot,
                                                uint8_t* B, int q) {
  using C = wg::Cfg<KIND, BM>;
  using T = Traits<KIND>;
  const uint8_t* W = slot + C::A_BYTES;
  const uint8_t* S = W + C::W_BYTES;
  {
    const int row = q >> 2, c = q & 3;
    const int r = r0 + row;
    const uint4 raw = *reinterpret_cast<const uint4*>(W + row * wg::NC + 16 * c);
    const uint32_t wd[4] = {raw.x, raw.y, raw.z, raw.w};
    float lo[16], hi[16];
    if (r >= a.KR) {
#pragma unroll
      for (int j = 0; j < 16; ++j) lo[j] = hi[j] = 0.f;
    } else {
      const int g = r / a.rpg - g0;
      const float* fs = reinterpret_cast<const float*>(S) + g * wg::NC + 16 * c;
      const float* fz =
          reinterpret_cast<const float*>(S + C::S_BYTES) + g * wg::NC + 16 * c;
      const uint8_t* xs = S + g * wg::NC + 16 * c;
#if !KT_T_CUT_DECODE
      if (KIND == K_INT4 && a.z == nullptr) {
        // no zero points: (code - 8) * s as (2^23 + code) - (2^23 + 8),
        // exact, times s: two float operations a weight
        const uint32_t flip = (uint32_t)a.flip;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const uint32_t b = (wd[j >> 2] >> (8 * (j & 3))) & 0xffu;
          lo[j] = (__uint_as_float(0x4B000000u | ((b & 15u) ^ flip)) -
                   8388616.f) * fs[j];
          hi[j] = (__uint_as_float(0x4B000000u | (((b >> 4) & 15u) ^ 8u)) -
                   8388616.f) * fs[j];
        }
      } else
#endif
      {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const uint32_t b = (wd[j >> 2] >> (8 * (j & 3))) & 0xffu;
#if !KT_T_CUT_DECODE
        if (KIND == K_INT8) {
          lo[j] = small_uint_to_float(b ^ 0x80u) - 128.f;
        } else if (KIND == K_FP8) {
          lo[j] = e4m3_to_float(b);
        } else if (KIND == K_MXFP8) {
          lo[j] = e4m3_to_float(b) * ue8m0_to_float(xs[j]);
        } else if (KIND == K_INT4) {
          const float sc = fs[j], zp = a.z != nullptr ? fz[j] : 0.f;
          const float l =
              small_uint_to_float((b & 15u) ^ (uint32_t)a.flip) - 8.f;
          const float h = small_uint_to_float(((b >> 4) & 15u) ^ 8u) - 8.f;
          lo[j] = (l - zp) * sc;
          hi[j] = (h - zp) * sc;
        } else {  // K_MXFP4
          const float sc = ue8m0_to_float(xs[j]);
          lo[j] = e2m1_to_float(b & 15u) * sc;
          hi[j] = e2m1_to_float((b >> 4) & 15u) * sc;
        }
#else
        lo[j] = hi[j] = __uint_as_float(b << 20);
#endif
      }
      }
    }
    *reinterpret_cast<uint4*>(B + wg::swz(row, 2 * c)) = pack8(lo);
    *reinterpret_cast<uint4*>(B + wg::swz(row, 2 * c + 1)) = pack8(lo + 8);
    if (T::nibble) {
      *reinterpret_cast<uint4*>(B + wg::swz(C::SR + row, 2 * c)) = pack8(hi);
      *reinterpret_cast<uint4*>(B + wg::swz(C::SR + row, 2 * c + 1)) =
          pack8(hi + 8);
    }
  }
}

// The dy tile of a landed stage where dy is float32 or scaled (int8 / fp8:
// bf16(dy * s[n])), converted in its swizzled place by the warpgroup that
// owns its rows (bf16 dy of the other kinds is copied as it is).
template <int KIND, int BM, typename DT>
__device__ __forceinline__ void wg_convert_dy(const Args& a, int row0,
                                              int nrows, int stage,
                                              uint8_t* slot) {
  using C = wg::Cfg<KIND, BM>;
  using T = Traits<KIND>;
  const int t = threadIdx.x;
  const float* ds =
      reinterpret_cast<const float*>(slot + C::A_BYTES + C::W_BYTES);
  if ((sizeof(DT) == 4 || T::dy_scaled) && (t >> 7) < BM / 64) {
    const int n0 = stage * wg::NC;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = (t & 127) + 128 * i;
      const int row = 64 * (t >> 7) + (q >> 3), c = q & 7;
      float v[8];
      if (sizeof(DT) == 4) {
        const int n = n0 + 8 * c;
        if (row < nrows && n < a.N) {
          const float* p =
              static_cast<const float*>(a.dy) + (size_t)(row0 + row) * a.N + n;
          load4(p, v);
          load4(p + 4, v + 4);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] = 0.f;
        }
      } else {
        const uint4 u = *reinterpret_cast<const uint4*>(slot + wg::swz(row, c));
        const uint32_t h[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&h[j]));
          v[2 * j] = f.x;
          v[2 * j + 1] = f.y;
        }
      }
      if (T::dy_scaled) {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] *= ds[8 * c + j];
      }
      *reinterpret_cast<uint4*>(slot + wg::swz(row, c)) = pack8(v);
    }
  }
}

// dx rows of one tile (up to BM rows) for the block's BV columns, over split
// blockIdx.z of the contraction. grid = (ceil(KR / SR), tiles, splits),
// THREADS threads, SMEM bytes of dynamic shared memory.
//
// A ring of RING copy slots, each the raw weight bytes and scale rows of NC
// contraction columns and the dy tile (copied by cp.async straight into its
// swizzled bf16 place), and a ring of B_RING decoded weight tiles. Every
// thread copies, arrives on the slot's mbarrier when its copies land, and
// decodes; warpgroup w (w < BM / 64) then multiplies its 64 dy rows with the
// weight tile, four wgmma m64nBVk16 a stage, while the threads go on to the
// next stage. One __syncthreads a stage orders the decoded tile before the
// wgmmas; each warpgroup keeps one stage of wgmmas in flight, so a decoded
// tile is written again three stages after its wgmmas were issued (waited
// for a stage before), and a copy slot RING - 1 stages after (a warpgroup
// copies only the dy rows its own, waited-for wgmmas read).
//
// With one split the block stores dx; with more, each stores its f32
// accumulators to part (fragment order), and the last block of a (column
// block, tile) pair to finish (counter in cnt, zero between launches) adds
// the splits' partials in split order and stores dx.
template <int KIND, int BM, typename DT>
__global__ void __launch_bounds__(wg::THREADS, BM == 64 ? 2 : 1)
    quant_wgmma_t_kernel(Args a, int splits, float* __restrict__ part,
                         int* __restrict__ cnt, float* __restrict__ dx) {
  using C = wg::Cfg<KIND, BM>;
  using T = Traits<KIND>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[C::RING];
  __shared__ int last;
  const int tile = blockIdx.y;
  const int nrows = a.tile_rows[tile];
  if (nrows <= 0) return;  // dead tile (block-uniform)
  const int row0 = a.tile_row0[tile];
  const int e = a.tile_expert[tile];
  const int r0 = blockIdx.x * C::SR;
  const int g0 = r0 / a.rpg;
  const int ng = (min(r0 + C::SR, a.KR) - 1) / a.rpg - g0 + 1;
  const int nst_all = (a.N + wg::NC - 1) / wg::NC;
  const int sb = (int)((long long)nst_all * blockIdx.z / splits);
  const int nst = (int)((long long)nst_all * (blockIdx.z + 1) / splits) - sb;
  const int t = threadIdx.x;
  // warpgroup index, provably warp-uniform (a __shfl_sync result), so that
  // ptxas sees the wgmma branch as convergent and does not serialize it
  const int wgi = __shfl_sync(0xffffffffu, t >> 7, 0);
  const bool consumer = BM == 128 || wgi == 0;
  uint8_t* base = smem_raw + ((1024 - (kt_mma::smem_addr(smem_raw) & 1023)) &
                              1023);
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < C::RING; ++i) kt_mma::mbar_init(&full[i], wg::THREADS);
    kt_mma::mbar_fence_init();
  }
  __syncthreads();

  float acc[C::ACC];
#pragma unroll
  for (int i = 0; i < C::ACC; ++i) acc[i] = 0.f;

  uint8_t* bring = base + C::RING * C::RAW;  // the decoded tiles
#pragma unroll
  for (int st = 0; st < C::RING - 1; ++st)
    if (st < nst)
      wg_issue<KIND, BM, DT>(a, e, row0, nrows, r0, g0, ng, sb + st,
                             base + st * C::RAW, &full[st]);
  for (int st = 0; st < nst; ++st) {
    const int k = st % C::RING;
    uint8_t* slot = base + k * C::RAW;
    uint8_t* B = bring + (st % wg::B_RING) * C::B_BYTES;
    kt_mma::mbar_wait(&full[k], (st / C::RING) & 1);
    for (int q = t; q < C::SR * 4; q += wg::THREADS)
      wg_decode_chunk<KIND, BM>(a, r0, g0, slot, B, q);
    wg_convert_dy<KIND, BM, DT>(a, row0, nrows, sb + st, slot);
    kt_mma::fence_proxy_async();
    __syncthreads();
    if (consumer) {
      const uint64_t da = kt_mma::sw128_desc(slot + wgi * 64 * wg::ROWB);
      const uint64_t db = kt_mma::sw128_desc(B);
      kt_mma::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < wg::NC / 16; ++kk) {
#if !KT_T_CUT_WGMMA
        kt_mma::wgmma_bf16(acc, da + 2 * kk, db + 2 * kk);
#else
        acc[kk] += __uint_as_float((uint32_t)(da ^ db));
#endif
      }
      kt_mma::wgmma_commit();
      kt_mma::wgmma_wait<1>();
    }
    const int nx = st + C::RING - 1;  // into the slot stage st - 1 used
    if (nx < nst)
      wg_issue<KIND, BM, DT>(a, e, row0, nrows, r0, g0, ng, sb + nx,
                             base + (nx % C::RING) * C::RAW,
                             &full[nx % C::RING]);
  }
  if (consumer) {
    kt_mma::wgmma_wait<0>();
    kt_mma::fence_acc(acc);
  }

  // acc[4j + q]: row 64 wgi + 16 (warp % 4) + lane / 4 + 8 (q / 2), block
  // column 8 j + 2 (lane % 4) + q % 2
  const size_t pair = (size_t)tile * gridDim.x + blockIdx.x;
  if (splits > 1) {
#if !KT_T_CUT_REDUCE
    if (consumer) {
      float* p = part + (pair * splits + blockIdx.z) * C::ACC * C::CT;
#pragma unroll
      for (int i = 0; i < C::ACC; ++i) p[(size_t)i * C::CT + t] = acc[i];
      __threadfence();
    }
    __syncthreads();
    if (t == 0) last = atomicAdd(cnt + pair, 1) == splits - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    if (consumer) {
      // the partials in split order, a split's ACC loads in flight at once
      const float* p = part + pair * splits * C::ACC * C::CT + t;
#pragma unroll
      for (int i = 0; i < C::ACC; ++i) acc[i] = 0.f;
      for (int s = 0; s < splits; ++s) {
#pragma unroll
        for (int i = 0; i < C::ACC; ++i)
          acc[i] += __ldcg(p + ((size_t)s * C::ACC + i) * C::CT);
      }
    }
    if (t == 0) cnt[pair] = 0;  // ready for the next launch
#endif
  }
  if (!consumer) return;
  const int lane = t & 31, wq = (t >> 5) & 3;
#pragma unroll
  for (int i = 0; i < C::ACC; ++i) {
    const int m = 64 * wgi + 16 * wq + (lane >> 2) + 8 * ((i & 3) >> 1);
    const int v = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
    const int half = T::nibble && v >= C::SR;
    const int r = r0 + v - half * C::SR;
    if (m < nrows && r < a.KR) {
      int col = r;
      if (T::nibble) {
        const int g = r / a.rpg;
        col = g * 2 * a.rpg + (r - g * a.rpg) + half * a.rpg;
      }
      dx[(size_t)(row0 + m) * a.K + col] = acc[i];
    }
  }
}

template <int KIND, int BM, typename DT>
cudaError_t launch_wgmma(const Args& a, int ntiles, int splits, float* part,
                         int* cnt, float* dx, cudaStream_t st) {
  using C = wg::Cfg<KIND, BM>;
  static int ready_dev = -1;
  cudaError_t err = kt_mma::allow_smem(quant_wgmma_t_kernel<KIND, BM, DT>,
                                       C::SMEM, &ready_dev);
  if (err != cudaSuccess) return err;
  dim3 grid((a.KR + C::SR - 1) / C::SR, ntiles, splits);
  quant_wgmma_t_kernel<KIND, BM, DT>
      <<<grid, wg::THREADS, C::SMEM, st>>>(a, splits, part, cnt, dx);
  return cudaGetLastError();
}

template <int BM, typename DT>
cudaError_t wgmma_kind(const Args& a, int kind, int ntiles, int splits,
                       float* part, int* cnt, float* dx, cudaStream_t st) {
  switch (kind) {
    case K_INT8:
      return launch_wgmma<K_INT8, BM, DT>(a, ntiles, splits, part, cnt, dx, st);
    case K_FP8:
      return launch_wgmma<K_FP8, BM, DT>(a, ntiles, splits, part, cnt, dx, st);
    case K_INT4:
      return launch_wgmma<K_INT4, BM, DT>(a, ntiles, splits, part, cnt, dx, st);
    case K_MXFP4:
      return launch_wgmma<K_MXFP4, BM, DT>(a, ntiles, splits, part, cnt, dx,
                                          st);
    case K_MXFP8:
      return launch_wgmma<K_MXFP8, BM, DT>(a, ntiles, splits, part, cnt, dx,
                                          st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename DT>
cudaError_t launch_kind(const Args& a, int kind, int ntiles, float* dx,
                        cudaStream_t st) {
  switch (kind) {
    case K_INT8: return launch<K_INT8, DT>(a, ntiles, dx, st);
    case K_FP8: return launch<K_FP8, DT>(a, ntiles, dx, st);
    case K_INT4: return launch<K_INT4, DT>(a, ntiles, dx, st);
    case K_MXFP4: return launch<K_MXFP4, DT>(a, ntiles, dx, st);
    case K_MXFP8: return launch<K_MXFP8, DT>(a, ntiles, dx, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// kind: 0 int8, 1 fp8, 2 int4 / int4_g / int4_gz, 3 mxfp4, 4 mxfp8.
// A tile holds at most mr <= 64 rows. dy_bf16: dy is bfloat16 (1) or
// float32 (0); dx is float32 [R, K]. z may be null.
extern "C" int kt_quant_rows_t(const void* dy, const void* w, const void* s,
                               const void* z, const void* tile_expert,
                               const void* tile_row0, const void* tile_rows,
                               int ntiles, int mr, int kind, int k, int kr,
                               int n, int sg, int rpg, int flip, int dy_bf16,
                               void* dx, void* stream) {
  if (ntiles <= 0) return 0;
  if (n % 4 || rpg <= 0 || kr % rpg || mr < 1 || mr > BM || ntiles > 65535)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.dy = dy;
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
  a.flip = flip;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(dx);
  if (dy_bf16) return (int)launch_kind<__nv_bfloat16>(a, kind, ntiles, out, st);
  return (int)launch_kind<float>(a, kind, ntiles, out, st);
}

static bool aligned16(const void* p) {
  return ((uintptr_t)p & 15u) == 0;
}

// The wgmma kernel: the operands of kt_quant_rows_t, tiles of up to bm = 64
// or 128 rows (blocks of bv = 128 or 256 dx columns: sr = bv / 2 storage
// rows of a nibble kind, bv of the others), the contraction cut into
// `splits` runs of whole 64-column stages. part holds ceil(kr / sr) *
// ntiles * splits * bm * bv floats and cnt ceil(kr / sr) * ntiles ints, zero
// on entry and on return; both may be null with one split. Takes N a
// multiple of 16, a block's storage rows within GMAX scale groups, and
// 16-byte aligned operands.
extern "C" int kt_quant_wgmma_t(const void* dy, const void* w, const void* s,
                                const void* z, const void* tile_expert,
                                const void* tile_row0, const void* tile_rows,
                                int ntiles, int bm, int splits, int kind,
                                int k, int kr, int n, int sg, int rpg,
                                int flip, int dy_bf16, void* part, void* cnt,
                                void* dx, void* stream) {
  if (ntiles <= 0) return 0;
  const int bv = bm == 128 ? 256 : 128;
  const int sr = (kind == K_INT4 || kind == K_MXFP4) ? bv / 2 : bv;
  if (n % 16 || rpg <= 0 || kr % rpg || sr / rpg + 1 > wg::GMAX ||
      (bm != 64 && bm != 128) || splits < 1 ||
      splits > (n + wg::NC - 1) / wg::NC || splits > 65535 ||
      ntiles > 65535 || (splits > 1 && (part == nullptr || cnt == nullptr)) ||
      !aligned16(dy) || !aligned16(w) || !aligned16(s) ||
      (z != nullptr && !aligned16(z)))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.dy = dy;
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
  a.flip = flip;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  int* c = static_cast<int*>(cnt);
  float* out = static_cast<float*>(dx);
  if (dy_bf16)
    return (int)(bm == 128 ? wgmma_kind<128, __nv_bfloat16>(
                                 a, kind, ntiles, splits, p, c, out, st)
                           : wgmma_kind<64, __nv_bfloat16>(
                                 a, kind, ntiles, splits, p, c, out, st));
  return (int)(bm == 128
                   ? wgmma_kind<128, float>(a, kind, ntiles, splits, p, c, out,
                                            st)
                   : wgmma_kind<64, float>(a, kind, ntiles, splits, p, c, out,
                                           st));
}
