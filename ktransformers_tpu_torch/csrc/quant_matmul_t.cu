// Transposed matmul with the weight decoded inside the kernel: the input
// gradient dx = dy @ W^T of y = x @ W, for a packed [K, N] weight of the
// kinds of quant_matmul.cu (int8, fp8, int4 / int4_g / int4_gz also in the
// offset-lo encoding, mxfp4, mxfp8). The base weights of LoRA SFT are
// frozen, so this is the only gradient their matmuls need.
//
// Replaces ktransformers_tpu/ops/pallas/quant_matmul_t.py:quant_matmul_t
// (dense) and :grouped_quant_matmul_t (per-row experts). Like
// quant_matmul.cu, one kernel serves every entry over a row-tile map
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
// the products run on the tensor cores (mma.sync m16n8k16, bf16 in, f32
// accumulate) with the Pallas kernel's roundings. N is the contraction
// axis: columns past N are stored as zeros in both staged tiles, so nothing
// past the end is read (the JAX package zero-pads to its block width
// instead, _pad_n). Nibble kinds keep row g*G + r of group g in the low
// nibble of storage row g*G/2 + r and row g*G + G/2 + r in the high nibble;
// a block decodes both halves of its storage rows and writes each to its
// column of dx (the JAX package's merge_int4_halves is only that layout).
//
// Design: a block owns BM rows of dy (one tile) and BV = 64 columns of dx
// (64 storage rows, or 32 of a nibble kind with both halves). It walks N in
// stages of NC = 64 columns: the threads load the stage's dy rows (rounded
// to bf16, times the scale for int8 / fp8) and weight bytes (decoded to
// bf16) into shared memory while the next stage's raw bytes are already on
// their way to registers; eight warps (4 x 2) then multiply the two tiles
// with ldmatrix + mma.sync, a warp's 16 x 32 corner of dx in registers.
// Both dy rows and weight rows are contiguous along N, so every global load
// is coalesced. Bound: operations at M = 512 (2 M N K at the bf16 tensor
// rate) and, for few rows, the weight bytes; the block re-decodes its
// weight rows once per tile of 64 dy rows. wgmma, TMA and split-N are later
// work.
//
// Plain C interface, built with nvcc and loaded through ctypes
// (ops/cuda/_build.py). Returns the cudaError_t of the launch.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// float8_e4m3fn via a half with the same fields (value / 2^8); 0x7f / 0xff
// are NaN.
__device__ __forceinline__ float e4m3_to_float(uint32_t b) {
  const unsigned short h =
      (unsigned short)(((b & 0x80u) << 8) | ((b & 0x7fu) << 7));
  const float v = __half2float(__ushort_as_half(h)) * 256.0f;
  return (b & 0x7fu) == 0x7fu ? __int_as_float(0x7fc00000) : v;
}

// e2m1 code [s e1 e0 m]: twice the magnitude is 0 1 2 3 4 6 8 12.
__device__ __forceinline__ float e2m1_to_float(uint32_t c) {
  const float mag = 0.5f * (float)((0xC8643210u >> ((c & 7u) * 4u)) & 15u);
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
