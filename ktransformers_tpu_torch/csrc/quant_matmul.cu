// Matmul with the weight decoded inside the kernel: y = x @ W for int8,
// fp8 (e4m3fn), int4 / int4_g / int4_gz (group-split nibbles, optional zero
// points, optional offset-lo encoding), mxfp4 (e2m1 nibbles) and mxfp8
// (e4m3fn) weights, the last two with ue8m0 power-of-two scales per group.
//
// Replaces ktransformers_tpu/ops/pallas/quant_matmul.py:quant_matmul,
// :gathered_quant_matmul and :grouped_quant_matmul. The three differ only
// in which expert a row uses, so they share one kernel over a row-tile map
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
// row g*G + G/2 + r in the high nibble, so the kernel reads x at those two
// columns and needs no split pass over the activations.
//
// Bound at decode: the weight bytes (each read once). Design: a block is
// 32 x KW threads; threadIdx.x owns 4 adjacent output columns (one 4-byte
// load per storage row, 128 contiguous bytes a warp), threadIdx.y walks
// "units" of `unit` consecutive storage rows that share one scale row, four
// rows at a time, decoding in registers and accumulating with f32 FMAs; the
// KW partial sums meet in shared memory. Prefill tiles of MR = 8 rows
// re-read the weight block from L2. Tensor cores, TMA and split-K are later
// work.
//
// Plain C interface, built with nvcc and loaded through ctypes
// (ops/cuda/_build.py). Returns the cudaError_t of the launch.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// float8_e4m3fn: the same exponent and mantissa fields placed in a half
// give value / 2^8, subnormals included; 0x7f / 0xff are NaN.
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
    const int l = (int)((b & 15u) ^ (uint32_t)flip) - 8;
    const int h = (int)(((b >> 4) & 15u) ^ 8u) - 8;
    lo = round_to(((float)l - zp) * sc, XT());
    hi = round_to(((float)h - zp) * sc, XT());
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
