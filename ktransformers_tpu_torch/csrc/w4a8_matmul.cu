// W4A8 matmuls y = x @ W for offset-lo packed int4_g weights.
//
// Three kernels replace three functions of
// ktransformers_tpu/ops/pallas/w4a8_matmul.py; the wrapper's row-tile map
// and its route (ops/cuda/w4a8_matmul.py:route) are all that differ:
// - dense_w4a8_matmul (body _dense_w4a8_kernel): tiles of consecutive rows
//   of one 2-D weight;
// - gathered_w4a8_matmul (body _gather_w4a8_kernel): row r through expert
//   ids[r] of a 3-D weight (decode MoE);
// - grouped_w4a8_matmul (body _grouped_w4a8_kernel): tiles of rows of one
//   expert over rows sorted by expert (prefill MoE).
//
// kt_w4a8_rows runs w4a8_rows_kernel of w4a8_core.cuh, the first version:
// now only for shapes the other two kernels refuse (and, through the
// wrapper's ``kernel`` argument, for a measurement). At decode it is bound
// by the weight bytes (K/2 * N int8 + the f32 group scales of the experts
// read): each weight byte read once a tile, 128 contiguous bytes per warp
// per weight row, int8 dots on __dp4a.
//
// kt_w4a8_gemv runs w4a8_gemv_kernel of w4a8_gemv.cuh: M = 1 (single-user
// decode) and the gathered entry, split-K over whole scale groups, tiles
// keyed by expert so that rows routed to one expert share its bytes (see
// its note). The FFN wrappers launch it for their one-row down.
//
// kt_w4a8_mma runs w4a8_mma_kernel of w4a8_mma.cuh on the dense and
// grouped entries from 2 rows on (the crossover: on the H100 it beats the
// first version at every M measured from 2 up) at group 128 or 96: tiles of
// 64 rows, a cp.async ring of four scale groups, s8 mma.sync; bound by
// operations at the dense prefill shapes and by the experts' weight bytes
// at the grouped ones (see its note).
//
// Plain C interface, built with nvcc and loaded through ctypes
// (ops/cuda/_build.py). Returns the cudaError_t of the launch.
#include "w4a8_core.cuh"
#include "w4a8_gemv.cuh"
#include "w4a8_mma.cuh"

// Activation prep for every W4A8 kernel (quant/w4a8.py:w4a8_prep, plain
// XLA in the JAX package): x [M, K] float32 (dtype 0) or bfloat16 (1) ->
// qa, qb int8 [M, K/2], sa, sb, t f32 [M, K/gs]. Bound by the bytes of x.
extern "C" int kt_w4a8_prep(const void* x, int m, int k, int gs, int dtype,
                            void* qa, void* qb, void* sa, void* sb, void* t,
                            void* stream) {
  const int units = m * (k / gs);
  const int warps = 8;
  dim3 grid((units + warps - 1) / warps);
  dim3 block(32 * warps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* a = static_cast<int8_t*>(qa);
  auto* b = static_cast<int8_t*>(qb);
  auto* fa = static_cast<float*>(sa);
  auto* fb = static_cast<float*>(sb);
  auto* ft = static_cast<float*>(t);
  if (dtype == 1)
    kt::w4a8_prep_kernel<<<grid, block, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), m, k, gs, a, b, fa, fb, ft);
  else
    kt::w4a8_prep_kernel<<<grid, block, 0, st>>>(
        static_cast<const float*>(x), m, k, gs, a, b, fa, fb, ft);
  return (int)cudaGetLastError();
}

extern "C" int kt_w4a8_rows(const void* qa, const void* qb, const void* sa,
                            const void* sb, const void* t, const void* w,
                            const void* s, const void* tile_expert,
                            const void* tile_row0, const void* tile_rows,
                            int ntiles, int mr, int k2, int n, int ng,
                            int gs2, int out_bf16, void* out, void* stream) {
  kt::W4A8Args a;
  a.qa = static_cast<const int8_t*>(qa);
  a.qb = static_cast<const int8_t*>(qb);
  a.sa = static_cast<const float*>(sa);
  a.sb = static_cast<const float*>(sb);
  a.t = static_cast<const float*>(t);
  a.w = static_cast<const int8_t*>(w);
  a.s = static_cast<const float*>(s);
  a.tile_expert = static_cast<const int*>(tile_expert);
  a.tile_row0 = static_cast<const int*>(tile_row0);
  a.tile_rows = static_cast<const int*>(tile_rows);
  a.K2 = k2;
  a.N = n;
  a.ng = ng;
  a.gs2 = gs2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    return (int)kt::launch_rows(a, ntiles, mr,
                                static_cast<__nv_bfloat16*>(out), st);
  return (int)kt::launch_rows(a, ntiles, mr, static_cast<float*>(out), st);
}

// The tensor-core kernel: the operands of kt_w4a8_rows, tiles of up to 64
// rows.
extern "C" int kt_w4a8_mma(const void* qa, const void* qb, const void* sa,
                           const void* sb, const void* t, const void* w,
                           const void* s, const void* tile_expert,
                           const void* tile_row0, const void* tile_rows,
                           int ntiles, int k2, int n, int ng, int gs2,
                           int out_bf16, void* out, void* stream) {
  if (ntiles <= 0) return 0;
  const uintptr_t align = (uintptr_t)qa | (uintptr_t)qb | (uintptr_t)w |
                          (uintptr_t)s | (uintptr_t)out;
  if (align & 15u || ((uintptr_t)sa | (uintptr_t)sb | (uintptr_t)t) & 3u)
    return (int)cudaErrorInvalidValue;
  kt::W4A8Args a;
  a.qa = static_cast<const int8_t*>(qa);
  a.qb = static_cast<const int8_t*>(qb);
  a.sa = static_cast<const float*>(sa);
  a.sb = static_cast<const float*>(sb);
  a.t = static_cast<const float*>(t);
  a.w = static_cast<const int8_t*>(w);
  a.s = static_cast<const float*>(s);
  a.tile_expert = static_cast<const int*>(tile_expert);
  a.tile_row0 = static_cast<const int*>(tile_row0);
  a.tile_rows = static_cast<const int*>(tile_rows);
  a.K2 = k2;
  a.N = n;
  a.ng = ng;
  a.gs2 = gs2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    return (int)kt::launch_mma(a, ntiles, static_cast<__nv_bfloat16*>(out),
                               st);
  return (int)kt::launch_mma(a, ntiles, static_cast<float*>(out), st);
}

// The split-K GEMV: row r of the activation codes through expert ids[r] of
// w [E, K2, N] for r < R (R <= 128; a dense call passes R = 1, ids = [0]),
// `tiles` tiles of up to rb rows of one expert (rb 1 or 2; tiles at least
// the number of (expert, chunk) pairs), `splits` runs of `gran` 8-row units
// (gran * 8 = gs2, one scale group). part holds R * splits * n floats and
// cnt ceil(n / 256) * tiles ints, zero on entry and on return; both may be
// null with one split. Takes N a multiple of 16, gs2 of 8, K2 of gs2,
// 16-byte aligned w, s and out, 8-byte aligned qa, qb.
extern "C" int kt_w4a8_gemv(const void* qa, const void* qb, const void* sa,
                            const void* sb, const void* t, const void* w,
                            const void* s, const void* ids, int r, int tiles,
                            int splits, int gran, int rb, int k2, int n,
                            int ng, int gs2, int out_bf16, void* part,
                            void* cnt, void* out, void* stream) {
  if (r <= 0) return 0;
  const uintptr_t a16 = (uintptr_t)w | (uintptr_t)s | (uintptr_t)out;
  const uintptr_t a8 = (uintptr_t)qa | (uintptr_t)qb;
  if (r > kt::w4gv::MAX_ROWS || tiles < 1 || tiles > 65535 || n % 16 ||
      gs2 <= 0 || gs2 % kt::w4gv::UNIT || k2 % gs2 || ng * gs2 != k2 ||
      gran < 1 || (k2 / kt::w4gv::UNIT) % gran || splits < 1 ||
      splits > 65535 || splits > k2 / kt::w4gv::UNIT / gran ||
      (splits > 1 && (part == nullptr || cnt == nullptr)) || (a16 & 15u) ||
      (a8 & 7u))
    return (int)cudaErrorInvalidValue;
  kt::W4A8Args a = {};
  a.qa = static_cast<const int8_t*>(qa);
  a.qb = static_cast<const int8_t*>(qb);
  a.sa = static_cast<const float*>(sa);
  a.sb = static_cast<const float*>(sb);
  a.t = static_cast<const float*>(t);
  a.w = static_cast<const int8_t*>(w);
  a.s = static_cast<const float*>(s);
  a.K2 = k2;
  a.N = n;
  a.ng = ng;
  a.gs2 = gs2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pid = static_cast<const int*>(ids);
  float* p = static_cast<float*>(part);
  int* c = static_cast<int*>(cnt);
  if (out_bf16)
    return (int)kt::launch_gemv(a, pid, r, tiles, splits, gran, rb, p, c,
                                static_cast<__nv_bfloat16*>(out), st);
  return (int)kt::launch_gemv(a, pid, r, tiles, splits, gran, rb, p, c,
                              static_cast<float*>(out), st);
}
