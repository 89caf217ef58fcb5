// W4A8 matmuls y = x @ W for offset-lo packed int4_g weights.
//
// Two entries over two kernels replace three functions of
// ktransformers_tpu/ops/pallas/w4a8_matmul.py; the wrapper's row-tile map
// and its route (ops/cuda/w4a8_matmul.py:route) are all that differ:
// - dense_w4a8_matmul (body _dense_w4a8_kernel): tiles of consecutive rows
//   of one 2-D weight;
// - gathered_w4a8_matmul (body _gather_w4a8_kernel): one tile per row, of
//   expert ids[r] of a 3-D weight (decode MoE);
// - grouped_w4a8_matmul (body _grouped_w4a8_kernel): tiles of rows of one
//   expert over rows sorted by expert (prefill MoE).
//
// kt_w4a8_rows runs w4a8_rows_kernel of w4a8_core.cuh, the first version:
// M = 1 (single-user decode) and the gathered entry (one row a tile). At
// decode it is bound by the weight bytes (K/2 * N int8 + the f32 group
// scales of the experts read): each weight byte read once, 128 contiguous
// bytes per warp per weight row, int8 dots on __dp4a.
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
