// Dense W4A8 matmul y = x @ W for offset-lo packed int4_g weights.
//
// Replaces ktransformers_tpu/ops/pallas/w4a8_matmul.py:dense_w4a8_matmul
// (body _dense_w4a8_kernel). At decode (M = 1) it is bound by the weight
// bytes (K/2 * N int8 + the f32 group scales): one tile of one row, each
// weight byte read once, 128 contiguous bytes per warp per weight row. At
// prefill the rows are cut into tiles of 8 that re-read the weight block
// from L2. The int8 dots use __dp4a; wgmma/TMA are later work.
//
// Plain C interface, built with nvcc and loaded through ctypes
// (ops/cuda/_build.py). Returns the cudaError_t of the launch.
#include "w4a8_core.cuh"

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
