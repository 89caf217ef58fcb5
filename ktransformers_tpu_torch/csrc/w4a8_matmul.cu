// W4A8 matmuls y = x @ W for offset-lo packed int4, int4_g and int4_gz
// weights (the zero term of int4_gz and the groups each kernel takes:
// w4a8_core.cuh, w4a8_gemv.cuh, w4a8_mma.cuh).
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
// The GEMV always, and the tensor-core kernel below the wrapper's crossover
// (ops/cuda/w4a8_matmul.py:folds), fold the activation prep in: they take x
// (x_dtype 1 or 2) and quantize it themselves with w4a8_core.cuh's
// prep_group, the same bits kt_w4a8_prep writes; with x_dtype 0 they read
// the codes of a kt_w4a8_prep launch, as the first version always does.
//
// Plain C interface, built with nvcc and loaded through ctypes
// (ops/cuda/_build.py). Returns the cudaError_t of the launch.
#include "w4a8_core.cuh"
#include "w4a8_gemv.cuh"
#include "w4a8_mma.cuh"

// Activation prep for the W4A8 kernels that read codes (quant/w4a8.py:
// w4a8_prep, plain XLA in the JAX package): x [M, K] float32 (dtype 0) or
// bfloat16 (1) -> qa, qb int8 [M, K/2], sa, sb, t (and xs where not null)
// f32 [M, K/gs]: one warp a (row, group) up to a group of 512, one block a
// (row, group) past it (w4a8_prep_block_kernel: per-channel groups, all of
// K). Bound by the bytes of x.
template <typename InT>
static cudaError_t launch_prep(const InT* x, int m, int k, int gs, int8_t* a,
                               int8_t* b, float* fa, float* fb, float* ft,
                               float* fx, cudaStream_t st) {
  const int units = m * (k / gs);
  const int warps = 8;
  dim3 grid((units + warps - 1) / warps);
  dim3 block(32 * warps);
  const int j = (gs / 2 + 31) / 32;  // values a lane, per half group
  if (j <= 1)
    kt::w4a8_prep_kernel<1><<<grid, block, 0, st>>>(x, m, k, gs, a, b, fa,
                                                    fb, ft, fx);
  else if (j <= 2)
    kt::w4a8_prep_kernel<2><<<grid, block, 0, st>>>(x, m, k, gs, a, b, fa,
                                                    fb, ft, fx);
  else if (j <= 4)
    kt::w4a8_prep_kernel<4><<<grid, block, 0, st>>>(x, m, k, gs, a, b, fa,
                                                    fb, ft, fx);
  else if (j <= 8)
    kt::w4a8_prep_kernel<8><<<grid, block, 0, st>>>(x, m, k, gs, a, b, fa,
                                                    fb, ft, fx);
  else
    return kt::launch_prep_block<InT, false>(x, m, k, gs, 0, a, b, fa, fb,
                                             ft, fx, st);
  return cudaGetLastError();
}

extern "C" int kt_w4a8_prep(const void* x, int m, int k, int gs, int dtype,
                            void* qa, void* qb, void* sa, void* sb, void* t,
                            void* xs, void* stream) {
  if (m <= 0) return 0;
  if (gs <= 0 || gs % 2 || k % gs) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* a = static_cast<int8_t*>(qa);
  auto* b = static_cast<int8_t*>(qb);
  auto* fa = static_cast<float*>(sa);
  auto* fb = static_cast<float*>(sb);
  auto* ft = static_cast<float*>(t);
  auto* fx = static_cast<float*>(xs);
  if (dtype == 1)
    return (int)launch_prep(static_cast<const __nv_bfloat16*>(x), m, k, gs,
                            a, b, fa, fb, ft, fx, st);
  return (int)launch_prep(static_cast<const float*>(x), m, k, gs, a, b, fa,
                          fb, ft, fx, st);
}

extern "C" int kt_w4a8_rows(const void* qa, const void* qb, const void* sa,
                            const void* sb, const void* t, const void* w,
                            const void* s, const void* tile_expert,
                            const void* tile_row0, const void* tile_rows,
                            int ntiles, int mr, int k2, int n, int ng,
                            int gs2, int out_bf16, void* out, const void* xs,
                            const void* z, void* stream) {
  if (z != nullptr && xs == nullptr) return (int)cudaErrorInvalidValue;
  kt::W4A8Args a = {};
  a.qa = static_cast<const int8_t*>(qa);
  a.qb = static_cast<const int8_t*>(qb);
  a.sa = static_cast<const float*>(sa);
  a.sb = static_cast<const float*>(sb);
  a.t = static_cast<const float*>(t);
  a.xs = static_cast<const float*>(xs);
  a.w = static_cast<const int8_t*>(w);
  a.s = static_cast<const float*>(s);
  a.z = static_cast<const float*>(z);
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

// The activations of a launch: x_dtype 0 takes the codes of a prep launch
// (qa, qb, sa, sb, t, and xs where the weight has zero points z), 1 float32
// and 2 bfloat16 rows x [R, 2 K2] (the kernel folds the prep in; the output
// shares x's dtype).
enum { X_CODES = 0, X_F32 = 1, X_BF16 = 2 };

static kt::W4A8Args make_args(const void* qa, const void* qb, const void* sa,
                              const void* sb, const void* t, const void* xs,
                              const void* x, const void* w, const void* s,
                              const void* z, int k2, int n, int ng, int gs2) {
  kt::W4A8Args a = {};
  a.qa = static_cast<const int8_t*>(qa);
  a.qb = static_cast<const int8_t*>(qb);
  a.sa = static_cast<const float*>(sa);
  a.sb = static_cast<const float*>(sb);
  a.t = static_cast<const float*>(t);
  a.xs = static_cast<const float*>(xs);
  a.x = x;
  a.w = static_cast<const int8_t*>(w);
  a.s = static_cast<const float*>(s);
  a.z = static_cast<const float*>(z);
  a.K2 = k2;
  a.N = n;
  a.ng = ng;
  a.gs2 = gs2;
  return a;
}

// The tensor-core kernel: the operands of kt_w4a8_rows, tiles of up to 64
// rows; the activations as x_dtype says (a folded launch quantizes each
// tile into an A tile of arows rows: a multiple of 16, at least every
// tile's rows).
extern "C" int kt_w4a8_mma(const void* qa, const void* qb, const void* sa,
                           const void* sb, const void* t, const void* x,
                           int x_dtype, const void* w, const void* s,
                           const void* tile_expert, const void* tile_row0,
                           const void* tile_rows, int ntiles, int arows,
                           int k2, int n, int ng, int gs2, int out_bf16,
                           void* out, const void* xs, const void* z,
                           void* stream) {
  if (ntiles <= 0) return 0;
  const uintptr_t align =
      (uintptr_t)w | (uintptr_t)s | (uintptr_t)out | (uintptr_t)z;
  const uintptr_t codes = (uintptr_t)qa | (uintptr_t)qb;
  const uintptr_t scales =
      (uintptr_t)sa | (uintptr_t)sb | (uintptr_t)t | (uintptr_t)xs;
  if (align & 15u ||
      (x_dtype == X_CODES && (codes & 15u || scales & 3u ||
                              (z != nullptr && xs == nullptr))) ||
      (x_dtype == X_F32 && out_bf16) || (x_dtype == X_BF16 && !out_bf16) ||
      x_dtype < X_CODES || x_dtype > X_BF16)
    return (int)cudaErrorInvalidValue;
  kt::W4A8Args a =
      make_args(qa, qb, sa, sb, t, xs, x, w, s, z, k2, n, ng, gs2);
  a.tile_expert = static_cast<const int*>(tile_expert);
  a.tile_row0 = static_cast<const int*>(tile_row0);
  a.tile_rows = static_cast<const int*>(tile_rows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using B = __nv_bfloat16;
  if (x_dtype == X_BF16)
    return (int)kt::launch_mma<B>(a, ntiles, arows, static_cast<B*>(out), st);
  if (x_dtype == X_F32)
    return (int)kt::launch_mma<float>(a, ntiles, arows,
                                      static_cast<float*>(out), st);
  if (out_bf16)
    return (int)kt::launch_mma<int8_t>(a, ntiles, arows, static_cast<B*>(out),
                                       st);
  return (int)kt::launch_mma<int8_t>(a, ntiles, arows,
                                     static_cast<float*>(out), st);
}

// The split-K GEMV: row r of the activations through expert ids[r] of
// w [E, K2, N] for r < R (R <= 128; a dense call passes R = 1, ids = [0]),
// `tiles` tiles of up to rb rows of one expert (rb 1 or 2; tiles at least
// the number of (expert, chunk) pairs), `splits` runs of `gran` 8-row units
// (gran * 8 = gs2, one scale group). The activations as x_dtype says. part
// holds R * splits * n floats and cnt ceil(n / 256) * tiles ints, zero on
// entry and on return; both may be null with one split. Takes N a multiple
// of 16, gs2 of 8, K2 of gs2, 16-byte aligned w, s, z and out, 8-byte
// aligned qa, qb. A split may cut a per-channel group (ng = 1; gran then
// counts units, and x_dtype is 0).
extern "C" int kt_w4a8_gemv(const void* qa, const void* qb, const void* sa,
                            const void* sb, const void* t, const void* x,
                            int x_dtype, const void* w, const void* s,
                            const void* ids, int r, int tiles, int splits,
                            int gran, int rb, int k2, int n, int ng, int gs2,
                            int out_bf16, void* part, void* cnt, void* out,
                            const void* xs, const void* z, void* stream) {
  if (r <= 0) return 0;
  const uintptr_t a16 =
      (uintptr_t)w | (uintptr_t)s | (uintptr_t)out | (uintptr_t)z;
  const uintptr_t a8 = (uintptr_t)qa | (uintptr_t)qb;
  if (r > kt::w4gv::MAX_ROWS || tiles < 1 || tiles > 65535 || n % 16 ||
      gs2 <= 0 || gs2 % kt::w4gv::UNIT || k2 % gs2 || ng * gs2 != k2 ||
      gran < 1 || (k2 / kt::w4gv::UNIT) % gran || splits < 1 ||
      splits > 65535 || splits > k2 / kt::w4gv::UNIT / gran ||
      (splits > 1 && (part == nullptr || cnt == nullptr)) || (a16 & 15u) ||
      (x_dtype == X_CODES && ((a8 & 7u) || (z != nullptr && xs == nullptr))) ||
      x_dtype < X_CODES ||
      x_dtype > X_BF16 || (x_dtype == X_F32 && out_bf16) ||
      (x_dtype == X_BF16 && !out_bf16))
    return (int)cudaErrorInvalidValue;
  kt::W4A8Args a =
      make_args(qa, qb, sa, sb, t, xs, x, w, s, z, k2, n, ng, gs2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pid = static_cast<const int*>(ids);
  float* p = static_cast<float*>(part);
  int* c = static_cast<int*>(cnt);
  using B = __nv_bfloat16;
  if (x_dtype == X_BF16)
    return (int)kt::launch_gemv<B>(a, pid, r, tiles, splits, gran, rb, p, c,
                                   static_cast<B*>(out), st);
  if (x_dtype == X_F32)
    return (int)kt::launch_gemv<float>(a, pid, r, tiles, splits, gran, rb, p,
                                       c, static_cast<float*>(out), st);
  if (out_bf16)
    return (int)kt::launch_gemv<int8_t>(a, pid, r, tiles, splits, gran, rb,
                                        p, c, static_cast<B*>(out), st);
  return (int)kt::launch_gemv<int8_t>(a, pid, r, tiles, splits, gran, rb, p,
                                      c, static_cast<float*>(out), st);
}
