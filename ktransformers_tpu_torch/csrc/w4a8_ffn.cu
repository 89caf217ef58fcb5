// Fused-by-two W4A8 expert FFN: gate_up dot -> GLU -> per (row, down
// group) int8 requant of the activation, then the down dot.
//
// Replaces three Pallas kernels of ktransformers_tpu/ops/pallas/
// w4a8_matmul.py that compute the same function: gathered_w4a8_ffn (one
// expert per routed row, decode), dense_w4a8_ffn (one dense expert, shared
// experts and dense MLP) and grouped_w4a8_ffn (rows sorted by expert,
// prefill). The wrapper (ops/cuda/w4a8_ffn.py) turns each into a list of
// row tiles that share one expert; dead tiles (rows = 0) exit at once.
//
// At decode the kernels are bound by the routed experts' weight bytes
// (gate_up K/2 x 2I + down I/2 x K int8 plus f32 scales). This first
// version uses two launches: ffn_up writes the int8 codes, scales and
// 8*sum(lo) of the GLU output to a scratch plane in device memory, and the
// down dot reads them back. Fusing both into one launch is later work.
//
// ffn_up: a block owns one down group of the intermediate dimension (bc
// columns of gate and the matching bc columns of up) for one tile, so the
// group's requant happens inside the block; the requant is per (row, down
// group), so the split does not change the numbers.
#include "w4a8_core.cuh"

namespace kt {

constexpr int MAX_BC = BN;  // one down group per block, <= 128 columns

__device__ __forceinline__ float glu(float g, float u, int act) {
  if (act == 0) return g * (1.0f / (1.0f + expf(-g))) * u;  // silu
  if (act == 1) return fmaxf(g, 0.0f) * u;                   // relu
  return 0.5f * g * (1.0f + erff(g * 0.70710678118654752f)) * u;  // gelu
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int MR>
__global__ void __launch_bounds__(32 * KW)
    ffn_up_kernel(W4A8Args a, int inter, int bc, int act,
                  int8_t* __restrict__ ca, int8_t* __restrict__ cb,
                  float* __restrict__ sa2, float* __restrict__ sb2,
                  float* __restrict__ t2) {
  __shared__ float red[KW][MR][2 * MAX_BC];
  __shared__ float act_s[MR][MAX_BC];
  const int tile = blockIdx.y;
  const int nrows = a.tile_rows[tile];
  if (nrows <= 0) return;
  const int row0 = a.tile_row0[tile];
  const int e = a.tile_expert[tile];
  const int c0 = blockIdx.x * bc;
  const int tx = threadIdx.x;
  float acc[MR][2 * CPT];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int c = 0; c < 2 * CPT; ++c) acc[m][c] = 0.f;
  if (tx * CPT < bc) {
    const int cols[2] = {c0 + tx * CPT, inter + c0 + tx * CPT};
    w4a8_accumulate<MR, 2>(a, e, row0, nrows, cols, acc);
  }
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      red[threadIdx.y][m][tx * CPT + c] = acc[m][c];
      red[threadIdx.y][m][MAX_BC + tx * CPT + c] = acc[m][CPT + c];
    }
  __syncthreads();
  const int tid = threadIdx.y * 32 + tx;
  for (int idx = tid; idx < MR * bc; idx += 32 * KW) {
    const int m = idx / bc, j = idx % bc;
    float hg = 0.f, hu = 0.f;
#pragma unroll
    for (int y = 0; y < KW; ++y) {
      hg += red[y][m][j];
      hu += red[y][m][MAX_BC + j];
    }
    act_s[m][j] = glu(hg, hu, act);
  }
  __syncthreads();

  // requant of the block's down group: warp m handles row m
  const int m = threadIdx.y;
  if (m >= nrows) return;
  const int gs2 = bc / 2;
  const int grp = blockIdx.x;
  const int ng2 = inter / bc;
  const size_t row = (size_t)(row0 + m);
  float v1[2], v2[2];
  float amax1 = 0.f, amax2 = 0.f, slo = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int j = tx + 32 * i;
    v1[i] = v2[i] = 0.f;
    if (j < gs2) {
      const float lo = act_s[m][j];
      const float hi = act_s[m][gs2 + j];
      v1[i] = lo - hi / 16.0f;
      v2[i] = hi / 16.0f;
      amax1 = fmaxf(amax1, fabsf(v1[i]));
      amax2 = fmaxf(amax2, fabsf(v2[i]));
      slo += lo;
    }
  }
  amax1 = warp_max(amax1);
  amax2 = warp_max(amax2);
  slo = warp_sum(slo);
  const float s1 = fmaxf(amax1, 1e-8f) / 127.0f;
  const float s2 = fmaxf(amax2, 1e-8f) / 127.0f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int j = tx + 32 * i;
    if (j < gs2) {
      const size_t o = row * (size_t)(inter / 2) + (size_t)grp * gs2 + j;
      ca[o] = (int8_t)fminf(fmaxf(rintf(v1[i] / s1), -127.f), 127.f);
      cb[o] = (int8_t)fminf(fmaxf(rintf(v2[i] / s2), -127.f), 127.f);
    }
  }
  if (tx == 0) {
    sa2[row * ng2 + grp] = s1;
    sb2[row * ng2 + grp] = s2;
    t2[row * ng2 + grp] = 8.0f * slo;
  }
}

}  // namespace kt

static kt::W4A8Args make_args(const void* qa, const void* qb, const void* sa,
                              const void* sb, const void* t, const void* w,
                              const void* s, const void* te, const void* tr0,
                              const void* trs, int k2, int n, int ng,
                              int gs2) {
  kt::W4A8Args a;
  a.qa = static_cast<const int8_t*>(qa);
  a.qb = static_cast<const int8_t*>(qb);
  a.sa = static_cast<const float*>(sa);
  a.sb = static_cast<const float*>(sb);
  a.t = static_cast<const float*>(t);
  a.w = static_cast<const int8_t*>(w);
  a.s = static_cast<const float*>(s);
  a.tile_expert = static_cast<const int*>(te);
  a.tile_row0 = static_cast<const int*>(tr0);
  a.tile_rows = static_cast<const int*>(trs);
  a.K2 = k2;
  a.N = n;
  a.ng = ng;
  a.gs2 = gs2;
  return a;
}

// gate_up + GLU + requant. w: [E, K2, 2*inter]; writes ca/cb int8
// [R, inter/2] and sa2/sb2/t2 f32 [R, inter/bc]. act: 0 silu, 1 relu,
// 2 gelu. Returns the cudaError_t of the launch.
extern "C" int kt_w4a8_ffn_up(const void* qa, const void* qb, const void* sa,
                              const void* sb, const void* t, const void* w,
                              const void* s, const void* tile_expert,
                              const void* tile_row0, const void* tile_rows,
                              int ntiles, int mr, int k2, int inter, int ng,
                              int gs2, int bc, int act, void* ca, void* cb,
                              void* sa2, void* sb2, void* t2, void* stream) {
  kt::W4A8Args a = make_args(qa, qb, sa, sb, t, w, s, tile_expert, tile_row0,
                             tile_rows, k2, 2 * inter, ng, gs2);
  dim3 grid(inter / bc, ntiles);
  dim3 block(32, kt::KW);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* pca = static_cast<int8_t*>(ca);
  auto* pcb = static_cast<int8_t*>(cb);
  auto* psa = static_cast<float*>(sa2);
  auto* psb = static_cast<float*>(sb2);
  auto* pt = static_cast<float*>(t2);
  switch (mr) {
    case 1:
      kt::ffn_up_kernel<1><<<grid, block, 0, st>>>(a, inter, bc, act, pca,
                                                   pcb, psa, psb, pt);
      break;
    case 4:
      kt::ffn_up_kernel<4><<<grid, block, 0, st>>>(a, inter, bc, act, pca,
                                                   pcb, psa, psb, pt);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// down dot over the requantized activation: same tiles as kt_w4a8_ffn_up.
extern "C" int kt_w4a8_ffn_down(const void* qa, const void* qb,
                                const void* sa, const void* sb, const void* t,
                                const void* w, const void* s,
                                const void* tile_expert,
                                const void* tile_row0, const void* tile_rows,
                                int ntiles, int mr, int k2, int n, int ng,
                                int gs2, int out_bf16, void* out,
                                void* stream) {
  kt::W4A8Args a = make_args(qa, qb, sa, sb, t, w, s, tile_expert, tile_row0,
                             tile_rows, k2, n, ng, gs2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    return (int)kt::launch_rows(a, ntiles, mr,
                                static_cast<__nv_bfloat16*>(out), st);
  return (int)kt::launch_rows(a, ntiles, mr, static_cast<float*>(out), st);
}
