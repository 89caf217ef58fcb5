// Fused-by-two W4A8 expert FFN: gate_up dot -> GLU -> per (row, down
// group) int8 requant of the activation, then the down dot.
//
// Replaces three Pallas kernels of ktransformers_tpu/ops/pallas/
// w4a8_matmul.py that compute the same function: gathered_w4a8_ffn (one
// expert per routed row, decode), dense_w4a8_ffn (one dense expert, shared
// experts and dense MLP) and grouped_w4a8_ffn (rows sorted by expert,
// prefill). The wrapper (ops/cuda/w4a8_ffn.py) turns each into a list of
// row tiles that share one expert; dead tiles (rows = 0) exit at once.
// Every call is two launches: the gate_up half writes the int8 codes,
// scales and 8*sum(lo) of the GLU output to a scratch plane in device
// memory, and the down dot reads them back. Which kernel runs each half
// is the wrapper's fixed rule (ops/cuda/w4a8_ffn.py:ffn_route):
// - tiles of more than one row: w4a8_ffn_mma_kernel below for gate_up
//   (64-row tiles on s8 tensor cores), w4a8_mma_kernel (w4a8_mma.cuh,
//   kt_w4a8_mma) for the down;
// - one-row tiles (decode): w4a8_ffn_gemv_kernel below for gate_up (the
//   split-K GEMV's walk with the GLU and requant in the last block of a
//   split set), the split-K GEMV (w4a8_gemv.cuh, kt_w4a8_gemv) for the
//   down;
// - shapes those refuse: the first version, ffn_up_kernel<1> / <4> and
//   w4a8_rows_kernel (kt_w4a8_ffn_down).
//
// At decode the kernels are bound by the routed experts' weight bytes
// (gate_up K/2 x 2I + down I/2 x K int8 plus f32 scales); at prefill by
// the experts' bytes too, as long as each expert is read once a 64-row
// tile (see w4a8_ffn_mma_kernel).
//
// Both gate_up kernels give a block one down group of the intermediate
// dimension (bc columns of gate and the matching bc columns of up) for one
// tile, so the group's requant happens inside the block; the requant is
// per (row, down group), so the split does not change the numbers. Both
// fold the activation prep of x in where the wrapper's rule says so
// (ops/cuda/w4a8_ffn.py:ffn_folds: the GEMV always, the tensor-core kernel
// below its crossover), with w4a8_core.cuh's prep_group: the GEMV as the
// down GEMV does (split_acts), the tensor-core kernel as w4a8_mma.cuh does
// (fold_tile: every group of the tile's rows into an A tile after its ring,
// before its K loop). The first version and the unfolded instantiations
// read the codes of a kt_w4a8_prep launch.
//
// Zero points (int4_gz) and other groups: the gate_up kernels subtract xs *
// z in each scale group's epilogue (w4a8_core.cuh), and the requant also
// writes each (row, down group)'s sum xs2 for a down with zero points. A
// block's columns hold one or more whole down groups (bc a multiple of the
// down group, at most 128: four groups of 32 from Q4_K, eight of 16), each
// requantized by a warp. The tensor-core gate_up takes scale groups of 32
// and 16 as w4a8_mma.cuh does (32-byte stages, m16n8k16 steps, a group of 16
// half a step with the other half's A lanes zeroed). A down group wider than
// 128 (per-channel int4: all of I) is held by no block: the wrapper then runs
// the gate_up as a W4A8 matmul into a float32 plane, kt_w4a8_glu_prep (the
// GLU and the requant, one block a (row, down group)) and the down matmul.
#include "w4a8_core.cuh"
#include "w4a8_gemv.cuh"
#include "w4a8_mma.cuh"

namespace kt {

constexpr int MAX_BC = BN;  // one down group per block, <= 128 columns

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

// w4a8_prep's requant of one (row, down group) of the GLU output, held by
// a warp: lane holds lo[i] = act[j] and hi[i] = act[gs2 + j] for
// j = lane + 32 i (used where j < gs2 <= 64). The codes go to ca / cb at
// o + j, the scales and 8*sum(lo) to sa2 / sb2 / t2 at si, and sum(lo + hi)
// to xs2 at si where xs2 is not null (a down with zero points).
__device__ __forceinline__ void requant_warp(const float lo[2],
                                             const float hi[2], int gs2,
                                             int8_t* __restrict__ ca,
                                             int8_t* __restrict__ cb,
                                             size_t o,
                                             float* __restrict__ sa2,
                                             float* __restrict__ sb2,
                                             float* __restrict__ t2,
                                             float* __restrict__ xs2,
                                             size_t si) {
  const int lane = threadIdx.x & 31;
  float v1[2], v2[2];
  float amax1 = 0.f, amax2 = 0.f, slo = 0.f, sx = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int j = lane + 32 * i;
    v1[i] = v2[i] = 0.f;
    if (j < gs2) {
      v1[i] = lo[i] - hi[i] / 16.0f;
      v2[i] = hi[i] / 16.0f;
      amax1 = fmaxf(amax1, fabsf(v1[i]));
      amax2 = fmaxf(amax2, fabsf(v2[i]));
      slo += lo[i];
      sx += lo[i] + hi[i];
    }
  }
  amax1 = warp_max(amax1);
  amax2 = warp_max(amax2);
  slo = warp_sum(slo);
  sx = warp_sum(sx);
  const float s1 = fmaxf(amax1, 1e-8f) / 127.0f;
  const float s2 = fmaxf(amax2, 1e-8f) / 127.0f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int j = lane + 32 * i;
    if (j < gs2) {
      ca[o + j] = (int8_t)fminf(fmaxf(rintf(v1[i] / s1), -127.f), 127.f);
      cb[o + j] = (int8_t)fminf(fmaxf(rintf(v2[i] / s2), -127.f), 127.f);
    }
  }
  if (lane == 0) {
    sa2[si] = s1;
    sb2[si] = s2;
    t2[si] = 8.0f * slo;
    if (xs2) xs2[si] = sx;
  }
}

template <int MR>
__global__ void __launch_bounds__(32 * KW)
    ffn_up_kernel(W4A8Args a, int inter, int bc, int act,
                  int8_t* __restrict__ ca, int8_t* __restrict__ cb,
                  float* __restrict__ sa2, float* __restrict__ sb2,
                  float* __restrict__ t2, float* __restrict__ xs2) {
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
  const size_t row = (size_t)(row0 + m);
  float lo[2], hi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int j = tx + 32 * i;
    lo[i] = j < gs2 ? act_s[m][j] : 0.f;
    hi[i] = j < gs2 ? act_s[m][gs2 + j] : 0.f;
  }
  requant_warp(lo, hi, gs2, ca, cb, row * (size_t)(inter / 2) +
               (size_t)grp * gs2, sa2, sb2, t2, xs2,
               row * (inter / bc) + grp);
}


// ------------------------------------- gate_up of one-row tiles: a GEMV

// w4a8_ffn_gemv_kernel: gate_up + GLU + requant of the W4A8 FFN for tiles
// of one or two rows of one expert (decode: gathered_w4a8_ffn, and
// dense_w4a8_ffn at M = 1). It replaces ffn_up_kernel<1>, which ran one
// block of 32 x KW threads per (down group, row) with 4-byte loads: 66
// blocks for DeepSeek-V2-Lite's 6 routed rows (11 down groups of 128) and
// 22 for the shared experts (I = 2816) on 132 SMs, each pulling its 256 KB
// through 4-byte loads, and rows routed to one expert read its bytes once
// each. Bound: the gate_up bytes of the experts the rows use (K/2 x 2I
// int8 plus the f32 group scales), read once. The design is the W4A8
// GEMV's (w4a8_gemv.cuh):
// - a block owns bc <= 128 columns, one or more whole down groups of gsd
//   (the wrapper's ffn_gemv_bc): gate columns [c0,
//   c0 + bc) and up columns [I + c0, I + c0 + bc), two column bases in one
//   block of BN = 256 (threads tx < 8 on the gate half, the others on the
//   up half, 16 columns a thread with one 16-byte load a storage row; a
//   down group below 128 leaves the threads past it idle), 8 row lanes
//   (w4gv::lane_walk: transpose4x4 + __dp4a, a group's int dots scaled
//   once);
// - the storage rows are cut into `splits` runs of whole scale groups
//   (blockIdx.z), planned by ops/cuda/w4a8_ffn.py:ffn_gemv_plan so that
//   (down groups x tiles x splits) fills the card: 4 splits for 6 routed
//   rows (264 blocks), 12 for the shared experts at M = 1, none at 48 rows;
// - tiles are keyed by expert (w4gv::tile_rows), as the down GEMV's: rows
//   routed to one expert read its bytes once, in neighbouring blocks;
//   tiles past the last (expert, chunk) pair exit at once, before they
//   arrive on any counter;
// - the lanes meet in shared memory; the splits through f32 partials
//   part[row][split][2I] in the same launch. The last block of a (down
//   group, tile) set to arrive (its counter, which it sets back to 0) adds
//   them in split order, so the same bits come out on every call, applies
//   the GLU and requantizes each row's down group with requant_warp into
//   the ca / cb / sa2 / sb2 / t2 planes the down GEMV reads. With one split
//   the block does that itself.
// (KT_W4GEMV_CUT_DECODE reaches this kernel through w4gv::lane_walk;
// KT_FFNGV_CUT_REDUCE and KT_FFNGV_CUT_REQUANT compile the cross-split sum
// and the GLU + requant out for ops/cuda/breakdown.py.) ZP: the gate_up has
// zero points (a separate instantiation, as w4a8_gemv_kernel's).
template <int RB, typename XT, bool ZP>
__global__ void __launch_bounds__(w4gv::THREADS, RB == 1 ? 4 : 3)
    w4a8_ffn_gemv_kernel(W4A8Args a, const int* __restrict__ ids, int R,
                         int inter, int bc, int gsd, int act, int splits,
                         int gran, float* __restrict__ part,
                         int* __restrict__ cnt, int8_t* __restrict__ ca,
                         int8_t* __restrict__ cb, float* __restrict__ sa2,
                         float* __restrict__ sb2, float* __restrict__ t2,
                         float* __restrict__ xs2) {
  constexpr int TX = w4gv::TX, LANES = w4gv::LANES, THREADS = w4gv::THREADS;
  constexpr int CPT = w4gv::CPT, BN = w4gv::BN;
  constexpr int MAX_ROWS = w4gv::MAX_ROWS;
  constexpr int HB = BN / 2;  // local columns of the gate half, then the up
  static_assert(HB == THREADS, "thread t holds gate and up column t");
  __shared__ __align__(16) float red[LANES][RB][BN];
  __shared__ float act_s[RB][HB];
  __shared__ int ids_s[MAX_ROWS], rows_s[RB], wsum[THREADS / 32];
  __shared__ int expert_s, chunk_s, nrows_s;
  extern __shared__ __align__(16) uint8_t acts_s[];
  w4gv::tile_rows<RB>(ids, R, blockIdx.y, ids_s, rows_s, wsum, &expert_s,
                      &chunk_s, &nrows_s);
  const int e = expert_s;
  if (e < 0) return;  // past the last (expert, chunk) pair (block-uniform)
  const int nr = nrows_s;
  const int tx = threadIdx.x % TX, ly = threadIdx.x / TX;
  const int grp = blockIdx.x, c0 = grp * bc;
  const int lc = tx * CPT;   // the thread's first local column
  const int j0 = lc % HB;    // ... as a column of the down group
  const int s = blockIdx.z;
  int l0, l1, g0, g1;
  w4gv::lane_run(a.K2, gran, splits, s, ly, l0, l1);
  w4gv::split_groups(a.ng, splits, s, g0, g1);
  const int col = (lc < HB ? 0 : inter) + c0 + j0;
  const int8_t* we = a.w + (size_t)e * a.K2 * a.N + col;
  const float* se = a.s + (size_t)e * a.ng * a.N + col;
  const float* ze = ZP ? a.z + (size_t)e * a.ng * a.N + col : nullptr;

  int row[RB];
#pragma unroll
  for (int m = 0; m < RB; ++m) row[m] = rows_s[m < nr ? m : 0];
  float acc[RB][CPT];
#pragma unroll
  for (int m = 0; m < RB; ++m)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[m][c] = 0.f;

  const auto acts = w4gv::split_acts<RB, XT>(a, row, nr, g0, g1, acts_s);
  if (j0 < bc && l0 < l1)
    w4gv::lane_walk<RB, !std::is_same<XT, int8_t>::value, ZP>(
        a, we, se, ze, acts, nr, l0, l1, acc);

#pragma unroll
  for (int m = 0; m < RB; ++m)
#pragma unroll
    for (int q = 0; q < CPT / 4; ++q)
      reinterpret_cast<float4*>(&red[ly][m][lc])[q] =
          make_float4(acc[m][4 * q], acc[m][4 * q + 1], acc[m][4 * q + 2],
                      acc[m][4 * q + 3]);
  __syncthreads();
  // thread t: gate column t (h[m][0]) and up column t (h[m][1]) of the
  // down group, the lanes summed in order
  const int t = threadIdx.x;
  const bool live = t < bc;
  float h[RB][2];
#pragma unroll
  for (int m = 0; m < RB; ++m)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float v = 0.f;
#pragma unroll
      for (int y = 0; y < LANES; ++y) v += red[y][m][u * HB + t];
      h[m][u] = v;
    }
  if (splits > 1) {
#pragma unroll
    for (int m = 0; m < RB; ++m) {
      if (m >= nr || !live) continue;
#pragma unroll
      for (int u = 0; u < 2; ++u)
        part[((size_t)row[m] * splits + s) * a.N + u * inter + c0 + t] =
            h[m][u];
    }
#if !KT_FFNGV_CUT_REDUCE
    int* c = cnt + (size_t)blockIdx.y * gridDim.x + blockIdx.x;
    if (!kt_mma::arrive_last(c, splits)) return;
    // the partials of the tile's rows in split order
#pragma unroll
    for (int m = 0; m < RB; ++m) {
      if (m >= nr || !live) continue;
      const float* p0 = part + (size_t)row[m] * splits * a.N + c0 + t;
#pragma unroll
      for (int u = 0; u < 2; ++u)
        h[m][u] = w4gv::split_sum(p0 + u * inter, splits, a.N);
    }
    if (t == 0) *c = 0;  // ready for the next launch
#endif
  }
#if !KT_FFNGV_CUT_REQUANT
#pragma unroll
  for (int m = 0; m < RB; ++m)
    if (m < nr && live) act_s[m][t] = glu(h[m][0], h[m][1], act);
  __syncthreads();
  // requant of the block's down groups: a warp a (row, down group), warp w
  // taking units w, w + 4, ... (one down group a block: warp m row m)
  const int nd = bc / gsd, gs2 = gsd / 2, lane = t & 31;
  for (int u = t >> 5; u < nr * nd; u += THREADS / 32) {
    const int m = u / nd, j = u - m * nd;
    float lo[2], hi[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int jj = lane + 32 * i;
      lo[i] = jj < gs2 ? act_s[m][j * gsd + jj] : 0.f;
      hi[i] = jj < gs2 ? act_s[m][j * gsd + gs2 + jj] : 0.f;
    }
    const size_t r = (size_t)rows_s[m];
    const size_t G = (size_t)grp * nd + j;  // the down group
    requant_warp(lo, hi, gs2, ca, cb, r * (size_t)(inter / 2) + G * gs2,
                 sa2, sb2, t2, xs2, r * (inter / gsd) + G);
  }
#else
  float sink = 0.f;  // keeps the sums live
#pragma unroll
  for (int m = 0; m < RB; ++m) sink += h[m][0] + h[m][1];
  if (sink == 1.2345f) ca[t] = 1;
#endif
}

template <int RB, typename XT>
cudaError_t launch_ffn_gemv(const W4A8Args& a, const int* ids, int R,
                            int tiles, int inter, int bc, int gsd, int act,
                            int splits, int gran, float* part, int* cnt,
                            int8_t* ca, int8_t* cb, float* sa2, float* sb2,
                            float* t2, float* xs2, cudaStream_t stream) {
  constexpr bool kFold = !std::is_same<XT, int8_t>::value;
  if (kFold && (gran * w4gv::UNIT != a.gs2 || a.gs2 > w4gv::FOLD_GS2))
    return cudaErrorInvalidValue;
  const int smem =
      kFold ? w4gv::acts_bytes(RB, (a.ng + splits - 1) / splits, a.gs2) : 0;
  if (smem > w4gv::MAX_ACTS_SMEM) return cudaErrorInvalidValue;
  static int ready_dev[2] = {-1, -1};
  const bool zp = a.z != nullptr;
  if (kFold) {
    cudaError_t err =
        zp ? kt_mma::allow_smem(w4a8_ffn_gemv_kernel<RB, XT, true>,
                                w4gv::MAX_ACTS_SMEM, &ready_dev[1])
           : kt_mma::allow_smem(w4a8_ffn_gemv_kernel<RB, XT, false>,
                                w4gv::MAX_ACTS_SMEM, &ready_dev[0]);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(inter / bc, tiles, splits);
  if (zp)
    w4a8_ffn_gemv_kernel<RB, XT, true><<<grid, w4gv::THREADS, smem,
                                          stream>>>(
        a, ids, R, inter, bc, gsd, act, splits, gran, part, cnt, ca, cb,
        sa2, sb2, t2, xs2);
  else
    w4a8_ffn_gemv_kernel<RB, XT, false><<<grid, w4gv::THREADS, smem,
                                           stream>>>(
        a, ids, R, inter, bc, gsd, act, splits, gran, part, cnt, ca, cb,
        sa2, sb2, t2, xs2);
  return cudaGetLastError();
}

// ----------------------------------------------- gate_up on tensor cores

// w4a8_ffn_mma_kernel: gate_up + GLU + requant for tiles of up to BM = 64
// rows of one expert (the tile maps of kt_w4a8_mma), one down group of
// BC = 128 columns a block: the block's 2 BC gate_up columns are gate
// columns [c0, c0 + BC) and up columns [I + c0, I + c0 + BC). The int8 dots
// run on s8 mma.sync as in w4a8_mma.cuh (its ldmatrix.trans of the N-major
// weight rows, no repack; m16n8k32, and m16n8k16 for the last 16 bytes of
// a group of 96), with a cp.async ring of STAGES scale groups. Sixteen
// warps (4 along M, 4 along N: two on the gate half, two on the up half)
// own 16 rows x 64 columns each: 32 f32 accumulators a thread, one block
// of 512 threads an SM, so the ring is deep enough (five groups ahead) to
// keep the copies in flight alone, and each scheduler has four warps whose
// dot / epilogue chains hide each other's latency. Per scale group a warp
// loads its A fragments once, then walks its 16-column chunks: the group's
// int32 sums of a chunk are exact (the integers __dp4a gives) and scaled
// into the f32 accumulators right away, so only one chunk's int sums are
// live (and the groups are added in order, as the plain version does).
// Warps whose 16 rows lie past the tile's rows skip the dots (a tile of a
// grouped prefill call holds ~24 rows, a decode batch 8). After the K loop
// the accumulators are staged through shared memory (the ring's bytes),
// and each warp takes rows for the f32 GLU and the
// per-(row, down group) requant of ffn_up_kernel (requant_warp).
//
// Bound: the experts' weight bytes at the grouped prefill shapes (each
// expert's gate_up read once a 64-row tile; the first version read it once
// every 4 rows), operations at the dense ones. The activation codes are
// read once a down group (I / 128 times).
// (The KT_FFNMMA_CUT_* switches compile parts out for ops/cuda/breakdown.py.)
namespace ffnmma {

constexpr int BM = 64;        // rows a tile
constexpr int BC = 128;       // gate (and up) columns a block
constexpr int BN = 2 * BC;    // gate_up columns a block
constexpr int STAGES = 6;     // depth of the cp.async ring
constexpr int WARPS_M = 4;    // warps along M: 16 rows each
constexpr int WARPS_N = 4;    // warps along N: 64 columns each
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int P = BN / 16 / WARPS_N;  // 16-column chunks a warp
constexpr int HS = BN + 4;    // row stride (floats) of the staged outputs

// The ring as w4a8_mma.cuh's Shape: a stage holds KC bytes of K (one group
// at 128 and 96, GPS = 2 or 4 groups at 32 and 16), the weight bytes and
// each group's columns' s (and z with zero points), and the stage's codes
// and each group's rows' sa, sb, t (and xs) where the kernel reads a prep
// launch's (XT = int8_t); without zero points the layout the kernel had
// before the zero term. Where it folds the prep in (float or bf16) the
// codes of every group lie in an A tile after the ring
// (w4mma::fold_bytes).
template <int GS2, typename XT>
struct Shape {
  static constexpr bool FOLD = !std::is_same<XT, int8_t>::value;
  static constexpr bool SMALL = GS2 < 32;
  static constexpr int KC = SMALL ? 32 : GS2;       // bytes of K a stage
  static constexpr int GPS = SMALL ? KC / GS2 : 1;  // groups a stage
  // qa / qb tile row stride: an odd number of 16-byte chunks keeps the
  // ldmatrix rows on distinct banks
  static constexpr int LDA = (KC / 16) % 2 ? KC : KC + 16;
  static constexpr int A_BYTES = BM * LDA;
  static constexpr int CODE_BYTES = FOLD ? 0 : 2 * A_BYTES;  // qa, qb
  static constexpr int W_BYTES = KC * BN;
  // a group's row floats (sa, sb, t[, xs]) and column floats (s[, z])
  __host__ __device__ static constexpr int rf(bool z) {
    return FOLD ? 0 : (z ? 4 : 3) * BM;
  }
  __host__ __device__ static constexpr int cf(bool z) {
    return (z ? 2 : 1) * BN;
  }
  __host__ __device__ static constexpr int stage(bool z) {
    return CODE_BYTES + W_BYTES + GPS * (rf(z) + cf(z)) * 4;
  }
  __host__ __device__ static constexpr int ring(bool z) {
    return STAGES * stage(z);
  }
  static constexpr int OUT = BM * HS * 4;
};

// 16-byte chunk c (of 16) of weight row k in the swizzled tile: the 8 rows
// an ldmatrix.trans reads (k = 0 1 4 5 8 9 12 13, or those + 2) land on 8
// distinct 16-byte bank groups of their 256-byte rows
__device__ __forceinline__ int wchunk(int k, int c) {
  return c ^ ((((k >> 2) & 3) << 1) | (k & 1));
}

// The gate_up column of the block's local column col (c0: the block's
// first gate column).
__device__ __forceinline__ int block_col(int col, int c0, int inter) {
  return col < BC ? c0 + col : inter + c0 + col - BC;
}

// Issue the copies of stage st into a ring slot (ZP: zero points).
template <int GS2, typename XT, bool ZP>
__device__ __forceinline__ void load_stage(const W4A8Args& a, int e,
                                           int row0, int nrows, int c0,
                                           int inter, int st, uint8_t* slot) {
  using S = Shape<GS2, XT>;
  const int t = threadIdx.x;
  const int kb = st * S::KC;
  const int g0 = st * S::GPS;
  if constexpr (!S::FOLD) {
    constexpr int CPR = S::KC / 16;  // 16-byte chunks of a qa row
    for (int i = t; i < BM * CPR; i += THREADS) {
      const int m = i / CPR, q = i % CPR;
      const bool ok = m < nrows;
      const size_t off =
          (size_t)(row0 + (ok ? m : 0)) * a.K2 + (size_t)kb + q * 16;
      kt_mma::cp_async16(slot + m * S::LDA + q * 16, a.qa + off, ok);
      kt_mma::cp_async16(slot + S::A_BYTES + m * S::LDA + q * 16,
                         a.qb + off, ok);
    }
  }
  uint8_t* wd = slot + S::CODE_BYTES;
  const int8_t* wg = a.w + ((size_t)e * a.K2 + (size_t)kb) * a.N;
  for (int i = t; i < S::KC * (BN / 16); i += THREADS) {
    const int k = i / (BN / 16), c = i % (BN / 16);
    const int n = block_col(c * 16, c0, inter);
    kt_mma::cp_async16(wd + k * BN + wchunk(k, c) * 16,
                       wg + (size_t)k * a.N + n, true);
  }
  float* f = reinterpret_cast<float*>(wd + S::W_BYTES);
  // each group's row floats sa, sb, t (and xs)
  constexpr int rf = S::rf(ZP), nrf = S::GPS * rf;
  for (int i = t; i < nrf; i += THREADS) {
    const int gi = i / rf, which = (i % rf) / BM, m = i % BM;
    const float* src = which == 0 ? a.sa : which == 1 ? a.sb
                       : which == 2 ? a.t : a.xs;
    const bool ok = m < nrows;
    kt_mma::cp_async4(
        f + i, ok ? src + (size_t)(row0 + m) * a.ng + g0 + gi : a.sa, ok);
  }
  // each group's column floats s (and z)
  constexpr int cf = S::cf(ZP), ncf = S::GPS * cf / 4;
  for (int i = t; i < ncf; i += THREADS) {
    const int gi = i / (cf / 4), which = (i % (cf / 4)) / (BN / 4);
    const int col = 4 * (i % (BN / 4));
    const int n = block_col(col, c0, inter);
    const float* src = which == 0 ? a.s : a.z;
    kt_mma::cp_async16(f + nrf + gi * cf + which * BN + col,
                       src + ((size_t)e * a.ng + g0 + gi) * a.N + n, true);
  }
}

// Issue the copies of scale group g into a ring slot.
template <int GS2, typename XT>
__device__ __forceinline__ void load_stage_v1(const W4A8Args& a, int e,
                                           int row0, int nrows, int c0,
                                           int inter, int g, uint8_t* slot) {
  using S = Shape<GS2, XT>;
  const int t = threadIdx.x;
  if constexpr (!S::FOLD) {
    constexpr int CPR = GS2 / 16;  // 16-byte chunks of a qa row
    for (int i = t; i < BM * CPR; i += THREADS) {
      const int m = i / CPR, q = i % CPR;
      const bool ok = m < nrows;
      const size_t off =
          (size_t)(row0 + (ok ? m : 0)) * a.K2 + (size_t)g * GS2 + q * 16;
      kt_mma::cp_async16(slot + m * S::LDA + q * 16, a.qa + off, ok);
      kt_mma::cp_async16(slot + S::A_BYTES + m * S::LDA + q * 16,
                         a.qb + off, ok);
    }
  }
  uint8_t* wd = slot + S::CODE_BYTES;
  const int8_t* wg = a.w + ((size_t)e * a.K2 + (size_t)g * GS2) * a.N;
  for (int i = t; i < GS2 * (BN / 16); i += THREADS) {
    const int k = i / (BN / 16), c = i % (BN / 16);
    const int n = (c < BC / 16 ? c0 : inter + c0 - BC) + c * 16;
    kt_mma::cp_async16(wd + k * BN + wchunk(k, c) * 16,
                       wg + (size_t)k * a.N + n, true);
  }
  float* f = reinterpret_cast<float*>(wd + S::W_BYTES);
  constexpr int RF = S::FOLD ? 0 : 3 * BM;  // the rows' sa, sb, t
  if (t < RF) {
    const int which = t / BM, m = t % BM;
    const float* src = which == 0 ? a.sa : which == 1 ? a.sb : a.t;
    const bool ok = m < nrows;
    kt_mma::cp_async4(f + t, src + (size_t)(row0 + (ok ? m : 0)) * a.ng + g,
                      ok);
  } else if (t < RF + BN / 4) {
    const int col = 4 * (t - RF);
    const int n = col < BC ? c0 + col : inter + c0 + col - BC;
    kt_mma::cp_async16(f + RF + col,
                       a.s + ((size_t)e * a.ng + g) * a.N + n, true);
  }
}

// Issue the copies of stage st: load_stage_v1 at one group of 128 or 96
// without zero points (the group's floats in one pass of the block's
// threads), else load_stage.
template <int GS2, typename XT, bool ZP>
__device__ __forceinline__ void issue_stage(const W4A8Args& a, int e,
                                            int row0, int nrows, int c0,
                                            int inter, int st,
                                            uint8_t* slot) {
  using S = Shape<GS2, XT>;
  if constexpr (S::GPS == 1 && !ZP)
    load_stage_v1<GS2, XT>(a, e, row0, nrows, c0, inter, st, slot);
  else
    load_stage<GS2, XT, ZP>(a, e, row0, nrows, c0, inter, st, slot);
}

}  // namespace ffnmma

// XT = int8_t reads a prep launch's codes; float or bf16 folds the prep in
// (w4mma::fold_tile into an A tile of arows rows, a multiple of 16 at least
// the tile's rows). gsd: the down group (128, 64, 32 or 16), BC / gsd of
// them a block. ZP: the gate_up has zero points (a separate instantiation,
// as w4a8_mma_kernel's). At gate_up groups of 128 and 96 without zero
// points the branches on SMALL and ZP compile away to one group a stage,
// its copies load_stage_v1's (issue_stage).
template <int GS2, typename XT, bool ZP>
__global__ void __launch_bounds__(ffnmma::THREADS, 1)
    w4a8_ffn_mma_kernel(W4A8Args a, int arows, int inter, int gsd, int act,
                        int8_t* __restrict__ ca, int8_t* __restrict__ cb,
                        float* __restrict__ sa2, float* __restrict__ sb2,
                        float* __restrict__ t2, float* __restrict__ xs2) {
  constexpr int BM = ffnmma::BM, BC = ffnmma::BC, BN = ffnmma::BN;
  constexpr int THREADS = ffnmma::THREADS;
  constexpr int P = ffnmma::P, HS = ffnmma::HS;
  constexpr int WARPS_M = ffnmma::WARPS_M;
  using S = ffnmma::Shape<GS2, XT>;
  constexpr int STAGES = ffnmma::STAGES;
  constexpr int KS = S::SMALL ? 0 : GS2 / 32;      // m16n8k32 steps a group
  constexpr bool TAIL = !S::SMALL && GS2 % 32 != 0;  // one k16 step (96)
  extern __shared__ __align__(128) uint8_t smem[];
  const int tile = blockIdx.y;
  const int nrows = a.tile_rows[tile];
  if (nrows <= 0) return;  // dead tile (block-uniform)
  const int row0 = a.tile_row0[tile];
  const int e = a.tile_expert[tile];
  const int grp = blockIdx.x, c0 = grp * BC;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const uint32_t LO = 0x0F0F0F0Fu;
  constexpr bool hasz = ZP;
  const int nst = a.ng / S::GPS;
  constexpr int stage = S::stage(ZP);  // bytes of a ring stage

  // acc[p][h][c]: row wm*16 + lane/4 + 8h, column (wn*P + p)*16 +
  // 4*(lane%4) + c of the block's gate_up columns
  float acc[P][2][4];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[p][h][c] = 0.f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nst)
      ffnmma::issue_stage<GS2, XT, ZP>(a, e, row0, nrows, c0, inter, st,
                                       smem + st * stage);
    kt_mma::cp_async_commit();
  }
  uint8_t* A = smem + S::ring(ZP);  // the folded A tile
  if constexpr (S::FOLD)
    w4mma::fold_tile<8, XT>(a, row0, nrows, arows, THREADS / 32, A);
  const int jm = lane >> 3, jr = lane & 7;
  // this lane's ldmatrix.trans row inside a 16-row k block
  const int krow = (jm & 1) * 2 + (jr >> 1) * 4 + (jr & 1);
  for (int st = 0; st < nst; ++st) {
    kt_mma::cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage st landed; stage st - 1 fully consumed
    const int nx = st + STAGES - 1;
    if (nx < nst)
      ffnmma::issue_stage<GS2, XT, ZP>(a, e, row0, nrows, c0, inter, nx,
                                       smem + (nx % STAGES) * stage);
    kt_mma::cp_async_commit();
    // a warp whose 16 rows all lie past the tile's rows has nothing to add
    // (warp-uniform; it still takes part in the copies and barriers)
    if (wm * 16 >= nrows) continue;
    const uint8_t* slot = smem + (st % STAGES) * stage;
    const uint8_t* wt = slot + S::CODE_BYTES;
    const float* fl = reinterpret_cast<const float*>(wt + S::W_BYTES);
    // the groups' columns' s (and z)
    const float* cs = fl + S::GPS * S::rf(hasz);
    w4mma::AView av;
    if constexpr (S::FOLD) {
      const int ld = w4mma::fold_ld(a.K2);
      av = {A + st * S::KC, A + arows * ld + st * S::KC, ld,
            reinterpret_cast<const float*>(A + 2 * arows * ld) +
                st * S::GPS,
            a.ng, arows * a.ng};
    } else {
      av = {slot, slot + S::A_BYTES, S::LDA, fl, 1, BM};
    }
    const uint8_t* qa = av.qa;
    const uint8_t* qb = av.qb;
    const int arow = (wm * 16 + (lane & 15)) * av.ld;

#pragma unroll
    for (int gi = 0; gi < S::GPS; ++gi) {
      // the group's A fragments: KS k32 steps (+ a k16 tail), or one k16
      // step (a group of 32), or half of one (16: the other half's lanes
      // zeroed)
      uint32_t fa[KS > 0 ? KS : 1][4], fb[KS > 0 ? KS : 1][4], ta[2], tb[2];
      const int kk16 = S::SMALL ? (GS2 == 16 ? gi * 16 : (gi >> 1) * 16)
                                : GS2 - 16;
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        const int ro = arow + s * 32 + (lane >> 4) * 16;
        kt_mma::ldmatrix_x4(fa[s], qa + ro);
        kt_mma::ldmatrix_x4(fb[s], qb + ro);
      }
      if (TAIL || S::SMALL) {
        kt_mma::ldmatrix_x2(ta, qa + arow + kk16);
        kt_mma::ldmatrix_x2(tb, qb + arow + kk16);
        if (S::SMALL && GS2 == 8) {
          const bool keep = ((lane >> 1) & 1) == (gi & 1);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            ta[j] = keep ? ta[j] : 0u;
            tb[j] = keep ? tb[j] : 0u;
          }
        }
      }
      const float* rf = S::FOLD ? av.f + gi : av.f + gi * S::rf(hasz);
      float sam[2], sbm[2], tm[2], xm[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* fr = rf + (wm * 16 + (lane >> 2) + h * 8) * av.fs;
        sam[h] = fr[0];
        sbm[h] = fr[av.fp];
        tm[h] = fr[2 * av.fp];
        xm[h] = hasz ? fr[3 * av.fp] : 0.f;
      }
      const float* gcs = cs + gi * S::cf(hasz);

#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int ch = wn * P + p;
        // the group's int sums of the chunk's even (e) and odd (o) columns
        int pe[4] = {0, 0, 0, 0}, po[4] = {0, 0, 0, 0};
        int qe[4] = {0, 0, 0, 0}, qo[4] = {0, 0, 0, 0};
#pragma unroll
        for (int s = 0; s < KS; ++s) {
          // matrices: k rows 0-15 (pi0, pi1), then 16-31
          const int k = s * 32 + (jm >> 1) * 16 + krow;
          uint32_t r[4];
          kt_mma::ldmatrix_x4_trans(r,
                                    wt + k * BN + ffnmma::wchunk(k, ch) * 16);
          uint32_t e0, o0, e1, o1;
          w4mma::split_pair(r[0], r[1], e0, o0);
          w4mma::split_pair(r[2], r[3], e1, o1);
#if KT_FFNMMA_CUT_MMA
          pe[0] ^= fa[s][0] ^ e0;
          qo[1] ^= fb[s][1] ^ o1;
#else
          kt_mma::mma_s8_16832(pe, fa[s], e0 & LO, e1 & LO);
          kt_mma::mma_s8_16832(po, fa[s], o0 & LO, o1 & LO);
          kt_mma::mma_s8_16832(qe, fb[s], e0, e1);
          kt_mma::mma_s8_16832(qo, fb[s], o0, o1);
#endif
        }
        if (TAIL || S::SMALL) {  // a k16 step at kk16
          const int k = kk16 + krow;
          uint32_t r[2];
          kt_mma::ldmatrix_x2_trans(r,
                                    wt + k * BN + ffnmma::wchunk(k, ch) * 16);
          uint32_t ev, od;
          w4mma::split_pair(r[0], r[1], ev, od);
#if KT_FFNMMA_CUT_MMA
          po[2] ^= ta[0] ^ ev ^ tb[1] ^ od;
#else
          kt_mma::mma_s8_16816(pe, ta, ev & LO);
          kt_mma::mma_s8_16816(po, ta, od & LO);
          kt_mma::mma_s8_16816(qe, tb, ev);
          kt_mma::mma_s8_16816(qo, tb, od);
#endif
        }
        // fragment element fc of the even / odd tile is row lane/4 +
        // 8(fc/2), column 4*(lane%4) + 2*(fc%2) (+ 1) of the chunk
        const float4 s4 = *reinterpret_cast<const float4*>(
            gcs + ch * 16 + 4 * (lane & 3));
        const float sc[4] = {s4.x, s4.y, s4.z, s4.w};
        float zc[4] = {0.f, 0.f, 0.f, 0.f};
        if (hasz) {
          const float4 z4 = *reinterpret_cast<const float4*>(
              gcs + BN + ch * 16 + 4 * (lane & 3));
          zc[0] = z4.x; zc[1] = z4.y; zc[2] = z4.z; zc[3] = z4.w;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int fc = 2 * h + (c >> 1);
            const int ia = c & 1 ? po[fc] : pe[fc];
            const int ib = c & 1 ? qo[fc] : qe[fc];
#if KT_FFNMMA_CUT_EPILOGUE
            acc[p][h][c] += (float)(ia ^ ib);
#else
            float val = (float)ia * sam[h] + (float)ib * sbm[h] - tm[h];
            if (hasz) val -= xm[h] * zc[c];
            acc[p][h][c] += val * sc[c];
#endif
          }
      }
    }
  }
#if !KT_FFNMMA_CUT_REQUANT
  kt_mma::cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring

  float* hs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wm * 16 + (lane >> 2) + h * 8;
      const int col = (wn * P + p) * 16 + 4 * (lane & 3);
      *reinterpret_cast<float4*>(hs + row * HS + col) =
          make_float4(acc[p][h][0], acc[p][h][1], acc[p][h][2],
                      acc[p][h][3]);
    }
  __syncthreads();

  if (gsd == BC && xs2 == nullptr) {
    // GLU and requant of one down group a block without its sums: warp w
    // takes rows w, w + 16, ...; act[j] = glu(gate column j, up column j),
    // lo = act[j], hi = act[BC/2 + j]
    constexpr int GS2D = BC / 2;
    for (int m = warp; m < nrows; m += THREADS / 32) {
      const float* hr = hs + m * HS;
      float lo[2], hi[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int j = lane + 32 * i;
        lo[i] = glu(hr[j], hr[BC + j], act);
        hi[i] = glu(hr[GS2D + j], hr[BC + GS2D + j], act);
      }
      const size_t row = (size_t)(row0 + m);
      requant_warp(lo, hi, GS2D, ca, cb,
                   row * (size_t)(inter / 2) + (size_t)grp * GS2D, sa2, sb2,
                   t2, nullptr, row * (inter / BC) + grp);
    }
    return;
  }
  // GLU and requant: a warp a (row, down group) unit, warp w taking units
  // w, w + 16, ... (one down group a block: rows w, w + 16, ...); act[j] =
  // glu(gate column j, up column j), lo = act[j0 + j], hi = act[j0 + gsd/2 +
  // j] for the down group at j0
  const int nd = BC / gsd, gs2d = gsd / 2;
  for (int u = warp; u < nrows * nd; u += THREADS / 32) {
    const int m = u / nd, j0 = (u - m * nd) * gsd;
    const float* hr = hs + m * HS;
    float lo[2], hi[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int j = lane + 32 * i;
      lo[i] = hi[i] = 0.f;
      if (j < gs2d) {
        lo[i] = glu(hr[j0 + j], hr[BC + j0 + j], act);
        hi[i] = glu(hr[j0 + gs2d + j], hr[BC + j0 + gs2d + j], act);
      }
    }
    const size_t row = (size_t)(row0 + m);
    const size_t G = (size_t)grp * nd + (j0 / gsd);  // the down group
    requant_warp(lo, hi, gs2d, ca, cb, row * (size_t)(inter / 2) + G * gs2d,
                 sa2, sb2, t2, xs2, row * (inter / gsd) + G);
  }
#else
  float sink = 0.f;  // keeps every accumulator live
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 4; ++c) sink += acc[p][h][c];
  if (sink == 1.2345f) ca[threadIdx.x] = 1;
#endif
}

// gs2 = 64 (gate_up group 128), 48 (96), 16 (32) or 8 (16, with K/2 a
// multiple of 32 at the last two); down group gsd of 128, 64, 32 or 16; I a
// multiple of BC; K/2 a multiple of 16 bytes. XT as w4a8_ffn_mma_kernel.
template <int GS2, typename XT, bool ZP>
cudaError_t launch_ffn_mma_zp(const W4A8Args& a, int ntiles, int arows,
                              int inter, int gsd, int act, int8_t* ca,
                              int8_t* cb, float* sa2, float* sb2, float* t2,
                              float* xs2, cudaStream_t stream) {
  static int ready_dev = -1;
  using S = ffnmma::Shape<GS2, XT>;
  if (a.ng % S::GPS || gsd < 16 || ffnmma::BC % gsd)
    return cudaErrorInvalidValue;
  const int ring =
      S::ring(ZP) + (S::FOLD ? w4mma::fold_bytes(arows, a.K2, a.ng, ZP) : 0);
  const int smem = ring > S::OUT ? ring : S::OUT;
  if (smem > w4mma::MAX_SMEM ||
      (S::FOLD && (arows < 16 || arows > ffnmma::BM || arows % 16)))
    return cudaErrorInvalidValue;
  cudaError_t err = kt_mma::allow_smem(w4a8_ffn_mma_kernel<GS2, XT, ZP>,
                                       w4mma::MAX_SMEM, &ready_dev);
  if (err != cudaSuccess) return err;
  dim3 grid(inter / ffnmma::BC, ntiles);
  w4a8_ffn_mma_kernel<GS2, XT, ZP><<<grid, ffnmma::THREADS, smem, stream>>>(
      a, arows, inter, gsd, act, ca, cb, sa2, sb2, t2, xs2);
  return cudaGetLastError();
}

// The instantiation with the zero term where a.z is given.
template <int GS2, typename XT>
cudaError_t launch_ffn_mma_gs(const W4A8Args& a, int ntiles, int arows,
                              int inter, int gsd, int act, int8_t* ca,
                              int8_t* cb, float* sa2, float* sb2, float* t2,
                              float* xs2, cudaStream_t stream) {
  return a.z ? launch_ffn_mma_zp<GS2, XT, true>(a, ntiles, arows, inter, gsd,
                                                act, ca, cb, sa2, sb2, t2,
                                                xs2, stream)
             : launch_ffn_mma_zp<GS2, XT, false>(a, ntiles, arows, inter, gsd,
                                                 act, ca, cb, sa2, sb2, t2,
                                                 xs2, stream);
}

template <typename XT>
cudaError_t launch_ffn_mma(const W4A8Args& a, int ntiles, int arows,
                           int inter, int gsd, int act, int8_t* ca,
                           int8_t* cb, float* sa2, float* sb2, float* t2,
                           float* xs2, cudaStream_t stream) {
  switch (a.gs2) {
    case 64:
      return launch_ffn_mma_gs<64, XT>(a, ntiles, arows, inter, gsd, act, ca,
                                       cb, sa2, sb2, t2, xs2, stream);
    case 48:
      return launch_ffn_mma_gs<48, XT>(a, ntiles, arows, inter, gsd, act, ca,
                                       cb, sa2, sb2, t2, xs2, stream);
    case 16:
      return launch_ffn_mma_gs<16, XT>(a, ntiles, arows, inter, gsd, act, ca,
                                       cb, sa2, sb2, t2, xs2, stream);
    case 8:
      return launch_ffn_mma_gs<8, XT>(a, ntiles, arows, inter, gsd, act, ca,
                                      cb, sa2, sb2, t2, xs2, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace kt

static kt::W4A8Args make_args(const void* qa, const void* qb, const void* sa,
                              const void* sb, const void* t, const void* xs,
                              const void* w, const void* s, const void* z,
                              const void* te, const void* tr0,
                              const void* trs, int k2, int n, int ng,
                              int gs2) {
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
  a.tile_expert = static_cast<const int*>(te);
  a.tile_row0 = static_cast<const int*>(tr0);
  a.tile_rows = static_cast<const int*>(trs);
  a.K2 = k2;
  a.N = n;
  a.ng = ng;
  a.gs2 = gs2;
  return a;
}

// gate_up + GLU + requant. w: [E, K2, 2*inter] (z: its zero points or
// null, xs the activations' group sums then); writes ca/cb int8
// [R, inter/2] and sa2/sb2/t2 (and xs2 where not null) f32 [R, inter/bc].
// act: 0 silu, 1 relu, 2 gelu. Returns the cudaError_t of the launch.
extern "C" int kt_w4a8_ffn_up(const void* qa, const void* qb, const void* sa,
                              const void* sb, const void* t, const void* w,
                              const void* s, const void* tile_expert,
                              const void* tile_row0, const void* tile_rows,
                              int ntiles, int mr, int k2, int inter, int ng,
                              int gs2, int bc, int act, void* ca, void* cb,
                              void* sa2, void* sb2, void* t2, const void* xs,
                              const void* z, void* xs2, void* stream) {
  if (z != nullptr && xs == nullptr) return (int)cudaErrorInvalidValue;
  kt::W4A8Args a = make_args(qa, qb, sa, sb, t, xs, w, s, z, tile_expert,
                             tile_row0, tile_rows, k2, 2 * inter, ng, gs2);
  dim3 grid(inter / bc, ntiles);
  dim3 block(32, kt::KW);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* pca = static_cast<int8_t*>(ca);
  auto* pcb = static_cast<int8_t*>(cb);
  auto* psa = static_cast<float*>(sa2);
  auto* psb = static_cast<float*>(sb2);
  auto* pt = static_cast<float*>(t2);
  auto* px = static_cast<float*>(xs2);
  switch (mr) {
    case 1:
      kt::ffn_up_kernel<1><<<grid, block, 0, st>>>(a, inter, bc, act, pca,
                                                   pcb, psa, psb, pt, px);
      break;
    case 4:
      kt::ffn_up_kernel<4><<<grid, block, 0, st>>>(a, inter, bc, act, pca,
                                                   pcb, psa, psb, pt, px);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The activations of a gate_up launch: x_dtype 0 takes the codes of a prep
// launch (qa, qb, sa, sb, t, and xs where the weight has zero points), 1
// float32 and 2 bfloat16 rows x [R, 2 K2] (the kernel folds the prep in).
enum { X_CODES = 0, X_F32 = 1, X_BF16 = 2 };

template <template <typename> class Launch, typename... Args>
static int by_x_dtype(int x_dtype, Args... args) {
  switch (x_dtype) {
    case X_CODES: return (int)Launch<int8_t>::run(args...);
    case X_F32: return (int)Launch<float>::run(args...);
    case X_BF16: return (int)Launch<__nv_bfloat16>::run(args...);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename XT>
struct GemvUp {
  template <typename... Args>
  static cudaError_t run(int rb, Args... args) {
    switch (rb) {
      case 1: return kt::launch_ffn_gemv<1, XT>(args...);
      case 2: return kt::launch_ffn_gemv<2, XT>(args...);
      default: return cudaErrorInvalidValue;
    }
  }
};

template <typename XT>
struct MmaUp {
  template <typename... Args>
  static cudaError_t run(Args... args) {
    return kt::launch_ffn_mma<XT>(args...);
  }
};

// gate_up + GLU + requant of one-row tiles on w4a8_ffn_gemv_kernel: row r
// of the activations (as x_dtype says) through expert ids[r] of w [E, K2,
// 2 * inter] (z: its zero points or null) for r < R (R <= 128; a dense call
// passes R = 1, ids = [0]), `tiles` tiles of up to rb rows of one expert (rb
// 1 or 2; tiles at least the number of (expert, chunk) pairs), `splits`
// runs of `gran` 8-row units (gran * 8 = gs2, one scale group, or fewer
// within a per-channel group: no fold then); blocks of bc columns (a
// multiple of 16 and of the down group gsd, at most 128, dividing inter).
// Writes ca / cb int8 [R, inter/2] and sa2 / sb2 / t2 (xs2 where not null)
// f32 [R, inter/gsd] (rows of tiles past the last pair untouched). part
// holds R * splits * 2 * inter floats and cnt (inter / bc) * tiles ints,
// zero on entry and on return; both may be null with one split. 16-byte
// aligned w, s and z, 8-byte aligned qa and qb.
extern "C" int kt_w4a8_ffn_gemv(const void* qa, const void* qb,
                                const void* sa, const void* sb, const void* t,
                                const void* x, int x_dtype, const void* w,
                                const void* s, const void* ids, int r,
                                int tiles, int splits, int gran, int rb,
                                int k2, int inter, int ng, int gs2, int bc,
                                int act, void* part, void* cnt, void* ca,
                                void* cb, void* sa2, void* sb2, void* t2,
                                const void* xs, const void* z, void* xs2,
                                int gsd, void* stream) {
  namespace G = kt::w4gv;
  if (r <= 0) return 0;
  const uintptr_t a16 = (uintptr_t)w | (uintptr_t)s | (uintptr_t)z;
  const uintptr_t a8 = (uintptr_t)qa | (uintptr_t)qb;
  if (r > G::MAX_ROWS || tiles < 1 || tiles > 65535 || bc < 16 ||
      bc > G::BN / 2 || bc % 16 || inter % bc || gsd < 16 || gsd > bc ||
      bc % gsd || gsd % 2 || gs2 <= 0 ||
      gs2 % G::UNIT || k2 % gs2 || ng * gs2 != k2 || gran < 1 ||
      (k2 / G::UNIT) % gran || splits < 1 || splits > 65535 ||
      splits > k2 / G::UNIT / gran || act < 0 || act > 2 ||
      (splits > 1 && (part == nullptr || cnt == nullptr)) || (a16 & 15u) ||
      (x_dtype == X_CODES && ((a8 & 7u) || (z != nullptr && xs == nullptr))))
    return (int)cudaErrorInvalidValue;
  kt::W4A8Args a = make_args(qa, qb, sa, sb, t, xs, w, s, z, nullptr,
                             nullptr, nullptr, k2, 2 * inter, ng, gs2);
  a.x = x;
  return by_x_dtype<GemvUp>(
      x_dtype, rb, a, static_cast<const int*>(ids), r, tiles, inter, bc, gsd,
      act, splits, gran, static_cast<float*>(part), static_cast<int*>(cnt),
      static_cast<int8_t*>(ca), static_cast<int8_t*>(cb),
      static_cast<float*>(sa2), static_cast<float*>(sb2),
      static_cast<float*>(t2), static_cast<float*>(xs2),
      static_cast<cudaStream_t>(stream));
}

// gate_up + GLU + requant on the tensor cores (w4a8_ffn_mma_kernel): the
// operands of kt_w4a8_ffn_up with tiles of up to 64 rows and blocks of 128
// gate columns holding 128 / gsd down groups (gsd 128, 64, 32 or 16), the
// activations as x_dtype says (a folded launch quantizes each tile into an
// A tile of arows rows: a multiple of 16, at least every tile's rows). gs2
// = 64, 48, 16 or 8 (K2 a multiple of 32 at the last two), inter a
// multiple of 128, K2 of 16; 16-byte aligned qa and qb, w, s, z.
extern "C" int kt_w4a8_ffn_mma(const void* qa, const void* qb,
                               const void* sa, const void* sb, const void* t,
                               const void* x, int x_dtype, const void* w,
                               const void* s, const void* tile_expert,
                               const void* tile_row0, const void* tile_rows,
                               int ntiles, int arows, int k2, int inter,
                               int ng, int gs2, int act, void* ca, void* cb,
                               void* sa2, void* sb2, void* t2,
                               const void* xs, const void* z, void* xs2,
                               int gsd, void* stream) {
  if (ntiles <= 0) return 0;
  const uintptr_t align = (uintptr_t)w | (uintptr_t)s | (uintptr_t)z;
  const uintptr_t codes = (uintptr_t)qa | (uintptr_t)qb;
  const uintptr_t scales =
      (uintptr_t)sa | (uintptr_t)sb | (uintptr_t)t | (uintptr_t)xs;
  if (inter % kt::ffnmma::BC || k2 % 16 || ng * gs2 != k2 ||
      ntiles > 65535 || (align & 15u) ||
      (x_dtype == X_CODES && (codes & 15u || scales & 3u ||
                              (z != nullptr && xs == nullptr))))
    return (int)cudaErrorInvalidValue;
  kt::W4A8Args a = make_args(qa, qb, sa, sb, t, xs, w, s, z, tile_expert,
                             tile_row0, tile_rows, k2, 2 * inter, ng, gs2);
  a.x = x;
  return by_x_dtype<MmaUp>(
      x_dtype, a, ntiles, arows, inter, gsd, act, static_cast<int8_t*>(ca),
      static_cast<int8_t*>(cb), static_cast<float*>(sa2),
      static_cast<float*>(sb2), static_cast<float*>(t2),
      static_cast<float*>(xs2), static_cast<cudaStream_t>(stream));
}

// down dot over the requantized activation: same tiles as kt_w4a8_ffn_up
// (z: the down's zero points or null, xs the requant's group sums then).
extern "C" int kt_w4a8_ffn_down(const void* qa, const void* qb,
                                const void* sa, const void* sb, const void* t,
                                const void* w, const void* s,
                                const void* tile_expert,
                                const void* tile_row0, const void* tile_rows,
                                int ntiles, int mr, int k2, int n, int ng,
                                int gs2, int out_bf16, void* out,
                                const void* xs, const void* z,
                                void* stream) {
  if (z != nullptr && xs == nullptr) return (int)cudaErrorInvalidValue;
  kt::W4A8Args a = make_args(qa, qb, sa, sb, t, xs, w, s, z, tile_expert,
                             tile_row0, tile_rows, k2, n, ng, gs2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    return (int)kt::launch_rows(a, ntiles, mr,
                                static_cast<__nv_bfloat16*>(out), st);
  return (int)kt::launch_rows(a, ntiles, mr, static_cast<float*>(out), st);
}

// The GLU and the requant of an FFN whose down group no block holds
// (per-channel int4: all of I): h float32 [M, 2 inter] (the gate_up
// output, gate columns then up columns) -> a = glu(gate, up) quantized per
// (row, down group of gsd) into ca / cb int8 [M, inter/2] and sa2 / sb2 /
// t2 (xs2 where not null) f32 [M, inter/gsd], one block a (row, group)
// (w4a8_core.cuh:w4a8_prep_block_kernel).
extern "C" int kt_w4a8_glu_prep(const void* h, int m, int inter, int gsd,
                                int act, void* ca, void* cb, void* sa2,
                                void* sb2, void* t2, void* xs2,
                                void* stream) {
  if (m <= 0) return 0;
  if (act < 0 || act > 2 || gsd <= 0 || inter % gsd)
    return (int)cudaErrorInvalidValue;
  return (int)kt::launch_prep_block<float, true>(
      static_cast<const float*>(h), m, inter, gsd, act,
      static_cast<int8_t*>(ca), static_cast<int8_t*>(cb),
      static_cast<float*>(sa2), static_cast<float*>(sb2),
      static_cast<float*>(t2), static_cast<float*>(xs2),
      static_cast<cudaStream_t>(stream));
}
