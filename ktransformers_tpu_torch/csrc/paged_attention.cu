// Absorbed-MLA attention straight off a paged KV pool.
//
// Replaces ktransformers_tpu/ops/pallas/paged_attention.py:mla_paged_decode
// (body _mla_kernel) and :mla_paged_prefill (body _mla_prefill_kernel).
// Pools are ckv [P, page, R] and kpe [P, page, DR]; a sequence's token at
// position pos lives in row pos % page of page tables[b, pos / page].
//   score = (qn . ckv + qp . kpe) * scale,  value = ckv,
// so the output stays in the compressed space [.., R]. Rows at or past the
// live length are never read: pages are recycled without clearing and may
// hold anything. A query with no live key gives zeros.
//
// mla_paged_decode: one query token per sequence, `lengths` INCLUDES the
// current token (its KV is already in the pages). Bound: the bytes of the
// live rows, lengths[b] * (R + DR) elements. One block per (sequence, group
// of HG heads); its 8 warps stride over the live rows with the online
// softmax of online_softmax.cuh, each row's address taken through the page
// table. That kernel keeps float32 calls; bf16 calls take
// mla_paged_decode_split_kernel (the end of this file), which splits each
// sequence over blocks on the tensor cores.
//
// mla_paged_prefill: S new tokens per chunk, already written to the pages;
// `lengths` is the OLD cached length (chunk excluded), `valid` the live new
// tokens. Query row qs sees keys kpos <= lengths + qs and kpos < lengths +
// valid. Bound at the serving shapes: the f32 FMAs of the two products
// (operations, not bytes). One block per (chunk, head, tile of TQ query
// rows): the query tile sits in shared memory as f32; the block walks the
// keys in tiles of TK positions up to the tile's causal limit, staging each
// key tile (ckv | kpe as f32) in shared memory, and does
//   A: scores = Q K^T   (2x2 outputs a thread, float4 over the depth),
//   B: online softmax   (warp w owns rows 4w..4w+3, one key per lane),
//   C: acc += P V       (4 rows x 16 columns a thread, in registers).
// That kernel keeps float32 calls; bf16 calls take mla_prefill_mma_kernel
// (the end of this file) on the tensor cores.
// Shapes: R = 512, DR = 64, H a multiple of HG for decode.
#include "mla_mma.cuh"
#include "online_softmax.cuh"

namespace {

using namespace kt_mla;

template <typename T>
__global__ void __launch_bounds__(32 * NW)
    mla_paged_decode_kernel(const T* __restrict__ qn, const T* __restrict__ qp,
                            const T* __restrict__ ckv_pages,
                            const T* __restrict__ kpe_pages,
                            const int* __restrict__ tables,
                            const int* __restrict__ lengths, int H, int page,
                            int pmax, float scale, T* __restrict__ out) {
  __shared__ float qn_s[HG][R];
  __shared__ float qp_s[HG][DR];
  __shared__ float m_s[NW][HG];
  __shared__ float l_s[NW][HG];
  __shared__ float acc_s[HG][R];

  const int b = blockIdx.x;
  const int h0 = blockIdx.y * HG;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int len = max(0, min(lengths[b], page * pmax));
  const int* tb = tables + (size_t)b * pmax;

  for (int i = tid; i < HG * R; i += 32 * NW)
    qn_s[i / R][i % R] = to_f(qn[((size_t)b * H + h0) * R + i]);
  for (int i = tid; i < HG * DR; i += 32 * NW)
    qp_s[i / DR][i % DR] = to_f(qp[((size_t)b * H + h0) * DR + i]);
  __syncthreads();

  float qreg[HG][16];
  float preg[HG][2];
  load_query_regs(qn_s, qp_s, lane, qreg, preg);
  float m[HG], l[HG], acc[HG][16];
#pragma unroll
  for (int h = 0; h < HG; ++h) {
    m[h] = NEG_INF;
    l[h] = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[h][i] = 0.f;
  }
  for (int s = warp; s < len; s += NW) {
    const size_t row = (size_t)__ldg(tb + s / page) * page + (s % page);
    softmax_row(ckv_pages + row * R, kpe_pages + row * DR, lane, scale, qreg,
                preg, m, l, acc);
  }
  merge_and_store(m, l, acc, m_s, l_s, acc_s, out + ((size_t)b * H + h0) * R);
}

// ---- prefill ----

constexpr int TQ = 32;            // query rows per block
constexpr int TK = 32;            // key positions per staged tile
constexpr int LD = R + DR + 4;    // staged row stride in floats: LD / 4 odd,
                                  // so 8 rows' float4 reads hit 8 bank groups
constexpr int SLD = TK + 1;
constexpr int PREFILL_THREADS = 256;
constexpr size_t PREFILL_SMEM =
    (size_t)(TQ * LD + TK * LD + TQ * SLD + TK * TQ) * sizeof(float);

// Stage row `dst` (LD floats) from a ckv row [R] and a kpe row [DR]; one
// warp per row.
template <typename T>
__device__ __forceinline__ void stage_row(float* __restrict__ dst,
                                          const T* __restrict__ crow,
                                          const T* __restrict__ prow,
                                          int lane) {
  float c[16];
  load8(crow + 8 * lane, c);
  load8(crow + 256 + 8 * lane, c + 8);
  float4* d0 = reinterpret_cast<float4*>(dst + 8 * lane);
  float4* d1 = reinterpret_cast<float4*>(dst + 256 + 8 * lane);
  d0[0] = make_float4(c[0], c[1], c[2], c[3]);
  d0[1] = make_float4(c[4], c[5], c[6], c[7]);
  d1[0] = make_float4(c[8], c[9], c[10], c[11]);
  d1[1] = make_float4(c[12], c[13], c[14], c[15]);
  dst[R + 2 * lane] = to_f(prow[2 * lane]);
  dst[R + 2 * lane + 1] = to_f(prow[2 * lane + 1]);
}

__device__ __forceinline__ void zero_row(float* __restrict__ dst, int lane) {
  for (int i = lane; i < LD; i += 32) dst[i] = 0.f;
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  acc = fmaf(a.w, b.w, acc);
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(PREFILL_THREADS)
    mla_paged_prefill_kernel(const T* __restrict__ qn,
                             const T* __restrict__ qp,
                             const T* __restrict__ ckv_pages,
                             const T* __restrict__ kpe_pages,
                             const int* __restrict__ tables,
                             const int* __restrict__ lengths,
                             const int* __restrict__ valid, int H, int S,
                             int page, int pmax, float scale,
                             T* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                 // [TQ][LD]
  float* k_s = q_s + TQ * LD;        // [TK][LD]
  float* s_s = k_s + TK * LD;        // [TQ][SLD] scores
  float* pt_s = s_s + TQ * SLD;      // [TK][TQ] probabilities, transposed

  const int q0 = blockIdx.x * TQ;
  const int h = blockIdx.y;
  const int c = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int old_len = max(lengths[c], 0);
  const int total = min(old_len + max(valid[c], 0), page * pmax);
  const int* tb = tables + (size_t)c * pmax;
  const size_t qbase = ((size_t)c * H + h) * S;

  // query tile (rows past S are zero and never stored)
  for (int r = warp; r < TQ; r += PREFILL_THREADS / 32) {
    const int qs = q0 + r;
    if (qs < S)
      stage_row(q_s + r * LD, qn + (qbase + qs) * R, qp + (qbase + qs) * DR,
                lane);
    else
      zero_row(q_s + r * LD, lane);
  }

  // warp w owns rows 4w .. 4w+3 in phases B and C
  float m[4], l[4];
  float4 acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // every row of the tile sees the same keys up to the tile's causal limit
  const int q_last = min(q0 + TQ, S) - 1;
  const int limit = min(total, old_len + q_last + 1);
  const int ty = tid >> 4, tx = tid & 15;  // phase A: rows 2ty, 2ty+1;
                                           // keys tx, tx + 16

  for (int k0 = 0; k0 < limit; k0 += TK) {
    const int kmax = min(TK, limit - k0);
    __syncthreads();  // the previous tile's phase C is done with k_s
    for (int r = warp; r < TK; r += PREFILL_THREADS / 32) {
      if (r < kmax) {
        const int pos = k0 + r;
        const size_t row = (size_t)__ldg(tb + pos / page) * page + pos % page;
        stage_row(k_s + r * LD, ckv_pages + row * R, kpe_pages + row * DR,
                  lane);
      } else {
        zero_row(k_s + r * LD, lane);
      }
    }
    __syncthreads();

    // A: scores
    {
      float s00 = 0.f, s01 = 0.f, s10 = 0.f, s11 = 0.f;
      const float4* qa = reinterpret_cast<const float4*>(q_s + (2 * ty) * LD);
      const float4* qb =
          reinterpret_cast<const float4*>(q_s + (2 * ty + 1) * LD);
      const float4* ka = reinterpret_cast<const float4*>(k_s + tx * LD);
      const float4* kb = reinterpret_cast<const float4*>(k_s + (tx + 16) * LD);
#pragma unroll 4
      for (int d = 0; d < (R + DR) / 4; ++d) {
        const float4 a0 = qa[d], a1 = qb[d], b0 = ka[d], b1 = kb[d];
        s00 = dot4(a0, b0, s00);
        s01 = dot4(a0, b1, s01);
        s10 = dot4(a1, b0, s10);
        s11 = dot4(a1, b1, s11);
      }
      s_s[(2 * ty) * SLD + tx] = s00 * scale;
      s_s[(2 * ty) * SLD + tx + 16] = s01 * scale;
      s_s[(2 * ty + 1) * SLD + tx] = s10 * scale;
      s_s[(2 * ty + 1) * SLD + tx + 16] = s11 * scale;
    }
    __syncthreads();

    // B: online softmax, one key per lane
    float corr[4];
    const int kpos = k0 + lane;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * warp + i;
      const int qpos = old_len + q0 + r;
      const bool ok = kpos <= qpos && kpos < total && lane < kmax;
      const float sc = ok ? s_s[r * SLD + lane] : NEG_INF;
      const float m_new = fmaxf(m[i], warp_max(sc));
      const float p = expf(sc - m_new);
      corr[i] = expf(m[i] - m_new);
      l[i] = l[i] * corr[i] + warp_sum(p);
      m[i] = m_new;
      pt_s[lane * TQ + r] = p;
    }
    __syncwarp();

    // C: acc = acc * corr + P V; lane owns columns 4*lane + 128*j .. +3
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j].x *= corr[i];
        acc[i][j].y *= corr[i];
        acc[i][j].z *= corr[i];
        acc[i][j].w *= corr[i];
      }
    }
    for (int k = 0; k < kmax; ++k) {
      const float4 p4 =
          *reinterpret_cast<const float4*>(pt_s + k * TQ + 4 * warp);
      const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
      const float4* vrow = reinterpret_cast<const float4*>(k_s + k * LD);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 v = vrow[lane + 32 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][j].x = fmaf(pr[i], v.x, acc[i][j].x);
          acc[i][j].y = fmaf(pr[i], v.y, acc[i][j].y);
          acc[i][j].z = fmaf(pr[i], v.z, acc[i][j].z);
          acc[i][j].w = fmaf(pr[i], v.w, acc[i][j].w);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qs = q0 + 4 * warp + i;
    if (qs >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = out + (qbase + qs) * R;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      T* o = orow + 4 * lane + 128 * j;
      from_f(o, acc[i][j].x * inv);
      from_f(o + 1, acc[i][j].y * inv);
      from_f(o + 2, acc[i][j].z * inv);
      from_f(o + 3, acc[i][j].w * inv);
    }
  }
}

template <typename T>
int launch_prefill(const void* qn, const void* qp, const void* ckv,
                   const void* kpe, const int* tables, const int* lengths,
                   const int* valid, int C, int H, int S, int page, int pmax,
                   float scale, void* out, cudaStream_t st) {
  auto kernel = mla_paged_prefill_kernel<T>;
  // raise the dynamic shared memory limit once per instantiation (and per
  // device: the attribute belongs to the device's copy of the function)
  static int ready_dev = -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev != ready_dev) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)PREFILL_SMEM);
    if (err != cudaSuccess) return (int)err;
    ready_dev = dev;
  }
  dim3 grid((S + TQ - 1) / TQ, H, C);
  kernel<<<grid, PREFILL_THREADS, PREFILL_SMEM, st>>>(
      static_cast<const T*>(qn), static_cast<const T*>(qp),
      static_cast<const T*>(ckv), static_cast<const T*>(kpe), tables, lengths,
      valid, H, S, page, pmax, scale, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (qn, qp, both pools and out share it).
// qn [B, H, R], qp [B, H, DR], tables [B, pmax] int32, lengths [B] int32
// (valid KV length, current token included), out [B, H, R]. Returns the
// cudaError_t.
extern "C" int kt_mla_paged_decode(const void* qn, const void* qp,
                                   const void* ckv_pages,
                                   const void* kpe_pages, const void* tables,
                                   const void* lengths, int B, int H,
                                   int page, int pmax, float scale, int dtype,
                                   void* out, void* stream) {
  if (H % HG != 0 || page <= 0 || pmax <= 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  dim3 grid(B, H / HG);
  dim3 block(32 * NW);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lengths);
  if (dtype == 1) {
    using T = __nv_bfloat16;
    mla_paged_decode_kernel<T><<<grid, block, 0, st>>>(
        static_cast<const T*>(qn), static_cast<const T*>(qp),
        static_cast<const T*>(ckv_pages), static_cast<const T*>(kpe_pages),
        tb, ln, H, page, pmax, scale, static_cast<T*>(out));
  } else {
    mla_paged_decode_kernel<float><<<grid, block, 0, st>>>(
        static_cast<const float*>(qn), static_cast<const float*>(qp),
        static_cast<const float*>(ckv_pages),
        static_cast<const float*>(kpe_pages), tb, ln, H, page, pmax, scale,
        static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}

// qn [C, H, S, R], qp [C, H, S, DR], tables [C, pmax], lengths [C] OLD
// cached length, valid [C] live new tokens, out [C, H, S, R].
extern "C" int kt_mla_paged_prefill(const void* qn, const void* qp,
                                    const void* ckv_pages,
                                    const void* kpe_pages, const void* tables,
                                    const void* lengths, const void* valid,
                                    int C, int H, int S, int page, int pmax,
                                    float scale, int dtype, void* out,
                                    void* stream) {
  if (page <= 0 || pmax <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  if (C == 0 || H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lengths);
  const int* vl = static_cast<const int*>(valid);
  if (dtype == 1)
    return launch_prefill<__nv_bfloat16>(qn, qp, ckv_pages, kpe_pages, tb, ln,
                                         vl, C, H, S, page, pmax, scale, out,
                                         st);
  return launch_prefill<float>(qn, qp, ckv_pages, kpe_pages, tb, ln, vl, C, H,
                               S, page, pmax, scale, out, st);
}

// ---- mla_prefill_mma_kernel: the bf16 mla_paged_prefill on tensor cores ----
//
// Replaces ktransformers_tpu/ops/pallas/paged_attention.py:mla_paged_prefill
// (body _mla_prefill_kernel) for bf16 operands; computes what
// mla_paged_prefill_kernel computes. Bound at the serving shapes: the bf16
// operations of the two products (2 * H * live pairs * (2 R + DR)) against
// the bytes of the live rows. The first version ran one block per (chunk,
// head, 32 queries) on float32 FMAs, so every key tile was staged and
// converted once per head. Here, as in the Pallas kernel, a block's query
// rows are flattened (head, position) rows: RG heads x 16 positions (RG = 4:
// 64 rows, or 2: 32 rows, by ops/cuda/paged_attention.py:prefill_plan), one
// mma row group a head, so each staged key tile serves every head of the
// block (mla_mma.cuh: bf16 mma.sync for Q K^T over depth 576 and for P V,
// softmax in float32). A block walks the keys in tiles of TK positions (32
// at 4 heads, 64 at 2: the largest ring that fits beside the query rows)
// up to its causal limit min(live, old + last position + 1), each tile copied
// through the page table with 16-byte cp.async (rows past the limit
// zero-filled, never read) into a two-stage ring; query row qs sees kpos <=
// old + qs and kpos < old + valid. Position groups are numbered from the
// end of the chunk, so the blocks with the longest walks start first. Heads
// past H and positions past S are zero rows, never stored.
// Shared memory: RG = 4: queries 64 x 1168 B, ring 2 x 32 x 1168 B, scores
// 64 x 40 x 4 B: 156 KB; RG = 2: queries 32 rows, ring 2 x 64 rows, scores
// 32 x 72 x 4 B: 192 KB. One block an SM (RG = 4 holds 128 accumulators a
// thread). At RG = 2 the 64-key ring beat a 32-key one on the H100 at the
// mixed step's chunk (C = 1, S = 256 after 256).
namespace kt_mla_mma {
namespace prefill {

constexpr int PB = 16;  // query positions a block: one row group's rows

template <int RG, int TK>
__global__ void __launch_bounds__(THREADS, 1)
    mla_prefill_mma_kernel(const bf16* __restrict__ qn,
                           const bf16* __restrict__ qp,
                           const bf16* __restrict__ ckv_pages,
                           const bf16* __restrict__ kpe_pages,
                           const int* __restrict__ tables,
                           const int* __restrict__ lengths,
                           const int* __restrict__ valid, int H, int S,
                           int page, int pmax, float scale,
                           bf16* __restrict__ out) {
  using Tl = Tile<RG, TK>;
  extern __shared__ __align__(128) uint8_t smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = q_s + Tl::ROWS * LDS;
  float* s_s = reinterpret_cast<float*>(smem + Tl::Q_BYTES + 2 * Tl::K_BYTES);

  const int p0 = (gridDim.x - 1 - blockIdx.x) * PB;
  const int h0 = blockIdx.y * RG;
  const int c = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int rg = warp / Tl::CW, cw = warp % Tl::CW;
  const int old = max(lengths[c], 0);
  const int total = min(old + max(valid[c], 0), page * pmax);
  const int q_last = min(p0 + PB, S) - 1;
  const int limit = min(total, old + q_last + 1);
  const int nt = limit > 0 ? (limit + TK - 1) / TK : 0;
  const int* tb = tables + (size_t)c * pmax;

  State<RG, TK> st;
  st.clear();
  if (nt > 0) {
    // query row i: head h0 + i / PB, position p0 + i % PB
    stage_rows<Tl::ROWS>(q_s, [&](int i, const bf16*& cr, const bf16*& pr) {
      const int h = h0 + i / PB, qs = p0 + i % PB;
      const bool ok = h < H && qs < S;
      const size_t row = ok ? ((size_t)c * H + h) * S + qs : 0;
      cr = qn + row * R;
      pr = qp + row * DR;
      return ok;
    });
  }
  auto keys = [&](bf16* dst, int k0) {
    stage_rows<TK>(dst, [&](int r, const bf16*& cr, const bf16*& pr) {
      const int pos = k0 + r;
      const bool ok = pos < limit;
      const size_t row =
          ok ? (size_t)__ldg(tb + pos / page) * page + pos % page : 0;
      cr = ckv_pages + row * R;
      pr = kpe_pages + row * DR;
      return ok;
    });
  };
  if (nt > 0) keys(k_s, 0);
  kt_mma::cp_async_commit();
  int lim[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) lim[e] = min(total, old + p0 + g + 8 * e + 1);
  walk<RG, TK>(q_s, k_s, s_s, 0, nt, scale * LOG2E, lim, keys, st);

  const int h = h0 + rg;
  if (h >= H) return;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int qs = p0 + g + 8 * e;
    if (qs >= S) continue;
    const float inv = 1.f / fmaxf(st.l[e], 1e-30f);
    bf16* o = out + (((size_t)c * H + h) * S + qs) * R + cw * Tl::COLS + 2 * q;
#pragma unroll
    for (int t = 0; t < Tl::NTO; ++t)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * t) = __floats2bfloat162_rn(
          st.acc[t][2 * e] * inv, st.acc[t][2 * e + 1] * inv);
  }
}

template <int RG, int TK>
int launch(const void* qn, const void* qp, const void* ckv, const void* kpe,
           const int* tables, const int* lengths, const int* valid, int C,
           int H, int S, int page, int pmax, float scale, void* out,
           cudaStream_t st) {
  auto kernel = mla_prefill_mma_kernel<RG, TK>;
  constexpr int smem = Tile<RG, TK>::SMEM;
  static int ready_dev = -1;
  cudaError_t err = kt_mma::allow_smem(kernel, smem, &ready_dev);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + PB - 1) / PB, (H + RG - 1) / RG, C);
  kernel<<<grid, THREADS, smem, st>>>(
      static_cast<const bf16*>(qn), static_cast<const bf16*>(qp),
      static_cast<const bf16*>(ckv), static_cast<const bf16*>(kpe), tables,
      lengths, valid, H, S, page, pmax, scale, static_cast<bf16*>(out));
  return (int)cudaGetLastError();
}

}  // namespace prefill
}  // namespace kt_mla_mma

// The bf16 mla_paged_prefill on mla_prefill_mma_kernel: operands as
// kt_mla_paged_prefill (bf16 only); rg = 4 heads a block (32-key tiles) or
// 2 (64-key tiles).
extern "C" int kt_mla_prefill_mma(const void* qn, const void* qp,
                                  const void* ckv_pages,
                                  const void* kpe_pages, const void* tables,
                                  const void* lengths, const void* valid,
                                  int C, int H, int S, int page, int pmax,
                                  float scale, int rg, void* out,
                                  void* stream) {
  if (page <= 0 || pmax <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  if (C == 0 || H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lengths);
  const int* vl = static_cast<const int*>(valid);
  if (rg == 4)
    return kt_mla_mma::prefill::launch<4, 32>(qn, qp, ckv_pages, kpe_pages,
                                              tb, ln, vl, C, H, S, page, pmax,
                                              scale, out, st);
  if (rg == 2)
    return kt_mla_mma::prefill::launch<2, 64>(qn, qp, ckv_pages, kpe_pages,
                                              tb, ln, vl, C, H, S, page, pmax,
                                              scale, out, st);
  return (int)cudaErrorInvalidValue;
}

// ---- mla_paged_decode_split_kernel: the bf16 mla_paged_decode, split over
// the pages ----
//
// Replaces ktransformers_tpu/ops/pallas/paged_attention.py:mla_paged_decode
// (body _mla_kernel) for bf16 operands; computes what
// mla_paged_decode_kernel computes. Bound: the bytes of the live rows,
// lengths[b] * (R + DR) * 2, read once. The first version ran one block per
// (sequence, 4 heads), 32 blocks at the serving batch of 8 x 16 heads for
// 132 SMs, each walking every live row of its sequence on float32 FMAs and
// each row read once per head group: the longest sequence set the time.
// Here, as mla_decode.cu's mla_decode_split_kernel without its
// current-token block (the current token is already in the pages):
// - the grid is (B, splits, ceil(H / 16)). Block (b, s, t) takes the
//   positions [s * span, (s + 1) * span) of sequence b, cut at lengths[b],
//   for the 16 heads 16 t .. 16 t + 15 (missing heads zero rows), so each
//   row is read once a head tile; (splits, span) is
//   ops/cuda/mla_decode.py:decode_split_plan over the pool's pmax * page
//   positions, a pure function of the shapes: lengths stay on the card;
// - the 16 heads are the 16 rows of one mma.sync tile (mla_mma.cuh, RG =
//   1): tiles of 64 positions, each row's [ckv | kpe] copied through the
//   page table with 16-byte cp.async into a two-stage ring, rows past the
//   split's end zero-filled and never read (recycled pages may hold NaN);
// - a block with a row writes (m, l, acc[16][512]) to its record of part
//   and every block arrives on the (sequence, head tile) counter; the last
//   to arrive merges the splits that start below lengths[b] in split order
//   (weights exp2(m_i - M) / L; none: zeros) and sets the counter back.
//   One launch, the same bits on every call.
// Shared memory: query rows 16 x 1168 B, the ring 2 x 64 x 1168 B, scores
// 16 x 72 x 4 B, the merge weights 2 KB: 171 KB, one block an SM. ptxas
// (sm_90a): 132 registers, no spill.
namespace kt_mla_mma {
namespace split {

constexpr int PAGED_SMEM = Tl::SMEM + W_FLOATS * 4;

__global__ void __launch_bounds__(THREADS, 1)
    mla_paged_decode_split_kernel(const bf16* __restrict__ qn,
                                  const bf16* __restrict__ qp,
                                  const bf16* __restrict__ ckv_pages,
                                  const bf16* __restrict__ kpe_pages,
                                  const int* __restrict__ tables,
                                  const int* __restrict__ lengths, int H,
                                  int page, int pmax, int span, float scale,
                                  float* __restrict__ part,
                                  int* __restrict__ cnt,
                                  bf16* __restrict__ out) {
  extern __shared__ __align__(128) uint8_t smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = q_s + Tl::ROWS * LDS;
  float* s_s = reinterpret_cast<float*>(smem + Tl::Q_BYTES + 2 * Tl::K_BYTES);
  float* w_s = reinterpret_cast<float*>(smem + Tl::SMEM);

  const int b = blockIdx.x, sp = blockIdx.y, ht = blockIdx.z;
  const int splits = gridDim.y;
  const int h0 = ht * HT;
  const int nh = min(HT, H - h0);
  const int len = min(max(lengths[b], 0), page * pmax);
  const int start = sp * span;
  const int end = min(len, start + span);
  const int nt = end > start ? (end - start + TK - 1) / TK : 0;
  const int* tb = tables + (size_t)b * pmax;
  const size_t pair = (size_t)b * gridDim.z + ht;
  float* base = part + pair * splits * REC;

  if (nt > 0) {
    stage_rows<HT>(q_s, [&](int i, const bf16*& cr, const bf16*& pr) {
      const bool ok = i < nh;
      const size_t row = (size_t)b * H + h0 + (ok ? i : 0);
      cr = qn + row * R;
      pr = qp + row * DR;
      return ok;
    });
    auto keys = [&](bf16* dst, int k0) {
      stage_rows<TK>(dst, [&](int r, const bf16*& cr, const bf16*& pr) {
        const int pos = k0 + r;
        const bool ok = pos < end;
        const size_t row =
            ok ? (size_t)__ldg(tb + pos / page) * page + pos % page : 0;
        cr = ckv_pages + row * R;
        pr = kpe_pages + row * DR;
        return ok;
      });
    };
    keys(k_s, start);
    kt_mma::cp_async_commit();
    State<1, TK> st;
    st.clear();
    const int lim[2] = {end, end};
    walk<1, TK>(q_s, k_s, s_s, start, nt, scale * LOG2E, lim, keys, st);
    store_state(st, base + (size_t)sp * REC);
  }
  if (!arrive_last(cnt + pair, splits)) return;
#if !KT_MLA_CUT_MERGE  // ops/cuda/breakdown.py: the merge compiled out
  merge_states(base, min(splits, (len + span - 1) / span),
               [](int i) { return i; }, w_s, nh,
               out + ((size_t)b * H + h0) * R);
#endif
  if (threadIdx.x == 0) cnt[pair] = 0;  // ready for the next launch
}

}  // namespace split
}  // namespace kt_mla_mma

// The bf16 mla_paged_decode on mla_paged_decode_split_kernel: operands as
// kt_mla_paged_decode (bf16 only, any H); `splits` blocks of `span`
// positions a sequence and head tile (splits * span >= page * pmax, 1 <=
// splits <= MAX_SPLITS); part holds B * ceil(H / 16) * splits * REC
// floats, cnt B * ceil(H / 16) ints, zero on entry (left zero).
extern "C" int kt_mla_paged_decode_split(const void* qn, const void* qp,
                                         const void* ckv_pages,
                                         const void* kpe_pages,
                                         const void* tables,
                                         const void* lengths, int B, int H,
                                         int page, int pmax, int splits,
                                         int span, float scale, void* part,
                                         void* cnt, void* out, void* stream) {
  namespace K = kt_mla_mma::split;
  if (H <= 0 || page <= 0 || pmax <= 0 || splits < 1 ||
      splits > K::MAX_SPLITS || span <= 0 ||
      (long long)splits * span < (long long)page * pmax || part == nullptr ||
      cnt == nullptr)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  static int ready_dev = -1;
  cudaError_t err = kt_mma::allow_smem(K::mla_paged_decode_split_kernel,
                                       K::PAGED_SMEM, &ready_dev);
  if (err != cudaSuccess) return (int)err;
  using T = __nv_bfloat16;
  dim3 grid(B, splits, (H + K::HT - 1) / K::HT);
  K::mla_paged_decode_split_kernel<<<grid, kt_mla_mma::THREADS, K::PAGED_SMEM,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(qn), static_cast<const T*>(qp),
      static_cast<const T*>(ckv_pages), static_cast<const T*>(kpe_pages),
      static_cast<const int*>(tables), static_cast<const int*>(lengths), H,
      page, pmax, span, scale, static_cast<float*>(part),
      static_cast<int*>(cnt), static_cast<T*>(out));
  return (int)cudaGetLastError();
}
