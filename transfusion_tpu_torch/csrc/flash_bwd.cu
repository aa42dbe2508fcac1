// Flash-attention backward with the transfusion mask, for Hopper (sm_90a).
//
// Replaces the Pallas TPU backwards of transfusion_tpu/ops/pallas_attn_kernel.py
// (rows 6-9 of PERF.md's kernel table):
//   * `_bwd_kernel_batched_nhd` (row 6): token-major [b, n, h*d] operands,
//     RoPE fused on q/k, dq/dk un-rotated on store;
//   * `_bwd_kernel_batched_heads` (row 7), `_bwd_dkv_kernel` +
//     `_bwd_dq_kernel` (row 8) and, above n*d = 8192*64,
//     `_flash_bwd_streamed` -> `_bwd_dkv_kernel_streamed` +
//     `_bwd_dq_kernel_streamed` (row 9): head-major [b, h, n, d], q/kv
//     offsets, lse cotangent.
// The TPU splits them by what fits in VMEM (a full n x n score matrix per
// grid step, blocks with one [n, d] pair resident, or every operand
// streamed through the grid); here every tile is streamed from device
// memory, so one design meets all four contracts, at any length (64-bit
// offsets; shared memory does not grow with n):
//
//   s  = cap * tanh((q * scale) . k / cap)            scale = d^-1/2
//   p  = allowed(i, j) ? exp(s - lse_i) : 0           (lse from the forward)
//   dv = p^T dO        dp = dO v^T
//   ds = p * (dp - delta_i) * (1 - (s / cap)^2)       delta = rowsum(dO o) - g_lse
//   dk = ds^T (q * scale)        dq = (ds k) * scale
//
// with allowed(i, j) = i >= j | any_m[len_m > 0 & i >= off_m & j < off_m + len_m]
// at global coordinates i = q_off + row, j = kv_off + col. `where(allowed)`
// rather than exp(masked - lse): a row that sees no column has lse ~ -1e30
// and exp(-1e30 + 1e30) = 1 would leak gradient into it (`:550-553`); such a
// row gets dq = 0 and adds nothing to dk/dv. delta (with the lse cotangent
// folded in, `:591-593`) is computed by the caller in PyTorch.
//
// What bounds it on the H100: operations. Five products of n x n x d per
// head (s, dp, dv, dk, dq) over ~8 b h n d elements of traffic: at d >= 64
// and the long causal path that is far above the 295 FLOP/byte ridge. Once
// the products run on the tensor cores, the per-pair float32 work (tanh,
// exp, the chain rule, the mask) costs about as much as the products.
//
// bf16 (every training path): tensor cores, in namespace `tc` below.
//   * One block per (b*h, 64-row kv tile) holds K and V and walks the
//     64-row q tiles that can see it (from the first that causality or a
//     span's rectangle reaches, `:646-655`), skipping tiles with no
//     visible pair. Q, K, V and dO tiles sit in shared memory as bf16
//     (16-byte row pad: ldmatrix without bank conflicts), filled by 16-byte
//     cp.async copies into two buffers, so the next Q / dO tile streams in
//     while the current one is consumed; rows past n are zero-filled. Under
//     RoPE, q and k go through registers instead (rotated in float32 and
//     rounded to bf16 as the forward does; the partner column 2j^1 is in
//     the same 16 bytes).
//   * Every product is mma.sync m16n8k16 (bf16 -> float32), five per
//     visible pair: s^T = K Q^T and dp^T = V dO^T; p^T and ds^T, rounded to
//     bf16, are already the A operand of dV += p^T dO and dK += ds^T Q
//     (FlashAttention-2's register reuse; dO and Q read with
//     ldmatrix.trans); ds^T goes to shared memory, and dQ += ds K of the q
//     tile (ds read back transposed) is added into a float32 [b, h, nq, d]
//     scratch with 8-byte atomics. `flash_bwd_dq_store` then scales it,
//     un-rotates it under RoPE and writes dq in its layout. The order of the
//     atomic additions, and so dq's last bits, varies from run to run.
//   * Scales act on float32 sums, never on a bf16 operand (d^-1/2 is not a
//     power of two at d 32): s = scale (q.k), dk = scale (ds^T q),
//     dq = scale (ds k). dq/dk are un-rotated from the accumulator
//     fragment, which holds columns 2c and 2c+1 in one thread.
//   * One elementwise pass per pair: tanh once (tanh.approx on the
//     special-function unit; the chain reuses it), exp as exp2 of
//     (s - lse) log2 e. The mask is evaluated per element only on tiles
//     that hold a masked pair, in the fragment's own coordinates; tiles
//     that causality makes full skip the span loop. Where dp - delta
//     cancels to within 2^-10 (a row that sees one key, or keys of equal
//     v), ds is float32 rounding noise; that dp is then taken from
//     sequential float32 FMAs, as the plain version's product takes it,
//     so that the noise agrees with the plain version's.
//   * A warp owns 16 kv rows (4 warps; at d 128 8 warps, two per 16 rows,
//     each holding half of the columns of dK, dV and dQ, so that no
//     register spills). The grid is one-dimensional, (b*h) fastest: kv
//     tile 0 of every head, the longest walk under causality, starts first.
//
// float32 (the card-vs-CPU checks at 1e-4): the first version's FMA kernels,
// unchanged: float32 products from shared memory, no tensor cores (TF32
// would keep ~3 decimal digits), deterministic. Two kernels, no atomics:
//   flash_bwd_dkv: one block per (b*h, 64-row kv tile); loops over the q
//     tiles from the first that can see the kv tile (causality, or a span
//     whose rectangle reaches it, `:646-655`) to the end, skipping tiles
//     with no visible pair; accumulates dk and dv in registers.
//   flash_bwd_dq: one block per (b*h, 64-row q tile); loops over the kv tiles
//     up to the last one visible (as the forward), accumulates dq.
// Both recompute p from the forward's lse. q is scaled in float32, dq again
// at the end. With cos/sin, q and k are rotated on load and dq/dk
// un-rotated with the negated sin before the store (`:1408-1410`): the
// partner column 2j^1 lives in the neighbouring lane, one shuffle away.

#include <algorithm>
#include <type_traits>

#include "attn_tile.cuh"
#include "mma_tile.cuh"

using namespace attn_tile;

namespace {

constexpr int RPT = 4;
constexpr int BQ = 16 * RPT;  // 64 q rows per tile
constexpr int BKV = BK;       // 64 kv rows per tile
constexpr int PS = BKV + 1;   // padded stride of the p / ds tiles
constexpr int MAX_SPANS = 128;

struct Params {
  const void *q, *k, *v, *dout;
  const float *lse, *delta, *cos, *sin;
  const int* spans;
  void *dq, *dk, *dv;
  int m, H, nq, nkv, q_off, kv_off, nhd;
  float scale, softcap;
};

// s[r][j] = A[ty*RPT + r] . B[tx + 16 j]; A, B tiles of row stride D + 1
template <int D>
__device__ __forceinline__ void dot_tile(const float* A, const float* B, float (&s)[RPT][4],
                                         int tx, int ty) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[r][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const float a = A[(ty * RPT + r) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) s[r][j] = fmaf(a, b[j], s[r][j]);
    }
  }
}

// acc[r][c] += sum_k P[ty*RPT + r][k] * M[k][tx + 16 c]; P of stride PS,
// M of stride D + 1, k over the 64 rows of M
template <int D>
__device__ __forceinline__ void acc_tile(const float* P, const float* M,
                                         float (&acc)[RPT][D / 16], int tx, int ty) {
  constexpr int LD = D + 1;
#pragma unroll 4
  for (int k = 0; k < 64; ++k) {
    float mv[D / 16];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) mv[c] = M[k * LD + tx + 16 * c];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const float p = P[(ty * RPT + r) * PS + k];
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[r][c] = fmaf(p, mv[c], acc[r][c]);
    }
  }
}

// Load rows [r0, r0 + 64) of one head into a tile of stride D + 1, as
// float32: RoPE-rotated and rounded to T when ROPE (angles of row r at
// cs + (bi * n + r) * D), times `mul`; rows >= n are zero.
template <typename T, int D, bool ROPE>
__device__ __forceinline__ void load_tile(float* dst, const T* base, size_t rs, int r0, int n,
                                          const float* cs, const float* sn, int bi,
                                          float mul) {
  constexpr int LD = D + 1;
  for (int e = threadIdx.x; e < 64 * D; e += NT) {
    const int r = e / D, c = e - r * D, g = r0 + r;
    float x = 0.f;
    if (g < n) {
      const size_t a = (size_t(bi) * n + g) * D;
      x = rope_load(base + size_t(g) * rs, c, ROPE ? cs + a : nullptr,
                    ROPE ? sn + a : nullptr) * mul;
    }
    dst[r * LD + c] = x;
  }
}

__device__ __forceinline__ bool allowed(int i, int j, const int* sp_off, const int* sp_len,
                                        int m) {
  bool ok = i >= j;
  for (int s = 0; s < m; ++s) ok = ok || (sp_len[s] > 0 && i >= sp_off[s] && j < sp_off[s] + sp_len[s]);
  return ok;
}

// any pair of the (q rows [qs, qe], kv cols [kg, kg + 63]) tile visible /
// every pair visible (global coordinates)
__device__ __forceinline__ void tile_visibility(int qs, int qe, int kg, const int* sp_off,
                                                const int* sp_len, int m, bool& any,
                                                bool& full) {
  any = qe >= kg;
  full = qs >= kg + BKV - 1;
  for (int s = 0; s < m; ++s) {
    const int off = sp_off[s], ln = sp_len[s];
    if (ln <= 0) continue;
    any = any || (qe >= off && kg < off + ln);
    full = full || (qs >= off && kg + BKV - 1 < off + ln);
  }
}

// p and ds of this thread's 4 x 4 pairs of one tile, from the raw scores
// s and dp, the visibility `ok` and each pair's q-row lse and delta.
// Writes p, and ds over s.
__device__ __forceinline__ void grad_scores(float (&s)[RPT][4], const float (&dp)[RPT][4],
                                            const bool (&ok)[RPT][4],
                                            const float (&lse)[RPT][4],
                                            const float (&delta)[RPT][4], float softcap,
                                            float (&p)[RPT][4]) {
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float x = s[r][j], chain = 1.f;
      if (softcap > 0.f) {
        x = tanhf(x / softcap) * softcap;
        const float t = x / softcap;
        chain = 1.f - t * t;
      }
      const float pr = ok[r][j] ? expf(x - lse[r][j]) : 0.f;
      p[r][j] = pr;
      s[r][j] = pr * (dp[r][j] - delta[r][j]) * chain;  // ds
    }
}

// Un-rotate acc (columns tx + 16 c of this thread's rows) with the inverse
// RoPE: out = x cos - rot(x) sin. The partner column c ^ 1 sits in lane
// tx ^ 1 of the same row group; every thread takes part in the shuffle.
template <int D>
__device__ __forceinline__ void unrotate(float (&acc)[RPT][D / 16], const float* cs,
                                         const float* sn, int bi, int n, int row0, int tx,
                                         int ty) {
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int g = row0 + ty * RPT + r;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const float x = acc[r][c];
      const float partner = __shfl_xor_sync(0xffffffffu, x, 1);
      const int col = tx + 16 * c;
      if (g < n) {
        const size_t a = (size_t(bi) * n + g) * D + col;
        const float rot = (col & 1) ? partner : -partner;
        acc[r][c] = x * cs[a] - rot * sn[a];
      }
    }
  }
}

template <typename T, int D>
__device__ __forceinline__ void store_rows(T* base, size_t rs, const float (&acc)[RPT][D / 16],
                                           int row0, int n, int tx, int ty) {
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int g = row0 + ty * RPT + r;
    if (g >= n) continue;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) base[size_t(g) * rs + tx + 16 * c] = from_f<T>(acc[r][c]);
  }
}

template <int D>
struct Smem {
  static constexpr int LD = D + 1;
  // dkv: K, V, Q, dO tiles + p, ds tiles; dq: Q, dO, K, V tiles + ds tile
  static constexpr size_t kFloats = 4 * size_t(64) * LD + 2 * size_t(64) * PS + 2 * 64;
  static constexpr size_t kBytes = kFloats * sizeof(float) + 2 * MAX_SPANS * sizeof(int);
};

__device__ __forceinline__ void load_spans(const Params& P, int bi, int* sp_off, int* sp_len) {
  for (int s = threadIdx.x; s < P.m; s += NT) {
    sp_off[s] = P.spans[(size_t(bi) * P.m + s) * 3 + 1];
    sp_len[s] = P.spans[(size_t(bi) * P.m + s) * 3 + 2];
  }
}

template <typename T, int D, bool ROPE>
__global__ void __launch_bounds__(NT) flash_bwd_dkv(const Params P) {
  constexpr int LD = D + 1, DC = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + 64 * LD;
  float* Qs = Vs + 64 * LD;
  float* dOs = Qs + 64 * LD;
  float* Ps = dOs + 64 * LD;
  float* dSs = Ps + 64 * PS;
  float* lse_s = dSs + 64 * PS;
  float* delta_s = lse_s + 64;
  int* sp_off = reinterpret_cast<int*>(delta_s + 64);
  int* sp_len = sp_off + MAX_SPANS;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int H = P.H, nq = P.nq, nkv = P.nkv, m = P.m;
  const int bh = blockIdx.y, bi = bh / H, head = bh - bi * H;
  const int k0 = blockIdx.x * BKV, kg = k0 + P.kv_off;
  const size_t rs = row_stride(P.nhd, H, D);
  const T* qb = static_cast<const T*>(P.q) + head_base(P.nhd, bi, head, H, nq, D);
  const T* ob = static_cast<const T*>(P.dout) + head_base(P.nhd, bi, head, H, nq, D);
  const T* kb = static_cast<const T*>(P.k) + head_base(P.nhd, bi, head, H, nkv, D);
  const T* vb = static_cast<const T*>(P.v) + head_base(P.nhd, bi, head, H, nkv, D);
  const float* lse = P.lse + size_t(bh) * nq;
  const float* delta = P.delta + size_t(bh) * nq;

  load_spans(P, bi, sp_off, sp_len);
  load_tile<T, D, ROPE>(Ks, kb, rs, k0, nkv, P.cos, P.sin, bi, 1.f);
  load_tile<T, D, false>(Vs, vb, rs, k0, nkv, nullptr, nullptr, bi, 1.f);
  __syncthreads();

  // first global q row that can see this kv tile: causally kg, or the
  // offset of any span whose rectangle (rows >= off, cols < off + len)
  // reaches the tile
  int lo_tok = kg;
  for (int s = 0; s < m; ++s) {
    const int off = sp_off[s], ln = sp_len[s];
    if (ln > 0 && kg < off + ln && kg + BKV - 1 >= off) lo_tok = min(lo_tok, off);
  }
  const int lo = lo_tok - P.q_off <= 0 ? 0 : (lo_tok - P.q_off) / BQ;
  const int n_q_tiles = (nq + BQ - 1) / BQ;

  float dk[RPT][DC], dv[RPT][DC];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[r][c] = dv[r][c] = 0.f;

  for (int iq = lo; iq < n_q_tiles; ++iq) {
    const int q0 = iq * BQ, qs = q0 + P.q_off, qe = min(q0 + BQ, nq) - 1 + P.q_off;
    bool any, full;
    tile_visibility(qs, qe, kg, sp_off, sp_len, m, any, full);
    if (!any) continue;  // uniform across the block
    full = full && q0 + BQ <= nq && k0 + BKV <= nkv;

    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D, ROPE>(Qs, qb, rs, q0, nq, P.cos, P.sin, bi, P.scale);
    load_tile<T, D, false>(dOs, ob, rs, q0, nq, nullptr, nullptr, bi, 1.f);
    if (tid < 64) {
      const bool in = q0 + tid < nq;
      lse_s[tid] = in ? lse[q0 + tid] : 0.f;
      delta_s[tid] = in ? delta[q0 + tid] : 0.f;
    }
    __syncthreads();

    // transposed scores: rows are this thread's kv rows, columns q rows
    float s[RPT][4], dp[RPT][4], p[RPT][4], l[RPT][4], dl[RPT][4];
    bool ok[RPT][4];
    dot_tile<D>(Ks, Qs, s, tx, ty);
    dot_tile<D>(Vs, dOs, dp, tx, ty);
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int jl = k0 + ty * RPT + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int il = q0 + tx + 16 * j;
        ok[r][j] = full || (il < nq && jl < nkv &&
                            allowed(il + P.q_off, jl + P.kv_off, sp_off, sp_len, m));
        l[r][j] = lse_s[tx + 16 * j];
        dl[r][j] = delta_s[tx + 16 * j];
      }
    }
    grad_scores(s, dp, ok, l, dl, P.softcap, p);
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        Ps[(ty * RPT + r) * PS + tx + 16 * j] = p[r][j];
        dSs[(ty * RPT + r) * PS + tx + 16 * j] = s[r][j];
      }
    __syncthreads();
    acc_tile<D>(Ps, dOs, dv, tx, ty);   // dv += p^T dO
    acc_tile<D>(dSs, Qs, dk, tx, ty);   // dk += ds^T (q * scale)
  }

  if (ROPE) unrotate<D>(dk, P.cos, P.sin, bi, nkv, k0, tx, ty);
  store_rows<T, D>(static_cast<T*>(P.dk) + head_base(P.nhd, bi, head, H, nkv, D), rs, dk, k0,
                   nkv, tx, ty);
  store_rows<T, D>(static_cast<T*>(P.dv) + head_base(P.nhd, bi, head, H, nkv, D), rs, dv, k0,
                   nkv, tx, ty);
}

template <typename T, int D, bool ROPE>
__global__ void __launch_bounds__(NT) flash_bwd_dq(const Params P) {
  constexpr int LD = D + 1, DC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + 64 * LD;
  float* Ks = dOs + 64 * LD;
  float* Vs = Ks + 64 * LD;
  float* dSs = Vs + 64 * LD;
  float* lse_s = dSs + 2 * 64 * PS;
  float* delta_s = lse_s + 64;
  int* sp_off = reinterpret_cast<int*>(delta_s + 64);
  int* sp_len = sp_off + MAX_SPANS;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int H = P.H, nq = P.nq, nkv = P.nkv, m = P.m;
  const int bh = blockIdx.y, bi = bh / H, head = bh - bi * H;
  const int q0 = blockIdx.x * BQ;
  const size_t rs = row_stride(P.nhd, H, D);
  const T* qb = static_cast<const T*>(P.q) + head_base(P.nhd, bi, head, H, nq, D);
  const T* ob = static_cast<const T*>(P.dout) + head_base(P.nhd, bi, head, H, nq, D);
  const T* kb = static_cast<const T*>(P.k) + head_base(P.nhd, bi, head, H, nkv, D);
  const T* vb = static_cast<const T*>(P.v) + head_base(P.nhd, bi, head, H, nkv, D);

  load_spans(P, bi, sp_off, sp_len);
  load_tile<T, D, ROPE>(Qs, qb, rs, q0, nq, P.cos, P.sin, bi, P.scale);
  load_tile<T, D, false>(dOs, ob, rs, q0, nq, nullptr, nullptr, bi, 1.f);
  if (tid < 64) {
    const bool in = q0 + tid < nq;
    lse_s[tid] = in ? P.lse[size_t(bh) * nq + q0 + tid] : 0.f;
    delta_s[tid] = in ? P.delta[size_t(bh) * nq + q0 + tid] : 0.f;
  }
  __syncthreads();

  const int qs = q0 + P.q_off, qe = min(q0 + BQ, nq) - 1 + P.q_off;
  int hi_tok = qe;
  for (int s = 0; s < m; ++s)
    if (sp_len[s] > 0 && qe >= sp_off[s]) hi_tok = max(hi_tok, sp_off[s] + sp_len[s] - 1);
  const int n_kv_tiles = (nkv + BKV - 1) / BKV;
  const int hi = hi_tok < P.kv_off ? 0 : min((hi_tok - P.kv_off) / BKV + 1, n_kv_tiles);

  float l[RPT][4], dl[RPT][4];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      l[r][j] = lse_s[ty * RPT + r];
      dl[r][j] = delta_s[ty * RPT + r];
    }

  float dq[RPT][DC];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) dq[r][c] = 0.f;

  for (int it = 0; it < hi; ++it) {
    const int k0 = it * BKV, kg = k0 + P.kv_off;
    bool any, full;
    tile_visibility(qs, qe, kg, sp_off, sp_len, m, any, full);
    if (!any) continue;  // uniform across the block
    full = full && q0 + BQ <= nq && k0 + BKV <= nkv;

    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D, ROPE>(Ks, kb, rs, k0, nkv, P.cos, P.sin, bi, 1.f);
    load_tile<T, D, false>(Vs, vb, rs, k0, nkv, nullptr, nullptr, bi, 1.f);
    __syncthreads();

    float s[RPT][4], dp[RPT][4], p[RPT][4];
    bool ok[RPT][4];
    dot_tile<D>(Qs, Ks, s, tx, ty);
    dot_tile<D>(dOs, Vs, dp, tx, ty);
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int il = q0 + ty * RPT + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int jl = k0 + tx + 16 * j;
        ok[r][j] = full || (il < nq && jl < nkv &&
                            allowed(il + P.q_off, jl + P.kv_off, sp_off, sp_len, m));
      }
    }
    grad_scores(s, dp, ok, l, dl, P.softcap, p);
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) dSs[(ty * RPT + r) * PS + tx + 16 * j] = s[r][j];
    __syncthreads();
    acc_tile<D>(dSs, Ks, dq, tx, ty);  // dq += ds k
  }

#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) dq[r][c] *= P.scale;
  if (ROPE) unrotate<D>(dq, P.cos, P.sin, bi, nq, q0, tx, ty);
  store_rows<T, D>(static_cast<T*>(P.dq) + head_base(P.nhd, bi, head, H, nq, D), rs, dq, q0, nq,
                   tx, ty);
}

template <typename T, int D>
int launch(const Params& P, int b, cudaStream_t stream) {
  const int smem = int(Smem<D>::kBytes);
  const bool rope = P.cos != nullptr;  // a template flag: no branch in the loads
  auto dkv = rope ? flash_bwd_dkv<T, D, true> : flash_bwd_dkv<T, D, false>;
  auto dq = rope ? flash_bwd_dq<T, D, true> : flash_bwd_dq<T, D, false>;
  cudaError_t err = cudaFuncSetAttribute(dkv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  dkv<<<dim3((P.nkv + BKV - 1) / BKV, b * P.H), NT, smem, stream>>>(P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  dq<<<dim3((P.nq + BQ - 1) / BQ, b * P.H), NT, smem, stream>>>(P);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch_d(int d, const Params& P, int b, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(P, b, stream);
    case 64:
      return launch<T, 64>(P, b, stream);
    case 128:
      return launch<T, 128>(P, b, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (see the note at the top)
// ---------------------------------------------------------------------------

namespace tc {

using namespace mma_tile;
using bf16 = __nv_bfloat16;

constexpr int TB = 64;  // q rows and kv rows per tile
constexpr float LOG2E = 1.4426950408889634f;
static_assert(TB == BKV, "tile_visibility takes 64 kv columns");

template <int D>
struct Lay {
  static constexpr int LD = D + 8;    // padded bf16 row stride of a [64][D] tile
  static constexpr int TILE = TB * LD;
  static constexpr int SLD = TB + 8;  // row stride of the ds^T tile
  // warps per 16 kv rows: each computes those rows' s^T and dp^T and owns
  // DW = D / DS columns of dK, dV and dQ. At d 128 two such warps keep
  // their sums beside the score fragments in registers without spilling.
  static constexpr int DS = D > 64 ? 2 : 1;
  static constexpr int DW = D / DS;
  static constexpr int TT = 32 * 4 * DS;  // threads of a block
  // K, V, 2 x Q and 2 x dO [64][D] tiles, the ds^T tile, 2 x 64 lse and
  // 2 x 64 delta, the spans
  static constexpr size_t kBytes =
      (6 * size_t(TILE) + size_t(TB) * SLD) * sizeof(bf16) + 4 * TB * sizeof(float) +
      2 * MAX_SPANS * sizeof(int);
};

// cp.async copies of rows [r0, r0 + 64) of one head (rows rs elements
// apart) into a tile; rows >= n are zero-filled
template <int D>
__device__ __forceinline__ void async_rows(bf16* dst, const bf16* base, size_t rs, int r0,
                                           int n) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int e = threadIdx.x; e < TB * CH; e += Lay<D>::TT) {
    const int r = e / CH, c = e % CH, g = r0 + r;
    const bool in = g < n;
    cp_async16(dst + r * Lay<D>::LD + c * 8, base + (in ? size_t(g) * rs + c * 8 : 0), in);
  }
}

// The same rows rotated by the interleaved RoPE in float32 and rounded to
// bf16 (as `rope_load`), through registers; angles of row g at
// cs + (bi * n + g) * D. The partner column c ^ 1 is in the same 16 bytes.
template <int D>
__device__ __forceinline__ void rope_rows(bf16* dst, const bf16* base, size_t rs, int r0, int n,
                                          const float* cs, const float* sn, int bi) {
  constexpr int CH = D / 8;
  for (int e = threadIdx.x; e < TB * CH; e += Lay<D>::TT) {
    const int r = e / CH, c = e % CH, g = r0 + r;
    uint4 out = make_uint4(0u, 0u, 0u, 0u);
    if (g < n) {
      const uint4 raw = *reinterpret_cast<const uint4*>(base + size_t(g) * rs + c * 8);
      const size_t a = (size_t(bi) * n + g) * D + c * 8;
      const float4 c0 = *reinterpret_cast<const float4*>(cs + a);
      const float4 c1 = *reinterpret_cast<const float4*>(cs + a + 4);
      const float4 s0 = *reinterpret_cast<const float4*>(sn + a);
      const float4 s1 = *reinterpret_cast<const float4*>(sn + a + 4);
      const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
      const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      const uint32_t in[4] = {raw.x, raw.y, raw.z, raw.w};
      uint32_t o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 x = unpack_bf16(in[i]);
        o[i] = pack_bf16(x.x * cv[2 * i] - x.y * sv[2 * i],
                         x.y * cv[2 * i + 1] + x.x * sv[2 * i + 1]);
      }
      out = make_uint4(o[0], o[1], o[2], o[3]);
    }
    *reinterpret_cast<uint4*>(dst + r * Lay<D>::LD + c * 8) = out;
  }
}

// lse (threads 0-63) and delta (64-127) of q rows [q0, q0 + 64); 0 past nq
__device__ __forceinline__ void async_row_stats(float* ls, float* dls, const float* lse,
                                                const float* delta, int q0, int nq) {
  if (threadIdx.x >= 2 * TB) return;
  const int r = threadIdx.x & (TB - 1), g = q0 + r;
  const bool in = g < nq, first = threadIdx.x < TB;
  cp_async4((first ? ls : dls) + r, (first ? lse : delta) + (in ? g : 0), in);
}

// (x0, x1) = columns (a, a + 1) of a row, un-rotated: x cos - rot(x) sin
__device__ __forceinline__ void unrotate_pair(float& x0, float& x1, const float* cs,
                                              const float* sn, size_t a) {
  const float y0 = x0 * cs[a] + x1 * sn[a];
  x1 = x1 * cs[a + 1] - x0 * sn[a + 1];
  x0 = y0;
}

// tanh on the special-function unit (max relative error ~2^-11), as
// production flash kernels evaluate softcaps
__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// From the raw products s = q.k and dp of one pair: p (returned) and ds
// (over dp). `ok`: the pair is visible.
__device__ __forceinline__ float grad_pair(float s, float& dp, bool ok, float lse, float delta,
                                           float scale, float cap, float inv_cap) {
  float x = s * scale, chain = 1.f;
  if (cap > 0.f) {
    const float th = tanh_approx(x * inv_cap);
    x = th * cap;
    chain = 1.f - th * th;
  }
  const float p = ok ? exp2f((x - lse) * LOG2E) : 0.f;
  dp = p * (dp - delta) * chain;
  return p;
}

// x . y over D bf16 values, as sequential float32 FMAs from element 0
template <int D>
__device__ __forceinline__ float dot_fma(const bf16* x, const bf16* y) {
  float acc = 0.f;
#pragma unroll 1
  for (int d = 0; d < D; ++d) acc = fmaf(__bfloat162float(x[d]), __bfloat162float(y[d]), acc);
  return acc;
}

// The first q tile in [iq, n_q_tiles) with a pair visible to the kv tile
// at global column kg (n_q_tiles if none). A tile whose last q row sees
// the first kv column causally is visible without the span loop.
__device__ __forceinline__ int visible_from(int iq, int n_q_tiles, int kg, int nq,
                                            const Params& P, const int* sp_off,
                                            const int* sp_len) {
  for (; iq < n_q_tiles; ++iq) {
    const int qs = iq * TB + P.q_off, qe = min(iq * TB + TB, nq) - 1 + P.q_off;
    if (qe >= kg) break;
    bool any, full;
    tile_visibility(qs, qe, kg, sp_off, sp_len, P.m, any, full);
    if (any) break;
  }
  return iq;
}

// dK and dV of one (b*h, kv tile), and dQ += ds K of each of its q tiles
// into dq_acc.
template <int D, bool ROPE>
__global__ void __launch_bounds__(Lay<D>::TT) flash_bwd_dkv_tc(const Params P, float* dq_acc) {
  using L = Lay<D>;
  constexpr int LD = L::LD, TILE = L::TILE, SLD = L::SLD, DW = L::DW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + TILE;
  bf16* Qs = Vs + TILE;      // two buffers
  bf16* Os = Qs + 2 * TILE;  // two buffers of dO
  bf16* Ss = Os + 2 * TILE;  // ds^T [kv][q]
  float* ls = reinterpret_cast<float*>(Ss + TB * SLD);  // two buffers of lse
  float* dls = ls + 2 * TB;                              // two buffers of delta
  int* sp_off = reinterpret_cast<int*>(dls + 2 * TB);
  int* sp_len = sp_off + MAX_SPANS;

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  // this warp's 16 rows of the tile (kv rows of s^T, dK, dV; q rows of dQ)
  // and the first of the DW columns of dK, dV and dQ it owns
  const int rw = 16 * (w & 3), cw = (w >> 2) * DW;
  const int H = P.H, nq = P.nq, nkv = P.nkv, m = P.m;
  const int BH = gridDim.x / ((nkv + TB - 1) / TB);
  const int bh = blockIdx.x % BH, bi = bh / H, head = bh - bi * H;
  const int k0 = (blockIdx.x / BH) * TB, kg = k0 + P.kv_off;
  const size_t rs = row_stride(P.nhd, H, D);
  const bf16* qb = static_cast<const bf16*>(P.q) + head_base(P.nhd, bi, head, H, nq, D);
  const bf16* ob = static_cast<const bf16*>(P.dout) + head_base(P.nhd, bi, head, H, nq, D);
  const bf16* kb = static_cast<const bf16*>(P.k) + head_base(P.nhd, bi, head, H, nkv, D);
  const bf16* vb = static_cast<const bf16*>(P.v) + head_base(P.nhd, bi, head, H, nkv, D);
  const float* lse = P.lse + size_t(bh) * nq;
  const float* delta = P.delta + size_t(bh) * nq;
  const float scale = P.scale, cap = P.softcap, inv_cap = cap > 0.f ? 1.f / cap : 0.f;

  load_spans(P, bi, sp_off, sp_len);
  if (ROPE)
    rope_rows<D>(Ks, kb, rs, k0, nkv, P.cos, P.sin, bi);
  else
    async_rows<D>(Ks, kb, rs, k0, nkv);
  async_rows<D>(Vs, vb, rs, k0, nkv);
  __syncthreads();  // the spans

  // first global q row that can see this kv tile: causally kg, or the
  // offset of any span whose rectangle reaches the tile
  int lo_tok = kg;
  for (int s = 0; s < m; ++s) {
    const int off = sp_off[s], ln = sp_len[s];
    if (ln > 0 && kg < off + ln && kg + TB - 1 >= off) lo_tok = min(lo_tok, off);
  }
  const int n_q_tiles = (nq + TB - 1) / TB;
  const int lo = lo_tok - P.q_off <= 0 ? 0 : (lo_tok - P.q_off) / TB;
  auto load_q = [&](int iq, int buf) {
    const int q0 = iq * TB;
    if (ROPE)
      rope_rows<D>(Qs + buf * TILE, qb, rs, q0, nq, P.cos, P.sin, bi);
    else
      async_rows<D>(Qs + buf * TILE, qb, rs, q0, nq);
    async_rows<D>(Os + buf * TILE, ob, rs, q0, nq);
    async_row_stats(ls + buf * TB, dls + buf * TB, lse, delta, q0, nq);
  };

  float dk[DW / 8][4] = {}, dv[DW / 8][4] = {};
  int iq = visible_from(lo, n_q_tiles, kg, nq, P, sp_off, sp_len), buf = 0;
  if (iq < n_q_tiles) load_q(iq, 0);
  cp_async_commit();  // K, V and the first Q / dO tile
  while (iq < n_q_tiles) {
    const int nxt = visible_from(iq + 1, n_q_tiles, kg, nq, P, sp_off, sp_len);
    if (nxt < n_q_tiles) load_q(nxt, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // all but the tile just started
    __syncthreads();

    const int q0 = iq * TB;
    // full: every pair visible (causally without the span loop)
    bool any = true, full = q0 + P.q_off >= kg + TB - 1;
    if (!full)
      tile_visibility(q0 + P.q_off, min(q0 + TB, nq) - 1 + P.q_off, kg, sp_off, sp_len, m, any,
                      full);
    full = full && q0 + TB <= nq && k0 + TB <= nkv;
    const bf16* Qb = Qs + buf * TILE;
    const bf16* Ob = Os + buf * TILE;
    const float* lb = ls + buf * TB;
    const float* db = dls + buf * TB;

    // transposed scores: rows are kv rows rw + (g, g + 8), columns q rows
    float st[8][4] = {}, dpt[8][4] = {};
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t ka[4], va[4];
      ldsm_x4(ka, ldsm_rows(Ks, LD, rw, kk, lane));
      ldsm_x4(va, ldsm_rows(Vs, LD, rw, kk, lane));
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        uint32_t qf[4], of[4];
        ldsm_x4(qf, ldsm_cols(Qb, LD, 8 * j, kk, lane));
        ldsm_x4(of, ldsm_cols(Ob, LD, 8 * j, kk, lane));
        mma(st[j], ka, qf[0], qf[1]);
        mma(st[j + 1], ka, qf[2], qf[3]);
        mma(dpt[j], va, of[0], of[1]);
        mma(dpt[j + 1], va, of[2], of[3]);
      }
    }
    // Where dp - delta cancels (a row that sees one key, or keys of equal
    // v: ds is then float32 rounding noise), dp is taken as the plain
    // version's float32 product takes it, sequential FMAs over d, not in
    // the tensor cores' sum order, so that the noise agrees. Rare: one
    // warp-wide test first.
    auto cancels = [&](int j, int c) {
      const float dl = db[8 * j + 2 * t + (c & 1)];
      return fabsf(dpt[j][c] - dl) < 0x1p-10f * fabsf(dl);
    };
    bool any_cancel = false;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) any_cancel |= cancels(j, c);
    if (__any_sync(0xffffffffu, any_cancel)) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (cancels(j, c))
            dpt[j][c] = dot_fma<D>(Ob + (8 * j + 2 * t + (c & 1)) * LD,
                                   Vs + (rw + g + 8 * (c >> 1)) * LD);
    }
    // the mask, in the fragment's coordinates, only on a tile with a
    // masked pair
    auto grads = [&](auto masked) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int qi = 8 * j + 2 * t + (c & 1), kj = rw + g + 8 * (c >> 1);
          const bool ok = !decltype(masked)::value ||
                          (q0 + qi < nq && k0 + kj < nkv &&
                           allowed(q0 + qi + P.q_off, kg + kj, sp_off, sp_len, m));
          st[j][c] = grad_pair(st[j][c], dpt[j][c], ok, lb[qi], db[qi], scale, cap, inv_cap);
        }
    };
    if (full)
      grads(std::false_type());
    else
      grads(std::true_type());
    // dV += p^T dO and dK += ds^T Q over the warp's DW columns: p^T and
    // ds^T are A fragments as they stand
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      uint32_t pa[4], sa[4];
      acc_to_a(pa, st[j], st[j + 1]);
      acc_to_a(sa, dpt[j], dpt[j + 1]);
#pragma unroll
      for (int c = 0; c < DW / 8; c += 2) {
        uint32_t of[4], qf[4];
        ldsm_x4_t(of, ldsm_rows(Ob, LD, 8 * j, cw + 8 * c, lane));
        ldsm_x4_t(qf, ldsm_rows(Qb, LD, 8 * j, cw + 8 * c, lane));
        mma(dv[c], pa, of[0], of[1]);
        mma(dv[c + 1], pa, of[2], of[3]);
        mma(dk[c], sa, qf[0], qf[1]);
        mma(dk[c + 1], sa, qf[2], qf[3]);
      }
      if (cw == 0) {  // ds^T to shared memory, as the A fragment lays it out
        bf16* row = Ss + (rw + g) * SLD + 8 * j + 2 * t;
        *reinterpret_cast<uint32_t*>(row) = sa[0];
        *reinterpret_cast<uint32_t*>(row + 8 * SLD) = sa[1];
        *reinterpret_cast<uint32_t*>(row + 8) = sa[2];
        *reinterpret_cast<uint32_t*>(row + 8 * SLD + 8) = sa[3];
      }
    }

    __syncthreads();  // ds^T complete
    // dQ rows rw .. rw + 15 of this q tile, the warp's DW columns, += ds K
    // (ds read transposed from ds^T), added into dq_acc
    {
      float dq[DW / 8][4] = {};
#pragma unroll
      for (int kk = 0; kk < TB; kk += 16) {
        uint32_t a[4];
        ldsm_x4_t(a, ldsm_cols(Ss, SLD, kk, rw, lane));
#pragma unroll
        for (int c = 0; c < DW / 8; c += 2) {
          uint32_t kf[4];
          ldsm_x4_t(kf, ldsm_rows(Ks, LD, kk, cw + 8 * c, lane));
          mma(dq[c], a, kf[0], kf[1]);
          mma(dq[c + 1], a, kf[2], kf[3]);
        }
      }
      const int r = q0 + rw + g;
      float* dst = dq_acc + (size_t(bh) * nq + r) * D + cw + 2 * t;
#pragma unroll
      for (int c = 0; c < DW / 8; ++c) {
        if (r < nq) atomic_add2(dst + 8 * c, dq[c][0], dq[c][1]);
        if (r + 8 < nq) atomic_add2(dst + 8 * D + 8 * c, dq[c][2], dq[c][3]);
      }
    }
    __syncthreads();  // this buffer's (and ds^T's) readers are done
    iq = nxt;
    buf ^= 1;
  }
  cp_async_wait<0>();

  bf16* dkb = static_cast<bf16*>(P.dk) + head_base(P.nhd, bi, head, H, nkv, D);
  bf16* dvb = static_cast<bf16*>(P.dv) + head_base(P.nhd, bi, head, H, nkv, D);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = k0 + rw + g + 8 * half;
    if (r >= nkv) continue;
#pragma unroll
    for (int c = 0; c < DW / 8; ++c) {
      const int col = cw + 8 * c + 2 * t;
      float x0 = dk[c][2 * half] * scale, x1 = dk[c][2 * half + 1] * scale;
      if (ROPE) unrotate_pair(x0, x1, P.cos, P.sin, (size_t(bi) * nkv + r) * D + col);
      *reinterpret_cast<uint32_t*>(dkb + size_t(r) * rs + col) = pack_bf16(x0, x1);
      *reinterpret_cast<uint32_t*>(dvb + size_t(r) * rs + col) =
          pack_bf16(dv[c][2 * half], dv[c][2 * half + 1]);
    }
  }
}

// dq = scale * dq_acc, un-rotated under RoPE, as bf16 in dq's layout; one
// thread per pair of columns
template <int D, bool ROPE>
__global__ void __launch_bounds__(256) flash_bwd_dq_store(const Params P, const float* dq_acc,
                                                          size_t pairs) {
  const size_t rs = row_stride(P.nhd, P.H, D);
  for (size_t i = blockIdx.x * size_t(256) + threadIdx.x; i < pairs;
       i += size_t(gridDim.x) * 256) {
    const size_t row = 2 * i / D;  // bh * nq + r
    const int col = int(2 * i - row * D), r = int(row % P.nq), bh = int(row / P.nq);
    const int bi = bh / P.H, head = bh - bi * P.H;
    const float2 x = *reinterpret_cast<const float2*>(dq_acc + 2 * i);
    float x0 = x.x * P.scale, x1 = x.y * P.scale;
    if (ROPE) unrotate_pair(x0, x1, P.cos, P.sin, (size_t(bi) * P.nq + r) * D + col);
    bf16* dst = static_cast<bf16*>(P.dq) + head_base(P.nhd, bi, head, P.H, P.nq, D) +
                size_t(r) * rs + col;
    *reinterpret_cast<uint32_t*>(dst) = pack_bf16(x0, x1);
  }
}

template <int D, bool ROPE>
int launch(const Params& P, int b, float* dq_acc, cudaStream_t stream) {
  const int smem = int(Lay<D>::kBytes);
  const long long kv_blocks = (long long)b * P.H * ((P.nkv + TB - 1) / TB);
  if (kv_blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  auto dkv = flash_bwd_dkv_tc<D, ROPE>;
  cudaError_t err = cudaFuncSetAttribute(dkv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  dkv<<<unsigned(kv_blocks), Lay<D>::TT, smem, stream>>>(P, dq_acc);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  const size_t pairs = size_t(b) * P.H * P.nq * (D / 2);
  const unsigned grid = unsigned(std::min<size_t>((pairs + 255) / 256, 132 * 16));
  flash_bwd_dq_store<D, ROPE><<<grid, 256, 0, stream>>>(P, dq_acc, pairs);
  return int(cudaGetLastError());
}

int dispatch(int d, const Params& P, int b, float* dq_acc, cudaStream_t stream) {
  const bool rope = P.cos != nullptr;  // a template flag: no branch in the loads
  switch (d) {
    case 32:
      return rope ? launch<32, true>(P, b, dq_acc, stream) : launch<32, false>(P, b, dq_acc, stream);
    case 64:
      return rope ? launch<64, true>(P, b, dq_acc, stream) : launch<64, false>(P, b, dq_acc, stream);
    case 128:
      return rope ? launch<128, true>(P, b, dq_acc, stream)
                  : launch<128, false>(P, b, dq_acc, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace tc

}  // namespace

// q/dout/dq [b,h,nq,d], k/v/dk/dv [b,h,nkv,d] (nhd = 0) or the token-major
// [b,n,h*d] (nhd = 1), contiguous, bf16 (is_bf16=1; q, k, v, dout and
// cos/sin 16-byte aligned) or float32; lse and delta float32 [b,h,nq];
// spans int32 [b,m,3] (m <= 128); cos/sin float32 [b,nq,d] or NULL (needs
// nq == nkv when given); dq_acc: for bf16 a zeroed float32 [b,h,nq,d]
// scratch, for float32 NULL.
// Returns the cudaError_t of the launches (0 = success).
extern "C" int flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                         const float* lse, const float* delta, const int* spans, int m,
                         const float* cos, const float* sin, void* dq, void* dk, void* dv,
                         float* dq_acc, int b, int h, int nq, int nkv, int d, int q_off,
                         int kv_off, int nhd, float scale, float softcap, int is_bf16,
                         void* stream) {
  if (m < 0 || m > MAX_SPANS || nq <= 0 || nkv <= 0 || b * h > 65535)
    return int(cudaErrorInvalidValue);  // one grid row per (batch, head)
  if ((cos == nullptr) != (sin == nullptr) || (cos != nullptr && nq != nkv))
    return int(cudaErrorInvalidValue);
  if ((dq_acc != nullptr) != (is_bf16 != 0)) return int(cudaErrorInvalidValue);
  const Params P{q,   k,  v,  dout, lse, delta, cos,    sin,  spans, dq,    dk,
                 dv,  m,  h,  nq,   nkv, q_off, kv_off, nhd,  scale, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return tc::dispatch(d, P, b, dq_acc, s);
  return dispatch_d<float>(d, P, b, s);
}
