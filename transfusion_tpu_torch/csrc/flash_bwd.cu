// Flash-attention backward with the transfusion mask, for Hopper (sm_90a).
//
// Replaces the Pallas TPU backwards of transfusion_tpu/ops/pallas_attn_kernel.py:
//   * `_bwd_kernel_batched_nhd` (row 6 of the kernel table): token-major
//     [b, n, h*d] operands, RoPE fused on q/k, dq/dk un-rotated on store;
//   * `_bwd_kernel_batched_heads` (row 7), `_bwd_dkv_kernel` +
//     `_bwd_dq_kernel` (row 8) and, above n*d = 8192*64,
//     `_flash_bwd_streamed` -> `_bwd_dkv_kernel_streamed` +
//     `_bwd_dq_kernel_streamed` (row 9): head-major [b, h, n, d], q/kv
//     offsets, lse cotangent.
// The TPU splits them by what fits in VMEM (a full n x n score matrix per
// grid step, blocks with one [n, d] pair resident, or every operand
// streamed through the grid); here every tile is streamed from device
// memory, so one FlashAttention-2 pair meets all four contracts, at any
// length (64-bit offsets; shared memory does not grow with n):
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
// Two kernels, no atomics:
//   flash_bwd_dkv: one block per (b*h, 64-row kv tile); loops over the q
//     tiles from the first that can see the kv tile (causality, or a span
//     whose rectangle reaches it, `:646-655`) to the end, skipping tiles
//     with no visible pair; accumulates dk and dv in registers.
//   flash_bwd_dq: one block per (b*h, 64-row q tile); loops over the kv tiles
//     up to the last one visible (as the forward), accumulates dq.
// Both recompute p from the forward's lse. The JAX scale order holds: q is
// scaled in float32 (the forward scaled it in its own dtype), dq is scaled
// again at the end. With cos/sin, q and k are rotated on load in float32 and
// rounded to the input dtype (as the forward); dq and dk are un-rotated
// with the negated sin before the store (`:1408-1410`): the partner column
// 2j^1 lives in the neighbouring lane, one shuffle away.
//
// What bounds it on the H100: operations. The backward does five products
// of n x n x d per head (s, dp, dv, dk, dq; the dq and dkv kernels each
// recompute s and dp, so seven are executed) over ~8 b h n d elements of
// traffic; at the bench shape that is far above the 295 FLOP/byte ridge.
// Long causal sequences also leave the dK/dV grid unbalanced: the block of
// the first kv tile walks every q tile, the last one a single tile.
// This first version runs the products as float32 FMAs from shared memory
// (the forward's tile scheme, 256 threads, 64 x 64 tiles) with no tensor
// cores; tile skipping keeps the work to the visible pairs. Tensor-core
// products are later work (PERF.md).

#include "attn_tile.cuh"

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

}  // namespace

// q/dout/dq [b,h,nq,d], k/v/dk/dv [b,h,nkv,d] (nhd = 0) or the token-major
// [b,n,h*d] (nhd = 1), contiguous, bf16 (is_bf16=1) or float32; lse and
// delta float32 [b,h,nq]; spans int32 [b,m,3] (m <= 128); cos/sin float32
// [b,nq,d] or NULL (needs nq == nkv when given).
// Returns the cudaError_t of the launches (0 = success).
extern "C" int flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                         const float* lse, const float* delta, const int* spans, int m,
                         const float* cos, const float* sin, void* dq, void* dk, void* dv,
                         int b, int h, int nq, int nkv, int d, int q_off, int kv_off, int nhd,
                         float scale, float softcap, int is_bf16, void* stream) {
  if (m < 0 || m > MAX_SPANS || nq <= 0 || nkv <= 0 || b * h > 65535)
    return int(cudaErrorInvalidValue);  // one grid row per (batch, head)
  if ((cos == nullptr) != (sin == nullptr) || (cos != nullptr && nq != nkv))
    return int(cudaErrorInvalidValue);
  const Params P{q,   k,  v,  dout, lse, delta, cos,    sin,  spans, dq,    dk,
                 dv,  m,  h,  nq,   nkv, q_off, kv_off, nhd,  scale, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return dispatch_d<__nv_bfloat16>(d, P, b, s);
  return dispatch_d<float>(d, P, b, s);
}
