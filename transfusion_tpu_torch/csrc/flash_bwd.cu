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
// head (s, dp, dv, dk, dq; the bf16 kernel runs dv's twice, for p's hi and
// lo halves) over ~8 b h n d elements of traffic: at d >= 64
// and the long causal path that is far above the 295 FLOP/byte ridge. Once
// the products run on the tensor cores, the per-pair float32 work (tanh,
// exp, the chain rule, the mask) costs about as much as the products.
//
// bf16 (every training path): tensor cores, in namespace `tc` below.
//   * One block per (b*h, 64-row kv tile) holds K and V and walks the
//     64-row q tiles that can see it: the keys a row sees form a prefix
//     whose end grows with the row (attn_tile `visible_ends`), so these are
//     the tiles from the one holding the first row that sees the kv tile's
//     first column (`first_row_seeing`) to the end. Q, K, V and dO tiles sit in shared memory as bf16
//     (16-byte row pad: ldmatrix without bank conflicts), filled by 16-byte
//     cp.async copies into two buffers, so the next Q / dO tile streams in
//     while the current one is consumed; rows past n are zero-filled. Under
//     RoPE, q and k go through registers instead (rotated in float32 and
//     rounded to bf16 as the forward does; the partner column 2j^1 is in
//     the same 16 bytes).
//   * Every product is mma.sync m16n8k16 (bf16 -> float32), six per
//     visible pair: s^T = K Q^T and dp^T = V dO^T; p^T (as a bf16 pair hi +
//     lo, two products) and ds^T (rounded to bf16) are already the A
//     operand of dV += p^T dO and dK += ds^T Q
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
//   * One elementwise pass per pair: the forward's exact tanh once (attn_tile
//     `softcap_tile`, so that p agrees with the lse the forward saved even
//     near the cap; the chain reuses it), exp as exp2 of (s - lse) log2 e.
//     The mask is one compare per pair against its q row's visible end
//     (`row_ends` computes every row's once per call from the spans in
//     device memory, any span count; a q tile's 64 come in by cp.async
//     beside its lse and delta), and none on a tile whose first q row sees
//     the whole kv tile. Where dp - delta
//     cancels to within its row's bound (`cancel_bounds`: 2^-10 of delta,
//     or 2^-20 of |dO_i| max_j |v_j|; a row that sees one key, keys of
//     equal v, a dO . v that cancels), ds is mostly float32 rounding,
//     which the tensor cores' sum order (some ulps of |dO_i| |v_j| off)
//     would move past the row rule; that dp is then taken from sequential
//     float32 FMAs, as the plain version's product takes it, so that the
//     rounding agrees with the plain version's.
//   * A warp owns 16 kv rows (4 warps; from d 128 one warp per 64 columns
//     and 16 rows, each holding its columns of dK, dV and dQ: 8 warps at
//     d 128, so that no register spills, 16 at d 256). The grid is
//     one-dimensional, (b*h) fastest: kv tile 0 of every head, the longest
//     walk under causality, starts first.
//
// Value width. Each kernel takes the q . k width D and the value width DV
// as template parameters (DV = D unless given; every (d, d) instantiation
// is the code it was). (D, DV) = (192, 128), the latent attention of
// DeepSeek-V3-style blocks (128 dims without RoPE and 64 with it beside
// 128-dim values), is instantiated head-major without RoPE: s^T and dK, dQ
// run over D columns, dp^T and dV over DV; the tensor-core kernel takes
// one warp per 64 value columns (2 warps a 16-row slice, 96 columns of dK
// and dQ each). Padding such a head to d 256 would waste a third of the
// q k^T products and half of the value products.
//
// float32 (the card-vs-CPU checks at 1e-4): the first version's FMA kernels:
// float32 products from shared memory, no tensor cores (TF32 would keep ~3
// decimal digits), deterministic. Two kernels, no atomics, the mask from
// the visible ends as above:
//   flash_bwd_dkv: one block per (b*h, 64-row kv tile; 32 rows at d 256,
//     where four 64-row float32 tiles would not fit); loops over the q
//     tiles from the first that can see the kv tile to the end;
//     accumulates dk and dv in registers.
//   flash_bwd_dq: one block per (b*h, 64-row q tile; 32 at d 256); loops
//     over the kv tiles up to the last one visible (as the forward),
//     accumulates dq.
// Every grid is one-dimensional, (b*h) fastest, so b*h is not capped at
// grid.y's 65535.
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

constexpr int BQ = 64;       // q rows of the dkv kernel's q tiles
constexpr int BKV = BK;      // kv rows of the dq kernel's kv tiles
constexpr int PS = BKV + 1;  // padded stride of the p / ds tiles

// Rows per thread of the FMA kernels' own row tile (the dkv kernel's kv
// rows, the dq kernel's q rows): 4 (64-row tiles), or 2 at d 256, where
// four 64-row float32 tiles would not fit in shared memory.
template <int D>
__host__ __device__ constexpr int rpt() {
  return D == 256 ? 2 : 4;
}

struct Params {
  const void *q, *k, *v, *dout;
  const float *lse, *delta, *cos, *sin;
  float2* cancel;  // [b, h, nq] (delta, its bound) (bf16 only): `cancel_bounds`
  const int* spans;
  int* ends;  // int32 [b, nq]: each q row's visible end, written by `row_ends`
  void *dq, *dk, *dv;
  int m, H, nq, nkv, q_off, kv_off, nhd;
  float scale, softcap;
};

// s[r][j] = A[ty*R + r] . B[tx + 16 j]; A, B tiles of row stride D + 1
template <int D, int R>
__device__ __forceinline__ void dot_tile(const float* A, const float* B, float (&s)[R][4],
                                         int tx, int ty) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[r][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float a = A[(ty * R + r) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) s[r][j] = fmaf(a, b[j], s[r][j]);
    }
  }
}

// acc[r][c] += sum_k P[ty*R + r][k] * M[k][tx + 16 c]; P of stride PS,
// M of stride D + 1, k over the 64 rows of M
template <int D, int R>
__device__ __forceinline__ void acc_tile(const float* P, const float* M,
                                         float (&acc)[R][D / 16], int tx, int ty) {
  constexpr int LD = D + 1;
#pragma unroll 4
  for (int k = 0; k < 64; ++k) {
    float mv[D / 16];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) mv[c] = M[k * LD + tx + 16 * c];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float p = P[(ty * R + r) * PS + k];
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[r][c] = fmaf(p, mv[c], acc[r][c]);
    }
  }
}

// Load rows [r0, r0 + ROWS) of one head into a tile of stride D + 1, as
// float32: RoPE-rotated and rounded to T when ROPE (angles of row r at
// cs + (bi * n + r) * D), times `mul`; rows >= n are zero.
template <typename T, int D, bool ROPE, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const T* base, size_t rs, int r0, int n,
                                          const float* cs, const float* sn, int bi,
                                          float mul) {
  constexpr int LD = D + 1;
  for (int e = threadIdx.x; e < ROWS * D; e += NT) {
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

// p and ds of this thread's R x 4 pairs of one tile, from the raw scores
// s and dp, the visibility `ok` and each pair's q-row lse and delta.
// Writes p, and ds over s. Called by every thread of the block.
template <int R>
__device__ __forceinline__ void grad_scores(float (&s)[R][4], const float (&dp)[R][4],
                                            const bool (&ok)[R][4], const float (&lse)[R][4],
                                            const float (&delta)[R][4], float softcap,
                                            float (&p)[R][4]) {
  if (softcap > 0.f) softcap_tile(flat<R * 4>(s), softcap);
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float x = s[r][j];
      float chain = 1.f;
      if (softcap > 0.f) {
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
template <int D, int R>
__device__ __forceinline__ void unrotate(float (&acc)[R][D / 16], const float* cs,
                                         const float* sn, int bi, int n, int row0, int tx,
                                         int ty) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int g = row0 + ty * R + r;
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

template <typename T, int D, int R>
__device__ __forceinline__ void store_rows(T* base, size_t rs, const float (&acc)[R][D / 16],
                                           int row0, int n, int tx, int ty) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int g = row0 + ty * R + r;
    if (g >= n) continue;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) base[size_t(g) * rs + tx + 16 * c] = from_f<T>(acc[r][c]);
  }
}

// D: the q . k width; DV: the value width (D unless given)
template <int D, int DV = D>
struct Smem {
  static constexpr int LD = D + 1, RT = 16 * rpt<D>();  // rows of the own tile
  // dkv: K, V [RT] and Q, dO [64] tiles + p, ds [RT] tiles; dq: Q, dO [RT]
  // and K, V [64] tiles + the ds [RT] tile; lse and delta [64]; the q
  // tile's visible ends (dkv, int [64]). Q and K rows are D wide, V and dO
  // rows DV.
  static constexpr size_t kFloats =
      (size_t(RT) + 64) * (LD + DV + 1) + 2 * size_t(RT) * PS + 2 * 64;
  static constexpr size_t kBytes = kFloats * sizeof(float) + 64 * sizeof(int);
};

// The visible end (attn_tile `visible_ends`, local kv columns) of every q
// row, once per call: the dK/dV kernels walk many q tiles per kv tile, and
// a span loop per tile would stall them (20 spans at n 16384: +13 %). One
// thread per (batch row, q row).
__global__ void __launch_bounds__(256) row_ends(const Params P, int b) {
  const size_t i = blockIdx.x * size_t(256) + threadIdx.x;
  if (i >= size_t(b) * P.nq) return;
  const int bi = int(i / P.nq), rows[1] = {P.q_off + int(i % P.nq)};
  int end[1];
  visible_ends<1>(rows, P.spans + size_t(bi) * P.m * 3, P.m, P.kv_off, P.nkv, end);
  P.ends[i] = end[0];
}

template <typename T, int D, bool ROPE, int DV = D>
__global__ void __launch_bounds__(NT) flash_bwd_dkv(const Params P) {
  constexpr int LD = D + 1, LDV = DV + 1, DC = D / 16, DCV = DV / 16, R = rpt<D>(), KT = 16 * R;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + KT * LD;
  float* Qs = Vs + KT * LDV;
  float* dOs = Qs + 64 * LD;
  float* Ps = dOs + 64 * LDV;
  float* dSs = Ps + KT * PS;
  float* lse_s = dSs + KT * PS;
  float* delta_s = lse_s + 64;
  int* end_s = reinterpret_cast<int*>(delta_s + 64);

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int H = P.H, nq = P.nq, nkv = P.nkv;
  // one-dimensional grid, (b*h) fastest: no 65535 cap on b*h
  const int BH = gridDim.x / ((nkv + KT - 1) / KT);
  const int bh = blockIdx.x % BH, bi = bh / H, head = bh - bi * H;
  const int k0 = int(blockIdx.x / BH) * KT, kg = k0 + P.kv_off;
  const size_t rs = row_stride(P.nhd, H, D), rsv = row_stride(P.nhd, H, DV);
  const T* qb = static_cast<const T*>(P.q) + head_base(P.nhd, bi, head, H, nq, D);
  const T* ob = static_cast<const T*>(P.dout) + head_base(P.nhd, bi, head, H, nq, DV);
  const T* kb = static_cast<const T*>(P.k) + head_base(P.nhd, bi, head, H, nkv, D);
  const T* vb = static_cast<const T*>(P.v) + head_base(P.nhd, bi, head, H, nkv, DV);
  const float* lse = P.lse + size_t(bh) * nq;
  const float* delta = P.delta + size_t(bh) * nq;
  const int* sp = P.spans + size_t(bi) * P.m * 3;

  load_tile<T, D, ROPE, KT>(Ks, kb, rs, k0, nkv, P.cos, P.sin, bi, 1.f);
  load_tile<T, DV, false, KT>(Vs, vb, rsv, k0, nkv, nullptr, nullptr, bi, 1.f);

  // the q tiles from the one holding the first row that sees kv column kg
  // on: each has a visible pair (the ends grow with the row)
  const int lo_tok = first_row_seeing(kg, sp, P.m);
  const int lo = lo_tok - P.q_off <= 0 ? 0 : (lo_tok - P.q_off) / BQ;
  const int n_q_tiles = (nq + BQ - 1) / BQ;

  float dk[R][DC], dv[R][DCV];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[r][c] = 0.f;
#pragma unroll
    for (int c = 0; c < DCV; ++c) dv[r][c] = 0.f;
  }

  for (int iq = lo; iq < n_q_tiles; ++iq) {
    const int q0 = iq * BQ;
    __syncthreads();  // K / V are written / the previous tile's readers are done
    load_tile<T, D, ROPE, BQ>(Qs, qb, rs, q0, nq, P.cos, P.sin, bi, P.scale);
    load_tile<T, DV, false, BQ>(dOs, ob, rsv, q0, nq, nullptr, nullptr, bi, 1.f);
    if (tid < 64) {
      const bool in = q0 + tid < nq;
      lse_s[tid] = in ? lse[q0 + tid] : 0.f;
      delta_s[tid] = in ? delta[q0 + tid] : 0.f;
      end_s[tid] = in ? P.ends[size_t(bi) * nq + q0 + tid] : 0;
    }
    __syncthreads();

    // transposed scores: rows are this thread's kv rows, columns q rows
    float s[R][4], dp[R][4], p[R][4], l[R][4], dl[R][4];
    bool ok[R][4];
    dot_tile<D, R>(Ks, Qs, s, tx, ty);
    dot_tile<DV, R>(Vs, dOs, dp, tx, ty);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int jl = k0 + ty * R + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ok[r][j] = jl < end_s[tx + 16 * j];  // 0 past nq
        l[r][j] = lse_s[tx + 16 * j];
        dl[r][j] = delta_s[tx + 16 * j];
      }
    }
    grad_scores<R>(s, dp, ok, l, dl, P.softcap, p);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        Ps[(ty * R + r) * PS + tx + 16 * j] = p[r][j];
        dSs[(ty * R + r) * PS + tx + 16 * j] = s[r][j];
      }
    __syncthreads();
    acc_tile<DV, R>(Ps, dOs, dv, tx, ty);  // dv += p^T dO
    acc_tile<D, R>(dSs, Qs, dk, tx, ty);   // dk += ds^T (q * scale)
  }

  if (ROPE) unrotate<D, R>(dk, P.cos, P.sin, bi, nkv, k0, tx, ty);
  store_rows<T, D, R>(static_cast<T*>(P.dk) + head_base(P.nhd, bi, head, H, nkv, D), rs, dk,
                      k0, nkv, tx, ty);
  store_rows<T, DV, R>(static_cast<T*>(P.dv) + head_base(P.nhd, bi, head, H, nkv, DV), rsv,
                       dv, k0, nkv, tx, ty);
}

template <typename T, int D, bool ROPE, int DV = D>
__global__ void __launch_bounds__(NT) flash_bwd_dq(const Params P) {
  constexpr int LD = D + 1, LDV = DV + 1, DC = D / 16, R = rpt<D>(), QT = 16 * R;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + QT * LD;
  float* Ks = dOs + QT * LDV;
  float* Vs = Ks + 64 * LD;
  float* dSs = Vs + 64 * LDV;
  float* lse_s = dSs + QT * PS;
  float* delta_s = lse_s + 64;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int H = P.H, nq = P.nq, nkv = P.nkv;
  const int BH = gridDim.x / ((nq + QT - 1) / QT);  // as in the dkv kernel
  const int bh = blockIdx.x % BH, bi = bh / H, head = bh - bi * H;
  const int q0 = int(blockIdx.x / BH) * QT;
  const size_t rs = row_stride(P.nhd, H, D), rsv = row_stride(P.nhd, H, DV);
  const T* qb = static_cast<const T*>(P.q) + head_base(P.nhd, bi, head, H, nq, D);
  const T* ob = static_cast<const T*>(P.dout) + head_base(P.nhd, bi, head, H, nq, DV);
  const T* kb = static_cast<const T*>(P.k) + head_base(P.nhd, bi, head, H, nkv, D);
  const T* vb = static_cast<const T*>(P.v) + head_base(P.nhd, bi, head, H, nkv, DV);

  load_tile<T, D, ROPE, QT>(Qs, qb, rs, q0, nq, P.cos, P.sin, bi, P.scale);
  load_tile<T, DV, false, QT>(dOs, ob, rsv, q0, nq, nullptr, nullptr, bi, 1.f);
  if (tid < QT) {
    const bool in = q0 + tid < nq;
    lse_s[tid] = in ? P.lse[size_t(bh) * nq + q0 + tid] : 0.f;
    delta_s[tid] = in ? P.delta[size_t(bh) * nq + q0 + tid] : 0.f;
  }
  __syncthreads();

  // kv columns seen by this thread's rows and by the block's last row
  // (the loop bound: every kv tile below it has a visible pair)
  int end[R + 1];
  {
    int rows[R + 1];
#pragma unroll
    for (int r = 0; r < R; ++r) rows[r] = P.q_off + q0 + ty * R + r;
    rows[R] = P.q_off + min(q0 + QT, nq) - 1;
    visible_ends<R + 1>(rows, P.spans + size_t(bi) * P.m * 3, P.m, P.kv_off, nkv, end);
  }
  const int hi = (end[R] + BKV - 1) / BKV;

  float l[R][4], dl[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      l[r][j] = lse_s[ty * R + r];
      dl[r][j] = delta_s[ty * R + r];
    }

  float dq[R][DC];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) dq[r][c] = 0.f;

  for (int it = 0; it < hi; ++it) {
    const int k0 = it * BKV;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D, ROPE, BKV>(Ks, kb, rs, k0, nkv, P.cos, P.sin, bi, 1.f);
    load_tile<T, DV, false, BKV>(Vs, vb, rsv, k0, nkv, nullptr, nullptr, bi, 1.f);
    __syncthreads();

    float s[R][4], dp[R][4], p[R][4];
    bool ok[R][4];
    dot_tile<D, R>(Qs, Ks, s, tx, ty);
    dot_tile<DV, R>(dOs, Vs, dp, tx, ty);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) ok[r][j] = q0 + ty * R + r < nq && k0 + tx + 16 * j < end[r];
    grad_scores<R>(s, dp, ok, l, dl, P.softcap, p);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) dSs[(ty * R + r) * PS + tx + 16 * j] = s[r][j];
    __syncthreads();
    acc_tile<D, R>(dSs, Ks, dq, tx, ty);  // dq += ds k
  }

#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) dq[r][c] *= P.scale;
  if (ROPE) unrotate<D, R>(dq, P.cos, P.sin, bi, nq, q0, tx, ty);
  store_rows<T, D, R>(static_cast<T*>(P.dq) + head_base(P.nhd, bi, head, H, nq, D), rs, dq, q0,
                      nq, tx, ty);
}

template <typename T, int D, int DV = D>
int launch(const Params& P, int b, cudaStream_t stream) {
  constexpr int RT = 16 * rpt<D>();
  const int smem = int(Smem<D, DV>::kBytes);
  const bool rope = P.cos != nullptr;  // a template flag: no branch in the loads
  auto dkv = flash_bwd_dkv<T, D, false, DV>;
  auto dq = flash_bwd_dq<T, D, false, DV>;
  if constexpr (DV != D) {  // unequal widths: head-major, no RoPE
    if (rope || P.nhd) return int(cudaErrorInvalidValue);
  } else if (rope) {
    dkv = flash_bwd_dkv<T, D, true>;
    dq = flash_bwd_dq<T, D, true>;
  }
  cudaError_t err = cudaFuncSetAttribute(dkv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  const long long bh = (long long)b * P.H;
  const long long dkv_blocks = bh * ((P.nkv + RT - 1) / RT), dq_blocks = bh * ((P.nq + RT - 1) / RT);
  if (std::max(dkv_blocks, dq_blocks) > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  dkv<<<unsigned(dkv_blocks), NT, smem, stream>>>(P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  dq<<<unsigned(dq_blocks), NT, smem, stream>>>(P);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch_d(int d, int dv, const Params& P, int b, cudaStream_t stream) {
  if (dv != d) {
    if (d == 192 && dv == 128) return launch<T, 192, 128>(P, b, stream);
    return int(cudaErrorInvalidValue);
  }
  switch (d) {
    case 32:
      return launch<T, 32>(P, b, stream);
    case 64:
      return launch<T, 64>(P, b, stream);
    case 128:
      return launch<T, 128>(P, b, stream);
    case 256:
      return launch<T, 256>(P, b, stream);
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

// D: the q . k width; DV: the value width (D unless given)
template <int D, int DV = D>
struct Lay {
  static constexpr int LD = D + 8;    // padded bf16 row stride of a [64][D] tile
  static constexpr int LDV = DV + 8;  // and of a [64][DV] tile (V, dO)
  static constexpr int TILE = TB * LD, TILEV = TB * LDV;
  static constexpr int SLD = TB + 8;  // row stride of the ds^T tile
  // warps per 16 kv rows: each computes those rows' s^T and dp^T and owns
  // DW = D / DS columns of dK and dQ and DWV = DV / DS of dV. From d 128
  // one such warp per 64 value columns keeps its sums beside the score
  // fragments in registers (d 128: 2 warps, no spills; d 256: 4 warps, 512
  // threads, at most 128 registers a thread; q . k 192 beside v 128: 2
  // warps, each 96 columns of dK and dQ and 64 of dV).
  static constexpr int DS = DV > 64 ? DV / 64 : 1;
  static constexpr int DW = D / DS, DWV = DV / DS;
  static constexpr int TT = 32 * 4 * DS;  // threads of a block
  // K, V, 2 x Q and 2 x dO tiles, the ds^T tile, 2 x 64 lse, 2 x 64
  // (delta, its bound) and 2 x 64 visible ends
  static constexpr size_t kBytes =
      (3 * size_t(TILE) + 3 * size_t(TILEV) + size_t(TB) * SLD) * sizeof(bf16) +
      6 * TB * sizeof(float) + 2 * TB * sizeof(int);
};

// 8 bytes, zero-filled when !valid
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 8 : 0));
}

// lse, (delta, its bound) and visible end of q rows [q0, q0 + 64); 0 past
// nq
template <int NTH>
__device__ __forceinline__ void async_row_stats(float* ls, float2* dls, int* es, const float* lse,
                                                const float2* delta, const int* ends, int q0,
                                                int nq) {
  for (int e = threadIdx.x; e < 3 * TB; e += NTH) {
    const int r = e % TB, g = q0 + r;
    const bool in = g < nq;
    const int gi = in ? g : 0;
    if (e < TB)
      cp_async4(ls + r, lse + gi, in);
    else if (e < 2 * TB)
      cp_async8(dls + r, delta + gi, in);
    else
      cp_async4(es + r, ends + gi, in);
  }
}

// (x0, x1) = columns (a, a + 1) of a row, un-rotated: x cos - rot(x) sin
__device__ __forceinline__ void unrotate_pair(float& x0, float& x1, const float* cs,
                                              const float* sn, size_t a) {
  const float y0 = x0 * cs[a] + x1 * sn[a];
  x1 = x1 * cs[a + 1] - x0 * sn[a + 1];
  x0 = y0;
}

// From the capped logit x of one pair and its raw dp: p (returned) and ds
// (over dp). `ok`: the pair is visible.
__device__ __forceinline__ float grad_pair(float x, float& dp, bool ok, float lse, float delta,
                                           float cap, float inv_cap) {
  float chain = 1.f;
  if (cap > 0.f) {
    const float th = x * inv_cap;
    chain = 1.f - th * th;
  }
  const float p = ok ? exp2f((x - lse) * LOG2E) : 0.f;
  dp = p * (dp - delta) * chain;
  return p;
}

// x . y over D bf16 values (16-byte aligned rows), as sequential float32
// FMAs from element 0; eight elements a load, the loop kept rolled (it is
// inlined at every pair of a fragment)
template <int D>
__device__ __forceinline__ float dot_fma(const bf16* x, const bf16* y) {
  float acc = 0.f;
#pragma unroll 1
  for (int d = 0; d < D; d += 8) {
    const uint4 a = *reinterpret_cast<const uint4*>(x + d);
    const uint4 b = *reinterpret_cast<const uint4*>(y + d);
    const uint32_t aw[4] = {a.x, a.y, a.z, a.w}, bw[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // the low half is the earlier element
      acc = fmaf(__uint_as_float(aw[e] << 16), __uint_as_float(bw[e] << 16), acc);
      acc = fmaf(__uint_as_float(aw[e] & 0xffff0000u), __uint_as_float(bw[e] & 0xffff0000u),
                 acc);
    }
  }
  return acc;
}

// The norm of bf16 row r of each head (rows of D values, 16-byte aligned)
// for a group of D / 8 lanes, each reading 8 values; every lane of the
// group gets it. A warp covers 256 / D rows; `row` is this lane's, and
// false past n.
__device__ __forceinline__ float group_row_norm(const bf16* base, const Params& P, int n, int D,
                                                size_t bh, int r, bool row) {
  const int L = D / 8, sub = threadIdx.x % L;
  float s = 0.f;
  if (row) {
    const int bi = int(bh / P.H), head = int(bh % P.H);
    const uint4 a = *reinterpret_cast<const uint4*>(
        base + head_base(P.nhd, bi, head, P.H, n, D) + size_t(r) * row_stride(P.nhd, P.H, D) +
        8 * sub);
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float lo = __uint_as_float(w[e] << 16), hi = __uint_as_float(w[e] & 0xffff0000u);
      s = fmaf(lo, lo, fmaf(hi, hi, s));
    }
  }
  for (int o = L / 2; o > 0; o /= 2) s += __shfl_xor_sync(0xffffffffu, s, o);
  return sqrtf(s);
}

// max_j |v_j| of each (batch row, head) into vmax (zeroed; nonnegative
// floats order as their bits): a block takes 2048 / D rows of one head,
// one atomic each
__global__ void __launch_bounds__(256) v_norm_max(const Params P, int D, unsigned* vmax) {
  const int per = 2048 / D, chunks = (P.nkv + per - 1) / per;
  const size_t bh = blockIdx.x / chunks;
  const int r = (blockIdx.x % chunks) * per + int(threadIdx.x) / (D / 8);
  float x = group_row_norm(static_cast<const bf16*>(P.v), P, P.nkv, D, bh, r, r < P.nkv);
  for (int o = 16; o > 0; o /= 2) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  __shared__ float warp_max[8];
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < 8; ++w) x = fmaxf(x, warp_max[w]);
    atomicMax(vmax + bh, __float_as_uint(x));
  }
}

// Each q row's bound on |dp - delta| below which the dK/dV kernel sums dp
// sequentially: 2^-10 of |delta|, or 2^-20 of |dO_i| max_j |v_j|. Where
// dp - delta is that small, ds is mostly float32 rounding, and the tensor
// cores' sum order, some ulps of |dO_i| |v_j| from the sequential one,
// would move it past the row rule. Blocks as `v_norm_max`'s, over q rows.
__global__ void __launch_bounds__(256) cancel_bounds(const Params P, int D,
                                                     const unsigned* vmax) {
  const int L = D / 8, per = 256 / L, chunks = (P.nq + per - 1) / per;
  const size_t bh = blockIdx.x / chunks;
  const int r = (blockIdx.x % chunks) * per + int(threadIdx.x) / L;
  const float x = group_row_norm(static_cast<const bf16*>(P.dout), P, P.nq, D, bh, r, r < P.nq);
  if (r < P.nq && threadIdx.x % L == 0) {
    const size_t i = bh * P.nq + r;
    const float delta = P.delta[i];
    P.cancel[i] = make_float2(
        delta, fmaxf(0x1p-10f * fabsf(delta), 0x1p-20f * x * __uint_as_float(vmax[bh])));
  }
}

// dK and dV of one (b*h, kv tile), and dQ += ds K of each of its q tiles
// into dq_acc.
template <int D, bool ROPE, int DV = D>
__global__ void __launch_bounds__(Lay<D, DV>::TT)
    flash_bwd_dkv_tc(const Params P, float* dq_acc) {
  using L = Lay<D, DV>;
  constexpr int LD = L::LD, LDV = L::LDV, TILE = L::TILE, TILEV = L::TILEV, SLD = L::SLD,
                DW = L::DW, DWV = L::DWV;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + TILE;
  bf16* Qs = Vs + TILEV;      // two buffers
  bf16* Os = Qs + 2 * TILE;   // two buffers of dO
  bf16* Ss = Os + 2 * TILEV;  // ds^T [kv][q]
  float* ls = reinterpret_cast<float*>(Ss + TB * SLD);  // two buffers of lse
  float2* dls = reinterpret_cast<float2*>(ls + 2 * TB);  // two buffers of (delta, bound)
  int* es = reinterpret_cast<int*>(dls + 2 * TB);        // two buffers of visible ends

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  // this warp's 16 rows of the tile (kv rows of s^T, dK, dV; q rows of dQ)
  // and the first of the DW columns of dK and dQ, and of the DWV of dV, it
  // owns
  const int rw = 16 * (w & 3), cw = (w >> 2) * DW, cwv = (w >> 2) * DWV;
  const int H = P.H, nq = P.nq, nkv = P.nkv;
  const int BH = gridDim.x / ((nkv + TB - 1) / TB);
  const int bh = blockIdx.x % BH, bi = bh / H, head = bh - bi * H;
  const int k0 = (blockIdx.x / BH) * TB, kg = k0 + P.kv_off;
  const size_t rs = row_stride(P.nhd, H, D), rsv = row_stride(P.nhd, H, DV);
  const bf16* qb = static_cast<const bf16*>(P.q) + head_base(P.nhd, bi, head, H, nq, D);
  const bf16* ob = static_cast<const bf16*>(P.dout) + head_base(P.nhd, bi, head, H, nq, DV);
  const bf16* kb = static_cast<const bf16*>(P.k) + head_base(P.nhd, bi, head, H, nkv, D);
  const bf16* vb = static_cast<const bf16*>(P.v) + head_base(P.nhd, bi, head, H, nkv, DV);
  const float* lse = P.lse + size_t(bh) * nq;
  const float2* delta = P.cancel + size_t(bh) * nq;
  const float scale = P.scale, cap = P.softcap, inv_cap = cap > 0.f ? 1.f / cap : 0.f;
  const int* sp = P.spans + size_t(bi) * P.m * 3;
  const int* ends = P.ends + size_t(bi) * nq;

  if (ROPE)
    copy_rows_regs<D, LD, TB, L::TT, true>(Ks, kb, rs, k0, nkv, P.cos, P.sin, bi, 1.f);
  else
    copy_rows_async<D, LD, TB, L::TT>(Ks, kb, rs, k0, nkv);
  copy_rows_async<DV, LDV, TB, L::TT>(Vs, vb, rsv, k0, nkv);

  // the q tiles from the one holding the first row that sees kv column kg
  // on: each has a visible pair (the ends grow with the row)
  const int lo_tok = first_row_seeing(kg, sp, P.m);
  const int n_q_tiles = (nq + TB - 1) / TB;
  const int lo = lo_tok - P.q_off <= 0 ? 0 : (lo_tok - P.q_off) / TB;
  auto load_q = [&](int iq, int buf) {
    const int q0 = iq * TB;
    if (ROPE)
      copy_rows_regs<D, LD, TB, L::TT, true>(Qs + buf * TILE, qb, rs, q0, nq, P.cos, P.sin, bi,
                                             1.f);
    else
      copy_rows_async<D, LD, TB, L::TT>(Qs + buf * TILE, qb, rs, q0, nq);
    copy_rows_async<DV, LDV, TB, L::TT>(Os + buf * TILEV, ob, rsv, q0, nq);
    async_row_stats<L::TT>(ls + buf * TB, dls + buf * TB, es + buf * TB, lse, delta, ends, q0,
                           nq);
  };

  float dk[DW / 8][4] = {}, dv[DWV / 8][4] = {};
  int buf = 0;
  if (lo < n_q_tiles) load_q(lo, 0);
  cp_async_commit();  // K, V and the first Q / dO tile
  for (int iq = lo; iq < n_q_tiles; ++iq) {
    if (iq + 1 < n_q_tiles) load_q(iq + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // all but the tile just started
    __syncthreads();

    const int q0 = iq * TB;
    const bf16* Qb = Qs + buf * TILE;
    const bf16* Ob = Os + buf * TILEV;
    const float* lb = ls + buf * TB;
    const float2* db = dls + buf * TB;  // (delta, its bound)
    const int* eb = es + buf * TB;  // 0 past nq
    // full: every pair visible (the tile's first row sees the whole kv tile)
    const bool full = eb[0] >= k0 + TB && q0 + TB <= nq;

    // transposed scores: rows are kv rows rw + (g, g + 8), columns q rows
    float st[8][4] = {}, dpt[8][4] = {};
    if constexpr (DV == D) {
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
    } else {  // s^T over the D columns of K and Q, dp^T over the DV of V and dO
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        uint32_t ka[4];
        ldsm_x4(ka, ldsm_rows(Ks, LD, rw, kk, lane));
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
          uint32_t qf[4];
          ldsm_x4(qf, ldsm_cols(Qb, LD, 8 * j, kk, lane));
          mma(st[j], ka, qf[0], qf[1]);
          mma(st[j + 1], ka, qf[2], qf[3]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < DV; kk += 16) {
        uint32_t va[4];
        ldsm_x4(va, ldsm_rows(Vs, LDV, rw, kk, lane));
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
          uint32_t of[4];
          ldsm_x4(of, ldsm_cols(Ob, LDV, 8 * j, kk, lane));
          mma(dpt[j], va, of[0], of[1]);
          mma(dpt[j + 1], va, of[2], of[3]);
        }
      }
    }
    // Where dp - delta cancels to within the row's bound (a row that sees
    // one key, keys of equal v, a dO . v that cancels: ds is then mostly
    // float32 rounding), dp is taken as the plain version's float32
    // product takes it, sequential FMAs over d, not in the tensor cores'
    // sum order, so that the rounding agrees. Rare: one warp-wide test
    // first.
    auto cancels = [&](int j, int c) {
      const int qi = 8 * j + 2 * t + (c & 1);
      return fabsf(dpt[j][c] - db[qi].x) < db[qi].y;
    };
    if constexpr (DV == D) {
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
              dpt[j][c] = dot_fma<DV>(Ob + (8 * j + 2 * t + (c & 1)) * LDV,
                                      Vs + (rw + g + 8 * (c >> 1)) * LDV);
      }
    } else {
      // Latent attention's values collapse toward one vector early in
      // training, and then most warp tiles hold a cancelling pair in most
      // of their 32 fragment slots: walked slot by slot, a tile costs a
      // sequential product for every slot that any lane needs. Here each
      // lane walks a mask of its own pairs, so a tile costs the most that
      // one lane holds; each dp is the same sequential product as above.
      unsigned mine = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) mine |= unsigned(cancels(j, c)) << (4 * j + c);
      while (__any_sync(0xffffffffu, mine != 0u)) {
        if (mine != 0u) {
          const int s = __ffs(mine) - 1, j = s >> 2, c = s & 3;
          mine &= mine - 1u;
          const float x = dot_fma<DV>(Ob + (8 * j + 2 * t + (c & 1)) * LDV,
                                      Vs + (rw + g + 8 * (c >> 1)) * LDV);
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
#pragma unroll
            for (int cc = 0; cc < 4; ++cc)
              if (4 * jj + cc == s) dpt[jj][cc] = x;
        }
      }
    }
    // the capped logits: scale on the float32 sums, the shared exact tanh
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) st[j][c] *= scale;
    if (cap > 0.f) softcap_tile(flat<32>(st), cap);
    // the mask, in the fragment's coordinates, only on a tile with a
    // masked pair
    auto grads = [&](auto masked) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int qi = 8 * j + 2 * t + (c & 1), kj = rw + g + 8 * (c >> 1);
          const bool ok = !decltype(masked)::value || k0 + kj < eb[qi];
          st[j][c] = grad_pair(st[j][c], dpt[j][c], ok, lb[qi], db[qi].x, cap, inv_cap);
        }
    };
    if (full)
      grads(std::false_type());
    else
      grads(std::true_type());
    // dV += p^T dO and dK += ds^T Q over the warp's DW columns: p^T and
    // ds^T are A fragments as they stand. p^T goes in as a bf16 pair hi +
    // lo: rounded once, p's error reaches dV through dO, whose rows can
    // span orders of magnitude (LASER's dO = g / O) and cancel, far beyond
    // the rounding of dV itself
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      uint32_t pa[4], pl[4], sa[4];
      acc_to_a(pa, st[j], st[j + 1]);
      acc_to_a_residual(pl, pa, st[j], st[j + 1]);
      acc_to_a(sa, dpt[j], dpt[j + 1]);
      if constexpr (DV == D) {
#pragma unroll
        for (int c = 0; c < DW / 8; c += 2) {
          uint32_t of[4], qf[4];
          ldsm_x4_t(of, ldsm_rows(Ob, LD, 8 * j, cw + 8 * c, lane));
          ldsm_x4_t(qf, ldsm_rows(Qb, LD, 8 * j, cw + 8 * c, lane));
          mma(dv[c], pa, of[0], of[1]);
          mma(dv[c], pl, of[0], of[1]);
          mma(dv[c + 1], pa, of[2], of[3]);
          mma(dv[c + 1], pl, of[2], of[3]);
          mma(dk[c], sa, qf[0], qf[1]);
          mma(dk[c + 1], sa, qf[2], qf[3]);
        }
      } else {
#pragma unroll
        for (int c = 0; c < DWV / 8; c += 2) {
          uint32_t of[4];
          ldsm_x4_t(of, ldsm_rows(Ob, LDV, 8 * j, cwv + 8 * c, lane));
          mma(dv[c], pa, of[0], of[1]);
          mma(dv[c], pl, of[0], of[1]);
          mma(dv[c + 1], pa, of[2], of[3]);
          mma(dv[c + 1], pl, of[2], of[3]);
        }
#pragma unroll
        for (int c = 0; c < DW / 8; c += 2) {
          uint32_t qf[4];
          ldsm_x4_t(qf, ldsm_rows(Qb, LD, 8 * j, cw + 8 * c, lane));
          mma(dk[c], sa, qf[0], qf[1]);
          mma(dk[c + 1], sa, qf[2], qf[3]);
        }
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
    buf ^= 1;
  }
  cp_async_wait<0>();

  bf16* dkb = static_cast<bf16*>(P.dk) + head_base(P.nhd, bi, head, H, nkv, D);
  bf16* dvb = static_cast<bf16*>(P.dv) + head_base(P.nhd, bi, head, H, nkv, DV);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = k0 + rw + g + 8 * half;
    if (r >= nkv) continue;
    if constexpr (DV == D) {
#pragma unroll
      for (int c = 0; c < DW / 8; ++c) {
        const int col = cw + 8 * c + 2 * t;
        float x0 = dk[c][2 * half] * scale, x1 = dk[c][2 * half + 1] * scale;
        if (ROPE) unrotate_pair(x0, x1, P.cos, P.sin, (size_t(bi) * nkv + r) * D + col);
        *reinterpret_cast<uint32_t*>(dkb + size_t(r) * rs + col) = pack_bf16(x0, x1);
        *reinterpret_cast<uint32_t*>(dvb + size_t(r) * rs + col) =
            pack_bf16(dv[c][2 * half], dv[c][2 * half + 1]);
      }
    } else {  // no RoPE
#pragma unroll
      for (int c = 0; c < DW / 8; ++c) {
        const int col = cw + 8 * c + 2 * t;
        *reinterpret_cast<uint32_t*>(dkb + size_t(r) * rs + col) =
            pack_bf16(dk[c][2 * half] * scale, dk[c][2 * half + 1] * scale);
      }
#pragma unroll
      for (int c = 0; c < DWV / 8; ++c) {
        const int col = cwv + 8 * c + 2 * t;
        *reinterpret_cast<uint32_t*>(dvb + size_t(r) * rsv + col) =
            pack_bf16(dv[c][2 * half], dv[c][2 * half + 1]);
      }
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

template <int D, bool ROPE, int DV = D>
int launch(const Params& P, int b, float* dq_acc, cudaStream_t stream) {
  const int smem = int(Lay<D, DV>::kBytes);
  const long long kv_blocks = (long long)b * P.H * ((P.nkv + TB - 1) / TB);
  if (kv_blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  auto dkv = flash_bwd_dkv_tc<D, ROPE, DV>;
  cudaError_t err = cudaFuncSetAttribute(dkv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  dkv<<<unsigned(kv_blocks), Lay<D, DV>::TT, smem, stream>>>(P, dq_acc);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  const size_t pairs = size_t(b) * P.H * P.nq * (D / 2);
  const unsigned grid = unsigned(std::min<size_t>((pairs + 255) / 256, 132 * 16));
  flash_bwd_dq_store<D, ROPE><<<grid, 256, 0, stream>>>(P, dq_acc, pairs);
  return int(cudaGetLastError());
}

int dispatch(int d, int dv, const Params& P, int b, float* dq_acc, cudaStream_t stream) {
  const bool rope = P.cos != nullptr;  // a template flag: no branch in the loads
  if (dv != d) {  // unequal widths: head-major, no RoPE
    if (d == 192 && dv == 128 && !rope && !P.nhd)
      return launch<192, false, 128>(P, b, dq_acc, stream);
    return int(cudaErrorInvalidValue);
  }
  switch (d) {
    case 32:
      return rope ? launch<32, true>(P, b, dq_acc, stream) : launch<32, false>(P, b, dq_acc, stream);
    case 64:
      return rope ? launch<64, true>(P, b, dq_acc, stream) : launch<64, false>(P, b, dq_acc, stream);
    case 128:
      return rope ? launch<128, true>(P, b, dq_acc, stream)
                  : launch<128, false>(P, b, dq_acc, stream);
    case 256:
      return rope ? launch<256, true>(P, b, dq_acc, stream)
                  : launch<256, false>(P, b, dq_acc, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace tc

}  // namespace

// q/dq [b,h,nq,d], dout [b,h,nq,d_v], k/dk [b,h,nkv,d], v/dv [b,h,nkv,d_v]
// (nhd = 0) or the token-major [b,n,h*d] (nhd = 1, d_v = d), contiguous,
// bf16 (is_bf16=1; q, k, v, dout and cos/sin 16-byte aligned) or float32;
// d = d_v in {32, 64, 128, 256}, or (d, d_v) = (192, 128) head-major without
// RoPE; lse and delta float32 [b,h,nq];
// spans int32 [b,m,3] (any m); cos/sin float32 [b,nq,d] or NULL (needs
// nq == nkv when given); dq_acc and cancel: for bf16 a zeroed float32
// [b,h,nq,d] scratch and a float32 [b*h*(2*nq+1)] one (`cancel_bounds`'s
// (delta, bound) pairs and the heads' largest |v|), for float32 NULL;
// ends: an int32 [b,nq] scratch (each q row's visible end, written here
// first).
// Returns the cudaError_t of the launches (0 = success).
extern "C" int flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                         const float* lse, const float* delta, float* cancel,
                         const int* spans, int m,
                         const float* cos, const float* sin, void* dq, void* dk, void* dv,
                         float* dq_acc, int* ends, int b, int h, int nq, int nkv, int d,
                         int d_v, int q_off, int kv_off, int nhd, float scale, float softcap,
                         int is_bf16, void* stream) {
  if (m < 0 || nq <= 0 || nkv <= 0 || ends == nullptr) return int(cudaErrorInvalidValue);
  if ((cos == nullptr) != (sin == nullptr) || (cos != nullptr && nq != nkv))
    return int(cudaErrorInvalidValue);
  if ((dq_acc != nullptr) != (is_bf16 != 0) || (cancel != nullptr) != (is_bf16 != 0))
    return int(cudaErrorInvalidValue);
  float2* pairs = reinterpret_cast<float2*>(cancel);
  const Params P{q,  k,  v,  dout, lse, delta, cos,   sin,    pairs, spans, ends,   dq,
                 dk, dv, m,  h,    nq,  nkv,   q_off, kv_off, nhd,   scale, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t rows = size_t(b) * nq;
  row_ends<<<unsigned((rows + 255) / 256), 256, 0, s>>>(P, b);
  if (cudaError_t err = cudaGetLastError(); err != cudaSuccess) return int(err);
  if (is_bf16) {
    if (d_v != 32 && d_v != 64 && d_v != 128 && d_v != 256) return int(cudaErrorInvalidValue);
    const size_t bh = size_t(b) * h;
    unsigned* vmax = reinterpret_cast<unsigned*>(cancel + 2 * bh * nq);
    cudaError_t err = cudaMemsetAsync(vmax, 0, bh * sizeof(unsigned), s);
    if (err != cudaSuccess) return int(err);
    const int per = 2048 / d_v;  // rows a block of the two (rows of v and dO: d_v wide)
    tc::v_norm_max<<<unsigned(bh * ((nkv + per - 1) / per)), 256, 0, s>>>(P, d_v, vmax);
    tc::cancel_bounds<<<unsigned(bh * ((nq + per - 1) / per)), 256, 0, s>>>(P, d_v, vmax);
    if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
    return tc::dispatch(d, d_v, P, b, dq_acc, s);
  }
  return dispatch_d<float>(d, d_v, P, b, s);
}
