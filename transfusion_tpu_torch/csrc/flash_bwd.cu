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
// bf16, the head-major RoPE-free calls at (d, d_v) = (64, 64) and (192,
// 128) (the training cells: every layer of n 4096 and 16384 takes the
// head-major route): a Hopper warpgroup design, namespace `wg` below.
//   * A block of three warpgroups per (b*h, kv tile): one producer warp
//     (setmaxnreg 24) brings K and V once, then each q tile's Q and dO by
//     TMA (128-byte swizzled boxes of 64 columns, rows past n zero-filled)
//     and its rows' lse, (delta, bound) and visible ends, through a ring of
//     2 stages of mbarriers; two consumer warpgroups (setmaxnreg 240) run
//     wgmma m64nNk16 on the tiles that have arrived.
//   * d 64: a block holds 128 kv rows, 64 a consumer, whose K and V rows
//     sit in registers as the A operand of s^T = K Q^T and dp^T = V dO^T
//     (B read from the swizzled tile); q . k 192 / v 128: both consumers
//     share a 64-row kv tile, each computing s^T and dp^T, and split the
//     64-column blocks of dK, dV and dQ (0 and 2 / 1 of d, 0 / 1 of d_v),
//     so that no sum spills (`-Xptxas -v`: 168 registers at launch, no
//     spill at either width).
//   * Then the tc kernel's per-pair float32 step on the accumulator
//     fragments (same layout as mma.sync's C fragments): the shared exact
//     tanh, exp2 of (s - lse) log2 e (flushed to 0 below 2^-126), the mask
//     by visible end on partial tiles only, p as a bf16 pair hi + lo into
//     dV += p^T dO (register A, dO read MN-major), ds = p (dp - delta) (1 -
//     (s / cap)^2) (p times the chain formed first) into dK += ds^T Q. The
//     cancellation rule as below, each lane walking a mask of its own
//     cancelling pairs, dp summed by `dot_fma` through the swizzle. Issued
//     in order s^T, dp^T; p while dp^T runs; dV; ds while dV runs; dK.
//   * dQ: ds^T to shared memory once (swizzled), dQ = ds K by wgmma with
//     both operands MN-major (d 64: each consumer 32 of the columns over
//     all 128 kv rows; the pair: its blocks), added into dq_acc with
//     8-byte atomics; `flash_bwd_dq_store` scales and stores it.
//   * The grid is one-dimensional in groups of 16 heads: within a group kv
//     tile 0 of each head first (the longest walk under causality), then
//     tile 1, ..., so that the blocks in flight share a few heads' q, dO and
//     dq rows in L2 (at b8 h16 n4096 the dq scratch is 403 MB; all heads at
//     once took the pair's call from 10.0 to 20.0 ms on the H100).
//   * What bounds it: the per-pair float32 work, not the products. At d 64
//     with the softcap on, b1 h16 n16384 runs 6.8 ms against 1.39 ms of
//     products at the bf16 peak; without that float32 work (timing only)
//     3.7 ms. Two consumer warpgroups leave two warps a scheduler to hide
//     its latency; issuing the next tile's s^T early made ptxas serialize
//     every wgmma (a product's sums read across loop iterations), and
//     taking a tile in two halves of 32 q rows was slower.
//
// bf16, the rest (d 32, 128 and 256, RoPE, the token-major layout): the
// mma.sync design, namespace `tc` below. The warpgroup kernel takes neither
// RoPE's rotation of q and k on load nor the token-major rows (TMA boxes of
// one head's contiguous rows); d 32, 128 and 256 are not instantiated for
// it (no training cell runs them; d 128 would take the pair's column split).
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
// Value width. The FMA kernels take the q . k width D and the value width
// DV as template parameters (DV = D unless given). (D, DV) = (192, 128), the
// latent attention of DeepSeek-V3-style blocks (128 dims without RoPE and 64
// with it beside 128-dim values), is instantiated head-major without RoPE
// (the warpgroup kernel for bf16): s^T and dK, dQ run over D columns, dp^T
// and dV over DV. Padding such a head to d 256 would waste a third of the
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

#include <dlfcn.h>

#include <algorithm>
#include <type_traits>

#include "attn_tile.cuh"
#include "mma_tile.cuh"
#include "wgmma_tile.cuh"

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

// D: the head width (q, k, v)
template <int D>
struct Lay {
  static constexpr int LD = D + 8;    // padded bf16 row stride of a [64][D] tile
  static constexpr int TILE = TB * LD;
  static constexpr int SLD = TB + 8;  // row stride of the ds^T tile
  // warps per 16 kv rows: each computes those rows' s^T and dp^T and owns
  // DW = D / DS columns of dK, dV and dQ. From d 128 one such warp per 64
  // columns keeps its sums beside the score fragments in registers (d 128:
  // 2 warps, no spills; d 256: 4 warps, 512 threads, at most 128 registers
  // a thread).
  static constexpr int DS = D > 64 ? D / 64 : 1;
  static constexpr int DW = D / DS;
  static constexpr int TT = 32 * 4 * DS;  // threads of a block
  // K, V, 2 x Q and 2 x dO tiles, the ds^T tile, 2 x 64 lse, 2 x 64
  // (delta, its bound) and 2 x 64 visible ends
  static constexpr size_t kBytes =
      (6 * size_t(TILE) + size_t(TB) * SLD) * sizeof(bf16) +
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
// acc + x . y over the 8 bf16 values of two 16-byte chunks, as sequential
// float32 FMAs
__device__ __forceinline__ float fma8(float acc, uint4 a, uint4 b) {
  const uint32_t aw[4] = {a.x, a.y, a.z, a.w}, bw[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {  // the low half is the earlier element
    acc = fmaf(__uint_as_float(aw[e] << 16), __uint_as_float(bw[e] << 16), acc);
    acc = fmaf(__uint_as_float(aw[e] & 0xffff0000u), __uint_as_float(bw[e] & 0xffff0000u),
               acc);
  }
  return acc;
}

template <int D>
__device__ __forceinline__ float dot_fma(const bf16* x, const bf16* y) {
  float acc = 0.f;
#pragma unroll 1
  for (int d = 0; d < D; d += 8)
    acc = fma8(acc, *reinterpret_cast<const uint4*>(x + d),
               *reinterpret_cast<const uint4*>(y + d));
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
template <int D, bool ROPE>
__global__ void __launch_bounds__(Lay<D>::TT)
    flash_bwd_dkv_tc(const Params P, float* dq_acc) {
  using L = Lay<D>;
  constexpr int LD = L::LD, TILE = L::TILE, SLD = L::SLD, DW = L::DW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + TILE;
  bf16* Qs = Vs + TILE;       // two buffers
  bf16* Os = Qs + 2 * TILE;   // two buffers of dO
  bf16* Ss = Os + 2 * TILE;   // ds^T [kv][q]
  float* ls = reinterpret_cast<float*>(Ss + TB * SLD);  // two buffers of lse
  float2* dls = reinterpret_cast<float2*>(ls + 2 * TB);  // two buffers of (delta, bound)
  int* es = reinterpret_cast<int*>(dls + 2 * TB);        // two buffers of visible ends

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  // this warp's 16 rows of the tile (kv rows of s^T, dK, dV; q rows of dQ)
  // and the first of the DW columns of dK, dV and dQ it owns
  const int rw = 16 * (w & 3), cw = (w >> 2) * DW;
  const int H = P.H, nq = P.nq, nkv = P.nkv;
  const int BH = gridDim.x / ((nkv + TB - 1) / TB);
  const int bh = blockIdx.x % BH, bi = bh / H, head = bh - bi * H;
  const int k0 = (blockIdx.x / BH) * TB, kg = k0 + P.kv_off;
  const size_t rs = row_stride(P.nhd, H, D);
  const bf16* qb = static_cast<const bf16*>(P.q) + head_base(P.nhd, bi, head, H, nq, D);
  const bf16* ob = static_cast<const bf16*>(P.dout) + head_base(P.nhd, bi, head, H, nq, D);
  const bf16* kb = static_cast<const bf16*>(P.k) + head_base(P.nhd, bi, head, H, nkv, D);
  const bf16* vb = static_cast<const bf16*>(P.v) + head_base(P.nhd, bi, head, H, nkv, D);
  const float* lse = P.lse + size_t(bh) * nq;
  const float2* delta = P.cancel + size_t(bh) * nq;
  const float scale = P.scale, cap = P.softcap, inv_cap = cap > 0.f ? 1.f / cap : 0.f;
  const int* sp = P.spans + size_t(bi) * P.m * 3;
  const int* ends = P.ends + size_t(bi) * nq;

  if (ROPE)
    copy_rows_regs<D, LD, TB, L::TT, true>(Ks, kb, rs, k0, nkv, P.cos, P.sin, bi, 1.f);
  else
    copy_rows_async<D, LD, TB, L::TT>(Ks, kb, rs, k0, nkv);
  copy_rows_async<D, LD, TB, L::TT>(Vs, vb, rs, k0, nkv);

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
    copy_rows_async<D, LD, TB, L::TT>(Os + buf * TILE, ob, rs, q0, nq);
    async_row_stats<L::TT>(ls + buf * TB, dls + buf * TB, es + buf * TB, lse, delta, ends, q0,
                           nq);
  };

  float dk[DW / 8][4] = {}, dv[DW / 8][4] = {};
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
    const bf16* Ob = Os + buf * TILE;
    const float* lb = ls + buf * TB;
    const float2* db = dls + buf * TB;  // (delta, its bound)
    const int* eb = es + buf * TB;  // 0 past nq
    // full: every pair visible (the tile's first row sees the whole kv tile)
    const bool full = eb[0] >= k0 + TB && q0 + TB <= nq;

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

}  // namespace tc

// ---------------------------------------------------------------------------
// bf16, head-major, no RoPE, (d, d_v) = (64, 64) or (192, 128): warpgroups
// (see the note at the top)
// ---------------------------------------------------------------------------

namespace wg {

using namespace mma_tile;
using namespace wgmma_tile;
using bf16 = __nv_bfloat16;

constexpr int BQ = 64;      // q rows of a tile
constexpr int STAGES = 2;   // Q / dO tiles in flight
constexpr int NTH = 384;    // the producer warpgroup, then two consumer warpgroups
// registers a thread after setmaxnreg: the block is launched with 168 a
// thread (65536 / 384, rounded down to 8), and the consumers' increase
// must come out of what the producer gives back, or they wait for ever
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
static_assert(128 * PRODUCER_REGS + 256 * CONSUMER_REGS == NTH * 168,
              "setmaxnreg: the warpgroups' registers must add up to the launch's");

template <int D, int DV>
struct Cfg {
  // SPLIT (value width 128): the two consumer warpgroups share one 64-row
  // kv tile, each computing its s^T and dp^T, and split the 64-column blocks
  // of dK, dV and dQ (blocks cw, cw + 2, .. of d; block cw of d_v), so that
  // their sums fit beside the scores. Else (d 64) each owns 64 of the
  // block's 128 kv rows with all their columns, and half of dQ's columns,
  // and holds its K and V rows in registers as the A operand of s^T and
  // dp^T (RS).
  static constexpr bool SPLIT = DV > 64, RS = !SPLIT;
  static constexpr int BN = SPLIT ? 64 : 128;        // kv rows of a block
  static constexpr int NB = D / 64, NBV = DV / 64;   // 64-column blocks of q, k and of v, dO
  static constexpr int QBLK = BQ * 128, KBLK = BN * 128;  // bytes of one block of a tile
  static constexpr int STAGE = (NB + NBV) * QBLK;    // a stage's Q and dO tiles
  // ds^T [kv][q] as bf16, for dQ: SPLIT, one [64][64] buffer a warpgroup;
  // else two [128][64] (by the q tile's parity) that hold both
  // warpgroups' rows
  static constexpr int DSB = SPLIT ? 64 * 128 : 128 * 128;
  static constexpr int K_OFF = 0, V_OFF = NB * KBLK, Q_OFF = V_OFF + NBV * KBLK;
  static constexpr int DS_OFF = Q_OFF + STAGES * STAGE;
  // a stage's row statistics: lse [64], (delta, bound) [64], visible ends [64]
  static constexpr int ST_OFF = DS_OFF + 2 * DSB, ST_BYTES = BQ * 16;
  static constexpr int BAR_OFF = ST_OFF + STAGES * ST_BYTES;  // full[STAGES], empty[STAGES], kv
  static constexpr int BYTES = BAR_OFF + (2 * STAGES + 1) * 8;
  // consumer warpgroup cw's 64-column blocks of dK (SPLIT: and of dQ): how
  // many, and the i-th
  __host__ __device__ static constexpr int nkb(int cw) {
    return SPLIT ? (NB - cw + 1) / 2 : NB;
  }
  __host__ __device__ static constexpr int kb(int cw, int i) { return SPLIT ? cw + 2 * i : i; }
};

struct Maps {
  CUtensorMap q, dout, k, v;  // [b*h][n][width] bf16, boxes of [rows][64]
};

// x . y over W bf16 values of row ra of swizzled tile a and row rb of
// swizzled tile b (64-column blocks a_blk / b_blk bytes apart), as
// sequential float32 FMAs from element 0: tc `dot_fma` read through the
// swizzle
template <int W>
__device__ __forceinline__ float dot_fma_swz(const unsigned char* a, int a_blk, int ra,
                                             const unsigned char* b, int b_blk, int rb) {
  float acc = 0.f;
#pragma unroll 1
  for (int d = 0; d < W; d += 8) {
    const int blk = d >> 6, ch = (d >> 3) & 7;
    acc = tc::fma8(acc, *reinterpret_cast<const uint4*>(a + blk * a_blk + swz(ra, ch)),
                   *reinterpret_cast<const uint4*>(b + blk * b_blk + swz(rb, ch)));
  }
  return acc;
}

// The producer warp: K and V of the block once, then for each q tile its
// Q and dO tiles (TMA) and its rows' lse, (delta, bound) and visible ends
// into the next free stage; the statistics of the tile after are read from
// device memory while it waits for a stage.
template <int D, int DV>
__device__ __forceinline__ void produce(const Maps& M, const Params& P, unsigned char* sm,
                                        int bh, int bi, int k0, int lo) {
  using C = Cfg<D, DV>;
  const int lane = threadIdx.x;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* kv_bar = empty + STAGES;
  if (lane == 0) {
    mbar_arrive_expect_tx(kv_bar, (C::NB + C::NBV) * C::KBLK);
#pragma unroll
    for (int cb = 0; cb < C::NB; ++cb)
      tma_load_3d(sm + C::K_OFF + cb * C::KBLK, &M.k, kv_bar, 64 * cb, k0, bh);
#pragma unroll
    for (int cb = 0; cb < C::NBV; ++cb)
      tma_load_3d(sm + C::V_OFF + cb * C::KBLK, &M.v, kv_bar, 64 * cb, k0, bh);
  }
  const int nq = P.nq, n_q_tiles = (nq + BQ - 1) / BQ;
  const float* lse = P.lse + size_t(bh) * nq;
  const float2* cancel = P.cancel + size_t(bh) * nq;
  const int* ends = P.ends + size_t(bi) * nq;
  // rows lane and lane + 32 of a tile; 0 past nq
  float l[2];
  float2 dl[2];
  int e[2];
  auto read = [&](int iq) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gq = iq * BQ + lane + 32 * h;
      const bool in = gq < nq;
      l[h] = in ? lse[gq] : 0.f;
      dl[h] = in ? cancel[gq] : make_float2(0.f, 0.f);
      e[h] = in ? ends[gq] : 0;
    }
  };
  if (lo < n_q_tiles) read(lo);
  for (int it = 0, iq = lo; iq < n_q_tiles; ++it, ++iq) {
    const int s = it % STAGES, q0 = iq * BQ;
    mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
    unsigned char* stats = sm + C::ST_OFF + s * C::ST_BYTES;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      reinterpret_cast<float*>(stats)[lane + 32 * h] = l[h];
      reinterpret_cast<float2*>(stats + BQ * 4)[lane + 32 * h] = dl[h];
      reinterpret_cast<int*>(stats + BQ * 12)[lane + 32 * h] = e[h];
    }
    if (lane == 0) {  // rows past nq come zero-filled
      unsigned char* Qb = sm + C::Q_OFF + s * C::STAGE;
      mbar_arrive_expect_tx(&full[s], C::STAGE);
#pragma unroll
      for (int cb = 0; cb < C::NB; ++cb)
        tma_load_3d(Qb + cb * C::QBLK, &M.q, &full[s], 64 * cb, q0, bh);
#pragma unroll
      for (int cb = 0; cb < C::NBV; ++cb)
        tma_load_3d(Qb + (C::NB + cb) * C::QBLK, &M.dout, &full[s], 64 * cb, q0, bh);
    } else {
      mbar_arrive(&full[s]);
    }
    if (iq + 1 < n_q_tiles) read(iq + 1);
  }
}

// Consumer warpgroup CW: its 64 kv rows' dK and dV over the q tiles, and
// its share of each q tile's dQ added into dq_acc. A tile's products are
// issued as their operands are ready, so that the float32 work overlaps
// the tensor cores: s^T, then dp^T; p while dp^T runs; dV += p^T dO, then
// ds while dV runs; dK += ds^T Q; dQ = ds K. CAP: a softcap.
template <int D, int DV, int CW, bool CAP>
__device__ __forceinline__ void consume(const Params& P, float* dq_acc, unsigned char* sm,
                                        int bh, int k0, int lo) {
  using C = Cfg<D, DV>;
  constexpr int NK = C::nkb(CW);          // its blocks of dK
  constexpr int VB = C::SPLIT ? CW : 0;   // its block of dV
  const int ct = threadIdx.x - 128 * (CW + 1);
  const int lane = ct & 31, g = lane >> 2, t = lane & 3, rw = 16 * (ct >> 5);
  const int kr = C::SPLIT ? 0 : 64 * CW;  // its first kv row in the block
  const int nq = P.nq, nkv = P.nkv, k0w = k0 + kr, n_q_tiles = (nq + BQ - 1) / BQ;
  const float scale = P.scale, cap = P.softcap, inv_cap = CAP ? 1.f / cap : 0.f;
  const unsigned char* Ks = sm + C::K_OFF;
  const unsigned char* Vs = sm + C::V_OFF;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* kv_bar = empty + STAGES;
  // K-major descriptors of this warpgroup's rows of K and V (A of s^T, dp^T)
  const uint64_t kd = desc(Ks + kr * 128, 16, 1024), vd = desc(Vs + kr * 128, 16, 1024);

  float dk[NK][8][4] = {}, dv[8][4] = {};
  mbar_wait(kv_bar, 0);
  // RS: this warpgroup's rows of K and V as the register A operand, loaded
  // once
  uint32_t kf[4][4], vf[4][4];
  if constexpr (C::RS) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int off = swz(kr + rw + (lane & 15), 2 * kk + (lane >> 4));
      ldsm_x4(kf[kk], Ks + off);
      ldsm_x4(vf[kk], Vs + off);
    }
  }
  for (int it = 0, iq = lo; iq < n_q_tiles; ++it, ++iq) {
    const int s = it % STAGES, q0 = iq * BQ;
    mbar_wait(&full[s], (it / STAGES) & 1);
    const unsigned char* Qb = sm + C::Q_OFF + s * C::STAGE;
    const unsigned char* Ob = Qb + C::NB * C::QBLK;
    const unsigned char* stats = sm + C::ST_OFF + s * C::ST_BYTES;
    const float* lb = reinterpret_cast<const float*>(stats);
    const float2* db = reinterpret_cast<const float2*>(stats + BQ * 4);  // (delta, its bound)
    const int* eb = reinterpret_cast<const int*>(stats + BQ * 12);        // 0 past nq
    // every pair visible: the tile's first row sees all of this warpgroup's kv rows
    const bool full_tile = eb[0] >= k0w + 64 && q0 + BQ <= nq;

    // transposed scores: rows are kv rows rw + (g, g + 8), columns q rows
    float st[8][4] = {}, dpt[8][4] = {};
    const uint64_t qd = desc(Qb, 16, 1024), od = desc(Ob, 16, 1024);
    wg_fence();
    if constexpr (C::RS) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) mma_rs_n64<0>(st, kf[kk], qd + kk * 2);  // +32 bytes
      wg_commit();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) mma_rs_n64<0>(dpt, vf[kk], od + kk * 2);
      wg_commit();
    } else {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)  // +32 bytes a k-step, the next block every 4
        mma_ss_n64<0, 0>(st, kd + (((kk / 4) * C::KBLK + (kk % 4) * 32) >> 4),
                         qd + (((kk / 4) * C::QBLK + (kk % 4) * 32) >> 4), kk > 0);
      wg_commit();
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk)
        mma_ss_n64<0, 0>(dpt, vd + (((kk / 4) * C::KBLK + (kk % 4) * 32) >> 4),
                         od + (((kk / 4) * C::QBLK + (kk % 4) * 32) >> 4), kk > 0);
      wg_commit();
    }
    wg_wait<1>();  // s^T
    fence_regs(st);

    // the capped logits (scale on the float32 sums, the shared exact
    // tanh), then per pair p (into the A operand of dV, as a bf16 pair hi
    // + lo as the tc kernel takes it) and p times the softcap's chain rule
    // (over st); the mask only on a tile with a masked pair
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) st[j][c] *= scale;
    if constexpr (CAP) softcap_tile(flat<32>(st), cap);
    uint32_t pa[4][4], pl[4][4];
    auto probs = [&](auto masked) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float pv[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = 2 * kk + h, qi = 8 * j + 2 * t + (c & 1), kj = rw + g + 8 * (c >> 1);
            const float x = st[j][c];
            // exp2 of a normal result is exact as the tc kernel's exp2f;
            // below 2^-126 it flushes to 0
            pv[h][c] = exp2_ftz((x - lb[qi]) * LOG2E);
            if (decltype(masked)::value && k0w + kj >= eb[qi]) pv[h][c] = 0.f;
            if constexpr (CAP) {
              const float th = x * inv_cap;
              st[j][c] = pv[h][c] * (1.f - th * th);
            } else {
              st[j][c] = pv[h][c];
            }
          }
        acc_to_a(pa[kk], pv[0], pv[1]);
        acc_to_a_residual(pl[kk], pa[kk], pv[0], pv[1]);
      }
    };
    if (full_tile)
      probs(std::false_type());
    else
      probs(std::true_type());
    // dV += p^T dO: A from registers, dO read MN-major (16 q rows a
    // k-step: 2048 bytes)
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t ob = desc(Ob + VB * C::QBLK + kk * 2048, C::QBLK, 1024);
      mma_rs_n64<1>(dv, pa[kk], ob);
      mma_rs_n64<1>(dv, pl[kk], ob);
    }
    wg_commit();
    wg_wait<1>();  // dp^T
    fence_regs(dpt);

    // dp - delta, over dpt. Where it cancels to within its row's bound,
    // dp is the plain version's sequential float32 product (tc kernel's
    // rule): rare, one warp-wide test first, then each lane walks a mask
    // of its own pairs
    bool any = false;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float2 dl = db[8 * j + 2 * t + (c & 1)];
        dpt[j][c] -= dl.x;
        any |= fabsf(dpt[j][c]) < dl.y;
      }
    if (__any_sync(0xffffffffu, any)) {
      unsigned mine = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          mine |= unsigned(fabsf(dpt[j][c]) < db[8 * j + 2 * t + (c & 1)].y) << (4 * j + c);
      while (__any_sync(0xffffffffu, mine != 0u)) {
        if (mine != 0u) {
          const int sl = __ffs(mine) - 1, j = sl >> 2, c = sl & 3, qi = 8 * j + 2 * t + (c & 1);
          mine &= mine - 1u;
          const float x = dot_fma_swz<DV>(Ob, C::QBLK, qi, Vs, C::KBLK,
                                          kr + rw + g + 8 * (c >> 1)) - db[qi].x;
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
#pragma unroll
            for (int cc = 0; cc < 4; ++cc)
              if (4 * jj + cc == sl) dpt[jj][cc] = x;
        }
      }
    }
    // ds = p (dp - delta) (1 - (s / cap)^2), over dpt; ds^T to shared
    // memory (swizzled, as TMA lays a tile) for dQ
    const int buf = C::SPLIT ? CW : (it & 1);
    unsigned char* dsb = sm + C::DS_OFF + buf * C::DSB;
    {
      const int r = (C::SPLIT ? 0 : kr) + rw + g;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) dpt[j][c] *= st[j][c];
        *reinterpret_cast<uint32_t*>(dsb + swz(r, j) + 4 * t) = pack_bf16(dpt[j][0], dpt[j][1]);
        *reinterpret_cast<uint32_t*>(dsb + swz(r + 8, j) + 4 * t) =
            pack_bf16(dpt[j][2], dpt[j][3]);
      }
      fence_proxy_async();
    }
    // dK += ds^T Q: A from registers, Q read MN-major
    uint32_t sa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a(sa[kk], dpt[2 * kk], dpt[2 * kk + 1]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < NK; ++i)
        mma_rs_n64<1>(dk[i], sa[kk],
                      desc(Qb + C::kb(CW, i) * C::QBLK + kk * 2048, C::QBLK, 1024));
    wg_commit();

    // dQ = ds K, this warpgroup's share (SPLIT: its blocks; else half the
    // columns): A is ds^T read MN-major, B is K read MN-major; added into
    // dq_acc
    constexpr int DQB = C::SPLIT ? NK : 1, DQT = C::SPLIT ? 8 : 4;
    float dq[DQB][DQT][4];
    if constexpr (C::SPLIT) {
      wg_wait<0>();  // free the A registers before dQ's sums
      fence_regs(dv);
#pragma unroll
      for (int i = 0; i < NK; ++i) fence_regs(dk[i]);
      bar_sync(2 + CW, 128);  // this warpgroup's ds^T complete
      wg_fence();
#pragma unroll
      for (int i = 0; i < NK; ++i)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          mma_ss_n64<1, 1>(dq[i], desc(dsb + kk * 2048, C::DSB, 1024),
                           desc(Ks + C::kb(CW, i) * C::KBLK + kk * 2048, C::KBLK, 1024), kk > 0);
    } else {
      bar_sync(1, 256);  // both warpgroups' ds^T rows complete
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < C::BN / 16; ++kk)  // columns 32 CW .. 32 CW + 31 of K
        mma_ss_n32<1, 1>(dq[0], desc(dsb + kk * 2048, C::DSB, 1024),
                         desc(Ks + 64 * CW + kk * 2048, C::KBLK, 1024), kk > 0);
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(dv);
#pragma unroll
    for (int i = 0; i < NK; ++i) fence_regs(dk[i]);
#pragma unroll
    for (int i = 0; i < DQB; ++i) fence_regs(dq[i]);
    mbar_arrive(&empty[s]);  // this stage's Q, dO and statistics are read
    {
      const int r = q0 + rw + g;
      float* row = dq_acc + (size_t(bh) * nq + r) * D + 2 * t;
#pragma unroll
      for (int i = 0; i < DQB; ++i)
#pragma unroll
        for (int j = 0; j < DQT; ++j) {
          const int col = (C::SPLIT ? 64 * C::kb(CW, i) : 32 * CW) + 8 * j;
          if (r < nq) atomic_add2(row + col, dq[i][j][0], dq[i][j][1]);
          if (r + 8 < nq) atomic_add2(row + 8 * D + col, dq[i][j][2], dq[i][j][3]);
        }
    }
  }

  bf16* dkb = static_cast<bf16*>(P.dk) + size_t(bh) * nkv * D;
  bf16* dvb = static_cast<bf16*>(P.dv) + size_t(bh) * nkv * DV;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = k0w + rw + g + 8 * half;
    if (r >= nkv) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int i = 0; i < NK; ++i) {
        const int col = 64 * C::kb(CW, i) + 8 * j + 2 * t;
        *reinterpret_cast<uint32_t*>(dkb + size_t(r) * D + col) =
            pack_bf16(dk[i][j][2 * half] * scale, dk[i][j][2 * half + 1] * scale);
      }
      *reinterpret_cast<uint32_t*>(dvb + size_t(r) * DV + 64 * VB + 8 * j + 2 * t) =
          pack_bf16(dv[j][2 * half], dv[j][2 * half + 1]);
    }
  }
}

// dK and dV of one (b*h, BN-row kv tile), and dQ += ds K of each of its q
// tiles into dq_acc: warpgroup 0 produces (one warp), 1 and 2 consume.
template <int D, int DV, bool CAP>
__global__ void __launch_bounds__(NTH, 1)
    flash_bwd_dkv_tc(const __grid_constant__ Maps M, const Params P, float* dq_acc, int group) {
  using C = Cfg<D, DV>;
  extern __shared__ __align__(128) unsigned char wg_smem[];
  // 1024-byte aligned: the swizzle's rows are the address bits 7-9
  unsigned char* sm = wg_smem + ((1024 - (smem_u32(wg_smem) & 1023)) & 1023);
  // heads in groups of `group`, one group after another; in a group, kv
  // tile 0 of each head first (the longest walk under causality), then
  // tile 1, ..: the blocks in flight share a few heads' q, dO and dq rows
  // in L2
  const int tiles = (P.nkv + C::BN - 1) / C::BN, BH = gridDim.x / tiles;
  const int gi = blockIdx.x / (group * tiles), r = blockIdx.x - gi * group * tiles;
  const int in_group = min(group, BH - gi * group);
  const int bh = gi * group + r % in_group, bi = bh / P.H;
  const int k0 = (r / in_group) * C::BN;
  // the q tiles from the one holding the first row that sees kv column
  // k0 on (as tc's)
  const int lo_tok = first_row_seeing(k0 + P.kv_off, P.spans + size_t(bi) * P.m * 3, P.m);
  const int lo = lo_tok - P.q_off <= 0 ? 0 : (lo_tok - P.q_off) / BQ;
  if (threadIdx.x == 0) {
    uint64_t* bars = reinterpret_cast<uint64_t*>(sm + C::BAR_OFF);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + s, 32);            // full: the producer warp's lanes (and TMA's bytes)
      mbar_init(bars + STAGES + s, 256);  // empty: every consumer thread
    }
    mbar_init(bars + 2 * STAGES, 1);  // K and V
    mbar_fence_init();
  }
  __syncthreads();
  const int wgi = threadIdx.x / 128;
  if (wgi == 0) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x < 32) produce<D, DV>(M, P, sm, bh, bi, k0, lo);
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    if (wgi == 1)
      consume<D, DV, 0, CAP>(P, dq_acc, sm, bh, k0, lo);
    else
      consume<D, DV, 1, CAP>(P, dq_acc, sm, bh, k0, lo);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up in the libcuda the process has loaded
// (the library links against the CUDA runtime only)
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// map of a head-major [bh][n][w] bf16 tensor in boxes of [rows][64],
// 128-byte swizzled; rows past n read as zeros
bool tile_map(CUtensorMap* map, const void* base, int w, int n, size_t bh, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {cuuint64_t(w), cuuint64_t(n), cuuint64_t(bh)};
  const cuuint64_t strides[2] = {cuuint64_t(w) * 2, cuuint64_t(w) * 2 * cuuint64_t(n)};
  const cuuint32_t box[3] = {64, cuuint32_t(rows), 1}, unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int DV>
int launch(const Params& P, int b, float* dq_acc, cudaStream_t stream) {
  using C = Cfg<D, DV>;
  const size_t bh = size_t(b) * P.H;
  const int tiles = (P.nkv + C::BN - 1) / C::BN;
  const long long blocks = (long long)bh * tiles;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  Maps M;
  if (!tile_map(&M.q, P.q, D, P.nq, bh, BQ) || !tile_map(&M.dout, P.dout, DV, P.nq, bh, BQ) ||
      !tile_map(&M.k, P.k, D, P.nkv, bh, C::BN) || !tile_map(&M.v, P.v, DV, P.nkv, bh, C::BN))
    return int(cudaErrorInvalidValue);
  // more than half the SM's shared memory: one block an SM, so that the
  // consumers' setmaxnreg.inc always finds the producer's registers
  const int smem = std::max(C::BYTES + 1024, 116 * 1024);
  auto kern = P.softcap > 0.f ? flash_bwd_dkv_tc<D, DV, true> : flash_bwd_dkv_tc<D, DV, false>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  // 16 heads a group (measured on an H100 at 700 W: at b8 h16 n4096, q k
  // 192 / v 128, 20.0 ms with all 128 heads in flight at once and 10.0
  // ms in groups of 16, whose dq scratch and q, dO rows stay in L2; at b1
  // h16 n16384 d 64, 7.0 ms in groups of 2 and 6.8 in one of 16)
  kern<<<unsigned(blocks), NTH, smem, stream>>>(M, P, dq_acc, int(std::min<size_t>(bh, 16)));
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  const size_t pairs = bh * P.nq * (D / 2);
  const unsigned grid = unsigned(std::min<size_t>((pairs + 255) / 256, 132 * 16));
  tc::flash_bwd_dq_store<D, false><<<grid, 256, 0, stream>>>(P, dq_acc, pairs);
  return int(cudaGetLastError());
}

}  // namespace wg

namespace tc {

// The bf16 backward: the warpgroup kernel for the head-major, RoPE-free
// calls at (d, d_v) = (64, 64) and (192, 128) (design 2), the mma.sync
// kernel for the rest (design 1)
int dispatch(int d, int dv, const Params& P, int b, float* dq_acc, cudaStream_t stream,
             int* design) {
  const bool rope = P.cos != nullptr;  // a template flag: no branch in the loads
  *design = 2;
  if (!rope && !P.nhd && d == 64 && dv == 64) return wg::launch<64, 64>(P, b, dq_acc, stream);
  if (!rope && !P.nhd && d == 192 && dv == 128)
    return wg::launch<192, 128>(P, b, dq_acc, stream);
  *design = 1;
  if (dv != d) return int(cudaErrorInvalidValue);
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
// first); design: where the design of the dK/dV kernel launched is written
// (0: float32 FMA, 1: bf16 mma.sync, 2: bf16 warpgroups).
// Returns the cudaError_t of the launches (0 = success).
extern "C" int flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                         const float* lse, const float* delta, float* cancel,
                         const int* spans, int m,
                         const float* cos, const float* sin, void* dq, void* dk, void* dv,
                         float* dq_acc, int* ends, int b, int h, int nq, int nkv, int d,
                         int d_v, int q_off, int kv_off, int nhd, float scale, float softcap,
                         int is_bf16, int* design, void* stream) {
  if (m < 0 || nq <= 0 || nkv <= 0 || ends == nullptr || design == nullptr)
    return int(cudaErrorInvalidValue);
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
    return tc::dispatch(d, d_v, P, b, dq_acc, s, design);
  }
  *design = 0;
  return dispatch_d<float>(d, d_v, P, b, s);
}
