// Flash-attention forward with the transfusion mask, for Hopper (sm_90a).
//
// Replaces the head-major Pallas TPU forward of
// transfusion_tpu/ops/pallas_attn_kernel.py — `_flash_fwd` and the three
// kernels it routes to: `_kernel_batched_heads` (short sequences, full score
// matrix; row 1 of PERF.md's kernel table), `_kernel` (blocked online
// softmax, K/V resident; row 2) and `_kernel_streamed` (K/V streamed through
// the grid; row 3) — and the token-major `_nhd_pallas` ->
// `_kernel_batched_nhd` (row 5). The splits are TPU VMEM artifacts; here
// every tile streams from device memory, so one design meets all four
// contracts:
//
//   out[i] = softmax_j(cap * tanh((q_i * d^-1/2) . k_j / cap) | allowed) . v
//   allowed(i, j) = i >= j  |  any_m[len_m > 0 & i >= off_m & j < off_m + len_m]
//
// at GLOBAL coordinates i = q_offset + row, j = kv_offset + col, with an
// optional per-row logsumexp. A row that sees no column gets out = 0 and
// lse ~ -1e30 (the contract ring attention merges through).
//
// Two layouts, chosen by `nhd`: head-major q/k/v/out [b, h, n, d] and
// token-major [b, n, h*d]. In both, a head's row r lies at base + r *
// row_stride, so the token-major route needs no transpose copies. With
// cos/sin (float32 [b, n, d]) q and k are rotated on load by the
// interleaved RoPE (pairs 2j, 2j+1) in float32 and rounded to the input
// dtype, as `_rope_tile` does before the product.
//
// Numerics follow the JAX kernel: q is scaled in its own dtype before the
// product, scores and softmax state are float32, probabilities are rounded
// to the value dtype before the PV product (their row sum is not), the
// output is written in q's dtype.
//
// What bounds it on the H100: operations. Two products of n x n x d per
// head over ~4 b h n d elements of traffic: at the main-path shapes (d 64,
// n >= 256) far above the 295 FLOP/byte ridge of the bf16 tensor cores.
//
// bf16 (every main path): tensor cores, namespace `tc` below.
//   * A block of 4 warps owns a q tile of one (b, h): 32 rows a warp (two
//     m-tiles of 16: each K / V fragment read from shared memory feeds two
//     products, as in FlashAttention-2) up to d 64, 16 rows a warp above,
//     where two output accumulators would not fit in registers. The 1-D
//     grid launches the last q tile of every head first: under causality
//     it sees the most keys, so the longest blocks do not form the tail.
//   * Q and the first K / V tile are in flight (cp.async) while the spans
//     are read (short sequences are bound by this latency); q is then scaled in
//     place in its own dtype (under RoPE it is rotated and scaled through
//     registers) and kept as mma A fragments in registers (at d 256 the
//     output accumulator alone is 128 registers a thread, so Q is read
//     from shared memory at each k-step instead). K and V stream in 64-row
//     tiles through two shared-memory buffers filled by 16-byte cp.async
//     copies, the next tile in flight while the current one is used; rows
//     past n are zero-filled. Under RoPE K goes through registers, rotated
//     as q.
//   * S = Q K^T and O += P V on mma.sync m16n8k16 (bf16 in, float32 sums);
//     P's C fragments, rounded to bf16, are the A fragments of the PV
//     product as they stand (FlashAttention-2's register reuse). The online
//     softmax runs in registers: row max and sum over the 4 lanes of a quad.
//   * The mask without a span loop per element: the keys a row sees form a
//     prefix (attn_tile `visible_ends`), so each thread finds once, for its
//     two rows, how many kv columns they see, reading the spans from device
//     memory (any span count; no shared memory for them). The block walks the kv tiles
//     up to the last row's end, none of which is hidden from every row; a
//     warp skips a tile none of its rows sees, takes no mask on a tile that
//     its first row sees whole (the ends grow with the row), and otherwise
//     masks with one compare per score.
//   * The softcap's tanh is exact (attn_tile `softcap_tile`, shared with
//     the backward and decode): tanh.approx (2^-11 relative, times the cap)
//     would move lse by ~1e-3, beyond the card checks' 1e-4. exp is exp2
//     on the special-function unit.
//
// Value width. The kernels take the q . k width D and the value (and
// output) width DV as template parameters (DV = D unless given; every
// (d, d) instantiation is the code it was). (D, DV) = (192, 128), the
// latent attention of DeepSeek-V3-style blocks, is instantiated head-major
// without RoPE (the caller rotates the 64 RoPE columns): S over D, O over
// DV, one m-tile a warp as at d 128, Q's fragments in registers.
//
// float32 (the card-vs-CPU checks at 1e-4): the first version's FMA kernel:
// one block of 256 threads per (b*h, 64-row q tile), float32 products from
// shared memory (no tensor cores: TF32 would keep ~3 decimal digits), loops
// over the kv tiles up to the last one the block's last row sees, masks
// with one compare per score against its row's visible end.
//
// Both grids are one-dimensional, (b*h) fastest, so b*h is not capped at
// grid.y's 65535.

#include "attn_tile.cuh"
#include "mma_tile.cuh"

using namespace attn_tile;

namespace {

struct Rope {
  const float* cos;  // float32 [b, nq, d] or NULL
  const float* sin;
};

// ---------------------------------------------------------------------------
// float32: FMA kernel
// ---------------------------------------------------------------------------

namespace fp32 {

constexpr int RPT = 4;
constexpr int BQ = 16 * RPT;  // 64 query rows per block

// D: the q . k width; DV: the value and output width (D unless given)
template <typename T, int D, bool NHD, bool ROPE, int DV = D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ spans, int m, const float* __restrict__ cos,
                 const float* __restrict__ sin, T* __restrict__ out, float* __restrict__ lse,
                 int H, int nq, int nkv, int q_off, int kv_off, float scale, float softcap) {
  using TileT = Tile<D, RPT, DV>;
  extern __shared__ float smem[];
  TileT tile(smem);

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  // one-dimensional grid, (b*h) fastest: no 65535 cap on b*h
  const int BH = gridDim.x / ((nq + BQ - 1) / BQ);
  const int bh = blockIdx.x % BH, bi = bh / H, head = bh - bi * H;
  const int q0 = int(blockIdx.x / BH) * BQ;
  const size_t rs = row_stride(NHD, H, D), rsv = row_stride(NHD, H, DV);
  const T* qb = q + head_base(NHD, bi, head, H, nq, D);
  const T* kb = k + head_base(NHD, bi, head, H, nkv, D);
  const T* vb = v + head_base(NHD, bi, head, H, nkv, DV);
  // q * scale in q's own dtype (the JAX kernel scales before the product)
  const float scale_t = round_to<T>(scale);
  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D, c = e - r * D, gr = q0 + r;
    float x = 0.f;
    if (gr < nq) {
      const size_t a = (size_t(bi) * nq + gr) * D;
      x = round_to<T>(rope_load(qb + size_t(gr) * rs, c, ROPE ? cos + a : nullptr,
                                ROPE ? sin + a : nullptr) * scale_t);
    }
    tile.Qs[r * TileT::QS + c] = x;
  }

  // kv columns seen by this thread's rows and by the block's last row (the
  // loop bound: the ends grow with the row, so every tile below it has a
  // visible pair)
  int end[RPT + 1];
  {
    int rows[RPT + 1];
#pragma unroll
    for (int r = 0; r < RPT; ++r) rows[r] = q_off + q0 + ty * RPT + r;
    rows[RPT] = q_off + min(q0 + BQ, nq) - 1;
    visible_ends<RPT + 1>(rows, spans + size_t(bi) * m * 3, m, kv_off, nkv, end);
  }
  const int hi = (end[RPT] + BK - 1) / BK;

  float m_i[RPT], l_i[RPT], acc[RPT][TileT::DC];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    m_i[r] = NEG_INF;
    l_i[r] = 0.f;
#pragma unroll
    for (int c = 0; c < TileT::DC; ++c) acc[r][c] = 0.f;
  }

  for (int it = 0; it < hi; ++it) {
    const int k0 = it * BK;
    __syncthreads();  // Q is written / the previous tile's readers are done
    if constexpr (DV == D) {
      for (int e = tid; e < BK * D; e += NT) {
        const int r = e / D, c = e - r * D, gk = k0 + r;
        float kx = 0.f, vx = 0.f;
        if (gk < nkv) {
          const size_t a = (size_t(bi) * nkv + gk) * D;
          kx = rope_load(kb + size_t(gk) * rs, c, ROPE ? cos + a : nullptr,
                         ROPE ? sin + a : nullptr);
          vx = to_f(vb[size_t(gk) * rs + c]);
        }
        tile.Ks[r * TileT::QS + c] = kx;
        tile.Vs[r * D + c] = vx;
      }
    } else {  // K and V rows of different widths (no RoPE: head-major only)
      for (int e = tid; e < BK * D; e += NT) {
        const int r = e / D, c = e - r * D, gk = k0 + r;
        tile.Ks[r * TileT::QS + c] = gk < nkv ? to_f(kb[size_t(gk) * rs + c]) : 0.f;
      }
      for (int e = tid; e < BK * DV; e += NT) {
        const int r = e / DV, c = e - r * DV, gk = k0 + r;
        tile.Vs[r * DV + c] = gk < nkv ? to_f(vb[size_t(gk) * rsv + c]) : 0.f;
      }
    }
    __syncthreads();

    float s[RPT][4];
    tile.scores(s, tx, ty);
    if (softcap > 0.f) softcap_tile(flat<RPT * 4>(s), softcap);
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k0 + tx + 16 * j >= end[r]) s[r][j] = NEG_INF;
    tile.template softmax_update<true, T>(s, m_i, l_i, acc, tx, ty);
    __syncthreads();
    tile.pv(acc, tx, ty);
  }

  T* ob = out + head_base(NHD, bi, head, H, nq, DV);
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = q0 + ty * RPT + r;
    if (row >= nq) continue;
    const float ls = fmaxf(l_i[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < TileT::DC; ++c) ob[size_t(row) * rsv + tx + 16 * c] = from_f<T>(acc[r][c] / ls);
    if (lse != nullptr && tx == 0) lse[size_t(bh) * nq + row] = m_i[r] + logf(ls);
  }
}

template <int D, int DV = D>
int launch(const float* q, const float* k, const float* v, const int* spans, int m, Rope rope,
           float* out, float* lse, int b, int h, int nq, int nkv, int q_off, int kv_off, int nhd,
           float scale, float softcap, cudaStream_t stream) {
  const size_t smem = Tile<D, RPT, DV>::kFloats * sizeof(float);
  // layout and RoPE are template flags: the head-major route compiles to
  // constant strides and loads without a branch; unequal widths are
  // head-major only
  auto kern = flash_fwd_kernel<float, D, false, false, DV>;
  if constexpr (DV != D) {
    if (nhd) return int(cudaErrorInvalidValue);
  } else if (nhd) {
    kern = rope.cos != nullptr ? flash_fwd_kernel<float, D, true, true>
                               : flash_fwd_kernel<float, D, true, false>;
  }
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const long long blocks = (long long)b * h * ((nq + BQ - 1) / BQ);
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  kern<<<unsigned(blocks), NT, smem, stream>>>(q, k, v, spans, m, rope.cos, rope.sin, out, lse, h,
                                               nq, nkv, q_off, kv_off, scale, softcap);
  return int(cudaGetLastError());
}

int dispatch(int d, int dv, const void* q, const void* k, const void* v, const int* spans,
             int m, Rope rope, void* out, float* lse, int b, int h, int nq, int nkv, int q_off,
             int kv_off, int nhd, float scale, float softcap, cudaStream_t stream) {
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(out);
  if (dv != d) {
    if (d == 192 && dv == 128)
      return launch<192, 128>(qf, kf, vf, spans, m, rope, of, lse, b, h, nq, nkv, q_off, kv_off,
                              nhd, scale, softcap, stream);
    return int(cudaErrorInvalidValue);
  }
  switch (d) {
    case 32:
      return launch<32>(qf, kf, vf, spans, m, rope, of, lse, b, h, nq, nkv, q_off, kv_off, nhd,
                        scale, softcap, stream);
    case 64:
      return launch<64>(qf, kf, vf, spans, m, rope, of, lse, b, h, nq, nkv, q_off, kv_off, nhd,
                        scale, softcap, stream);
    case 128:
      return launch<128>(qf, kf, vf, spans, m, rope, of, lse, b, h, nq, nkv, q_off, kv_off, nhd,
                         scale, softcap, stream);
    case 256:
      return launch<256>(qf, kf, vf, spans, m, rope, of, lse, b, h, nq, nkv, q_off, kv_off, nhd,
                         scale, softcap, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace fp32

// ---------------------------------------------------------------------------
// bf16: tensor cores (see the note at the top)
// ---------------------------------------------------------------------------

namespace tc {

using namespace mma_tile;
using bf16 = __nv_bfloat16;

constexpr int BKV = 64;     // kv rows of a tile
constexpr int TT = 128;     // threads: 4 warps

// D: the q . k width; DV: the value and output width (D unless given)
template <int D, int DV = D>
struct Lay {
  // m-tiles of 16 q rows a warp: two up to d 64 (FlashAttention-2's 32
  // rows a warp: each K / V fragment read from shared memory feeds two
  // products), one above (the output accumulator would not fit)
  static constexpr int MT = D <= 64 && DV <= 64 ? 2 : 1;
  static constexpr int BQ = 64 * MT;  // q rows of a block
  static constexpr int LD = D + 8;    // padded bf16 row stride of a Q or K tile
  static constexpr int LDV = DV + 8;  // and of a V tile
  static constexpr int QTILE = BQ * LD, TILE = BKV * LD, TILEV = BKV * LDV;
  // Q's A fragments held in registers (at q . k 192 beside v 128 they and
  // the output accumulator take 112 registers a thread, as d 128's 96)
  static constexpr bool QREG = D <= 192;
  // the Q tile, 2 x K and 2 x V tiles
  static constexpr size_t kBytes =
      (size_t(QTILE) + 2 * size_t(TILE) + 2 * size_t(TILEV)) * sizeof(bf16);
};

struct Args {
  const bf16 *q, *k, *v;
  const int* spans;
  const float *cos, *sin;
  bf16* out;
  float* lse;
  int m, H, nq, nkv, q_off, kv_off;
  float scale, softcap;
};

// The q tile, loaded raw, times `mul` and rounded to bf16, in place
template <int D>
__device__ __forceinline__ void scale_rows(bf16* tile, float mul) {
  constexpr int CH = D / 8;
  for (int e = threadIdx.x; e < Lay<D>::BQ * CH; e += TT) {
    uint4* p = reinterpret_cast<uint4*>(tile + (e / CH) * Lay<D>::LD + (e % CH) * 8);
    uint4 x = *p;
    uint32_t* w = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = unpack_bf16(w[i]);
      w[i] = pack_bf16(f.x * mul, f.y * mul);
    }
    *p = x;
  }
}

template <int D, bool NHD, bool ROPE, int DV = D>
__global__ void __launch_bounds__(TT) flash_fwd_tc(const Args A) {
  using L = Lay<D, DV>;
  constexpr int LD = L::LD, LDV = L::LDV, TILE = L::TILE, TILEV = L::TILEV, MT = L::MT,
                BQ = L::BQ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + L::QTILE;  // two buffers
  bf16* Vs = Ks + 2 * TILE;  // two buffers

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * MT * w;  // this warp's q rows r0 .. r0 + 16 MT - 1 of the tile
  const int H = A.H, nq = A.nq, nkv = A.nkv, m = A.m;
  const int n_q_tiles = (nq + BQ - 1) / BQ;
  const int BH = gridDim.x / n_q_tiles;
  const int bh = blockIdx.x % BH, bi = bh / H, head = bh - bi * H;
  const int q0 = (n_q_tiles - 1 - int(blockIdx.x / BH)) * BQ;  // last q tiles first
  const size_t rs = row_stride(NHD, H, D), rsv = row_stride(NHD, H, DV);
  const bf16* qb = A.q + head_base(NHD, bi, head, H, nq, D);
  const bf16* kb = A.k + head_base(NHD, bi, head, H, nkv, D);
  const bf16* vb = A.v + head_base(NHD, bi, head, H, nkv, DV);
  const float scale_t = __bfloat162float(__float2bfloat16(A.scale));

  auto load_kv = [&](int it, int buf) {
    const int k0 = it * BKV;
    if (ROPE)
      copy_rows_regs<D, LD, BKV, TT, true>(Ks + buf * TILE, kb, rs, k0, nkv, A.cos, A.sin, bi,
                                           1.f);
    else
      copy_rows_async<D, LD, BKV, TT>(Ks + buf * TILE, kb, rs, k0, nkv);
    copy_rows_async<DV, LDV, BKV, TT>(Vs + buf * TILEV, vb, rsv, k0, nkv);
  };
  // the first K / V tile and Q (raw without RoPE) in flight while the
  // spans are read: short sequences are bound by this latency
  load_kv(0, 0);
  if (!ROPE) copy_rows_async<D, LD, BQ, TT>(Qs, qb, rs, q0, nq);
  cp_async_commit();
  // kv columns seen by this thread's rows (g and g + 8 of each m-tile),
  // and by the block's last row
  int end[2 * MT + 1];
  {
    int rows[2 * MT + 1];
#pragma unroll
    for (int r = 0; r < 2 * MT; ++r) rows[r] = A.q_off + q0 + r0 + 8 * r + g;
    rows[2 * MT] = A.q_off + min(q0 + BQ, nq) - 1;
    visible_ends<2 * MT + 1>(rows, A.spans + size_t(bi) * m * 3, m, A.kv_off, nkv, end);
  }
  if (ROPE) copy_rows_regs<D, LD, BQ, TT, true>(Qs, qb, rs, q0, nq, A.cos, A.sin, bi, scale_t);
  cp_async_wait<0>();
  __syncthreads();
  if (!ROPE) scale_rows<D>(Qs, scale_t);  // q * scale in q's own dtype
  const int end_first = __shfl_sync(0xffffffffu, end[0], 0);           // warp row r0
  const int end_last = __shfl_sync(0xffffffffu, end[2 * MT - 1], 31);  // its last row
  const int hi = (end[2 * MT] + BKV - 1) / BKV;  // kv tiles some row of the block sees
  __syncthreads();  // Q scaled

  uint32_t qa[MT][L::QREG ? D / 16 : 1][4];
  if constexpr (L::QREG) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldsm_x4(qa[mt][kk], ldsm_rows(Qs, LD, r0 + 16 * mt, 16 * kk, lane));
  }

  float o[MT][DV / 8][4] = {};  // m-tile rows g, g + 8; columns 8c + 2t, + 1
  float mrow[MT][2], lrow[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) mrow[mt][h2] = NEG_INF, lrow[mt][h2] = 0.f;
  const float cap = A.softcap;

  int buf = 0;
  for (int it = 0; it < hi; ++it) {
    if (it + 1 < hi) load_kv(it + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // all but the tile just started
    __syncthreads();

    const int k0 = it * BKV;
    if (k0 < end_last && q0 + r0 < nq) {  // warp-uniform: a row of the warp sees it
      const bf16* Kb = Ks + buf * TILE;
      const bf16* Vb = Vs + buf * TILEV;
      // S = (Q * scale) K^T: rows g, g + 8 of each m-tile; columns 8j + 2t, + 1
      float s[MT][8][4] = {};
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if constexpr (L::QREG) {
#pragma unroll
            for (int x = 0; x < 4; ++x) a[mt][x] = qa[mt][kk / 16][x];
          } else {
            ldsm_x4(a[mt], ldsm_rows(Qs, LD, r0 + 16 * mt, kk, lane));
          }
        }
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
          uint32_t kf[4];
          ldsm_x4(kf, ldsm_cols(Kb, LD, 8 * j, kk, lane));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma(s[mt][j], a[mt], kf[0], kf[1]);
            mma(s[mt][j + 1], a[mt], kf[2], kf[3]);
          }
        }
      }
      if (cap > 0.f) softcap_tile(flat<MT * 32>(s), cap);
      if (k0 + BKV > end_first) {  // a masked pair in the warp's rows
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (k0 + 8 * j + 2 * t + (c & 1) >= end[2 * mt + (c >> 1)]) s[mt][j][c] = NEG_INF;
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        // online softmax; a row that has seen no visible column yet (max
        // still NEG_INF) gets p = 0, not exp(0)
        float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) mx[c >> 1] = fmaxf(mx[c >> 1], s[mt][j][c]);
        float alpha[2], mlog[2];
        bool live[2];
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 1));
          mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 2));
          const float m_new = fmaxf(mrow[mt][h2], mx[h2]);
          live[h2] = m_new > 0.5f * NEG_INF;
          alpha[h2] = live[h2] ? exp2_ftz((mrow[mt][h2] - m_new) * LOG2E) : 1.f;
          mrow[mt][h2] = m_new;
          mlog[h2] = m_new * LOG2E;
        }
        float psum[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int h2 = c >> 1;
            const float p = live[h2] ? exp2_ftz(fmaf(s[mt][j][c], LOG2E, -mlog[h2])) : 0.f;
            s[mt][j][c] = p;
            psum[h2] += p;
          }
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) lrow[mt][h2] = lrow[mt][h2] * alpha[h2] + psum[h2];
#pragma unroll
        for (int c = 0; c < DV / 8; ++c) {
          o[mt][c][0] *= alpha[0];
          o[mt][c][1] *= alpha[0];
          o[mt][c][2] *= alpha[1];
          o[mt][c][3] *= alpha[1];
        }
      }
      // O += P V: P's C fragments, rounded to bf16, are A fragments
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        uint32_t pa[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) acc_to_a(pa[mt], s[mt][j], s[mt][j + 1]);
#pragma unroll
        for (int c = 0; c < DV / 8; c += 2) {
          uint32_t vf[4];
          ldsm_x4_t(vf, ldsm_rows(Vb, LDV, 8 * j, 8 * c, lane));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma(o[mt][c], pa[mt], vf[0], vf[1]);
            mma(o[mt][c + 1], pa[mt], vf[2], vf[3]);
          }
        }
      }
    }
    __syncthreads();  // this buffer's readers are done
    buf ^= 1;
  }
  cp_async_wait<0>();

  bf16* ob = A.out + head_base(NHD, bi, head, H, nq, DV);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      float l = lrow[mt][h2];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = q0 + r0 + 16 * mt + g + 8 * h2;
      if (row >= nq) continue;
      const float ls = fmaxf(l, 1e-30f);
      bf16* dst = ob + size_t(row) * rsv + 2 * t;
#pragma unroll
      for (int c = 0; c < DV / 8; ++c)
        *reinterpret_cast<uint32_t*>(dst + 8 * c) =
            pack_bf16(o[mt][c][2 * h2] / ls, o[mt][c][2 * h2 + 1] / ls);
      if (A.lse != nullptr && t == 0) A.lse[size_t(bh) * nq + row] = mrow[mt][h2] + logf(ls);
    }
}

template <int D, bool NHD, bool ROPE, int DV = D>
int launch(const Args& A, int b, cudaStream_t stream) {
  const int smem = int(Lay<D, DV>::kBytes);
  constexpr int BQ = Lay<D, DV>::BQ;
  const long long blocks = (long long)b * A.H * ((A.nq + BQ - 1) / BQ);
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  auto kern = flash_fwd_tc<D, NHD, ROPE, DV>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  kern<<<unsigned(blocks), TT, smem, stream>>>(A);
  return int(cudaGetLastError());
}

template <int D>
int launch_layout(const Args& A, int b, int nhd, cudaStream_t stream) {
  // layout and RoPE are template flags: the head-major route compiles to
  // constant strides and loads without a branch
  if (!nhd) return launch<D, false, false>(A, b, stream);
  return A.cos != nullptr ? launch<D, true, true>(A, b, stream)
                          : launch<D, true, false>(A, b, stream);
}

int dispatch(int d, int dv, const Args& A, int b, int nhd, cudaStream_t stream) {
  if (dv != d) {  // unequal widths: head-major, no RoPE
    if (d == 192 && dv == 128 && !nhd) return launch<192, false, false, 128>(A, b, stream);
    return int(cudaErrorInvalidValue);
  }
  switch (d) {
    case 32:
      return launch_layout<32>(A, b, nhd, stream);
    case 64:
      return launch_layout<64>(A, b, nhd, stream);
    case 128:
      return launch_layout<128>(A, b, nhd, stream);
    case 256:
      return launch_layout<256>(A, b, nhd, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace tc

}  // namespace

// q [b,h,nq,d], k [b,h,nkv,d], v [b,h,nkv,d_v] (nhd = 0) or q [b,nq,h*d],
// k/v [b,nkv,h*d] (nhd = 1), contiguous, bf16 (is_bf16=1; q, k, v and
// cos/sin 16-byte aligned) or float32; d = d_v in {32, 64, 128, 256}, or
// (d, d_v) = (192, 128) head-major; spans int32 [b,m,3] (any m); cos/sin
// float32 [b,nq,d] or NULL (no RoPE; only with nhd = 1, where nq == nkv);
// out like q with d_v columns; lse float32 [b,h,nq] or NULL.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const int* spans, int m,
                         const float* cos, const float* sin, void* out, float* lse, int b,
                         int h, int nq, int nkv, int d, int d_v, int q_off, int kv_off, int nhd,
                         float scale, float softcap, int is_bf16, void* stream) {
  if (m < 0 || nq <= 0 || nkv <= 0) return int(cudaErrorInvalidValue);
  if ((cos == nullptr) != (sin == nullptr) || (cos != nullptr && (nq != nkv || !nhd)))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using tc::bf16;
    const tc::Args A{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                     static_cast<const bf16*>(v), spans, cos, sin, static_cast<bf16*>(out), lse,
                     m, h, nq, nkv, q_off, kv_off, scale, softcap};
    return tc::dispatch(d, d_v, A, b, nhd, s);
  }
  return fp32::dispatch(d, d_v, q, k, v, spans, m, Rope{cos, sin}, out, lse, b, h, nq, nkv, q_off,
                       kv_off, nhd, scale, softcap, s);
}
