// Cached decode attention over the KV cache, for Hopper (sm_90a).
//
// Replaces transfusion_tpu/ops/pallas_decode_kernel.py `decode_attention` /
// `_decode_kernel_dma`: query rows of the chunk being decoded attend to the
// whole cache of their batch row,
//
//   s_j = cap * tanh((q * d^-1/2) . k_j / cap) + bias[b, j]      (j < lens[b])
//   out = softmax(s) . v       (float32 sums; 0 for a row with no valid slot)
//
// with K/V stored as float32, bf16, or int8 with a float32 scale per
// (token, head) (the cache stays int8-wide in device memory). bias is the
// additive validity (0 or -1e30); lens[b] bounds the slots a row streams.
// lens is idx + n, not the count of valid slots: after a padded prefill the
// valid slots are not a prefix. The port stores the cache as
// [b, h, cap, d]; the TPU's transposed layout was a DMA alignment artifact.
//
// What bounds it on the H100: bytes. A decode step reads every valid K/V
// slot once (2 * b * h * lens * d * itemsize) and does ~4 d FLOPs per slot
// and query row: at nq = 1 that is ~1 FLOP a byte, far below the ridge of
// ~295. So the kernel must keep the whole card streaming: one block per
// (b*h, query tile) would be 64 blocks at b 8, h 8 on 132 SMs, each
// streaming a row's history alone. Here:
//
//   * Split-K ("flash-decoding"). The cache is cut into `splits` chunks of
//     `chunk` slots (a multiple of 64), planned on the host from the
//     capacity, b*h and the SM count (`ops/decode_attn.py` `split_plan`;
//     lens stays on the device, so the plan never synchronises). One block
//     per (b*h, query tile, split) streams its chunk up to lens[b] and
//     writes a float32 partial (m, l, unnormalised acc[d]); a block whose
//     chunk starts at or past lens[b] writes m = -1e30, l = 0 and exits.
//     `decode_merge` combines the splits by their maxima and writes the
//     output in q's dtype: 0 where every split saw no valid slot, never a
//     NaN (splits with m = -1e30 are skipped, their acc never read). With
//     one split the block writes the output itself: one launch.
//   * nq <= 16 (text decode), `decode_warp`: one query row a block (no
//     padded rows), 4 warps. A lane loads 16 bytes of a K or V row at a
//     time (4 float32, 8 bf16 or 16 int8); the LPR lanes that share a row
//     reduce its dot product by shuffles; each group of LPR lanes keeps 4
//     slots' loads in flight and its own online softmax over the slots it
//     owns, and the groups and warps merge at the end (shuffles, then
//     shared memory). q is read in its own dtype, scaled in float32 and
//     held in registers. int8: k_scale multiplies the score, v_scale p.
//   * nq > 16 with bf16 q and a bf16 or int8 cache (the ODE's 196 modality
//     rows under CFG), `decode_mma`: the flash forward's tensor-core tiles
//     (mma.sync m16n8k16, one 16-row m-tile a warp, 64-row query tiles, K/V
//     tiles of 64 slots double-buffered by cp.async). int8 values are
//     exact in bf16, so K8 and V8 are widened in shared memory and enter
//     the products unscaled; k_scale multiplies the score column and
//     v_scale is folded into p before p is rounded to bf16.
//   * other nq > 16 calls (a float32 q or cache), `decode_fma`: the FMA
//     tile of attn_tile.cuh (float32 products: the card-vs-CPU checks hold
//     1e-4), split the same way.
// Every path takes head dims 32-256 and the exact softcap tanh shared with
// the flash kernels (attn_tile `softcap_tile`).

#include <type_traits>

#include "attn_tile.cuh"
#include "mma_tile.cuh"

using namespace attn_tile;

namespace {

using bf16 = __nv_bfloat16;

constexpr int SPLIT_SLOTS = 64;  // a chunk is a multiple of this many slots
constexpr int WARP_MAX_NQ = 16;  // decode_warp up to this many query rows
constexpr int QT_ROWS = 64;      // query rows of a decode_mma / decode_fma tile

struct Args {
  const void* q;          // [b, h, nq, d] float32, or bf16 when q_bf16
  const void *k, *v;      // [b, h, cap, d] in the cache's dtype
  const float *ks, *vs;   // [b, h, cap] for an int8 cache, else NULL
  const float* bias;      // [b, cap]
  const int* lens;        // [b], or NULL for the whole capacity
  void* out;              // [b, h, nq, d] in q's dtype
  float* ws;              // splits > 1: acc [splits][rows][d], then (m, l) [splits][rows]
  int H, nq, cap, splits, chunk, rows, q_bf16;  // rows = b * h * nq
  float scale, softcap;
  long long q_sb, q_sh, q_sn, o_sb, o_sh, o_sn;  // element strides of q / out over b, h, nq
};

// Element offset of query row `row` = (b*h) * nq + i in q / out: any strides
// but d's (the model hands q in as a [b, h, nq, d] view of its [b, nq, h*d]
// projection; out takes the same layout, so nothing is copied either way)
__device__ __forceinline__ size_t q_row(const Args& A, size_t row) {
  const size_t bh = row / A.nq, i = row % A.nq;
  return (bh / A.H) * A.q_sb + (bh % A.H) * A.q_sh + i * A.q_sn;
}
__device__ __forceinline__ size_t o_row(const Args& A, size_t row) {
  const size_t bh = row / A.nq, i = row % A.nq;
  return (bh / A.H) * A.o_sb + (bh % A.H) * A.o_sh + i * A.o_sn;
}

__device__ __forceinline__ float q_at(const Args& A, size_t i) {
  return A.q_bf16 ? __bfloat162float(static_cast<const bf16*>(A.q)[i])
                  : static_cast<const float*>(A.q)[i];
}

__device__ __forceinline__ void put_out(const Args& A, size_t i, float x) {
  if (A.q_bf16)
    static_cast<bf16*>(A.out)[i] = __float2bfloat16(x);
  else
    static_cast<float*>(A.out)[i] = x;
}

template <int D>
__device__ __forceinline__ float* part_acc(const Args& A, int split, size_t row) {
  return A.ws + (size_t(split) * A.rows + row) * D;
}

template <int D>
__device__ __forceinline__ float2* part_ml(const Args& A, int split, size_t row) {
  return reinterpret_cast<float2*>(A.ws + size_t(A.splits) * A.rows * D) +
         size_t(split) * A.rows + row;
}

// A block's share: (b*h, query tile, split), the query tile fastest (the
// blocks that read one chunk run together and share it in L2), and its
// slots [c0, c1): the chunk cut at lens[b].
struct Work {
  int bh, bi, qt, split, c0, c1;
};

__device__ __forceinline__ Work work_of(const Args& A, int q_tiles) {
  Work w;
  const int x = blockIdx.x;
  w.qt = x % q_tiles;
  w.split = (x / q_tiles) % A.splits;
  w.bh = x / q_tiles / A.splits;
  w.bi = w.bh / A.H;
  const int len = min(max(A.lens != nullptr ? A.lens[w.bi] : A.cap, 0), A.cap);
  w.c0 = w.split * A.chunk;
  w.c1 = min(w.c0 + A.chunk, len);
  return w;
}

// The rows [row0, row0 + n) of a block whose chunk holds no slot below
// lens[b]: (m, l) = (-1e30, 0), or, with one split, the output 0.
template <int D>
__device__ void empty_rows(const Args& A, int split, size_t row0, int n) {
  if (A.splits == 1) {
    for (int i = threadIdx.x; i < n * D; i += blockDim.x)
      put_out(A, o_row(A, row0 + i / D) + i % D, 0.f);
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      *part_ml<D>(A, split, row0 + i) = make_float2(NEG_INF, 0.f);
  }
}

// One finished value of query row `row` (its output at element `out`): the
// output (one split) or the partial
template <int D>
__device__ __forceinline__ void finish(const Args& A, int split, size_t row, size_t out, int col,
                                       float m, float l, float acc) {
  if (A.splits == 1)
    put_out(A, out + col, m > 0.5f * NEG_INF ? acc / fmaxf(l, 1e-30f) : 0.f);
  else
    part_acc<D>(A, split, row)[col] = acc;
}

// Online-softmax state (m, l) and an accumulator of another owner, folded
// into ours: both rescaled to the larger maximum. Owners that saw no valid
// slot hold m = -1e30, l = 0.
__device__ __forceinline__ void fold_weights(float& m, float& l, float mo, float lo, float& a,
                                             float& b) {
  const float mn = fmaxf(m, mo);
  a = exp2_ftz((m - mn) * LOG2E);
  b = exp2_ftz((mo - mn) * LOG2E);
  l = l * a + lo * b;
  m = mn;
}

// ---------------------------------------------------------------------------
// nq <= 16: one query row a block, 16-byte loads, shuffle dot products
// ---------------------------------------------------------------------------

constexpr int WNW = 4;  // warps of a block
constexpr int WU = 4;   // slots a lane group has in flight

template <typename T, int D>
struct WarpLay {
  static constexpr int EPV = 16 / sizeof(T);       // elements of a 16-byte load
  static constexpr int RV = D / EPV;               // loads of a row
  static constexpr int LPR = RV < 32 ? RV : 32;    // lanes that share a row
  static constexpr int VPL = RV / LPR;             // loads a lane makes of a row
  static constexpr int EPL = VPL * EPV;            // elements a lane holds of a row
  static constexpr int RPW = 32 / LPR;             // rows a warp loads at once
  static constexpr int NG = WNW * RPW;             // lane groups of a block
};

__device__ __forceinline__ void widen(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x), f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z), f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void widen(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = mma_tile::unpack_bf16(w[i]);
    f[2 * i] = x.x, f[2 * i + 1] = x.y;
  }
}
__device__ __forceinline__ void widen(const uint4& u, float (&f)[16]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    f[i] = static_cast<float>(static_cast<int8_t>((w[i / 4] >> (8 * (i % 4))) & 0xffu));
}

template <typename T, int D>
__global__ void __launch_bounds__(32 * WNW) decode_warp(const Args A) {
  using L = WarpLay<T, D>;
  constexpr int EPV = L::EPV, VPL = L::VPL, EPL = L::EPL, LPR = L::LPR, NG = L::NG;
  constexpr bool QUANT = std::is_same<T, int8_t>::value;
  __shared__ float red[WNW][D + 2];  // each warp's acc, m, l

  const Work w = work_of(A, A.nq);
  const size_t row = size_t(w.bh) * A.nq + w.qt;
  if (w.c0 >= w.c1) {  // uniform across the block
    empty_rows<D>(A, w.split, row, 1);
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int li = lane % LPR, grp = warp * L::RPW + lane / LPR;

  // q in registers, scaled in float32: this lane's elements (li + LPR p) *
  // EPV + e of the row
  float qv[EPL];
#pragma unroll
  for (int p = 0; p < VPL; ++p)
#pragma unroll
    for (int e = 0; e < EPV; ++e)
      qv[p * EPV + e] = q_at(A, q_row(A, row) + (li + LPR * p) * EPV + e) * A.scale;

  const T* kb = static_cast<const T*>(A.k) + size_t(w.bh) * A.cap * D + li * EPV;
  const T* vb = static_cast<const T*>(A.v) + size_t(w.bh) * A.cap * D + li * EPV;
  const float* ksb = QUANT ? A.ks + size_t(w.bh) * A.cap : nullptr;
  const float* vsb = QUANT ? A.vs + size_t(w.bh) * A.cap : nullptr;
  const float* brow = A.bias + size_t(w.bi) * A.cap;

  float m = NEG_INF, l = 0.f, acc[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc[e] = 0.f;

  const int n = w.c1 - w.c0;
  for (int base = 0; base < n; base += NG * WU) {  // uniform across the block
    // this group's WU slots: every load issued before any is used
    uint4 kr[WU][VPL], vr[WU][VPL];
    float bias[WU], kscale[WU], vscale[WU];
    bool ok[WU];
#pragma unroll
    for (int u = 0; u < WU; ++u) {
      const int jl = base + u * NG + grp;
      ok[u] = jl < n;
      const size_t j = size_t(w.c0) + (ok[u] ? jl : 0);
#pragma unroll
      for (int p = 0; p < VPL; ++p) {
        kr[u][p] = ok[u] ? __ldg(reinterpret_cast<const uint4*>(kb + j * D + LPR * EPV * p))
                         : make_uint4(0u, 0u, 0u, 0u);
        vr[u][p] = ok[u] ? __ldg(reinterpret_cast<const uint4*>(vb + j * D + LPR * EPV * p))
                         : make_uint4(0u, 0u, 0u, 0u);
      }
      bias[u] = ok[u] ? __ldg(brow + j) : 0.f;
      kscale[u] = QUANT && ok[u] ? __ldg(ksb + j) : 1.f;
      vscale[u] = QUANT && ok[u] ? __ldg(vsb + j) : 1.f;
    }
    float s[WU];
#pragma unroll
    for (int u = 0; u < WU; ++u) {
      float x = 0.f;
#pragma unroll
      for (int p = 0; p < VPL; ++p) {
        float kf[EPV];
        widen(kr[u][p], kf);
#pragma unroll
        for (int e = 0; e < EPV; ++e) x = fmaf(qv[p * EPV + e], kf[e], x);
      }
#pragma unroll
      for (int o = LPR / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
      s[u] = x * kscale[u];
    }
    if (A.softcap > 0.f) softcap_tile(s, A.softcap);
    float mx = m;
#pragma unroll
    for (int u = 0; u < WU; ++u) {
      s[u] = ok[u] ? s[u] + bias[u] : NEG_INF;
      mx = fmaxf(mx, s[u]);
    }
    // a group that has seen no valid slot yet (max still -1e30) keeps p = 0
    const bool live = mx > 0.5f * NEG_INF;
    const float alpha = live ? exp2_ftz((m - mx) * LOG2E) : 1.f;
    l *= alpha;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[e] *= alpha;
    m = mx;
#pragma unroll
    for (int u = 0; u < WU; ++u) {
      const float p = live && ok[u] ? exp2_ftz((s[u] - mx) * LOG2E) : 0.f;
      l += p;
      const float pv = p * vscale[u];
#pragma unroll
      for (int q = 0; q < VPL; ++q) {
        float vf[EPV];
        widen(vr[u][q], vf);
#pragma unroll
        for (int e = 0; e < EPV; ++e) acc[q * EPV + e] = fmaf(pv, vf[e], acc[q * EPV + e]);
      }
    }
  }

  // the warp's groups merged (lanes li of every group hold the same columns)
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
    float a, b;
    fold_weights(m, l, __shfl_xor_sync(0xffffffffu, m, o), __shfl_xor_sync(0xffffffffu, l, o), a,
                 b);
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[e] = acc[e] * a + __shfl_xor_sync(0xffffffffu, acc[e], o) * b;
  }
  if (lane < LPR) {
#pragma unroll
    for (int p = 0; p < VPL; ++p)
#pragma unroll
      for (int e = 0; e < EPV; ++e) red[warp][(li + LPR * p) * EPV + e] = acc[p * EPV + e];
    if (lane == 0) red[warp][D] = m, red[warp][D + 1] = l;
  }
  __syncthreads();
  // the warps merged: thread c finishes columns c, c + 128
  float mb = NEG_INF, lb = 0.f, wgt[WNW];
#pragma unroll
  for (int x = 0; x < WNW; ++x) mb = fmaxf(mb, red[x][D]);
#pragma unroll
  for (int x = 0; x < WNW; ++x) {
    wgt[x] = exp2_ftz((red[x][D] - mb) * LOG2E);
    lb += red[x][D + 1] * wgt[x];
  }
  const size_t orow = o_row(A, row);
  for (int c = threadIdx.x; c < D; c += 32 * WNW) {
    float o = 0.f;
#pragma unroll
    for (int x = 0; x < WNW; ++x) o += red[x][c] * wgt[x];
    finish<D>(A, w.split, row, orow, c, mb, lb, o);
  }
  if (A.splits > 1 && threadIdx.x == 0) *part_ml<D>(A, w.split, row) = make_float2(mb, lb);
}

// ---------------------------------------------------------------------------
// nq > 16, bf16 q, bf16 or int8 cache: tensor cores
// ---------------------------------------------------------------------------

namespace tc {

using namespace mma_tile;

constexpr int BKV = 64;  // slots of a K / V tile
constexpr int TT = 128;  // threads: 4 warps of 16 query rows

template <int D, bool KV8>
struct Lay {
  static constexpr int LD = D + 8;  // padded bf16 row stride (mma_tile.cuh)
  static constexpr int QTILE = QT_ROWS * LD, TILE = BKV * LD;
  static constexpr bool QREG = D <= 128;  // Q's A fragments in registers
  // bf16 K / V tiles: two buffers each, filled by cp.async; for int8 one
  // each, widened from two buffers of int8 tiles
  static constexpr int KVBUF = KV8 ? 1 : 2;
  static constexpr int STAGE = KV8 ? BKV * D : 0;  // int8 bytes of one tile
  static constexpr int NX = KV8 ? 3 : 1;           // bias (and k_scale, v_scale) of a tile
  static constexpr size_t kBytes = (size_t(QTILE) + 2 * KVBUF * size_t(TILE)) * sizeof(bf16) +
                                   4 * size_t(STAGE) + 2 * NX * BKV * sizeof(float);
};

template <int D, bool KV8>
__global__ void __launch_bounds__(TT) decode_mma(const Args A) {
  using L = Lay<D, KV8>;
  constexpr int LD = L::LD, TILE = L::TILE, NX = L::NX;
  using TKV = typename std::conditional<KV8, int8_t, bf16>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + L::QTILE;
  bf16* Vs = Ks + L::KVBUF * TILE;
  int8_t* St = reinterpret_cast<int8_t*>(Vs + L::KVBUF * TILE);  // [2][K, V][BKV][D]
  float* Xs = reinterpret_cast<float*>(St + 4 * L::STAGE);       // [2][NX][BKV]

  const Work w = work_of(A, (A.nq + QT_ROWS - 1) / QT_ROWS);
  const int q0 = w.qt * QT_ROWS, nrows = min(QT_ROWS, A.nq - q0);
  const size_t row0 = size_t(w.bh) * A.nq + q0;
  if (w.c0 >= w.c1) {  // uniform across the block
    empty_rows<D>(A, w.split, row0, nrows);
    return;
  }
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * wp;  // this warp's query rows r0 .. r0 + 15 of the tile
  const int c0 = w.c0, c1 = w.c1;
  const TKV* kb = static_cast<const TKV*>(A.k) + size_t(w.bh) * A.cap * D;
  const TKV* vb = static_cast<const TKV*>(A.v) + size_t(w.bh) * A.cap * D;
  const float* xsrc[3] = {A.bias + size_t(w.bi) * A.cap,
                          KV8 ? A.ks + size_t(w.bh) * A.cap : nullptr,
                          KV8 ? A.vs + size_t(w.bh) * A.cap : nullptr};

  // slots [j0, j0 + 64) of K and V, and their bias and scales, into buffer
  // buf; slots past c1 zero-filled
  auto load_kv = [&](int it, int buf) {
    const int j0 = c0 + it * BKV;
    if constexpr (KV8) {
      constexpr int CH = D / 16;  // 16-byte chunks of an int8 row
      for (int e = threadIdx.x; e < 2 * BKV * CH; e += TT) {
        const int kv = e / (BKV * CH), r = (e / CH) % BKV, c = e % CH, j = j0 + r;
        const bool in = j < c1;
        cp_async16(St + ((2 * buf + kv) * BKV + r) * D + c * 16,
                   (kv ? vb : kb) + (in ? size_t(j) * D + c * 16 : 0), in);
      }
    } else {
      copy_rows_async<D, LD, BKV, TT>(Ks + buf * TILE, kb, D, j0, c1);
      copy_rows_async<D, LD, BKV, TT>(Vs + buf * TILE, vb, D, j0, c1);
    }
    for (int e = threadIdx.x; e < NX * BKV; e += TT) {
      const int x = e / BKV, j = j0 + e % BKV;
      const bool in = j < c1;
      cp_async4(Xs + buf * NX * BKV + e, xsrc[x] + (in ? j : 0), in);
    }
  };

  const int n_tiles = (c1 - c0 + BKV - 1) / BKV;
  load_kv(0, 0);
  copy_rows_async<D, LD, QT_ROWS, TT>(Qs, static_cast<const bf16*>(A.q) + q_row(A, row0),
                                      size_t(A.q_sn), 0, nrows);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  uint32_t qa[L::QREG ? D / 16 : 1][4];
  if constexpr (L::QREG) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) ldsm_x4(qa[kk], ldsm_rows(Qs, LD, r0, 16 * kk, lane));
  }

  float o[D / 8][4] = {};  // rows g, g + 8; columns 8c + 2t, + 1
  float mrow[2] = {NEG_INF, NEG_INF}, lrow[2] = {0.f, 0.f};
  const float cap = A.softcap, scale = A.scale;
  const bool active = r0 < nrows;  // warp-uniform: the warp has a query row

  int buf = 0;
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) load_kv(it + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // all but the tile just started
    __syncthreads();
    const bf16* Kb = Ks + (KV8 ? 0 : buf * TILE);
    const bf16* Vb = Vs + (KV8 ? 0 : buf * TILE);
    if constexpr (KV8) {  // int8 tiles widened to bf16 (exact)
      constexpr int CH = D / 16;
      for (int e = threadIdx.x; e < 2 * BKV * CH; e += TT) {
        const int kv = e / (BKV * CH), r = (e / CH) % BKV, c = e % CH;
        const uint4 raw =
            *reinterpret_cast<const uint4*>(St + ((2 * buf + kv) * BKV + r) * D + c * 16);
        float f[16];
        widen(raw, f);
        uint4* dst = reinterpret_cast<uint4*>((kv ? Vs : Ks) + r * LD + c * 16);
        dst[0] = make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]), pack_bf16(f[4], f[5]),
                            pack_bf16(f[6], f[7]));
        dst[1] = make_uint4(pack_bf16(f[8], f[9]), pack_bf16(f[10], f[11]),
                            pack_bf16(f[12], f[13]), pack_bf16(f[14], f[15]));
      }
      __syncthreads();
    }
    const float* xb = Xs + buf * NX * BKV;  // bias, k_scale, v_scale of the tile's slots

    if (active) {
      // S = Q K^T: rows g, g + 8; columns 8j + 2t, + 1 of the tile
      float s[8][4] = {};
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        uint32_t a[4];
        if constexpr (L::QREG) {
#pragma unroll
          for (int x = 0; x < 4; ++x) a[x] = qa[kk / 16][x];
        } else {
          ldsm_x4(a, ldsm_rows(Qs, LD, r0, kk, lane));
        }
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
          uint32_t kf[4];
          ldsm_x4(kf, ldsm_cols(Kb, LD, 8 * j, kk, lane));
          mma(s[j], a, kf[0], kf[1]);
          mma(s[j + 1], a, kf[2], kf[3]);
        }
      }
      // the scale (and k_scale) on the float32 sums, the softcap, the bias
      const int j0 = c0 + it * BKV;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = 8 * j + 2 * t + (c & 1);
          s[j][c] *= KV8 ? scale * xb[BKV + col] : scale;
        }
      if (cap > 0.f) softcap_tile(flat<32>(s), cap);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = 8 * j + 2 * t + (c & 1);
          s[j][c] = j0 + col < c1 ? s[j][c] + xb[col] : NEG_INF;
        }
      // online softmax; a row that has seen no valid slot yet keeps p = 0
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) mx[c >> 1] = fmaxf(mx[c >> 1], s[j][c]);
      float alpha[2], mlog[2];
      bool live[2];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 1));
        mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 2));
        const float m_new = fmaxf(mrow[h2], mx[h2]);
        live[h2] = m_new > 0.5f * NEG_INF;
        alpha[h2] = live[h2] ? exp2_ftz((mrow[h2] - m_new) * LOG2E) : 1.f;
        mrow[h2] = m_new;
        mlog[h2] = m_new * LOG2E;
      }
      float psum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float p = live[c >> 1] ? exp2_ftz(fmaf(s[j][c], LOG2E, -mlog[c >> 1])) : 0.f;
          psum[c >> 1] += p;
          // v_scale folded into p before p is rounded to bf16 (l sums p)
          s[j][c] = KV8 ? p * xb[2 * BKV + 8 * j + 2 * t + (c & 1)] : p;
        }
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) lrow[h2] = lrow[h2] * alpha[h2] + psum[h2];
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        o[c][0] *= alpha[0];
        o[c][1] *= alpha[0];
        o[c][2] *= alpha[1];
        o[c][3] *= alpha[1];
      }
      // O += P V: P's C fragments, rounded to bf16, are A fragments
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        uint32_t pa[4];
        acc_to_a(pa, s[j], s[j + 1]);
#pragma unroll
        for (int c = 0; c < D / 8; c += 2) {
          uint32_t vf[4];
          ldsm_x4_t(vf, ldsm_rows(Vb, LD, 8 * j, 8 * c, lane));
          mma(o[c], pa, vf[0], vf[1]);
          mma(o[c + 1], pa, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();  // this buffer's readers are done
    buf ^= 1;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    float l = lrow[h2];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int r = r0 + g + 8 * h2;
    if (r >= nrows) continue;
    const size_t row = row0 + r, orow = o_row(A, row);
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      finish<D>(A, w.split, row, orow, 8 * c + 2 * t, mrow[h2], l, o[c][2 * h2]);
      finish<D>(A, w.split, row, orow, 8 * c + 2 * t + 1, mrow[h2], l, o[c][2 * h2 + 1]);
    }
    if (A.splits > 1 && t == 0) *part_ml<D>(A, w.split, row) = make_float2(mrow[h2], l);
  }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// nq > 16 otherwise (float32 q or cache): the FMA tile
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(NT) decode_fma(const Args A) {
  constexpr bool QUANT = std::is_same<T, int8_t>::value;
  constexpr int RPT = QT_ROWS / 16;
  using TileT = Tile<D, RPT>;
  extern __shared__ float smem[];
  TileT tile(smem);

  const Work w = work_of(A, (A.nq + QT_ROWS - 1) / QT_ROWS);
  const int q0 = w.qt * QT_ROWS, nrows = min(QT_ROWS, A.nq - q0);
  const size_t row0 = size_t(w.bh) * A.nq + q0;
  if (w.c0 >= w.c1) {  // uniform across the block
    empty_rows<D>(A, w.split, row0, nrows);
    return;
  }
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const T* kb = static_cast<const T*>(A.k) + size_t(w.bh) * A.cap * D;
  const T* vb = static_cast<const T*>(A.v) + size_t(w.bh) * A.cap * D;
  const float* ksb = QUANT ? A.ks + size_t(w.bh) * A.cap : nullptr;
  const float* vsb = QUANT ? A.vs + size_t(w.bh) * A.cap : nullptr;
  const float* brow = A.bias + size_t(w.bi) * A.cap;

  for (int e = tid; e < QT_ROWS * D; e += NT) {
    const int r = e / D, c = e - r * D;
    tile.Qs[r * TileT::QS + c] = r < nrows ? q_at(A, q_row(A, row0 + r) + c) * A.scale : 0.f;
  }

  float m_i[RPT], l_i[RPT], acc[RPT][TileT::DC];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    m_i[r] = NEG_INF;
    l_i[r] = 0.f;
#pragma unroll
    for (int c = 0; c < TileT::DC; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = w.c0; k0 < w.c1; k0 += BK) {
    __syncthreads();  // Q is written / the previous tile's readers are done
    for (int e = tid; e < BK * D; e += NT) {
      const int r = e / D, c = e - r * D, gk = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (gk < w.c1) {
        kx = to_f(kb[size_t(gk) * D + c]);
        vx = to_f(vb[size_t(gk) * D + c]);
        if (QUANT) {
          kx *= ksb[gk];
          vx *= vsb[gk];
        }
      }
      tile.Ks[r * TileT::QS + c] = kx;
      tile.Vs[r * D + c] = vx;
    }
    __syncthreads();

    float s[RPT][4];
    tile.scores(s, tx, ty);
    if (A.softcap > 0.f) softcap_tile(flat<RPT * 4>(s), A.softcap);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int jl = k0 + tx + 16 * j;
      const float b = jl < w.c1 ? brow[jl] : 0.f;
#pragma unroll
      for (int r = 0; r < RPT; ++r) s[r][j] = jl < w.c1 ? s[r][j] + b : NEG_INF;
    }
    tile.template softmax_update<true, float>(s, m_i, l_i, acc, tx, ty);
    __syncthreads();
    tile.pv(acc, tx, ty);
  }

#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int rr = ty * RPT + r;
    if (rr >= nrows) continue;
    const size_t orow = o_row(A, row0 + rr);
#pragma unroll
    for (int c = 0; c < TileT::DC; ++c)
      finish<D>(A, w.split, row0 + rr, orow, tx + 16 * c, m_i[r], l_i[r], acc[r][c]);
    if (A.splits > 1 && tx == 0) *part_ml<D>(A, w.split, row0 + rr) = make_float2(m_i[r], l_i[r]);
  }
}

// ---------------------------------------------------------------------------
// the merge of the splits
// ---------------------------------------------------------------------------

// out[row] = sum_s acc_s e^{m_s - M} / sum_s l_s e^{m_s - M}, M = max_s m_s;
// 0 where M is -1e30 (no split saw a valid slot). Splits with m_s = -1e30
// are skipped (an exiting block writes no acc). One thread per 4 columns.
template <int D>
__global__ void __launch_bounds__(256) decode_merge(const Args A) {
  const size_t n = size_t(A.rows) * (D / 4);
  for (size_t i = blockIdx.x * size_t(256) + threadIdx.x; i < n; i += size_t(gridDim.x) * 256) {
    const size_t row = i / (D / 4);
    const int col = int(i % (D / 4)) * 4;
    float M = NEG_INF;
    for (int s = 0; s < A.splits; ++s) M = fmaxf(M, part_ml<D>(A, s, row)->x);
    float o[4] = {0.f, 0.f, 0.f, 0.f};
    if (M > 0.5f * NEG_INF) {
      float L = 0.f;
      for (int s = 0; s < A.splits; ++s) {
        const float2 ml = *part_ml<D>(A, s, row);
        if (ml.x <= 0.5f * NEG_INF) continue;
        const float wgt = exp2_ftz((ml.x - M) * LOG2E);
        const float4 a = *reinterpret_cast<const float4*>(part_acc<D>(A, s, row) + col);
        L += ml.y * wgt;
        o[0] += a.x * wgt, o[1] += a.y * wgt, o[2] += a.z * wgt, o[3] += a.w * wgt;
      }
      const float inv = 1.f / fmaxf(L, 1e-30f);
#pragma unroll
      for (int x = 0; x < 4; ++x) o[x] *= inv;
    }
#pragma unroll
    for (int x = 0; x < 4; ++x) put_out(A, o_row(A, row) + col + x, o[x]);
  }
}

template <typename T, int D>
int launch(const Args& A, long long bh, cudaStream_t stream) {
  cudaError_t err;
  if (A.nq <= WARP_MAX_NQ) {
    const long long blocks = bh * A.nq * A.splits;
    if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
    decode_warp<T, D><<<unsigned(blocks), 32 * WNW, 0, stream>>>(A);
  } else {
    const long long blocks = bh * ((A.nq + QT_ROWS - 1) / QT_ROWS) * A.splits;
    if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
    bool done = false;
    if constexpr (!std::is_same<T, float>::value) {
      if (A.q_bf16) {
        constexpr bool KV8 = std::is_same<T, int8_t>::value;
        auto kern = tc::decode_mma<D, KV8>;
        const int smem = int(tc::Lay<D, KV8>::kBytes);
        err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return int(err);
        kern<<<unsigned(blocks), tc::TT, smem, stream>>>(A);
        done = true;
      }
    }
    if (!done) {
      auto kern = decode_fma<T, D>;
      const int smem = int(Tile<D, QT_ROWS / 16>::kFloats * sizeof(float));
      err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return int(err);
      kern<<<unsigned(blocks), NT, smem, stream>>>(A);
    }
  }
  if ((err = cudaGetLastError()) != cudaSuccess || A.splits == 1) return int(err);
  const size_t groups = size_t(A.rows) * (D / 4);
  const unsigned grid = unsigned(groups / 256 + 1 < 132 * 8 ? groups / 256 + 1 : 132 * 8);
  decode_merge<D><<<grid, 256, 0, stream>>>(A);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch_d(int d, const Args& A, long long bh, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(A, bh, stream);
    case 64:
      return launch<T, 64>(A, bh, stream);
    case 128:
      return launch<T, 128>(A, bh, stream);
    case 256:
      return launch<T, 256>(A, bh, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// q [b,h,nq,d] float32 or bf16 (q_bf16 = 1), 1 <= nq <= 1024; k/v
// [b,h,cap,d] of kv_dtype (0 float32, 1 bf16, 2 int8 with k_scale/v_scale
// float32 [b,h,cap]); bias float32 [b,cap]; lens int32 [b] or NULL (the
// whole capacity); out [b,h,nq,d] in q's dtype; d in {32, 64, 128, 256}.
// strides: the element strides of q over b, h, nq, then of out (d's is 1;
// a row of q 16-byte aligned); everything else contiguous, k and v 16-byte
// aligned. The cache is cut into `splits` chunks of `chunk`
// slots (a multiple of 64; (splits - 1) * chunk < cap <= splits * chunk);
// with splits > 1, ws is a float32 workspace of splits * b*h*nq * (d + 2)
// values, else NULL. Launches the split kernel and, with splits > 1, the
// merge; returns the cudaError_t of the launches (0 = success).
extern "C" int decode_attn(const void* q, const void* k, const void* v, const float* k_scale,
                           const float* v_scale, const float* bias, const int* lens, void* out,
                           float* ws, int b, int h, int nq, int cap, int d, float scale,
                           float softcap, int kv_dtype, int q_bf16, int splits, int chunk,
                           const long long* strides, void* stream) {
  if (b <= 0 || h <= 0 || nq <= 0 || nq > 1024 || cap <= 0) return int(cudaErrorInvalidValue);
  if (chunk <= 0 || chunk % SPLIT_SLOTS != 0 || splits <= 0 ||
      (long long)splits * chunk < cap || (long long)(splits - 1) * chunk >= cap)
    return int(cudaErrorInvalidValue);
  if ((splits > 1) != (ws != nullptr)) return int(cudaErrorInvalidValue);
  const long long bh = (long long)b * h;
  if (bh * nq > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  const Args A{q,          k,          v,          k_scale,    v_scale,    bias,
               lens,       out,        ws,         h,          nq,         cap,
               splits,     chunk,      int(bh * nq), q_bf16 != 0, scale,   softcap,
               strides[0], strides[1], strides[2], strides[3], strides[4], strides[5]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kv_dtype) {
    case 0:
      return dispatch_d<float>(d, A, bh, s);
    case 1:
      return dispatch_d<bf16>(d, A, bh, s);
    case 2:
      if (k_scale == nullptr || v_scale == nullptr) return int(cudaErrorInvalidValue);
      return dispatch_d<int8_t>(d, A, bh, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}
