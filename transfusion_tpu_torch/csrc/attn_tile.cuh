// Shared tile machinery of the port's attention kernels (flash_fwd.cu,
// flash_bwd.cu, decode_attn.cu): conversions, layouts, the mask, the
// softcap's tanh, and the FMA tile of the float32 forward and of the decode kernel (the bf16
// forward and backward run on the tensor cores, mma_tile.cuh).
//
// The FMA tile: a block of 256 threads holds a tile of ROWS = 16 * RPT
// query rows in shared memory and walks the keys/values in tiles of BK = 64
// columns. Thread (ty, tx) = (tid / 16, tid % 16) owns query rows
// ty*RPT .. ty*RPT+RPT-1 and, of each KV tile, the columns tx, tx+16, tx+32,
// tx+48; of the output it owns the head dimensions tx, tx+16, ... . The 16
// threads that share a row group sit in one half-warp, so row max and row
// sum are four shuffles. Scores, softmax state and the output accumulator
// are float32. Products are plain FMAs from shared memory: the tiles are
// padded by one float per row so the K reads of a half-warp hit 16
// different banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn_tile {

constexpr float NEG_INF = -1e30f;  // the JAX kernels' finite "minus infinity"
constexpr int BK = 64;             // KV tile width
constexpr int NT = 256;            // threads per block

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T's precision, as a float
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o, 16));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o, 16);
  return x;
}

// Offset of row 0 of head (bi, hi) in a [b, h, n, d] (nhd = 0) or
// [b, n, h*d] (nhd = 1) tensor; rows are row_stride(nhd, H, D) apart.
__device__ __forceinline__ size_t head_base(int nhd, int bi, int hi, int H, int n, int D) {
  return nhd ? (size_t(bi) * n * H + hi) * D : (size_t(bi) * H + hi) * size_t(n) * D;
}
__device__ __forceinline__ size_t row_stride(int nhd, int H, int D) {
  return nhd ? size_t(H) * D : size_t(D);
}

// Element c of a row, rotated by the interleaved RoPE when cs != nullptr
// (cs/sn point at the row's d angles) and rounded to T, as `_rope_tile`.
template <typename T>
__device__ __forceinline__ float rope_load(const T* row, int c, const float* cs,
                                           const float* sn) {
  const float x = to_f(row[c]);
  if (cs == nullptr) return x;
  const float partner = to_f(row[c ^ 1]);
  const float rot = (c & 1) ? partner : -partner;
  return round_to<T>(x * cs[c] + rot * sn[c]);
}

// The transfusion mask (`_span_allowed`, pallas_attn_kernel.py:54) at
// global coordinates: allowed(i, j) = i >= j | any span with len > 0,
// i >= off and j < off + len. The keys a query row sees form a prefix: a
// span's rectangle admits the columns j < off + len of every row i >= off,
// and causality j < i + 1, so allowed(i, j) <=> j < end(i) = max(i + 1,
// max over spans with len > 0 and off <= i of off + len), which is
// nondecreasing in i. The kernels reduce the mask to these ends and read
// the spans (int32 [m][3] of one batch row: type, off, len) straight from
// device memory, so any span count takes the same fixed shared memory.
//
// visible_ends gives, for R global rows i[r], end(i[r]) less kv_off,
// clamped to [0, nkv]: the number of local kv columns row i[r] sees.
template <int R>
__device__ __forceinline__ void visible_ends(const int (&i)[R], const int* __restrict__ sp,
                                             int m, int kv_off, int nkv, int (&end)[R]) {
  long long e[R];
#pragma unroll
  for (int r = 0; r < R; ++r) e[r] = i[r] + 1LL;
#pragma unroll 4
  for (int s = 0; s < m; ++s) {
    const int off = __ldg(sp + 3 * s + 1), ln = __ldg(sp + 3 * s + 2);
    if (ln <= 0) continue;
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (off <= i[r]) e[r] = e[r] > (long long)off + ln ? e[r] : (long long)off + ln;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long x = e[r] - kv_off;
    end[r] = int(x < 0 ? 0 : x > nkv ? nkv : x);
  }
}

// The first global row that sees global column j: j itself (causality), or
// the offset of a span whose rectangle reaches j. Every later row sees j
// too (the ends are nondecreasing).
__device__ __forceinline__ int first_row_seeing(int j, const int* __restrict__ sp, int m) {
  int lo = j;
#pragma unroll 4
  for (int s = 0; s < m; ++s) {
    const int off = __ldg(sp + 3 * s + 1), ln = __ldg(sp + 3 * s + 2);
    if (ln > 0 && j < (long long)off + ln) lo = min(lo, off);
  }
  return lo;
}

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// tanh(y) for |y| <= 1/4: y + y^3 (-1/3 + y^2 (2/15 + y^2 (-17/315 +
// y^2 62/2835))); the next term is < 2.1e-9 there
__device__ __forceinline__ float tanh_small(float y) {
  const float y2 = y * y;
  float p = fmaf(y2, 62.f / 2835.f, -17.f / 315.f);
  p = fmaf(y2, p, 2.f / 15.f);
  p = fmaf(y2, p, -1.f / 3.f);
  return fmaf(p * y2, y, y);
}

// tanh(y) = 1 - 2 / (1 + e^{2y}) (absolute error ~2e-7; e^{2y} kept finite)
__device__ __forceinline__ float tanh_exp(float y) {
  return 1.f - __fdividef(2.f, 1.f + exp2_ftz(fminf(y, 15.f) * (2.f * LOG2E)));
}

// The softcap of every kernel (forward, backward, decode): x = cap *
// tanh(x / cap) over the N values a lane holds, cap > 0. tanh is exact to
// ~2e-7: the odd polynomial where every |x / cap| of the warp is <= 1/4
// (|x| <= 12.5 at cap 50, every score of a model near its init; no
// special-function unit), else 1 - 2 / (1 + e^{2y}). tanh.approx (2^-11
// relative, times the cap) would move an lse by ~1e-3 and make the
// backward's p disagree with the forward's. The choice is warp-uniform:
// all 32 lanes of the warp must call it together.
template <int N>
__device__ __forceinline__ void softcap_tile(float (&x)[N], float cap) {
  const float inv = 1.f / cap;
  bool big = false;
#pragma unroll
  for (int i = 0; i < N; ++i) big |= fabsf(x[i] * inv) > 0.25f;
  if (__any_sync(0xffffffffu, big)) {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = cap * tanh_exp(x[i] * inv);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = cap * tanh_small(x[i] * inv);
  }
}

// a multi-dimensional float register array as one of its N values
template <int N, typename T>
__device__ __forceinline__ float (&flat(T& x))[N] {
  static_assert(sizeof(T) == N * sizeof(float), "flat: N must count every value of x");
  return reinterpret_cast<float(&)[N]>(x);
}

// D: the q . k width; DV: the value (and output) width, D unless given.
template <int D, int RPT, int DV = D>
struct Tile {
  static_assert(D % 16 == 0 && DV % 16 == 0, "head dims must be multiples of 16");
  static constexpr int ROWS = 16 * RPT;
  static constexpr int QS = D + 1;   // padded row stride of the Q and K tiles
  static constexpr int PS = BK + 1;  // padded row stride of the P tile
  static constexpr int DC = DV / 16;  // output columns per thread
  static constexpr size_t kFloats =
      size_t(ROWS) * QS + size_t(BK) * QS + size_t(BK) * DV + size_t(ROWS) * PS;

  float* Qs;  // [ROWS][QS]
  float* Ks;  // [BK][QS]
  float* Vs;  // [BK][DV]
  float* Ps;  // [ROWS][PS]

  __device__ explicit Tile(float* smem)
      : Qs(smem), Ks(smem + ROWS * QS), Vs(Ks + BK * QS), Ps(Vs + BK * DV) {}

  // s[r][j] = Q[ty*RPT + r] . K[tx + 16 j]
  __device__ __forceinline__ void scores(float (&s)[RPT][4], int tx, int ty) const {
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[r][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float kv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float qv = Qs[(ty * RPT + r) * QS + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) s[r][j] = fmaf(qv, kv[j], s[r][j]);
      }
    }
  }

  // Online-softmax update with one tile of (already capped and masked)
  // scores. Writes the tile's probabilities, rounded to PT, to Ps and
  // rescales the accumulator. GUARD: a row that has seen no visible
  // column yet (max still NEG_INF) gets p = 0 instead of exp(0) = 1.
  template <bool GUARD, typename PT>
  __device__ __forceinline__ void softmax_update(float (&s)[RPT][4], float (&m)[RPT],
                                                 float (&l)[RPT], float (&acc)[RPT][DC],
                                                 int tx, int ty) {
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      float mx = fmaxf(fmaxf(s[r][0], s[r][1]), fmaxf(s[r][2], s[r][3]));
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[r], mx);
      const bool live = !GUARD || m_new > 0.5f * NEG_INF;
      const float alpha = live ? expf(m[r] - m_new) : 1.f;
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = live ? expf(s[r][j] - m_new) : 0.f;
        psum += p;
        Ps[(ty * RPT + r) * PS + tx + 16 * j] = round_to<PT>(p);
      }
      psum = half_warp_sum(psum);
      l[r] = l[r] * alpha + psum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[r][c] *= alpha;
    }
  }

  // acc[r][c] += sum_k P[ty*RPT + r][k] * V[k][tx + 16 c]
  __device__ __forceinline__ void pv(float (&acc)[RPT][DC], int tx, int ty) const {
#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = Vs[k * DV + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float p = Ps[(ty * RPT + r) * PS + k];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
      }
    }
  }
};

}  // namespace attn_tile
