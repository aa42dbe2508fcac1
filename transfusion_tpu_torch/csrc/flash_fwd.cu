// Flash-attention forward with the transfusion mask, for Hopper (sm_90a).
//
// Replaces the head-major Pallas TPU forward of
// transfusion_tpu/ops/pallas_attn_kernel.py — `_flash_fwd` and the three
// kernels it routes to: `_kernel_batched_heads` (short sequences, full score
// matrix), `_kernel` (blocked online softmax, K/V resident) and
// `_kernel_streamed` (K/V streamed through the grid). Those splits are TPU
// VMEM artifacts; one CUDA kernel meets all three contracts:
//
//   out[i] = softmax_j(cap * tanh((q_i * d^-1/2) . k_j / cap) | allowed) . v
//   allowed(i, j) = i >= j  |  any_m[len_m > 0 & i >= off_m & j < off_m + len_m]
//
// at GLOBAL coordinates i = q_offset + row, j = kv_offset + col, with an
// optional per-row logsumexp. A row that sees no column gets out = 0 and
// lse ~ -1e30 (the contract ring attention merges through).
//
// Two layouts, chosen by `nhd`: head-major q/k/v/out [b, h, n, d] (the
// route of `_flash_fwd`) and token-major [b, n, h*d] (the route of
// `_nhd_pallas` -> `_kernel_batched_nhd`, row 5 of the kernel table). In
// both, a head's row r lies at base + r * row_stride; the kernel computes
// the base and stride from the layout, so the token-major route needs no
// transpose copies. With cos/sin (float32 [b, n, d]) each q/k element is
// rotated on load by the interleaved RoPE (pairs 2j, 2j+1) in float32 and
// rounded to the input dtype, as `_rope_tile` does before the product.
//
// Layout: one block per (b*h, 64-row q tile); the block reads its own spans
// (no scalar prefetch), loops over 64-column KV tiles only up to the last
// tile visible through causality or a span rectangle, skips fully masked
// tiles and skips mask evaluation on fully visible ones (`_blk_visibility`).
// Ragged n is masked in-kernel rather than padded.
//
// What bounds it on the H100: prefill at the serving shapes is
// compute-bound (4 b h n^2 d x visible-fraction FLOPs over ~2 b h n d
// elements). This first version runs the two products as float32 FMAs from
// shared memory, far below the 989 TFLOP/s of the bf16 tensor cores; the
// block-skipping keeps the work to the visible fraction. Moving the
// products to wgmma/mma.sync is later work (PERF.md).
//
// Numerics follow the JAX kernel: q is scaled in its own dtype before the
// product, scores and softmax state are float32, probabilities are rounded
// to the value dtype before the PV product, output is written in q's dtype.

#include "attn_tile.cuh"

using namespace attn_tile;

namespace {

constexpr int RPT = 4;
constexpr int BQ = 16 * RPT;  // 64 query rows per block
constexpr int MAX_SPANS = 128;

template <typename T, int D, bool NHD, bool ROPE>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ spans, int m, const float* __restrict__ cos,
                 const float* __restrict__ sin, T* __restrict__ out, float* __restrict__ lse,
                 int H, int nq, int nkv, int q_off, int kv_off, float scale, float softcap) {
  using TileT = Tile<D, RPT>;
  extern __shared__ float smem[];
  TileT tile(smem);
  int* sp_off = reinterpret_cast<int*>(smem + TileT::kFloats);
  int* sp_len = sp_off + MAX_SPANS;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y, bi = bh / H, head = bh - bi * H;
  const int q0 = blockIdx.x * BQ;
  const size_t rs = row_stride(NHD, H, D);
  const T* qb = q + head_base(NHD, bi, head, H, nq, D);
  const T* kb = k + head_base(NHD, bi, head, H, nkv, D);
  const T* vb = v + head_base(NHD, bi, head, H, nkv, D);

  for (int s = tid; s < m; s += NT) {
    sp_off[s] = spans[(size_t(bi) * m + s) * 3 + 1];
    sp_len[s] = spans[(size_t(bi) * m + s) * 3 + 2];
  }
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
  __syncthreads();

  // KV loop bound: causal visibility plus every span rectangle this tile's
  // rows reach, in global coordinates
  const int q_start = q0 + q_off;
  const int q_end = min(q0 + BQ, nq) - 1 + q_off;
  int hi_tok = q_end;
  for (int s = 0; s < m; ++s)
    if (sp_len[s] > 0 && q_end >= sp_off[s]) hi_tok = max(hi_tok, sp_off[s] + sp_len[s] - 1);
  const int n_tiles = (nkv + BK - 1) / BK;
  const int hi = hi_tok < kv_off ? 0 : min((hi_tok - kv_off) / BK + 1, n_tiles);

  float m_i[RPT], l_i[RPT], acc[RPT][TileT::DC];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    m_i[r] = NEG_INF;
    l_i[r] = 0.f;
#pragma unroll
    for (int c = 0; c < TileT::DC; ++c) acc[r][c] = 0.f;
  }

  for (int it = 0; it < hi; ++it) {
    const int k0 = it * BK, kg = k0 + kv_off;
    // tile summary: any column visible / every (row, col) visible
    bool any = q_end >= kg;
    bool full = q_start >= kg + BK - 1;
    for (int s = 0; s < m; ++s) {
      const int off = sp_off[s], ln = sp_len[s];
      if (ln <= 0) continue;
      any = any || (q_end >= off && kg < off + ln);
      full = full || (q_start >= off && kg + BK - 1 < off + ln);
    }
    full = full && (k0 + BK <= nkv);
    if (!any) continue;  // uniform across the block

    __syncthreads();  // previous tile's readers are done with Ks/Vs/Ps
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
    __syncthreads();

    float s[RPT][4];
    tile.scores(s, tx, ty);
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int i = q_start + ty * RPT + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[r][j];
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        if (!full) {
          const int jl = k0 + tx + 16 * j, jg = jl + kv_off;
          bool ok = i >= jg;
          for (int sp = 0; sp < m; ++sp)
            ok = ok || (sp_len[sp] > 0 && i >= sp_off[sp] && jg < sp_off[sp] + sp_len[sp]);
          if (!(ok && jl < nkv)) x = NEG_INF;
        }
        s[r][j] = x;
      }
    }
    tile.template softmax_update<true, T>(s, m_i, l_i, acc, tx, ty);
    __syncthreads();
    tile.pv(acc, tx, ty);
  }

  T* ob = out + head_base(NHD, bi, head, H, nq, D);
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = q0 + ty * RPT + r;
    if (row >= nq) continue;
    const float ls = fmaxf(l_i[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < TileT::DC; ++c) ob[size_t(row) * rs + tx + 16 * c] = from_f<T>(acc[r][c] / ls);
    if (lse != nullptr && tx == 0) lse[size_t(bh) * nq + row] = m_i[r] + logf(ls);
  }
}

struct Rope {
  const float* cos;  // float32 [b, nq, d] or NULL
  const float* sin;
};

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* spans, int m, Rope rope,
           void* out, float* lse, int b, int h, int nq, int nkv, int q_off, int kv_off, int nhd,
           float scale, float softcap, cudaStream_t stream) {
  const size_t smem = Tile<D, RPT>::kFloats * sizeof(float) + 2 * MAX_SPANS * sizeof(int);
  // layout and RoPE are template flags: the head-major route compiles to
  // constant strides and loads without a branch
  auto kern = !nhd ? flash_fwd_kernel<T, D, false, false>
              : rope.cos != nullptr ? flash_fwd_kernel<T, D, true, true>
                                    : flash_fwd_kernel<T, D, true, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((nq + BQ - 1) / BQ, b * h);
  kern<<<grid, NT, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                   static_cast<const T*>(v), spans, m, rope.cos, rope.sin,
                                   static_cast<T*>(out), lse, h, nq, nkv, q_off, kv_off, scale,
                                   softcap);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch_d(int d, const void* q, const void* k, const void* v, const int* spans, int m,
               Rope rope, void* out, float* lse, int b, int h, int nq, int nkv, int q_off,
               int kv_off, int nhd, float scale, float softcap, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, spans, m, rope, out, lse, b, h, nq, nkv, q_off, kv_off,
                           nhd, scale, softcap, stream);
    case 64:
      return launch<T, 64>(q, k, v, spans, m, rope, out, lse, b, h, nq, nkv, q_off, kv_off,
                           nhd, scale, softcap, stream);
    case 128:
      return launch<T, 128>(q, k, v, spans, m, rope, out, lse, b, h, nq, nkv, q_off, kv_off,
                            nhd, scale, softcap, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// q [b,h,nq,d], k/v [b,h,nkv,d] (nhd = 0) or q [b,nq,h*d], k/v [b,nkv,h*d]
// (nhd = 1), contiguous, bf16 (is_bf16=1) or float32; spans int32 [b,m,3]
// (m <= 128); cos/sin float32 [b,nq,d] or NULL (no RoPE; only with nhd = 1,
// where nq == nkv); out like q; lse float32 [b,h,nq] or NULL.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const int* spans, int m,
                         const float* cos, const float* sin, void* out, float* lse, int b,
                         int h, int nq, int nkv, int d, int q_off, int kv_off, int nhd,
                         float scale, float softcap, int is_bf16, void* stream) {
  if (m < 0 || m > MAX_SPANS || nq <= 0 || nkv <= 0 || b * h > 65535)
    return int(cudaErrorInvalidValue);  // one grid row per (batch, head)
  if ((cos == nullptr) != (sin == nullptr) || (cos != nullptr && (nq != nkv || !nhd)))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Rope rope{cos, sin};
  if (is_bf16)
    return dispatch_d<__nv_bfloat16>(d, q, k, v, spans, m, rope, out, lse, b, h, nq, nkv,
                                     q_off, kv_off, nhd, scale, softcap, s);
  return dispatch_d<float>(d, q, k, v, spans, m, rope, out, lse, b, h, nq, nkv, q_off, kv_off,
                           nhd, scale, softcap, s);
}
