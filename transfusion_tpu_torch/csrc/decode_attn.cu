// Cached decode attention over the KV cache, for Hopper (sm_90a).
//
// Replaces transfusion_tpu/ops/pallas_decode_kernel.py `decode_attention` /
// `_decode_kernel_dma`: query rows of the chunk being decoded attend to the
// whole cache of their batch row,
//
//   s_j = cap * tanh((q * d^-1/2) . k_j / cap) + bias[b, j]      (j < lens[b])
//   out = softmax(s) . v       (float32; 0 for a row with no valid slot)
//
// with K/V stored as float32, bf16, or int8 with a float32 scale per
// (token, head) that is applied in registers (the cache stays int8-wide in
// device memory). bias is the additive validity (0 or -1e30); lens[b]
// bounds the slots a row streams. lens is idx + n, not the count of valid
// slots: after a padded prefill the valid slots are not a prefix.
//
// Layout: one block per (b*h, tile of query rows); the block loops over the
// cache in 64-slot tiles up to lens[b]. Text decode (nq = 1) uses 16-row
// tiles, the ODE's modality rows (nq = 196) 64-row tiles. The port stores
// the cache as [b, h, cap, d]; the TPU's transposed layout was a DMA
// alignment artifact.
//
// What bounds it on the H100: bytes. A decode step must read every valid
// K/V slot once (2 * b * h * lens * d * itemsize) and does only ~4 d FLOPs
// per slot and query row, so at nq = 1 it sits far below the 295 FLOP/byte
// ridge. The design keeps the traffic to one pass at the stored width
// (int8 dequantized in registers, early exit at lens). What it does not do
// yet: at b <= 8, h = 8 the grid is 64 blocks or fewer on 132 SMs, so one
// block streams a whole history alone; splitting the cache across blocks
// (split-K) is later work (PERF.md).

#include <type_traits>

#include "attn_tile.cuh"

using namespace attn_tile;

namespace {

template <typename TKV, int D, int RPT>
__global__ void __launch_bounds__(NT)
decode_attn_kernel(const float* __restrict__ q, const TKV* __restrict__ k,
                   const TKV* __restrict__ v, const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale, const float* __restrict__ bias,
                   const int* __restrict__ lens, float* __restrict__ out, int H, int nq, int cap,
                   float scale, float softcap) {
  constexpr bool QUANT = std::is_same<TKV, int8_t>::value;
  using TileT = Tile<D, RPT>;
  extern __shared__ float smem[];
  TileT tile(smem);

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y, bi = bh / H;
  const int q0 = blockIdx.x * TileT::ROWS;
  const float* qb = q + size_t(bh) * nq * D;
  const TKV* kb = k + size_t(bh) * cap * D;
  const TKV* vb = v + size_t(bh) * cap * D;
  const float* ksb = QUANT ? k_scale + size_t(bh) * cap : nullptr;
  const float* vsb = QUANT ? v_scale + size_t(bh) * cap : nullptr;
  const float* brow = bias + size_t(bi) * cap;
  const int len = min(max(lens[bi], 0), cap);

  for (int e = tid; e < TileT::ROWS * D; e += NT) {
    const int r = e / D, c = e - r * D, gr = q0 + r;
    tile.Qs[r * TileT::QS + c] = gr < nq ? qb[size_t(gr) * D + c] * scale : 0.f;
  }

  float m_i[RPT], l_i[RPT], acc[RPT][TileT::DC];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    m_i[r] = NEG_INF;
    l_i[r] = 0.f;
#pragma unroll
    for (int c = 0; c < TileT::DC; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = 0; k0 < len; k0 += BK) {
    __syncthreads();  // Q is written / previous tile's readers are done
    for (int e = tid; e < BK * D; e += NT) {
      const int r = e / D, c = e - r * D, gk = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (gk < len) {
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
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int jl = k0 + tx + 16 * j;
      const float b = jl < len ? brow[jl] : 0.f;
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        float x = s[r][j];
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        s[r][j] = jl < len ? x + b : NEG_INF;
      }
    }
    tile.template softmax_update<false, float>(s, m_i, l_i, acc, tx, ty);
    __syncthreads();
    tile.pv(acc, tx, ty);
  }

  float* ob = out + size_t(bh) * nq * D;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = q0 + ty * RPT + r;
    if (row >= nq) continue;
    const bool valid = m_i[r] > 0.5f * NEG_INF;
    const float ls = fmaxf(l_i[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < TileT::DC; ++c)
      ob[size_t(row) * D + tx + 16 * c] = valid ? acc[r][c] / ls : 0.f;
  }
}

template <typename TKV, int D, int RPT>
int launch(const float* q, const void* k, const void* v, const float* ks, const float* vs,
           const float* bias, const int* lens, float* out, int b, int h, int nq, int cap,
           float scale, float softcap, cudaStream_t stream) {
  const size_t smem = Tile<D, RPT>::kFloats * sizeof(float);
  auto kern = decode_attn_kernel<TKV, D, RPT>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  constexpr int rows = 16 * RPT;
  const dim3 grid((nq + rows - 1) / rows, b * h);
  kern<<<grid, NT, smem, stream>>>(q, static_cast<const TKV*>(k), static_cast<const TKV*>(v), ks,
                                   vs, bias, lens, out, h, nq, cap, scale, softcap);
  return int(cudaGetLastError());
}

template <typename TKV, int D>
int dispatch_rows(const float* q, const void* k, const void* v, const float* ks,
                  const float* vs, const float* bias, const int* lens, float* out, int b, int h,
                  int nq, int cap, float scale, float softcap, cudaStream_t stream) {
  if (nq <= 16)
    return launch<TKV, D, 1>(q, k, v, ks, vs, bias, lens, out, b, h, nq, cap, scale, softcap,
                             stream);
  return launch<TKV, D, 4>(q, k, v, ks, vs, bias, lens, out, b, h, nq, cap, scale, softcap,
                           stream);
}

template <typename TKV>
int dispatch_d(int d, const float* q, const void* k, const void* v, const float* ks,
               const float* vs, const float* bias, const int* lens, float* out, int b, int h,
               int nq, int cap, float scale, float softcap, cudaStream_t stream) {
  switch (d) {
    case 32:
      return dispatch_rows<TKV, 32>(q, k, v, ks, vs, bias, lens, out, b, h, nq, cap, scale,
                                    softcap, stream);
    case 64:
      return dispatch_rows<TKV, 64>(q, k, v, ks, vs, bias, lens, out, b, h, nq, cap, scale,
                                    softcap, stream);
    case 128:
      return dispatch_rows<TKV, 128>(q, k, v, ks, vs, bias, lens, out, b, h, nq, cap, scale,
                                     softcap, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// q float32 [b,h,nq,d]; k/v [b,h,cap,d] of kv_dtype (0 float32, 1 bf16,
// 2 int8 with k_scale/v_scale float32 [b,h,cap]); bias float32 [b,cap];
// lens int32 [b]; out float32 [b,h,nq,d]. All contiguous.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int decode_attn(const float* q, const void* k, const void* v, const float* k_scale,
                           const float* v_scale, const float* bias, const int* lens, float* out,
                           int b, int h, int nq, int cap, int d, float scale, float softcap,
                           int kv_dtype, void* stream) {
  if (nq <= 0 || cap <= 0) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kv_dtype) {
    case 0:
      return dispatch_d<float>(d, q, k, v, k_scale, v_scale, bias, lens, out, b, h, nq, cap,
                               scale, softcap, s);
    case 1:
      return dispatch_d<__nv_bfloat16>(d, q, k, v, k_scale, v_scale, bias, lens, out, b, h, nq,
                                       cap, scale, softcap, s);
    case 2:
      if (k_scale == nullptr || v_scale == nullptr) return int(cudaErrorInvalidValue);
      return dispatch_d<int8_t>(d, q, k, v, k_scale, v_scale, bias, lens, out, b, h, nq, cap,
                                scale, softcap, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}
