// Multi-head self-attention forward, online softmax.
//
// Replaces the Pallas TPU kernel `ops/pallas_mha.py:_mha_kernel` (launched by
// `_mha_fwd_impl`) of the JAX package: o = softmax(q·Kᵀ·scale)·V per
// (batch, head), f32 scores and softmax, p rounded to V's dtype before the
// PV product, output in q's dtype.
//
// Bound on the H100: at SD level 0 (L=4096, dh=40) the work is 4·L²·dh FLOPs
// per head against 4·L·dh bytes, far above the card's ridge point, so the
// kernel is bound by operations.  The TPU kernel kept a whole score row per
// query in VMEM; an SM's 227 KB cannot hold a 4096-key f32 row for a useful
// query tile, so both kernels walk the keys in tiles of 64 with a running
// max and sum (flash-attention style), and the scores never reach device
// memory.  The loops live in `attn_fwd.cuh`, shared with `flash_fwd.cu`,
// and the caller picks one by `design`: 1, wgmma fed by a TMA ring (bf16 at
// head widths 40, 64, 80, 128: SD levels 0 and 1); 0, mma.sync m16n8k16
// (bf16 at any other width, dh padded to a multiple of 16: levels 2 and mid,
// dh = 160) or the CUDA cores (float32).
#include "attn_fwd.cuh"

namespace {

using dsta::bf16;

__global__ void __launch_bounds__(dsta::ATT_NT)
mha_fwd_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ out, int Lq, int Lk, int H,
                    int dh, float scale) {
  dsta::attn_fwd_simt<float>(q, k, v, out, nullptr, Lq, Lk, H, dh, scale);
}

template <int DP>
__global__ void __launch_bounds__(dsta::ATT_TC_NT)
mha_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ out, int Lq, int Lk, int H,
                   int dh, float scale_log2, bool vec) {
  dsta::attn_fwd_mma<DP>(q, k, v, out, nullptr, Lq, Lk, H, dh, scale_log2, vec);
}

template <int DH>
__global__ void __launch_bounds__(dsta::WG_THREADS, dsta::FwdWgmma<DH>::BLOCKS)
mha_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out, int Lq, int Lk,
                     int H, float scale_log2) {
  dsta::attn_fwd_wgmma<DH>(tq, tk, tv, out, nullptr, Lq, Lk, H, scale_log2);
}

template <int DH>
cudaError_t launch_wgmma_dh(const bf16* q, const bf16* k, const bf16* v, bf16* out, int B, int Lq,
                            int Lk, int H, float scale, cudaStream_t stream) {
  CUtensorMap m[3];
  const cudaError_t err = dsta::attn_fwd_maps<DH>(m, q, k, v, B, Lq, Lk, H);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + dsta::WG_BQ - 1) / dsta::WG_BQ, H, B);
  return dsta::launch_smem(mha_fwd_wgmma_kernel<DH>, grid, dsta::WG_THREADS,
                           dsta::FwdWgmma<DH>::SMEM, stream, m[0], m[1], m[2], out, Lq, Lk, H,
                           scale * 1.4426950408889634f);
}

cudaError_t launch_wgmma(const bf16* q, const bf16* k, const bf16* v, bf16* out, int B, int Lq,
                         int Lk, int H, int dh, float scale, cudaStream_t stream) {
  switch (dh) {
    case 40: return launch_wgmma_dh<40>(q, k, v, out, B, Lq, Lk, H, scale, stream);
    case 64: return launch_wgmma_dh<64>(q, k, v, out, B, Lq, Lk, H, scale, stream);
    case 80: return launch_wgmma_dh<80>(q, k, v, out, B, Lq, Lk, H, scale, stream);
    case 128: return launch_wgmma_dh<128>(q, k, v, out, B, Lq, Lk, H, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int DP>
cudaError_t launch_mma_dp(const bf16* q, const bf16* k, const bf16* v, bf16* out, int B, int Lq,
                          int Lk, int H, int dh, float scale, cudaStream_t stream) {
  const size_t inner = (size_t)H * dh;
  const bool vec = dh % 8 == 0 && inner % 8 == 0 && dsta::aligned16(q) && dsta::aligned16(k) &&
                   dsta::aligned16(v);
  dim3 grid((Lq + dsta::ATT_BQ - 1) / dsta::ATT_BQ, H, B);
  return dsta::launch_smem(mha_fwd_mma_kernel<DP>, grid, dsta::ATT_TC_NT,
                           dsta::attn_fwd_mma_smem(DP), stream, q, k, v, out, Lq, Lk, H, dh,
                           scale * 1.4426950408889634f, vec);
}

cudaError_t launch_mma(const bf16* q, const bf16* k, const bf16* v, bf16* out, int B, int Lq,
                       int Lk, int H, int dh, float scale, cudaStream_t stream) {
  switch ((dh + 15) / 16) {
    case 1: return launch_mma_dp<16>(q, k, v, out, B, Lq, Lk, H, dh, scale, stream);
    case 2: return launch_mma_dp<32>(q, k, v, out, B, Lq, Lk, H, dh, scale, stream);
    case 3: return launch_mma_dp<48>(q, k, v, out, B, Lq, Lk, H, dh, scale, stream);
    case 4: return launch_mma_dp<64>(q, k, v, out, B, Lq, Lk, H, dh, scale, stream);
    case 5: return launch_mma_dp<80>(q, k, v, out, B, Lq, Lk, H, dh, scale, stream);
    case 6: return launch_mma_dp<96>(q, k, v, out, B, Lq, Lk, H, dh, scale, stream);
    case 7: return launch_mma_dp<112>(q, k, v, out, B, Lq, Lk, H, dh, scale, stream);
    case 8: return launch_mma_dp<128>(q, k, v, out, B, Lq, Lk, H, dh, scale, stream);
    case 9: return launch_mma_dp<144>(q, k, v, out, B, Lq, Lk, H, dh, scale, stream);
    case 10: return launch_mma_dp<160>(q, k, v, out, B, Lq, Lk, H, dh, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, Lq, H*dh], k/v [B, Lk, H*dh], out [B, Lq, H*dh]; all contiguous, one
// dtype.  design: 1 wgmma (bf16 only), 0 the synchronous loops.
extern "C" int dsta_mha_fwd(int dtype, int design, const void* q, const void* k, const void* v,
                            void* out, int B, int Lq, int Lk, int H, int dh, float scale,
                            void* stream) {
  if (dh < 1 || dh > dsta::ATT_DMAX || Lk < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (design == 1) {
    if (dtype != dsta::kBF16) return (int)cudaErrorInvalidValue;
    return (int)launch_wgmma(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                             static_cast<const bf16*>(v), static_cast<bf16*>(out), B, Lq, Lk, H, dh,
                             scale, s);
  }
  if (dtype == dsta::kF32) {
    dim3 grid((Lq + dsta::ATT_BQ - 1) / dsta::ATT_BQ, H, B);
    return (int)dsta::launch_smem(mha_fwd_simt_kernel, grid, dsta::ATT_NT,
                                  dsta::attn_fwd_simt_smem(dh), s, static_cast<const float*>(q),
                                  static_cast<const float*>(k), static_cast<const float*>(v),
                                  static_cast<float*>(out), Lq, Lk, H, dh, scale);
  }
  if (dtype == dsta::kBF16)
    return (int)launch_mma(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                           static_cast<const bf16*>(v), static_cast<bf16*>(out), B, Lq, Lk, H, dh,
                           scale, s);
  return (int)cudaErrorInvalidValue;
}
