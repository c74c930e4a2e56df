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
// head widths 32, 40, 64, 80, 128, 160: every SD v1-4 site and the 768²
// RDM's); 0, mma.sync m16n8k16 (bf16 at any other width, dh padded to a
// multiple of 16) or the CUDA cores (float32).  At dh 32 and 160 the
// query-block height follows `dsta::mha_wide` (64 queries where such blocks
// fit the card in one wave, else 128); designs 2 and 3 force 64 and 128 so
// that a measurement can hold the two against each other.  Each kernel's
// shared-memory limit is raised once per device (`hop::launch_raised`).
#include "attn_fwd.cuh"

namespace {

using dsta::bf16;
namespace hop = dsta::hop;

constexpr float LOG2E = 1.4426950408889634f;

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

template <int DH, int BQ>
__global__ void __launch_bounds__(dsta::FwdWgmma<DH, BQ>::THREADS, dsta::FwdWgmma<DH, BQ>::BLOCKS)
mha_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out, int Lq, int Lk,
                     int H, float scale_log2) {
  dsta::attn_fwd_wgmma<DH, BQ>(tq, tk, tv, out, nullptr, Lq, Lk, H, scale_log2);
}

template <int DH, int BQ>
cudaError_t launch_wgmma_bq(const bf16* q, const bf16* k, const bf16* v, bf16* out, int B, int Lq,
                            int Lk, int H, float scale, cudaStream_t stream) {
  using C = dsta::FwdWgmma<DH, BQ>;
  CUtensorMap m[3];
  const cudaError_t err = dsta::attn_fwd_maps<DH, BQ>(m, q, k, v, B, Lq, Lk, H);
  if (err != cudaSuccess) return err;
  return hop::launch_raised<mha_fwd_wgmma_kernel<DH, BQ>>(
      dim3((Lq + BQ - 1) / BQ, H, B), C::THREADS, C::SMEM, C::SMEM, stream, m[0], m[1], m[2], out,
      Lq, Lk, H, scale * LOG2E);
}

// bq: 0 by `mha_wide`, else 64 or 128 (64 at dh 32 and 160 only).
template <int DH>
cudaError_t launch_wgmma_dh(const bf16* q, const bf16* k, const bf16* v, bf16* out, int B, int Lq,
                            int Lk, int H, float scale, int bq, cudaStream_t stream) {
  if constexpr (DH == 32 || DH == 160) {
    if (bq == 0)
      bq = dsta::mha_wide(Lq, H, B, hop::sm_count() * dsta::FwdWgmma<DH, 64>::BLOCKS) ? 128 : 64;
    if (bq == 64) return launch_wgmma_bq<DH, 64>(q, k, v, out, B, Lq, Lk, H, scale, stream);
  } else if (bq == 64) {
    return cudaErrorInvalidValue;
  }
  return launch_wgmma_bq<DH, 128>(q, k, v, out, B, Lq, Lk, H, scale, stream);
}

cudaError_t launch_wgmma(const bf16* q, const bf16* k, const bf16* v, bf16* out, int B, int Lq,
                         int Lk, int H, int dh, float scale, int bq, cudaStream_t stream) {
  switch (dh) {
    case 32: return launch_wgmma_dh<32>(q, k, v, out, B, Lq, Lk, H, scale, bq, stream);
    case 40: return launch_wgmma_dh<40>(q, k, v, out, B, Lq, Lk, H, scale, bq, stream);
    case 64: return launch_wgmma_dh<64>(q, k, v, out, B, Lq, Lk, H, scale, bq, stream);
    case 80: return launch_wgmma_dh<80>(q, k, v, out, B, Lq, Lk, H, scale, bq, stream);
    case 128: return launch_wgmma_dh<128>(q, k, v, out, B, Lq, Lk, H, scale, bq, stream);
    case 160: return launch_wgmma_dh<160>(q, k, v, out, B, Lq, Lk, H, scale, bq, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int DP>
cudaError_t launch_mma_dp(const bf16* q, const bf16* k, const bf16* v, bf16* out, int B, int Lq,
                          int Lk, int H, int dh, float scale, cudaStream_t stream) {
  const size_t inner = (size_t)H * dh;
  const bool vec = dh % 8 == 0 && inner % 8 == 0 && dsta::aligned16(q) && dsta::aligned16(k) &&
                   dsta::aligned16(v);
  const int smem = dsta::attn_fwd_mma_smem(DP);
  return hop::launch_raised<mha_fwd_mma_kernel<DP>>(
      dim3((Lq + dsta::ATT_BQ - 1) / dsta::ATT_BQ, H, B), dsta::ATT_TC_NT, smem, smem, stream, q,
      k, v, out, Lq, Lk, H, dh, scale * LOG2E, vec);
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
// dtype.  design: 1 wgmma (bf16 only; 2 and 3: wgmma in 64- and 128-query
// blocks), 0 the synchronous loops.
extern "C" int dsta_mha_fwd(int dtype, int design, const void* q, const void* k, const void* v,
                            void* out, int B, int Lq, int Lk, int H, int dh, float scale,
                            void* stream) {
  if (dh < 1 || dh > dsta::ATT_DMAX || Lk < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (design >= 1 && design <= 3) {
    if (dtype != dsta::kBF16) return (int)cudaErrorInvalidValue;
    const int bq = design == 1 ? 0 : design == 2 ? 64 : 128;
    return (int)launch_wgmma(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                             static_cast<const bf16*>(v), static_cast<bf16*>(out), B, Lq, Lk, H, dh,
                             scale, bq, s);
  }
  if (design != 0) return (int)cudaErrorInvalidValue;
  if (dtype == dsta::kF32)
    return (int)hop::launch_raised<mha_fwd_simt_kernel>(
        dim3((Lq + dsta::ATT_BQ - 1) / dsta::ATT_BQ, H, B), dsta::ATT_NT,
        (int)dsta::attn_fwd_simt_smem(dh), (int)dsta::attn_fwd_simt_smem(dsta::ATT_DMAX), s,
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(out), Lq, Lk, H, dh, scale);
  if (dtype == dsta::kBF16)
    return (int)launch_mma(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                           static_cast<const bf16*>(v), static_cast<bf16*>(out), B, Lq, Lk, H, dh,
                           scale, s);
  return (int)cudaErrorInvalidValue;
}
