// Flash self-attention forward: the output and the row log-sum-exp.
//
// Replaces the body `flash_attention_kernel` of jax's splash attention
// (`jax/experimental/pallas/ops/tpu/splash_attention/splash_attention_kernel.py`),
// which the JAX package builds per call site in `ops/attention.py:63-92` and
// calls from `flash_attention` (`:194-214`) for the self-attention sites that
// pass `flash_ok`.  Per (batch, head, 64-query tile), with q already scaled
// by dh^-½ and rounded to K's dtype by the caller (as `attention.py:205,210`):
//
//   o   = softmax(q·Kᵀ)·V          in q's dtype
//   lse = m + log Σ exp(q·Kᵀ − m)  in f32, [B·H, Lq]: the residual the
//                                  backward (`flash_bwd.cu`) recomputes p from
//
// Bound on the H100: 4·Lq·Lk·dh FLOPs per (batch, head) against
// (4·L·dh + 2·L) bytes, so it is bound by operations at SD levels 0 and 1
// (L = 4096, dh = 40; L = 1024, dh = 80).  Splash kept its running max, sum
// and accumulator in VMEM across a sequential grid over key blocks; here a
// loop inside the block walks 64-key tiles and keeps them in registers, and
// no [Lq, Lk] tensor reaches device memory.  The loops are those of
// `mha_fwd.cu` (`attn_fwd.cuh`), with the log-sum-exp written at their end;
// the caller picks one by `design`:
//   1, wgmma (bf16 at head widths 40, 64, 80, 128): 128-query blocks, K/V
//     tiles in a TMA ring, wgmma products, the two consumer warpgroups'
//     softmax and products interleaved;
//   0, bf16 at any other width: mma.sync m16n8k16, dh zero-padded to a
//     multiple of 16;
//   0, float32: the CUDA cores, where p stays f32 as in splash.
// In bf16, p enters the PV product as bf16 (the A operand of the product);
// splash keeps it f32 (`:819-820`), so the bf16 output differs from splash's
// by that rounding (`utils/testing.py` kind "flash").
#include "attn_fwd.cuh"

namespace {

using dsta::bf16;

constexpr int DMAX = 128;   // flash_ok's largest head width

__global__ void __launch_bounds__(dsta::ATT_NT)
flash_fwd_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      float* __restrict__ lse, int Lq, int Lk, int H, int dh) {
  dsta::attn_fwd_simt<float>(q, k, v, out, lse, Lq, Lk, H, dh, 1.f);
}

template <int DP>
__global__ void __launch_bounds__(dsta::ATT_TC_NT)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out, float* __restrict__ lse,
                     int Lq, int Lk, int H, int dh, bool vec) {
  dsta::attn_fwd_mma<DP>(q, k, v, out, lse, Lq, Lk, H, dh, 1.4426950408889634f, vec);
}

template <int DH>
__global__ void __launch_bounds__(dsta::WG_THREADS, dsta::FwdWgmma<DH>::BLOCKS)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out,
                       float* __restrict__ lse, int Lq, int Lk, int H) {
  dsta::attn_fwd_wgmma<DH>(tq, tk, tv, out, lse, Lq, Lk, H, 1.4426950408889634f);
}

template <int DH>
cudaError_t launch_wgmma_dh(const bf16* q, const bf16* k, const bf16* v, bf16* out, float* lse,
                            int B, int Lq, int Lk, int H, cudaStream_t stream) {
  CUtensorMap m[3];
  const cudaError_t err = dsta::attn_fwd_maps<DH>(m, q, k, v, B, Lq, Lk, H);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + dsta::WG_BQ - 1) / dsta::WG_BQ, H, B);
  return dsta::launch_smem(flash_fwd_wgmma_kernel<DH>, grid, dsta::WG_THREADS,
                           dsta::FwdWgmma<DH>::SMEM, stream, m[0], m[1], m[2], out, lse, Lq, Lk, H);
}

cudaError_t launch_wgmma(const bf16* q, const bf16* k, const bf16* v, bf16* out, float* lse, int B,
                         int Lq, int Lk, int H, int dh, cudaStream_t stream) {
  switch (dh) {
    case 40: return launch_wgmma_dh<40>(q, k, v, out, lse, B, Lq, Lk, H, stream);
    case 64: return launch_wgmma_dh<64>(q, k, v, out, lse, B, Lq, Lk, H, stream);
    case 80: return launch_wgmma_dh<80>(q, k, v, out, lse, B, Lq, Lk, H, stream);
    case 128: return launch_wgmma_dh<128>(q, k, v, out, lse, B, Lq, Lk, H, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int DP>
cudaError_t launch_mma_dp(const bf16* q, const bf16* k, const bf16* v, bf16* out, float* lse,
                          int B, int Lq, int Lk, int H, int dh, cudaStream_t stream) {
  const size_t inner = (size_t)H * dh;
  const bool vec = dh % 8 == 0 && inner % 8 == 0 && dsta::aligned16(q) && dsta::aligned16(k) &&
                   dsta::aligned16(v);
  dim3 grid((Lq + dsta::ATT_BQ - 1) / dsta::ATT_BQ, H, B);
  return dsta::launch_smem(flash_fwd_mma_kernel<DP>, grid, dsta::ATT_TC_NT,
                           dsta::attn_fwd_mma_smem(DP), stream, q, k, v, out, lse, Lq, Lk, H, dh,
                           vec);
}

cudaError_t launch_mma(const bf16* q, const bf16* k, const bf16* v, bf16* out, float* lse, int B,
                       int Lq, int Lk, int H, int dh, cudaStream_t stream) {
  switch ((dh + 15) / 16) {
    case 1: return launch_mma_dp<16>(q, k, v, out, lse, B, Lq, Lk, H, dh, stream);
    case 2: return launch_mma_dp<32>(q, k, v, out, lse, B, Lq, Lk, H, dh, stream);
    case 3: return launch_mma_dp<48>(q, k, v, out, lse, B, Lq, Lk, H, dh, stream);
    case 4: return launch_mma_dp<64>(q, k, v, out, lse, B, Lq, Lk, H, dh, stream);
    case 5: return launch_mma_dp<80>(q, k, v, out, lse, B, Lq, Lk, H, dh, stream);
    case 6: return launch_mma_dp<96>(q, k, v, out, lse, B, Lq, Lk, H, dh, stream);
    case 7: return launch_mma_dp<112>(q, k, v, out, lse, B, Lq, Lk, H, dh, stream);
    case 8: return launch_mma_dp<128>(q, k, v, out, lse, B, Lq, Lk, H, dh, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (pre-scaled) [B, Lq, H*dh], k/v [B, Lk, H*dh], out [B, Lq, H*dh], all
// contiguous in one dtype; lse [B*H, Lq] f32.  design: 1 wgmma (bf16 only),
// 0 the synchronous loops.
extern "C" int dsta_flash_fwd(int dtype, int design, const void* q, const void* k, const void* v,
                              void* out, void* lse, int B, int Lq, int Lk, int H, int dh,
                              void* stream) {
  if (dh < 1 || dh > DMAX || Lk < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (design == 1) {
    if (dtype != dsta::kBF16) return (int)cudaErrorInvalidValue;
    return (int)launch_wgmma(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                             static_cast<const bf16*>(v), static_cast<bf16*>(out), l, B, Lq, Lk, H,
                             dh, s);
  }
  if (dtype == dsta::kF32) {
    dim3 grid((Lq + dsta::ATT_BQ - 1) / dsta::ATT_BQ, H, B);
    return (int)dsta::launch_smem(flash_fwd_simt_kernel, grid, dsta::ATT_NT,
                                  dsta::attn_fwd_simt_smem(dh), s, static_cast<const float*>(q),
                                  static_cast<const float*>(k), static_cast<const float*>(v),
                                  static_cast<float*>(out), l, Lq, Lk, H, dh);
  }
  if (dtype == dsta::kBF16)
    return (int)launch_mma(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                           static_cast<const bf16*>(v), static_cast<bf16*>(out), l, B, Lq, Lk, H,
                           dh, s);
  return (int)cudaErrorInvalidValue;
}
