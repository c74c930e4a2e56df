// Blended global+local spacetime cross-attention forward, cond half.
//
// Replaces the Pallas TPU kernel `ops/pallas_spacetime.py:_kernel` (launched by
// `_forward`, public `fused_spacetime_attention`) of the JAX package:
//
//   g_c   = softmax(q·Kcᵀ/√dh)·Vc
//   loc_n = softmax(q·Knᵀ/√dh)·Vn                       n = 1..N
//   out   = g_c + Σ_n m_n[q]·coef[b,n]·(loc_n − g_u)
//
// each softmax in f32 over the context's own keys (77 for CLIP).
//
// Bound on the H100: at SD widths the op moves more bytes than it has FLOPs
// to hide them (q, g_u and out are [Lq, inner] each, against 2·(N+1)·Lq·77·dh
// multiply-adds per head), so it is bound by memory.  The design reads q and
// g_u once, keeps the N local attention results out of device memory (the
// plain version writes a [B, N, Lq, inner] tensor), and writes out once.
// One block per (b, head, 64-query tile) loops over the N+1 contexts and
// stages one [Lk, dh] K/V pair at a time in shared memory (all five at dh=160
// would not fit the SM's 227 KB).  Keys past Lk are masked to −inf.  The
// per-query blend weight w_n = m_n·coef_n is folded into the probabilities,
// so the f32 accumulator gathers Σ_n w_n·loc_n + g_c and the epilogue
// subtracts (Σ_n w_n)·g_u.  Products run on the CUDA cores in f32.
#include "common.cuh"

namespace {

constexpr int BQ = 64;
constexpr int NT = 256;
constexpr int LKMAX = 80;        // keys per context (CLIP: 77)
constexpr int KCOLS = LKMAX / 16;
constexpr int DMAX = 160;
constexpr int DCOLS = DMAX / 16;

size_t smem_bytes(int Lk, int dh) {
  return sizeof(float) * ((size_t)(BQ + 2 * Lk) * (dh + 1) + (size_t)BQ * (LKMAX + 1));
}

template <typename T>
__global__ void __launch_bounds__(NT)
spacetime_fwd_kernel(const T* __restrict__ q, const T* __restrict__ gu,
                     const T* __restrict__ kc, const T* __restrict__ vc,
                     const T* __restrict__ lk, const T* __restrict__ lv,
                     const float* __restrict__ masks, const float* __restrict__ coef,
                     T* __restrict__ out, int N, int Lq, int Lk, int H, int dh, float scale) {
  extern __shared__ float smem[];
  const int ld = dh + 1;
  float* qs = smem;             // [BQ][dh+1]
  float* ks = qs + BQ * ld;     // [Lk][dh+1]
  float* vs = ks + Lk * ld;     // [Lk][dh+1]
  float* ps = vs + Lk * ld;     // [BQ][LKMAX+1], w·p

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t inner = (size_t)H * dh;
  const size_t qoff = (size_t)b * Lq * inner + (size_t)h * dh;

  for (int idx = tid; idx < BQ * dh; idx += NT) {
    const int r = idx / dh, d = idx % dh;
    qs[r * ld + d] = (q0 + r < Lq) ? dsta::to_f32(q[qoff + (size_t)(q0 + r) * inner + d]) : 0.f;
  }

  float acc[4][DCOLS], wsum[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    wsum[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DCOLS; ++c) acc[i][c] = 0.f;
  }

  for (int ctx = 0; ctx <= N; ++ctx) {
    const T* kp;
    const T* vp;
    if (ctx == 0) {
      kp = kc + (size_t)b * Lk * inner;
      vp = vc + (size_t)b * Lk * inner;
    } else {
      const size_t base = ((size_t)b * N + (ctx - 1)) * Lk * inner;
      kp = lk + base;
      vp = lv + base;
    }
    kp += (size_t)h * dh;
    vp += (size_t)h * dh;

    __syncthreads();  // the previous context's ks/vs/ps are no longer read
    for (int idx = tid; idx < Lk * dh; idx += NT) {
      const int r = idx / dh, d = idx % dh;
      ks[r * ld + d] = dsta::to_f32(kp[(size_t)r * inner + d]);
      vs[r * ld + d] = dsta::to_f32(vp[(size_t)r * inner + d]);
    }
    __syncthreads();

    float w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty * 4 + i;
      if (ctx == 0) {
        w[i] = 1.f;
      } else {
        const int bn = b * N + ctx - 1;
        w[i] = (r < Lq) ? masks[(size_t)bn * Lq + r] * coef[bn] : 0.f;
        wsum[i] += w[i];
      }
    }

    float s[4][KCOLS];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) s[i][j] = 0.f;
    for (int d = 0; d < dh; ++d) {
      float a[4], kk[KCOLS];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty * 4 + i) * ld + d];
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) {
        const int c = tx + 16 * j;
        kk[j] = (c < Lk) ? ks[c * ld + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < KCOLS; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) {
        s[i][j] = (tx + 16 * j < Lk) ? s[i][j] * scale : -CUDART_INF_F;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = dsta::half_warp_max(mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) {
        s[i][j] = expf(s[i][j] - mx);
        sum += s[i][j];
      }
      sum = dsta::half_warp_sum(sum);
      const float wn = w[i] / sum;
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) ps[(ty * 4 + i) * (LKMAX + 1) + tx + 16 * j] = s[i][j] * wn;
    }
    __syncthreads();

    for (int kk = 0; kk < Lk; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty * 4 + i) * (LKMAX + 1) + kk];
#pragma unroll
      for (int c = 0; c < DCOLS; ++c) {
        const int d = tx + 16 * c;
        if (d < dh) {
          const float vv = vs[kk * ld + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Lq) continue;
    const size_t row = qoff + (size_t)r * inner;
#pragma unroll
    for (int c = 0; c < DCOLS; ++c) {
      const int d = tx + 16 * c;
      if (d < dh) out[row + d] = dsta::from_f32<T>(acc[i][c] - wsum[i] * dsta::to_f32(gu[row + d]));
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* gu, const void* kc, const void* vc, const void* lk,
                   const void* lv, const float* masks, const float* coef, void* out, int B,
                   int N, int Lq, int Lk, int H, int dh, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(Lk, dh);
  cudaError_t err = cudaFuncSetAttribute(spacetime_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + BQ - 1) / BQ, H, B);
  spacetime_fwd_kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(gu), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<const T*>(lk), static_cast<const T*>(lv), masks,
      coef, static_cast<T*>(out), N, Lq, Lk, H, dh, scale);
  return cudaGetLastError();
}

}  // namespace

// q/gu/out [B, Lq, H*dh]; kc/vc [B, Lk, H*dh]; lk/lv [B, N, Lk, H*dh] (one
// dtype, contiguous); masks [B, N, Lq] and coef [B, N] float32.
extern "C" int dsta_spacetime_fwd(int dtype, const void* q, const void* gu, const void* kc,
                                  const void* vc, const void* lk, const void* lv,
                                  const void* masks, const void* coef, void* out, int B, int N,
                                  int Lq, int Lk, int H, int dh, float scale, void* stream) {
  if (dh < 1 || dh > DMAX || Lk < 1 || Lk > LKMAX || N < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(masks);
  const float* c = static_cast<const float*>(coef);
  if (dtype == dsta::kF32)
    return (int)launch<float>(q, gu, kc, vc, lk, lv, m, c, out, B, N, Lq, Lk, H, dh, scale, s);
  if (dtype == dsta::kBF16)
    return (int)launch<__nv_bfloat16>(q, gu, kc, vc, lk, lv, m, c, out, B, N, Lq, Lk, H, dh,
                                      scale, s);
  return (int)cudaErrorInvalidValue;
}
