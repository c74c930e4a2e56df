// Blended global+local spacetime cross-attention backward, cond half.
//
// Replaces the Pallas TPU kernel `ops/pallas_spacetime.py:_bwd_kernel` (launched by
// `_backward`) of the JAX package.  With ḡ the output cotangent, p_c the softmax
// of context c (c = 0 the global context, c = n the object contexts) and the
// blend weights w_0 = 1, w_n[q] = m_n[q]·coef[b,n]:
//
//   dout_c = w_c·ḡ,   e_c = ḡ·V_cᵀ,   ds_c = w_c·p_c ⊙ (e_c − rowsum(p_c ⊙ e_c))
//   dq     = scale·Σ_c ds_c·K_c
//   dK_c   = scale·Σ_q ds_cᵀ·q,   dV_c = Σ_q (w_c·p_c)ᵀ·ḡ
//   t_n[q] = (loc_n[q] − g_u[q])·ḡ[q] = rowsum(p_n ⊙ e_n)[q] − g_u[q]·ḡ[q]   per head
//
// each softmax recomputed in f32 over the context's own keys (keys ≥ Lk are
// −inf), so no probability is stored and no [B, N, Lq, inner] tensor is
// written.  rowsum(p ⊙ e) = ḡ·(p·V) = ḡ·loc, so t needs no p·V product.  The
// cheap reductions dcoef, dmasks and dg_u stay outside, as in JAX.
//
// Bound on the H100: like the forward, the op moves more bytes (q, ḡ, g_u and
// dq rows) than it has FLOPs to hide them, so it is bound by memory.
//
// Two kernels and no atomics, so the result is a fixed function of the inputs:
//   spacetime_bwd_dq_kernel, one block per (b, head, 64-query tile), loops over
//     the N+1 contexts with one [Lk, dh] K/V pair staged in shared memory at a
//     time (as the forward) and writes dq and t;
//   spacetime_bwd_kv_kernel, one block per (b, context, head, 48-column slice
//     of dh), holds the context's K and V in shared memory, walks the query
//     tiles in order and keeps its dK/dV slice in registers.  It recomputes the
//     softmax and e itself (every key of a row is in the block), so it needs
//     nothing from the first kernel.  It runs only when dK/dV are asked for.
// Products run on the CUDA cores in f32; outputs are f32.
#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int BQ = 64;           // queries per dq block: 16 row groups x 4
constexpr int BQ2 = 32;          // queries per tile of the dK/dV walk: 16 x 2
constexpr int LKMAX = 80;        // keys per context (CLIP: 77)
constexpr int KCOLS = LKMAX / 16;
constexpr int DMAX = 160;
constexpr int DCOLS = DMAX / 16;
constexpr int DC = 48;           // dh columns per dK/dV block: 16 x 3
constexpr int KROWS = LKMAX / 16;

size_t dq_smem_bytes(int Lk, int dh) {
  return sizeof(float) * ((size_t)(2 * BQ + 2 * Lk) * (dh + 1) + (size_t)BQ * (LKMAX + 1));
}

size_t kv_smem_bytes(int Lk, int dh) {
  return sizeof(float) * ((size_t)(2 * BQ2 + 2 * Lk) * (dh + 1) + (size_t)2 * BQ2 * (LKMAX + 1));
}

template <typename T>
__device__ __forceinline__ void context_ptrs(const T* kc, const T* vc, const T* lk, const T* lv,
                                             int b, int ctx, int N, int Lk, size_t inner,
                                             const T*& kp, const T*& vp) {
  if (ctx == 0) {
    kp = kc + (size_t)b * Lk * inner;
    vp = vc + (size_t)b * Lk * inner;
  } else {
    const size_t base = ((size_t)b * N + (ctx - 1)) * Lk * inner;
    kp = lk + base;
    vp = lv + base;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
spacetime_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ gu,
                        const T* __restrict__ kc, const T* __restrict__ vc,
                        const T* __restrict__ lk, const T* __restrict__ lv,
                        const float* __restrict__ masks, const float* __restrict__ coef,
                        const T* __restrict__ gbar, float* __restrict__ dq,
                        float* __restrict__ tout, int N, int Lq, int Lk, int H, int dh,
                        float scale) {
  extern __shared__ float smem[];
  const int ld = dh + 1;
  float* qs = smem;             // [BQ][dh+1]
  float* gs = qs + BQ * ld;     // [BQ][dh+1]   ḡ
  float* ks = gs + BQ * ld;     // [Lk][dh+1]
  float* vs = ks + Lk * ld;     // [Lk][dh+1]
  float* dss = vs + Lk * ld;    // [BQ][LKMAX+1]  scale·ds

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t inner = (size_t)H * dh;
  const size_t qoff = (size_t)b * Lq * inner + (size_t)h * dh;

  for (int idx = tid; idx < BQ * dh; idx += NT) {
    const int r = idx / dh, d = idx % dh;
    const bool ok = q0 + r < Lq;
    const size_t off = qoff + (size_t)(q0 + r) * inner + d;
    qs[r * ld + d] = ok ? dsta::to_f32(q[off]) : 0.f;
    gs[r * ld + d] = ok ? dsta::to_f32(gbar[off]) : 0.f;
  }
  __syncthreads();

  // gg = g_u·ḡ per query over this head's columns
  float gg[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    float s = 0.f;
    if (q0 + r < Lq) {
      const size_t row = qoff + (size_t)(q0 + r) * inner;
#pragma unroll
      for (int c = 0; c < DCOLS; ++c) {
        const int d = tx + 16 * c;
        if (d < dh) s += dsta::to_f32(gu[row + d]) * gs[r * ld + d];
      }
    }
    gg[i] = dsta::half_warp_sum(s);
  }

  float acc[4][DCOLS];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DCOLS; ++c) acc[i][c] = 0.f;

  for (int ctx = 0; ctx <= N; ++ctx) {
    const T* kp;
    const T* vp;
    context_ptrs(kc, vc, lk, lv, b, ctx, N, Lk, inner, kp, vp);
    kp += (size_t)h * dh;
    vp += (size_t)h * dh;

    __syncthreads();  // the previous context's ks / vs / dss are no longer read
    for (int idx = tid; idx < Lk * dh; idx += NT) {
      const int r = idx / dh, d = idx % dh;
      ks[r * ld + d] = dsta::to_f32(kp[(size_t)r * inner + d]);
      vs[r * ld + d] = dsta::to_f32(vp[(size_t)r * inner + d]);
    }
    __syncthreads();

    // s = q·Kᵀ and e = ḡ·Vᵀ for 4 rows x 5 key columns per thread
    float s[4][KCOLS], e[4][KCOLS];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) s[i][j] = e[i][j] = 0.f;
    for (int d = 0; d < dh; ++d) {
      float a[4], gq[4], kk[KCOLS], vv[KCOLS];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = qs[(ty * 4 + i) * ld + d];
        gq[i] = gs[(ty * 4 + i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) {
        const int c = tx + 16 * j;
        kk[j] = (c < Lk) ? ks[c * ld + d] : 0.f;
        vv[j] = (c < Lk) ? vs[c * ld + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < KCOLS; ++j) {
          s[i][j] = fmaf(a[i], kk[j], s[i][j]);
          e[i][j] = fmaf(gq[i], vv[j], e[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty * 4 + i;
      float w = 1.f;
      if (ctx > 0) {
        const int bn = b * N + ctx - 1;
        w = (r < Lq) ? masks[(size_t)bn * Lq + r] * coef[bn] : 0.f;
      }
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
      const float inv = 1.f / sum;
      float dr = 0.f;
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) {
        s[i][j] *= inv;                 // p
        dr = fmaf(s[i][j], e[i][j], dr);
      }
      dr = dsta::half_warp_sum(dr);     // rowsum(p ⊙ e) = ḡ·(p·V)
      if (ctx > 0 && tx == 0 && r < Lq)
        tout[(((size_t)b * H + h) * N + ctx - 1) * Lq + r] = dr - gg[i];
      const float ws = w * scale;
#pragma unroll
      for (int j = 0; j < KCOLS; ++j)
        dss[(ty * 4 + i) * (LKMAX + 1) + tx + 16 * j] = s[i][j] * (e[i][j] - dr) * ws;
    }
    __syncthreads();

    // dq += (scale·ds)·K
    for (int kk = 0; kk < Lk; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = dss[(ty * 4 + i) * (LKMAX + 1) + kk];
#pragma unroll
      for (int c = 0; c < DCOLS; ++c) {
        const int d = tx + 16 * c;
        if (d < dh) {
          const float kv = ks[kk * ld + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], kv, acc[i][c]);
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
      if (d < dh) dq[row + d] = acc[i][c];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
spacetime_bwd_kv_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc, const T* __restrict__ lk,
                        const T* __restrict__ lv, const float* __restrict__ masks,
                        const float* __restrict__ coef, const T* __restrict__ gbar,
                        float* __restrict__ dkc, float* __restrict__ dvc,
                        float* __restrict__ dlk, float* __restrict__ dlv, int N, int Lq,
                        int Lk, int H, int dh, float scale) {
  extern __shared__ float smem[];
  const int ld = dh + 1;
  float* qs = smem;              // [BQ2][dh+1]
  float* gs = qs + BQ2 * ld;     // [BQ2][dh+1]   ḡ
  float* ks = gs + BQ2 * ld;     // [Lk][dh+1]
  float* vs = ks + Lk * ld;      // [Lk][dh+1]
  float* pws = vs + Lk * ld;     // [BQ2][LKMAX+1]  w·p
  float* dss = pws + BQ2 * (LKMAX + 1);  // [BQ2][LKMAX+1]  scale·ds

  const int b = blockIdx.z / (N + 1), ctx = blockIdx.z % (N + 1);
  const int h = blockIdx.y, d0 = blockIdx.x * DC;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t inner = (size_t)H * dh;
  const size_t qoff = (size_t)b * Lq * inner + (size_t)h * dh;

  const T* kp;
  const T* vp;
  context_ptrs(kc, vc, lk, lv, b, ctx, N, Lk, inner, kp, vp);
  kp += (size_t)h * dh;
  vp += (size_t)h * dh;
  for (int idx = tid; idx < Lk * dh; idx += NT) {
    const int r = idx / dh, d = idx % dh;
    ks[r * ld + d] = dsta::to_f32(kp[(size_t)r * inner + d]);
    vs[r * ld + d] = dsta::to_f32(vp[(size_t)r * inner + d]);
  }

  float dk[KROWS][3], dv[KROWS][3];
#pragma unroll
  for (int a = 0; a < KROWS; ++a)
#pragma unroll
    for (int c = 0; c < 3; ++c) dk[a][c] = dv[a][c] = 0.f;

  for (int q0 = 0; q0 < Lq; q0 += BQ2) {
    __syncthreads();  // the previous tile's qs / gs / pws / dss are no longer read
    for (int idx = tid; idx < BQ2 * dh; idx += NT) {
      const int r = idx / dh, d = idx % dh;
      const bool ok = q0 + r < Lq;
      const size_t off = qoff + (size_t)(q0 + r) * inner + d;
      qs[r * ld + d] = ok ? dsta::to_f32(q[off]) : 0.f;
      gs[r * ld + d] = ok ? dsta::to_f32(gbar[off]) : 0.f;
    }
    __syncthreads();

    float s[2][KCOLS], e[2][KCOLS];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) s[i][j] = e[i][j] = 0.f;
    for (int d = 0; d < dh; ++d) {
      float a[2], gq[2], kk[KCOLS], vv[KCOLS];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        a[i] = qs[(ty * 2 + i) * ld + d];
        gq[i] = gs[(ty * 2 + i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) {
        const int c = tx + 16 * j;
        kk[j] = (c < Lk) ? ks[c * ld + d] : 0.f;
        vv[j] = (c < Lk) ? vs[c * ld + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < KCOLS; ++j) {
          s[i][j] = fmaf(a[i], kk[j], s[i][j]);
          e[i][j] = fmaf(gq[i], vv[j], e[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = q0 + ty * 2 + i;
      float w = (r < Lq) ? 1.f : 0.f;
      if (ctx > 0) {
        const int bn = b * N + ctx - 1;
        w = (r < Lq) ? masks[(size_t)bn * Lq + r] * coef[bn] : 0.f;
      }
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
      const float inv = 1.f / sum;
      float dr = 0.f;
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) {
        s[i][j] *= inv;
        dr = fmaf(s[i][j], e[i][j], dr);
      }
      dr = dsta::half_warp_sum(dr);
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) {
        const int o = (ty * 2 + i) * (LKMAX + 1) + tx + 16 * j;
        pws[o] = w * s[i][j];
        dss[o] = w * s[i][j] * (e[i][j] - dr) * scale;
      }
    }
    __syncthreads();

    // dV += (w·p)ᵀ·ḡ and dK += (scale·ds)ᵀ·q over this tile's rows, in order
    for (int r = 0; r < BQ2; ++r) {
      float qv[3], gv[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int d = d0 + tx + 16 * c;
        qv[c] = (d < dh) ? qs[r * ld + d] : 0.f;
        gv[c] = (d < dh) ? gs[r * ld + d] : 0.f;
      }
#pragma unroll
      for (int a = 0; a < KROWS; ++a) {
        const int k = ty + 16 * a;
        const float pw = pws[r * (LKMAX + 1) + k];
        const float ds = dss[r * (LKMAX + 1) + k];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          dv[a][c] = fmaf(pw, gv[c], dv[a][c]);
          dk[a][c] = fmaf(ds, qv[c], dk[a][c]);
        }
      }
    }
  }

  float* dko;
  float* dvo;
  if (ctx == 0) {
    dko = dkc + (size_t)b * Lk * inner;
    dvo = dvc + (size_t)b * Lk * inner;
  } else {
    const size_t base = ((size_t)b * N + (ctx - 1)) * Lk * inner;
    dko = dlk + base;
    dvo = dlv + base;
  }
#pragma unroll
  for (int a = 0; a < KROWS; ++a) {
    const int k = ty + 16 * a;
    if (k >= Lk) continue;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int d = d0 + tx + 16 * c;
      if (d < dh) {
        const size_t o = (size_t)k * inner + (size_t)h * dh + d;
        dko[o] = dk[a][c];
        dvo[o] = dv[a][c];
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* gu, const void* kc, const void* vc, const void* lk,
                   const void* lv, const float* masks, const float* coef, const void* gbar,
                   float* dq, float* t, float* dkc, float* dvc, float* dlk, float* dlv, int B,
                   int N, int Lq, int Lk, int H, int dh, float scale, cudaStream_t stream) {
  const T *qt = static_cast<const T*>(q), *gut = static_cast<const T*>(gu);
  const T *kct = static_cast<const T*>(kc), *vct = static_cast<const T*>(vc);
  const T *lkt = static_cast<const T*>(lk), *lvt = static_cast<const T*>(lv);
  const T* gt = static_cast<const T*>(gbar);
  const size_t smem = dq_smem_bytes(Lk, dh);
  cudaError_t err = cudaFuncSetAttribute(spacetime_bwd_dq_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + BQ - 1) / BQ, H, B);
  spacetime_bwd_dq_kernel<T><<<grid, NT, smem, stream>>>(qt, gut, kct, vct, lkt, lvt, masks, coef,
                                                         gt, dq, t, N, Lq, Lk, H, dh, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || dkc == nullptr) return err;

  const size_t smem2 = kv_smem_bytes(Lk, dh);
  err = cudaFuncSetAttribute(spacetime_bwd_kv_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
  if (err != cudaSuccess) return err;
  dim3 grid2((dh + DC - 1) / DC, H, B * (N + 1));
  spacetime_bwd_kv_kernel<T><<<grid2, NT, smem2, stream>>>(qt, kct, vct, lkt, lvt, masks, coef, gt,
                                                           dkc, dvc, dlk, dlv, N, Lq, Lk, H, dh,
                                                           scale);
  return cudaGetLastError();
}

}  // namespace

// q/gu/gbar [B, Lq, H*dh]; kc/vc [B, Lk, H*dh]; lk/lv [B, N, Lk, H*dh] (one
// dtype, contiguous); masks [B, N, Lq] and coef [B, N] float32.  Outputs, all
// float32: dq [B, Lq, H*dh], t [B, H, N, Lq]; dkc/dvc [B, Lk, H*dh] and
// dlk/dlv [B, N, Lk, H*dh] only when dkc is not null (then all four are set).
extern "C" int dsta_spacetime_bwd(int dtype, const void* q, const void* gu, const void* kc,
                                  const void* vc, const void* lk, const void* lv,
                                  const void* masks, const void* coef, const void* gbar,
                                  void* dq, void* t, void* dkc, void* dvc, void* dlk, void* dlv,
                                  int B, int N, int Lq, int Lk, int H, int dh, float scale,
                                  void* stream) {
  if (dh < 1 || dh > DMAX || Lk < 1 || Lk > LKMAX || N < 0 || B < 1 || Lq < 1)
    return (int)cudaErrorInvalidValue;
  if (dkc != nullptr && (dvc == nullptr || (N > 0 && (dlk == nullptr || dlv == nullptr))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(masks);
  const float* c = static_cast<const float*>(coef);
  float *dqf = static_cast<float*>(dq), *tf = static_cast<float*>(t);
  float *dkcf = static_cast<float*>(dkc), *dvcf = static_cast<float*>(dvc);
  float *dlkf = static_cast<float*>(dlk), *dlvf = static_cast<float*>(dlv);
  if (dtype == dsta::kF32)
    return (int)launch<float>(q, gu, kc, vc, lk, lv, m, c, gbar, dqf, tf, dkcf, dvcf, dlkf, dlvf,
                              B, N, Lq, Lk, H, dh, scale, s);
  if (dtype == dsta::kBF16)
    return (int)launch<__nv_bfloat16>(q, gu, kc, vc, lk, lv, m, c, gbar, dqf, tf, dkcf, dvcf,
                                      dlkf, dlvf, B, N, Lq, Lk, H, dh, scale, s);
  return (int)cudaErrorInvalidValue;
}
