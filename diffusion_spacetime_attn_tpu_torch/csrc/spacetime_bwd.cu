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
// cheap reductions dcoef, dmasks and dg_u stay outside, as in JAX.  The
// masks are read in q's dtype, as the TPU kernel reads them.
//
// Bound on the H100: like the forward, the op moves more bytes (q, ḡ, g_u and
// dq rows) than it has FLOPs to hide them, so it is bound by memory.
//
// Two passes and no atomics, so the result is a fixed function of the inputs:
//   the dq pass, one block per (b, head, 64-query tile), walks the N+1
//     contexts and writes dq and t (f32);
//   the dK/dV pass, `spacetime_bwd_kv_kernel`, one block per (b, context,
//     head, 48-column slice of dh), holds the context's K and V in shared
//     memory, walks the query tiles in order and keeps its dK/dV slice in
//     registers.  It recomputes the softmax and e itself, so it needs nothing
//     from the dq pass.  It runs only when dK/dV are asked for (the
//     optimization's chain asks for dcoef only), on the CUDA cores in f32.
// The C entry picks the dq pass's design from the dtype:
//
// wgmma (bf16; dh a multiple of 8 up to 160, Lk ≤ 80, 16-byte aligned
//   operands): `spacetime_bwd_dq_wgmma_kernel<DN, WIDE>`, in the shape of
//   the forward (`spacetime_fwd.cu`): 384 threads, a producer warpgroup that
//   loads the block's q and ḡ rows once and streams the contexts' K/V (80
//   rows) through a ring (TMA, full/empty mbarriers: 5 stages at DN ≤ 64,
//   3-4 at DN = 80, 128, 2 at DN = 160), and two consumer warpgroups that
//   take the contexts in turn (64-query blocks) or own 64 rows each and
//   walk every context (128-query blocks, where 64-query blocks would more
//   than fill the SMs; `dsta::spacetime_wide`).  Per context, S = q·Kᵀ
//   and E = ḡ·Vᵀ are two wgmma m64n80 products from shared memory; p, r =
//   rowsum(p ⊙ e) and t = r − g_u·ḡ stay in f32 (t is written straight from
//   registers; g_u·ḡ is one reduction per row at the start), and dS =
//   scale·w·p ⊙ (e − r) is split into a bf16 high part and the bf16
//   rounding of the rest, the register A operands of two products dq +=
//   dS_hi·K + dS_lo·K (wgmma m64nDN, the same K stage read MN-major): dS
//   rounded once to bf16 missed the per-element tolerance of dq at SD
//   level 1 on an H100, and the split carries dS to about 16 bits.  In
//   64-query blocks warpgroup 1 hands its partial dq to warpgroup 0 through
//   the ring stage of its last context, and warpgroup 0 adds them in that
//   fixed order.  DN is dh rounded up to 40, 64, 80, 128 or 160.
//
// simt (float32): `spacetime_bwd_dq_simt_kernel` on the CUDA cores, one [Lk,
//   dh] K/V pair staged in shared memory at a time.
#include "hopper.cuh"

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
constexpr float LOG2E = 1.4426950408889634f;

constexpr size_t dq_smem_bytes(int Lk, int dh) {
  return sizeof(float) * ((size_t)(2 * BQ + 2 * Lk) * (dh + 1) + (size_t)BQ * (LKMAX + 1));
}

constexpr size_t kv_smem_bytes(int Lk, int dh) {
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

__global__ void __launch_bounds__(NT)
spacetime_bwd_dq_simt_kernel(const float* __restrict__ q, const float* __restrict__ gu,
                             const float* __restrict__ kc, const float* __restrict__ vc,
                             const float* __restrict__ lk, const float* __restrict__ lv,
                             const float* __restrict__ masks, const float* __restrict__ coef,
                             const float* __restrict__ gbar, float* __restrict__ dq,
                             float* __restrict__ tout, int N, int Lq, int Lk, int H, int dh,
                             float scale) {
  using T = float;
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
                        const T* __restrict__ lv, const T* __restrict__ masks,
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
        w = (r < Lq) ? dsta::to_f32(masks[(size_t)bn * Lq + r]) * coef[bn] : 0.f;
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


// ---- bfloat16 dq pass: wgmma fed by a TMA ring (sm_90a) ----
using dsta::bf16;
namespace hop = dsta::hop;

constexpr int WG_THREADS = 384;  // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int WG_ROWS = 64;      // query rows of one wgmma (a consumer's tile)

// Per rs-product width DN and block shape, as the forward's `FwdWgmma`:
// WIDE blocks own 128 queries (each consumer warpgroup 64 rows, every
// context), the others 64 (the consumer warpgroups take the contexts in turn).
template <int DN, bool WIDE> struct DqWgmma {
  static constexpr int NB = (DN + 63) / 64;          // 64-column boxes per row
  static constexpr int KS = (DN + 15) / 16;          // k-steps of S and E
  static constexpr int ROWS = WIDE ? 2 * WG_ROWS : WG_ROWS;
  static constexpr int OH_BYTES = WG_ROWS * 128 * NB;  // one consumer's q or ḡ tile
  static constexpr int OWN_BYTES = ROWS * 128 * NB;    // the block's q or ḡ rows
  static constexpr int KV_BYTES = LKMAX * 128 * NB;  // one K or V tile of a context
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int STAGES = NB == 1 ? 5 : NB == 2 ? (WIDE ? 3 : 4) : 2;
  static constexpr int BAR_OFF = 2 * OWN_BYTES + STAGES * STAGE_BYTES;
  static constexpr int SMEM = BAR_OFF + 128 + ROWS * 4 + 1024;  // barriers, g_u·ḡ, slack
  // warpgroup 1's hand-off (partial dq, [ND][128] f32) fits a stage
  static_assert((DN / 2) * 128 * 4 <= STAGE_BYTES, "hand-off exceeds a ring stage");
  static_assert(SMEM <= 232448, "shared memory exceeds a block's 227 KB");
};

template <int DN, bool WIDE>
__global__ void __launch_bounds__(WG_THREADS, 1)
spacetime_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tg,
                              const __grid_constant__ CUtensorMap tkc,
                              const __grid_constant__ CUtensorMap tvc,
                              const __grid_constant__ CUtensorMap tlk,
                              const __grid_constant__ CUtensorMap tlv,
                              const bf16* __restrict__ gu, const bf16* __restrict__ gbar,
                              const bf16* __restrict__ masks, const float* __restrict__ coef,
                              float* __restrict__ dq, float* __restrict__ tout, int N, int Lq,
                              int Lk, int H, int dh, float scale) {
  using C = DqWgmma<DN, WIDE>;
  constexpr int NB = C::NB, S = C::STAGES, NS = LKMAX / 2, ND = DN / 2, KT = LKMAX / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* const base = hop::align1024(smem_raw);
  unsigned char* const qs = base;                     // [ROWS / 64][NB][64 rows][128 B]
  unsigned char* const gs = base + C::OWN_BYTES;      // ḡ, the same layout
  unsigned char* const ring = base + 2 * C::OWN_BYTES;  // stage s: K [NB][80][128 B], then V
  uint64_t* const full = reinterpret_cast<uint64_t*>(base + C::BAR_OFF);
  uint64_t* const empty = full + S;
  uint64_t* const own = empty + S;
  float* const ggs = reinterpret_cast<float*>(base + C::BAR_OFF + 128);  // [ROWS] g_u·ḡ

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * C::ROWS;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], WIDE ? 256 : 128);  // the consuming warpgroups release it
    }
    hop::mbar_init(own, 1);
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer: one thread issues every copy, contexts in order
    hop::reg_dealloc<24>();
    if (threadIdx.x == 256) {
      hop::mbar_expect_tx(own, 2 * C::OWN_BYTES);
#pragma unroll
      for (int hf = 0; hf < C::ROWS / WG_ROWS; ++hf)
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          const int at = hf * C::OH_BYTES + c * WG_ROWS * 128, row = q0 + hf * WG_ROWS;
          hop::tma_load_4d(qs + at, &tq, own, 64 * c, h, row, b);
          hop::tma_load_4d(gs + at, &tg, own, 64 * c, h, row, b);
        }
      for (int ctx = 0; ctx <= N; ++ctx) {
        const int s = ctx % S;
        if (ctx >= S) hop::mbar_wait(&empty[s], (ctx / S - 1) & 1);
        unsigned char* const kt = ring + s * C::STAGE_BYTES;
        const CUtensorMap* const mk = ctx == 0 ? &tkc : &tlk;
        const CUtensorMap* const mv = ctx == 0 ? &tvc : &tlv;
        const int row = ctx == 0 ? b : b * N + ctx - 1;  // batch row of the map
        hop::mbar_expect_tx(&full[s], C::STAGE_BYTES);
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          hop::tma_load_4d(kt + c * LKMAX * 128, mk, &full[s], 64 * c, h, 0, row);
          hop::tma_load_4d(kt + C::KV_BYTES + c * LKMAX * 128, mv, &full[s], 64 * c, h, 0, row);
        }
      }
    }
  } else {  // consumers: WIDE, warpgroup wg owns rows 64 wg + [0, 64) and every
            // context; else both own the 64 rows and take contexts wg, wg + 2, ...
    hop::reg_alloc<240>();
    const size_t inner = (size_t)H * dh;
    {  // g_u·ḡ of the block's rows in f32: TPR threads per row
      constexpr int TPR = 256 / C::ROWS;
      const int row = q0 + threadIdx.x / TPR, part = threadIdx.x % TPR, span = dh / TPR;
      float acc = 0.f;
      if (row < Lq) {
        const size_t off = ((size_t)b * Lq + row) * inner + (size_t)h * dh + part * span;
        for (int d = 0; d < span; d += 2) {  // dh is a multiple of 8: span is even
          const float2 uf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(gu + off + d));
          const float2 gf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(gbar + off + d));
          acc = fmaf(uf.x, gf.x, acc);
          acc = fmaf(uf.y, gf.y, acc);
        }
      }
#pragma unroll
      for (int o = 1; o < TPR; o <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (part == 0) ggs[threadIdx.x / TPR] = acc;
      hop::named_sync(2, 256);
    }
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, t = lane % 4;
    const int lr = (WIDE ? WG_ROWS * wg : 0) + warp * 16 + lane / 4;  // block rows lr, lr + 8
    const int r0 = q0 + lr;
    const unsigned char* const qw = qs + (WIDE ? wg * C::OH_BYTES : 0);
    const unsigned char* const gw = gs + (WIDE ? wg * C::OH_BYTES : 0);
    const float gg[2] = {ggs[lr], ggs[lr + 8]};
    float sc[NS], e[NS], acc[ND];
    uint32_t da[KT][4] = {}, dl[KT][4] = {};
#pragma unroll
    for (int i = 0; i < NS; ++i) sc[i] = e[i] = 0.f;
#pragma unroll
    for (int i = 0; i < ND; ++i) acc[i] = 0.f;
    hop::mbar_wait(own, 0);

    for (int ctx = WIDE ? 0 : wg; ctx <= N; ctx += WIDE ? 1 : 2) {
      const int st = ctx % S;
      const unsigned char* const kt = ring + st * C::STAGE_BYTES;
      const unsigned char* const vt = kt + C::KV_BYTES;
      float w[2] = {1.f, 1.f};  // the blend weights of rows r0, r0 + 8, loaded under the wait
      if (ctx > 0) {
        const int bn = b * N + ctx - 1;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = r0 + 8 * r;
          w[r] = row < Lq ? __bfloat162float(masks[(size_t)bn * Lq + row]) * coef[bn] : 0.f;
        }
      }
      hop::mbar_wait(&full[st], (ctx / S) & 1);
      hop::fence_regs(sc);
      hop::fence_regs(e);
      hop::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < C::KS; ++ks)
        hop::Wgmma<LKMAX>::ss(sc, hop::desc_kmajor(qw, WG_ROWS, ks),
                              hop::desc_kmajor(kt, LKMAX, ks), ks > 0);
#pragma unroll
      for (int ks = 0; ks < C::KS; ++ks)
        hop::Wgmma<LKMAX>::ss(e, hop::desc_kmajor(gw, WG_ROWS, ks),
                              hop::desc_kmajor(vt, LKMAX, ks), ks > 0);
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(sc);
      hop::fence_regs(e);

      // element i: row r0 + 8·((i >> 1) & 1), key 8·(i / 4) + 2t + (i & 1).
      // p in f32, normalized; the row max on the unscaled scores (scale > 0).
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        if (8 * (i / 4) + 2 * t + (i & 1) >= Lk) sc[i] = -CUDART_INF_F;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      }
      const float sl2 = scale * LOG2E;
      float ms[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // the 4 lanes of a quad share a row
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        ms[r] = -mx[r] * sl2;
      }
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        sc[i] = hop::exp2_ftz(fmaf(sc[i], sl2, ms[(i >> 1) & 1]));
        rs[(i >> 1) & 1] += sc[i];
      }
      float inv[2], dr[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
        inv[r] = 1.f / rs[r];
      }
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        sc[i] *= inv[(i >> 1) & 1];  // p
        dr[(i >> 1) & 1] = fmaf(sc[i], e[i], dr[(i >> 1) & 1]);
      }
      float cw[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        dr[r] += __shfl_xor_sync(0xffffffffu, dr[r], 1);  // rowsum(p ⊙ e) = ḡ·(p·V)
        dr[r] += __shfl_xor_sync(0xffffffffu, dr[r], 2);
        const int row = r0 + 8 * r;
        if (ctx > 0 && t == 0 && row < Lq)
          tout[(((size_t)b * H + h) * N + ctx - 1) * Lq + row] = dr[r] - gg[r];
        cw[r] = w[r] * scale;
      }
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int r = (i >> 1) & 1;
        sc[i] = cw[r] * sc[i] * (e[i] - dr[r]);  // scale·ds
      }
      // scale·ds as a bf16 high part and the bf16 rounding of what it leaves
      hop::acc_to_a(da, sc);
#pragma unroll
      for (int kk = 0; kk < KT; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&da[kk][j]));
          dl[kk][j] = dsta::pack_bf16(sc[8 * kk + 2 * j] - hi.x, sc[8 * kk + 2 * j + 1] - hi.y);
        }

      // dq += (scale·ds)·K in two products, K read MN-major; then the stage goes back
      hop::fence_regs(acc);
      hop::fence_regs(da);
      hop::fence_regs(dl);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) hop::Wgmma<DN>::rs(acc, da[kk], hop::desc_mnmajor(kt, LKMAX, kk));
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) hop::Wgmma<DN>::rs(acc, dl[kk], hop::desc_mnmajor(kt, LKMAX, kk));
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(acc);
      hop::fence_regs(da);
      hop::fence_regs(dl);
      hop::mbar_arrive(&empty[st]);
    }

    // 64-row blocks: warpgroup 1's last context N or N − 1 (none at N = 0):
    // no copy lands in its stage again, and warpgroup 0 reads no other
    // context from it
    if (!WIDE && N > 0) {
      const int last = (N % 2 == 1) ? N : N - 1;
      float* const xfer = reinterpret_cast<float*>(ring + (last % S) * C::STAGE_BYTES);
      if (wg == 1) {
#pragma unroll
        for (int i = 0; i < ND; ++i) xfer[i * 128 + tid] = acc[i];
        hop::named_arrive(1, 256);
      } else {
        hop::named_sync(1, 256);
#pragma unroll
        for (int i = 0; i < ND; ++i) acc[i] += xfer[i * 128 + tid];
      }
    }
    if (WIDE || wg == 0) {  // dq rows r0, r0 + 8, columns 8c + 2t, +1
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        if (row >= Lq) continue;
        float* const out = dq + ((size_t)b * Lq + row) * inner + (size_t)h * dh + 2 * t;
#pragma unroll
        for (int c = 0; c < DN / 8; ++c) {
          if (8 * c >= dh) break;  // dh is a multiple of 8
          *reinterpret_cast<float2*>(out + 8 * c) = make_float2(acc[4 * c + 2 * r], acc[4 * c + 2 * r + 1]);
        }
      }
    }
  }
}

template <int DN, bool WIDE>
cudaError_t launch_dq_wgmma_dn(const bf16* q, const bf16* gu, const bf16* kc, const bf16* vc,
                               const bf16* lk, const bf16* lv, const bf16* masks,
                               const float* coef, const bf16* gbar, float* dq, float* t, int B,
                               int N, int Lq, int Lk, int H, int dh, float scale,
                               cudaStream_t stream) {
  CUtensorMap m[6];
  // with no objects the object maps describe the global context (never read)
  const bf16* lkb = N > 0 ? lk : kc;
  const bf16* lvb = N > 0 ? lv : vc;
  const int BN = N > 0 ? B * N : B;
  cudaError_t err = hop::head_map(&m[0], q, B, Lq, H, dh, WG_ROWS);
  if (err == cudaSuccess) err = hop::head_map(&m[1], gbar, B, Lq, H, dh, WG_ROWS);
  if (err == cudaSuccess) err = hop::head_map(&m[2], kc, B, Lk, H, dh, LKMAX);
  if (err == cudaSuccess) err = hop::head_map(&m[3], vc, B, Lk, H, dh, LKMAX);
  if (err == cudaSuccess) err = hop::head_map(&m[4], lkb, BN, Lk, H, dh, LKMAX);
  if (err == cudaSuccess) err = hop::head_map(&m[5], lvb, BN, Lk, H, dh, LKMAX);
  if (err != cudaSuccess) return err;
  using C = DqWgmma<DN, WIDE>;
  return hop::launch_raised<spacetime_bwd_dq_wgmma_kernel<DN, WIDE>>(
      dim3((Lq + C::ROWS - 1) / C::ROWS, H, B), WG_THREADS, C::SMEM, C::SMEM, stream, m[0], m[1],
      m[2], m[3], m[4], m[5], gu, gbar, masks, coef, dq, t, N, Lq, Lk, H, dh, scale);
}

template <int DN>
cudaError_t launch_dq_wgmma_dn(const bf16* q, const bf16* gu, const bf16* kc, const bf16* vc,
                               const bf16* lk, const bf16* lv, const bf16* masks,
                               const float* coef, const bf16* gbar, float* dq, float* t, int B,
                               int N, int Lq, int Lk, int H, int dh, float scale, cudaStream_t s) {
  if (dsta::spacetime_wide(Lq, H, B, hop::sm_count()))
    return launch_dq_wgmma_dn<DN, true>(q, gu, kc, vc, lk, lv, masks, coef, gbar, dq, t, B, N, Lq, Lk, H, dh, scale, s);
  return launch_dq_wgmma_dn<DN, false>(q, gu, kc, vc, lk, lv, masks, coef, gbar, dq, t, B, N, Lq, Lk, H, dh, scale, s);
}

cudaError_t launch_dq_wgmma(const bf16* q, const bf16* gu, const bf16* kc, const bf16* vc,
                            const bf16* lk, const bf16* lv, const bf16* masks, const float* coef,
                            const bf16* gbar, float* dq, float* t, int B, int N, int Lq, int Lk,
                            int H, int dh, float scale, cudaStream_t s) {
  if (dh % 8 != 0) return cudaErrorInvalidValue;
  if (dh <= 40) return launch_dq_wgmma_dn<40>(q, gu, kc, vc, lk, lv, masks, coef, gbar, dq, t, B, N, Lq, Lk, H, dh, scale, s);
  if (dh <= 64) return launch_dq_wgmma_dn<64>(q, gu, kc, vc, lk, lv, masks, coef, gbar, dq, t, B, N, Lq, Lk, H, dh, scale, s);
  if (dh <= 80) return launch_dq_wgmma_dn<80>(q, gu, kc, vc, lk, lv, masks, coef, gbar, dq, t, B, N, Lq, Lk, H, dh, scale, s);
  if (dh <= 128) return launch_dq_wgmma_dn<128>(q, gu, kc, vc, lk, lv, masks, coef, gbar, dq, t, B, N, Lq, Lk, H, dh, scale, s);
  return launch_dq_wgmma_dn<160>(q, gu, kc, vc, lk, lv, masks, coef, gbar, dq, t, B, N, Lq, Lk, H, dh, scale, s);
}

// The dK/dV pass (CUDA cores) of either dtype.
template <typename T>
cudaError_t launch_kv(const void* q, const void* kc, const void* vc, const void* lk, const void* lv,
                      const void* masks, const float* coef, const void* gbar, float* dkc,
                      float* dvc, float* dlk, float* dlv, int B, int N, int Lq, int Lk, int H,
                      int dh, float scale, cudaStream_t stream) {
  constexpr size_t most = kv_smem_bytes(LKMAX, DMAX);
  return hop::launch_raised<spacetime_bwd_kv_kernel<T>>(
      dim3((dh + DC - 1) / DC, H, B * (N + 1)), NT, (int)kv_smem_bytes(Lk, dh), (int)most, stream,
      static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc),
      static_cast<const T*>(lk), static_cast<const T*>(lv), static_cast<const T*>(masks), coef,
      static_cast<const T*>(gbar), dkc, dvc, dlk, dlv, N, Lq, Lk, H, dh, scale);
}

}  // namespace

// q/gu/gbar [B, Lq, H*dh]; kc/vc [B, Lk, H*dh]; lk/lv [B, N, Lk, H*dh] (one
// dtype, contiguous); masks [B, N, Lq] in that dtype; coef [B, N] float32.
// Outputs, all float32: dq [B, Lq, H*dh], t [B, H, N, Lq]; dkc/dvc [B, Lk,
// H*dh] and dlk/dlv [B, N, Lk, H*dh] only when dkc is not null (then all four
// are set).  The dq pass runs the CUDA-core design in float32 and the wgmma
// design in bfloat16 (dh a multiple of 8, 16-byte aligned q, ḡ, K and V).
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
  if (dtype != dsta::kF32 && dtype != dsta::kBF16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(coef);
  float *dqf = static_cast<float*>(dq), *tf = static_cast<float*>(t);
  float *dkcf = static_cast<float*>(dkc), *dvcf = static_cast<float*>(dvc);
  float *dlkf = static_cast<float*>(dlk), *dlvf = static_cast<float*>(dlv);
  cudaError_t err;
  if (dtype == dsta::kF32) {
    constexpr size_t most = dq_smem_bytes(LKMAX, DMAX);
    err = hop::launch_raised<spacetime_bwd_dq_simt_kernel>(
        dim3((Lq + BQ - 1) / BQ, H, B), NT, (int)dq_smem_bytes(Lk, dh), (int)most, s,
        static_cast<const float*>(q), static_cast<const float*>(gu),
        static_cast<const float*>(kc), static_cast<const float*>(vc),
        static_cast<const float*>(lk), static_cast<const float*>(lv),
        static_cast<const float*>(masks), c, static_cast<const float*>(gbar), dqf, tf, N, Lq, Lk,
        H, dh, scale);
  } else {
    err = launch_dq_wgmma(static_cast<const bf16*>(q), static_cast<const bf16*>(gu),
                          static_cast<const bf16*>(kc), static_cast<const bf16*>(vc),
                          static_cast<const bf16*>(lk), static_cast<const bf16*>(lv),
                          static_cast<const bf16*>(masks), c, static_cast<const bf16*>(gbar), dqf,
                          tf, B, N, Lq, Lk, H, dh, scale, s);
  }
  if (err != cudaSuccess || dkc == nullptr) return (int)err;
  if (dtype == dsta::kF32)
    return (int)launch_kv<float>(q, kc, vc, lk, lv, masks, c, gbar, dkcf, dvcf, dlkf, dlvf, B, N,
                                 Lq, Lk, H, dh, scale, s);
  return (int)launch_kv<bf16>(q, kc, vc, lk, lv, masks, c, gbar, dkcf, dvcf, dlkf, dlvf, B, N, Lq,
                              Lk, H, dh, scale, s);
}
