// Self-attention forward loops shared by `mha_fwd.cu` and `flash_fwd.cu`.
//
// o = softmax(q·Kᵀ·scale)·V per (batch, head, 64-query tile), with a running
// max and sum over 64-key tiles (flash-attention style), so no score leaves
// the chip.  Layouts: q [B, Lq, H*dh], k/v [B, Lk, H*dh], out like q.  When
// `lse` is not null, the row log-sum-exp of the scaled scores is written to
// lse [B*H, Lq] in f32 (the residual of the flash backward).
//
// float32 runs on the CUDA cores (`attn_fwd_simt`): each of 256 threads owns
// a 4x4 block of the 64x64 score tile and 4 rows x ceil(dh/16) columns of the
// output accumulator; p is rounded to T before the PV product.
//
// bf16 runs on the tensor cores (`attn_fwd_mma`): mma.sync m16n8k16 with f32
// accumulation, 4 warps of 16 queries each.  The head width is padded with
// zeros to a multiple of 16 in shared memory (the depth of one product), so
// dh = 40 costs the QKᵀ work of 48.  The scores stay in the accumulator
// registers, where their layout is that of the PV product's A operand, so p
// goes to bf16 in registers; V's B operand is read with ldmatrix.trans.  The
// running max and sum are kept in log2 units (exp2f).
#pragma once

#include "common.cuh"

namespace dsta {

constexpr int ATT_BQ = 64;      // queries per block
constexpr int ATT_BK = 64;      // keys per tile
constexpr int ATT_NT = 256;     // threads per CUDA-core block
constexpr int ATT_DMAX = 160;   // largest head width supported
constexpr int ATT_TC_NT = 128;  // threads per tensor-core block: 4 warps x 16 queries

inline size_t attn_fwd_simt_smem(int dh) {
  return sizeof(float) *
         ((size_t)(ATT_BQ + 2 * ATT_BK) * (dh + 1) + (size_t)ATT_BQ * (ATT_BK + 1));
}

inline int attn_fwd_mma_smem(int DP) {
  return (int)sizeof(bf16) * (ATT_BQ + 2 * ATT_BK) * (DP + 8);
}

template <typename T>
__device__ __forceinline__ void attn_fwd_simt(const T* __restrict__ q, const T* __restrict__ k,
                                              const T* __restrict__ v, T* __restrict__ out,
                                              float* __restrict__ lse, int Lq, int Lk, int H,
                                              int dh, float scale) {
  constexpr int BQ = ATT_BQ, BK = ATT_BK, NT = ATT_NT, DCOLS = ATT_DMAX / 16;
  extern __shared__ float smem[];
  const int ld = dh + 1;
  float* qs = smem;             // [BQ][dh+1]
  float* ks = qs + BQ * ld;     // [BK][dh+1]
  float* vs = ks + BK * ld;     // [BK][dh+1]
  float* ps = vs + BK * ld;     // [BQ][BK+1]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t inner = (size_t)H * dh;
  const T* qb = q + (size_t)b * Lq * inner + (size_t)h * dh;
  const T* kb = k + (size_t)b * Lk * inner + (size_t)h * dh;
  const T* vb = v + (size_t)b * Lk * inner + (size_t)h * dh;

  for (int idx = tid; idx < BQ * dh; idx += NT) {
    const int r = idx / dh, d = idx % dh;
    qs[r * ld + d] = (q0 + r < Lq) ? to_f32(qb[(size_t)(q0 + r) * inner + d]) : 0.f;
  }

  float m_i[4], l_i[4], acc[4][DCOLS];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = -CUDART_INF_F;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DCOLS; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < Lk; k0 += BK) {
    __syncthreads();  // the previous tile's ks/vs/ps are no longer read
    for (int idx = tid; idx < BK * dh; idx += NT) {
      const int r = idx / dh, d = idx % dh;
      const bool ok = k0 + r < Lk;
      const size_t off = (size_t)(k0 + r) * inner + d;
      ks[r * ld + d] = ok ? to_f32(kb[off]) : 0.f;
      vs[r * ld + d] = ok ? to_f32(vb[off]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < dh; ++d) {
      float a[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty * 4 + i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = ks[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = (k0 + tx + 16 * j < Lk) ? s[i][j] * scale : -CUDART_INF_F;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m_i[i], mx);  // finite: every tile holds a key
      const float alpha = expf(m_i[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        ps[(ty * 4 + i) * (BK + 1) + tx + 16 * j] = round_to<T>(p);
      }
      rs = half_warp_sum(rs);
      l_i[i] = l_i[i] * alpha + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < DCOLS; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    const int kmax = min(BK, Lk - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty * 4 + i) * (BK + 1) + kk];
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
    const float inv = 1.f / l_i[i];
    T* ob = out + (size_t)b * Lq * inner + (size_t)r * inner + (size_t)h * dh;
#pragma unroll
    for (int c = 0; c < DCOLS; ++c) {
      const int d = tx + 16 * c;
      if (d < dh) ob[d] = from_f32<T>(acc[i][c] * inv);
    }
    if (lse != nullptr && tx == 0) lse[((size_t)b * H + h) * Lq + r] = m_i[i] + logf(l_i[i]);
  }
}

template <int DP>
__device__ __forceinline__ void attn_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                             const bf16* __restrict__ v, bf16* __restrict__ out,
                                             float* __restrict__ lse, int Lq, int Lk, int H,
                                             int dh, float scale_log2, bool vec) {
  constexpr int TC_BQ = ATT_BQ, TC_BK = ATT_BK, TC_NT = ATT_TC_NT;
  constexpr int LD = DP + 8;   // +8: conflict-free fragment and ldmatrix reads
  constexpr int KS = DP / 16;  // product depth steps over the head width
  constexpr int DN = DP / 8;   // output column tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [TC_BQ][LD]
  bf16* ks = qs + TC_BQ * LD;                     // [TC_BK][LD]
  bf16* vs = ks + TC_BK * LD;                     // [TC_BK][LD]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * TC_BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const size_t inner = (size_t)H * dh;
  const size_t head = (size_t)h * dh;
  const bf16* kb = k + (size_t)b * Lk * inner + head;
  const bf16* vb = v + (size_t)b * Lk * inner + head;

  load_tile_bf16<TC_BQ, DP, TC_NT>(qs, q + (size_t)b * Lq * inner + head, q0, Lq, 0, dh, inner,
                                   vec);
  __syncthreads();
  uint32_t qf[KS][4];  // this warp's 16 query rows as A fragments
  const bf16* qw = qs + warp * 16 * LD;
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const int c = s * 16 + t * 2;
    qf[s][0] = ld_pair(qw + g * LD + c);
    qf[s][1] = ld_pair(qw + (g + 8) * LD + c);
    qf[s][2] = ld_pair(qw + g * LD + c + 8);
    qf[s][3] = ld_pair(qw + (g + 8) * LD + c + 8);
  }

  // accumulator rows: [0], [1] -> row g; [2], [3] -> row g + 8
  float o[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_i[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_i[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < Lk; k0 += TC_BK) {
    __syncthreads();  // the previous tile's ks / vs are no longer read
    load_tile_bf16<TC_BK, DP, TC_NT>(ks, kb, k0, Lk, 0, dh, inner, vec);
    load_tile_bf16<TC_BK, DP, TC_NT>(vs, vb, k0, Lk, 0, dh, inner, vec);
    __syncthreads();

    float s[TC_BK / 8][4];
#pragma unroll
    for (int n = 0; n < TC_BK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const bf16* kr = ks + (n * 8 + g) * LD + t * 2;
#pragma unroll
      for (int st = 0; st < KS; ++st)
        mma_bf16(s[n], qf[st], ld_pair(kr + st * 16), ld_pair(kr + st * 16 + 8));
    }

    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int n = 0; n < TC_BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = k0 + n * 8 + t * 2 + (e & 1) < Lk;
        s[n][e] = ok ? s[n][e] * scale_log2 : -CUDART_INF_F;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // the 4 lanes of a quad share a row
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_i[i], mx[i]);  // finite: every tile holds a key
      alpha[i] = exp2f(m_i[i] - m_new);
      m_i[i] = m_new;
    }
#pragma unroll
    for (int n = 0; n < TC_BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - m_i[e >> 1]);
        rs[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l_i[i] = l_i[i] * alpha[i] + rs[i];
    }
#pragma unroll
    for (int n = 0; n < DN; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // o += p·V: the score tiles of keys [16j, 16j + 16) are the A fragment
#pragma unroll
    for (int j = 0; j < TC_BK / 16; ++j) {
      const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
      const bf16* vr = vs + (j * 16 + (lane & 15)) * LD;
#pragma unroll
      for (int n = 0; n < DN; ++n) {
        if (n * 8 < dh) {
          uint32_t b0, b1;
          ldmatrix_x2_trans(b0, b1, vr + n * 8);
          mma_bf16(o[n], pa, b0, b1);
        }
      }
    }
  }

  bf16* ob = out + (size_t)b * Lq * inner + head;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + warp * 16 + g + 8 * i;
    if (r >= Lq) continue;
    const float inv = 1.f / l_i[i];
#pragma unroll
    for (int n = 0; n < DN; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = n * 8 + t * 2 + e;
        if (d < dh) ob[(size_t)r * inner + d] = __float2bfloat16_rn(o[n][2 * i + e] * inv);
      }
    // m and l are in log2 units: ln Σ exp(s) = ln 2 · (m + log2 l)
    if (lse != nullptr && t == 0)
      lse[((size_t)b * H + h) * Lq + r] = 0.6931471805599453f * (m_i[i] + log2f(l_i[i]));
  }
}

}  // namespace dsta
