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
// query tile, so both kernels below walk the keys in tiles of 64 with a
// running max and sum (flash-attention style), and the scores never reach
// device memory.
//
// bf16 runs on the tensor cores (`mha_fwd_mma_kernel`): mma.sync m16n8k16
// with f32 accumulation, 4 warps of 16 queries each.  The head width is
// padded with zeros to a multiple of 16 in shared memory (the depth of one
// product), so dh = 40 costs the QKᵀ work of 48.  The scores stay in the
// accumulator registers, where their layout is that of the PV product's A
// operand, so p goes to bf16 in registers; V's B operand is read with
// ldmatrix.trans.  float32 runs on the CUDA cores (`mha_fwd_simt_kernel`):
// each of 256 threads owns a 4x4 block of the 64x64 score tile and 4 rows x
// ceil(dh/16) columns of the output accumulator.
#include "common.cuh"

namespace {

// ---- float32: CUDA cores ----
constexpr int BQ = 64;          // queries per block
constexpr int BK = 64;          // keys per tile
constexpr int NT = 256;         // threads per block
constexpr int DMAX = 160;       // largest head width supported
constexpr int DCOLS = DMAX / 16;

size_t smem_bytes(int dh) {
  return sizeof(float) * ((size_t)(BQ + 2 * BK) * (dh + 1) + (size_t)BQ * (BK + 1));
}

template <typename T>
__global__ void __launch_bounds__(NT)
mha_fwd_simt_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    T* __restrict__ out, int Lq, int Lk, int H, int dh, float scale) {
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
    qs[r * ld + d] = (q0 + r < Lq) ? dsta::to_f32(qb[(size_t)(q0 + r) * inner + d]) : 0.f;
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
      ks[r * ld + d] = ok ? dsta::to_f32(kb[off]) : 0.f;
      vs[r * ld + d] = ok ? dsta::to_f32(vb[off]) : 0.f;
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
      mx = dsta::half_warp_max(mx);
      const float m_new = fmaxf(m_i[i], mx);  // finite: every tile holds a key
      const float alpha = expf(m_i[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        ps[(ty * 4 + i) * (BK + 1) + tx + 16 * j] = dsta::round_to<T>(p);
      }
      rs = dsta::half_warp_sum(rs);
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
      if (d < dh) ob[d] = dsta::from_f32<T>(acc[i][c] * inv);
    }
  }
}

cudaError_t launch_simt(const float* q, const float* k, const float* v, float* out, int B,
                        int Lq, int Lk, int H, int dh, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(dh);
  cudaError_t err = cudaFuncSetAttribute(mha_fwd_simt_kernel<float>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + BQ - 1) / BQ, H, B);
  mha_fwd_simt_kernel<float><<<grid, NT, smem, stream>>>(q, k, v, out, Lq, Lk, H, dh, scale);
  return cudaGetLastError();
}

// ---- bfloat16: tensor cores ----
constexpr int TC_BQ = 64;   // queries per block: 4 warps x 16
constexpr int TC_BK = 64;   // keys per tile
constexpr int TC_NT = 128;

using dsta::bf16;
using dsta::ld_pair;
using dsta::ldmatrix_x2_trans;
using dsta::mma_bf16;
using dsta::pack_bf16;
using dsta::load_tile_bf16;

template <int DP>
__global__ void __launch_bounds__(TC_NT)
mha_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ out, int Lq, int Lk, int H,
                   int dh, float scale_log2, bool vec) {
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
  }
}

template <int DP>
cudaError_t launch_mma_dp(const bf16* q, const bf16* k, const bf16* v, bf16* out, int B, int Lq,
                          int Lk, int H, int dh, float scale, cudaStream_t stream) {
  const int smem = (int)sizeof(bf16) * (TC_BQ + 2 * TC_BK) * (DP + 8);
  cudaError_t err = cudaFuncSetAttribute(mha_fwd_mma_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const size_t inner = (size_t)H * dh;
  const bool vec = dh % 8 == 0 && inner % 8 == 0 && dsta::aligned16(q) && dsta::aligned16(k) &&
                   dsta::aligned16(v);
  dim3 grid((Lq + TC_BQ - 1) / TC_BQ, H, B);
  mha_fwd_mma_kernel<DP><<<grid, TC_NT, smem, stream>>>(
      q, k, v, out, Lq, Lk, H, dh, scale * 1.4426950408889634f, vec);
  return cudaGetLastError();
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

// q [B, Lq, H*dh], k/v [B, Lk, H*dh], out [B, Lq, H*dh]; all contiguous, one dtype.
extern "C" int dsta_mha_fwd(int dtype, const void* q, const void* k, const void* v, void* out,
                            int B, int Lq, int Lk, int H, int dh, float scale, void* stream) {
  if (dh < 1 || dh > DMAX || Lk < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dsta::kF32)
    return (int)launch_simt(static_cast<const float*>(q), static_cast<const float*>(k),
                            static_cast<const float*>(v), static_cast<float*>(out), B, Lq, Lk, H,
                            dh, scale, s);
  if (dtype == dsta::kBF16)
    return (int)launch_mma(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                           static_cast<const bf16*>(v), static_cast<bf16*>(out), B, Lq, Lk, H, dh,
                           scale, s);
  return (int)cudaErrorInvalidValue;
}
