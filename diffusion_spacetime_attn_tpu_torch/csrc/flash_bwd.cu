// Flash self-attention backward: dq, dK and dV from the saved row
// log-sum-exp.
//
// Replaces the bodies `_flash_attention_dq_kernel` and
// `_flash_attention_dkv_kernel` of jax's splash attention
// (`jax/experimental/pallas/ops/tpu/splash_attention/splash_attention_kernel.py`),
// which the JAX package differentiates through at the self-attention sites
// that pass `flash_ok` (`ops/attention.py:194-214,238-239`).  With q already
// scaled by dh^-½ (as in the forward, `flash_fwd.cu`), ḡ the output
// cotangent, o the forward's output and lse its row log-sum-exp:
//
//   di = Σ_d o ⊙ ḡ              f32 per query row (splash computes it outside
//                               its kernels; here the first pass does)
//   p  = exp(q·Kᵀ − lse)        recomputed in f32 per tile
//   dp = ḡ·Vᵀ                   f32
//   ds = p ⊙ (dp − di)          rounded to K's dtype before both products
//   dq = scale · (ds·K)         the accumulator rounded to q's dtype, then
//                               the pre-scale's chain rule (as JAX applies it)
//   dK = dsᵀ·q,  dV = pᵀ·ḡ      p rounded to ḡ's dtype for dV
//
// Bound on the H100: 10·Lq·Lk·dh FLOPs (five products) per (batch, head)
// against ~10·L·dh bytes, so at SD levels 0 and 1 (L = 4096, dh = 40;
// L = 1024, dh = 80) it is bound by operations.  Neither p nor ds, nor any
// other [Lq, Lk] tensor, reaches device memory: each tile is recomputed from
// q, K and lse.
//
// Two passes and no atomics.  The TPU kernels accumulated dq, and dK/dV, in
// VMEM across a sequential grid; on the H100 blocks run in no order, and
// atomics would change the bits from run to run.  So:
//   dq pass:   one block per (b, head, query tile) walks the key tiles in
//              order and keeps its dq rows in registers (products q·Kᵀ,
//              ḡ·Vᵀ, ds·K);
//   dK/dV pass: one block per (b, head, key tile) walks the query tiles in
//              order and keeps its dK/dV rows in registers (products K·qᵀ,
//              V·ḡᵀ, pᵀ·ḡ, dsᵀ·q).
// Both recompute p and dp, so the two passes run 7 products where the
// bound counts 5.  The dK/dV pass runs after the dq pass on the same stream.
//
// The caller picks a design by `design`:
// 1, wgmma (bf16 at head widths 40, 64, 80, 128; 16-byte aligned tensors),
//   in the shape of the forward (`attn_fwd.cuh`): 384 threads, two consumer
//   warpgroups and a producer warpgroup that feeds a ring of 2 stages by TMA
//   (full/empty mbarriers; tile layout in `hopper.cuh`).  dq pass: each
//   consumer owns 64 query rows, Q and ḡ loaded once, 64-key K/V tiles
//   streamed; it computes di from o and ḡ for its rows and writes di and
//   lse·log2(e) to a scratch [2, B·H, Lpad] f32 (Lpad = Lq rounded up to
//   64).  dK/dV pass: each consumer owns 64 keys, K and V loaded once,
//   64-query q/ḡ tiles streamed with their lse/di slices from the scratch
//   (1-D bulk copies).  S and dP are wgmma products of shared-memory
//   operands; ds·K, pᵀ·ḡ and dsᵀ·q take the previous accumulator as the
//   register A operand and an MN-major B tile.
// 0, the synchronous designs: di by `flash_bwd_di_kernel` into the scratch
//   ([B·H, Lq]), then bf16 on the tensor cores with mma.sync m16n8k16 (4
//   warps of 16 rows, dh zero-padded to a multiple of 16, 16 columns of p /
//   ds at a time turned from accumulators into the next product's A operand
//   in registers; the NN products read their B operand with
//   ldmatrix.trans), or float32 on the CUDA cores (256 threads each owning a
//   4x4 block of the 64x64 tile, p / ds staged in shared memory).
#include "hopper.cuh"

namespace {

using dsta::bf16;
using dsta::ld_pair;
using dsta::ldmatrix_x2_trans;
using dsta::mma_bf16;
using dsta::pack_bf16;
using dsta::load_tile_bf16;

constexpr int DMAX = 128;      // flash_ok's largest head width
constexpr int BT = 64;         // rows per block, and rows per tile of the walk
constexpr float LOG2E = 1.4426950408889634f;

// ---- float32: CUDA cores ----
constexpr int NT = 256;
constexpr int DCOLS = DMAX / 16;

size_t simt_smem_bytes(int dh) {
  return sizeof(float) * ((size_t)4 * BT * (dh + 1) + (size_t)2 * BT * (BT + 1) + 2 * BT);
}

// [BT][dh+1] f32 tile of rows [r0, r0 + BT) of one head; zero past R.
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, int r0, int R,
                                              int dh, size_t inner) {
  for (int idx = threadIdx.x; idx < BT * dh; idx += NT) {
    const int r = idx / dh, d = idx % dh;
    dst[r * (dh + 1) + d] = (r0 + r < R) ? src[(size_t)(r0 + r) * inner + d] : 0.f;
  }
}

__global__ void __launch_bounds__(NT)
flash_bwd_dq_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ g,
                         const float* __restrict__ lse, const float* __restrict__ di,
                         float* __restrict__ dq, int Lq, int Lk, int H, int dh, float scale) {
  extern __shared__ float smem[];
  const int ld = dh + 1;
  float* qs = smem;             // [BT][ld]
  float* gs = qs + BT * ld;     // [BT][ld]
  float* ks = gs + BT * ld;     // [BT][ld]
  float* vs = ks + BT * ld;     // [BT][ld]
  float* dss = vs + BT * ld;    // [BT][BT+1]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BT;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t inner = (size_t)H * dh;
  const size_t rows_q = (size_t)b * Lq * inner + (size_t)h * dh;
  const size_t rows_k = (size_t)b * Lk * inner + (size_t)h * dh;
  const size_t bh = ((size_t)b * H + h) * Lq;

  load_tile_f32(qs, q + rows_q, q0, Lq, dh, inner);
  load_tile_f32(gs, g + rows_q, q0, Lq, dh, inner);
  float lse_r[4], di_r[4], acc[4][DCOLS];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    lse_r[i] = r < Lq ? lse[bh + r] : 0.f;
    di_r[i] = r < Lq ? di[bh + r] : 0.f;
#pragma unroll
    for (int c = 0; c < DCOLS; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < Lk; k0 += BT) {
    __syncthreads();  // the previous tile's ks / vs / dss are no longer read
    load_tile_f32(ks, k + rows_k, k0, Lk, dh, inner);
    load_tile_f32(vs, v + rows_k, k0, Lk, dh, inner);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < dh; ++d) {
      float a[4], gg[4], kk[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = qs[(ty * 4 + i) * ld + d];
        gg[i] = gs[(ty * 4 + i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kk[j] = ks[(tx + 16 * j) * ld + d];
        vv[j] = vs[(tx + 16 * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], kk[j], s[i][j]);
          dp[i][j] = fmaf(gg[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = (k0 + tx + 16 * j < Lk) ? expf(s[i][j] - lse_r[i]) : 0.f;
        dss[(ty * 4 + i) * (BT + 1) + tx + 16 * j] = p * (dp[i][j] - di_r[i]);
      }
    __syncthreads();

    const int kmax = min(BT, Lk - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dss[(ty * 4 + i) * (BT + 1) + kk];
#pragma unroll
      for (int c = 0; c < DCOLS; ++c) {
        const int d = tx + 16 * c;
        if (d < dh) {
          const float kv = ks[kk * ld + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(ds[i], kv, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Lq) continue;
    float* out = dq + rows_q + (size_t)r * inner;
#pragma unroll
    for (int c = 0; c < DCOLS; ++c) {
      const int d = tx + 16 * c;
      if (d < dh) out[d] = acc[i][c] * scale;
    }
  }
}

__global__ void __launch_bounds__(NT)
flash_bwd_dkv_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ g,
                          const float* __restrict__ lse, const float* __restrict__ di,
                          float* __restrict__ dk, float* __restrict__ dv, int Lq, int Lk, int H,
                          int dh) {
  extern __shared__ float smem[];
  const int ld = dh + 1;
  float* ks = smem;             // [BT][ld]
  float* vs = ks + BT * ld;     // [BT][ld]
  float* qs = vs + BT * ld;     // [BT][ld]
  float* gs = qs + BT * ld;     // [BT][ld]
  float* ps = gs + BT * ld;     // [BT keys][BT+1 queries]
  float* dss = ps + BT * (BT + 1);
  float* ls = dss + BT * (BT + 1);  // [BT] lse of the query tile
  float* dis = ls + BT;             // [BT] di of the query tile

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * BT;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t inner = (size_t)H * dh;
  const size_t rows_q = (size_t)b * Lq * inner + (size_t)h * dh;
  const size_t rows_k = (size_t)b * Lk * inner + (size_t)h * dh;
  const size_t bh = ((size_t)b * H + h) * Lq;

  load_tile_f32(ks, k + rows_k, k0, Lk, dh, inner);
  load_tile_f32(vs, v + rows_k, k0, Lk, dh, inner);
  float acc_k[4][DCOLS], acc_v[4][DCOLS];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DCOLS; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  for (int q0 = 0; q0 < Lq; q0 += BT) {
    __syncthreads();  // the previous tile's qs / gs / ps / dss are no longer read
    load_tile_f32(qs, q + rows_q, q0, Lq, dh, inner);
    load_tile_f32(gs, g + rows_q, q0, Lq, dh, inner);
    if (tid < BT) {
      const bool ok = q0 + tid < Lq;
      ls[tid] = ok ? lse[bh + q0 + tid] : 0.f;
      dis[tid] = ok ? di[bh + q0 + tid] : 0.f;
    }
    __syncthreads();

    // rows: keys ty*4 + i; columns: queries tx + 16j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < dh; ++d) {
      float kk[4], vv[4], a[4], gg[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kk[i] = ks[(ty * 4 + i) * ld + d];
        vv[i] = vs[(ty * 4 + i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        a[j] = qs[(tx + 16 * j) * ld + d];
        gg[j] = gs[(tx + 16 * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(kk[i], a[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], gg[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = (q0 + c < Lq) ? expf(s[i][j] - ls[c]) : 0.f;
        ps[(ty * 4 + i) * (BT + 1) + c] = p;
        dss[(ty * 4 + i) * (BT + 1) + c] = p * (dp[i][j] - dis[c]);
      }
    __syncthreads();

    const int qmax = min(BT, Lq - q0);
    for (int qq = 0; qq < qmax; ++qq) {
      float p[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = ps[(ty * 4 + i) * (BT + 1) + qq];
        ds[i] = dss[(ty * 4 + i) * (BT + 1) + qq];
      }
#pragma unroll
      for (int c = 0; c < DCOLS; ++c) {
        const int d = tx + 16 * c;
        if (d < dh) {
          const float gv = gs[qq * ld + d], qv = qs[qq * ld + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc_v[i][c] = fmaf(p[i], gv, acc_v[i][c]);
            acc_k[i][c] = fmaf(ds[i], qv, acc_k[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + ty * 4 + i;
    if (r >= Lk) continue;
#pragma unroll
    for (int c = 0; c < DCOLS; ++c) {
      const int d = tx + 16 * c;
      if (d < dh) {
        dk[rows_k + (size_t)r * inner + d] = acc_k[i][c];
        dv[rows_k + (size_t)r * inner + d] = acc_v[i][c];
      }
    }
  }
}

// ---- bfloat16: tensor cores ----
constexpr int TC_NT = 128;   // 4 warps x 16 rows

constexpr int mma_smem_bytes(int DP) {
  return (int)sizeof(bf16) * 4 * BT * (DP + 8) + (int)sizeof(float) * 2 * BT;
}

// This warp's 16 rows of a [BT][DP + 8] tile as A fragments.
template <int KS, int LD>
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[KS][4], const bf16* tile, int warp,
                                             int g, int t) {
  const bf16* w = tile + warp * 16 * LD;
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const int c = s * 16 + t * 2;
    f[s][0] = ld_pair(w + g * LD + c);
    f[s][1] = ld_pair(w + (g + 8) * LD + c);
    f[s][2] = ld_pair(w + g * LD + c + 8);
    f[s][3] = ld_pair(w + (g + 8) * LD + c + 8);
  }
}

// c[n] = a·Bᵀ for the 16 rows [r0, r0 + 16) of the tile B ([BT][LD], rows
// as columns of the product): two 16x8 accumulators.
template <int KS, int LD>
__device__ __forceinline__ void mma_abt16(float (&c)[2][4], const uint32_t (&a)[KS][4],
                                          const bf16* tile, int r0, int g, int t) {
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
    const bf16* r = tile + (r0 + n * 8 + g) * LD + t * 2;
#pragma unroll
    for (int st = 0; st < KS; ++st) mma_bf16(c[n], a[st], ld_pair(r + st * 16), ld_pair(r + st * 16 + 8));
  }
}

// acc += A·B for A the 16x16 bf16 fragment of two accumulators and B the
// rows [r0, r0 + 16) of the tile ([BT][LD]), read transposed.
template <int DN, int LD>
__device__ __forceinline__ void mma_ab16(float (&acc)[DN][4], const float (&a)[2][4],
                                         const bf16* tile, int r0, int lane, int dh) {
  const uint32_t pa[4] = {pack_bf16(a[0][0], a[0][1]), pack_bf16(a[0][2], a[0][3]),
                          pack_bf16(a[1][0], a[1][1]), pack_bf16(a[1][2], a[1][3])};
  const bf16* r = tile + (r0 + (lane & 15)) * LD;
#pragma unroll
  for (int n = 0; n < DN; ++n) {
    if (n * 8 < dh) {
      uint32_t b0, b1;
      ldmatrix_x2_trans(b0, b1, r + n * 8);
      mma_bf16(acc[n], pa, b0, b1);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(TC_NT)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ g,
                        const float* __restrict__ lse, const float* __restrict__ di,
                        bf16* __restrict__ dq, int Lq, int Lk, int H, int dh, float scale,
                        bool vec) {
  constexpr int LD = DP + 8, KS = DP / 16, DN = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BT][LD]
  bf16* gs = qs + BT * LD;
  bf16* ks = gs + BT * LD;
  bf16* vs = ks + BT * LD;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gr = lane / 4, t = lane % 4;
  const size_t inner = (size_t)H * dh;
  const size_t rows_q = (size_t)b * Lq * inner + (size_t)h * dh;
  const size_t rows_k = (size_t)b * Lk * inner + (size_t)h * dh;
  const size_t bh = ((size_t)b * H + h) * Lq;

  load_tile_bf16<BT, DP, TC_NT>(qs, q + rows_q, q0, Lq, 0, dh, inner, vec);
  load_tile_bf16<BT, DP, TC_NT>(gs, g + rows_q, q0, Lq, 0, dh, inner, vec);
  __syncthreads();
  uint32_t qf[KS][4], gf[KS][4];
  load_a_frags<KS, LD>(qf, qs, warp, gr, t);
  load_a_frags<KS, LD>(gf, gs, warp, gr, t);
  // accumulator rows: [0], [1] -> row gr; [2], [3] -> row gr + 8
  float lse2[2], di_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + warp * 16 + gr + 8 * i;
    lse2[i] = r < Lq ? lse[bh + r] * LOG2E : 0.f;
    di_r[i] = r < Lq ? di[bh + r] : 0.f;
  }
  float acc[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += BT) {
    __syncthreads();  // the previous tile's ks / vs are no longer read
    load_tile_bf16<BT, DP, TC_NT>(ks, k + rows_k, k0, Lk, 0, dh, inner, vec);
    load_tile_bf16<BT, DP, TC_NT>(vs, v + rows_k, k0, Lk, 0, dh, inner, vec);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < BT / 16; ++j) {  // 16 keys at a time
      float s[2][4], dp[2][4];
      mma_abt16<KS, LD>(s, qf, ks, j * 16, gr, t);
      mma_abt16<KS, LD>(dp, gf, vs, j * 16, gr, t);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = k0 + j * 16 + n * 8 + t * 2 + (e & 1) < Lk;
          const float p = ok ? exp2f(fmaf(s[n][e], LOG2E, -lse2[e >> 1])) : 0.f;
          s[n][e] = p * (dp[n][e] - di_r[e >> 1]);  // ds
        }
      mma_ab16<DN, LD>(acc, s, ks, j * 16, lane, dh);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + warp * 16 + gr + 8 * i;
    if (r >= Lq) continue;
    bf16* out = dq + rows_q + (size_t)r * inner;
#pragma unroll
    for (int n = 0; n < DN; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = n * 8 + t * 2 + e;
        if (d < dh) out[d] = __float2bfloat16_rn(dsta::round_to<bf16>(acc[n][2 * i + e]) * scale);
      }
  }
}

template <int DP>
__global__ void __launch_bounds__(TC_NT)
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ g,
                         const float* __restrict__ lse, const float* __restrict__ di,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int Lq, int Lk, int H,
                         int dh, bool vec) {
  constexpr int LD = DP + 8, KS = DP / 16, DN = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [BT][LD]
  bf16* vs = ks + BT * LD;
  bf16* qs = vs + BT * LD;
  bf16* gs = qs + BT * LD;
  float* ls = reinterpret_cast<float*>(gs + BT * LD);  // [BT] lse·log2(e) of the query tile
  float* dis = ls + BT;                                // [BT] di of the query tile

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * BT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gr = lane / 4, t = lane % 4;
  const size_t inner = (size_t)H * dh;
  const size_t rows_q = (size_t)b * Lq * inner + (size_t)h * dh;
  const size_t rows_k = (size_t)b * Lk * inner + (size_t)h * dh;
  const size_t bh = ((size_t)b * H + h) * Lq;

  load_tile_bf16<BT, DP, TC_NT>(ks, k + rows_k, k0, Lk, 0, dh, inner, vec);
  load_tile_bf16<BT, DP, TC_NT>(vs, v + rows_k, k0, Lk, 0, dh, inner, vec);
  __syncthreads();
  uint32_t kf[KS][4], vf[KS][4];  // this warp's 16 keys
  load_a_frags<KS, LD>(kf, ks, warp, gr, t);
  load_a_frags<KS, LD>(vf, vs, warp, gr, t);
  float acc_k[DN][4], acc_v[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  for (int q0 = 0; q0 < Lq; q0 += BT) {
    __syncthreads();  // the previous tile's qs / gs / ls / dis are no longer read
    load_tile_bf16<BT, DP, TC_NT>(qs, q + rows_q, q0, Lq, 0, dh, inner, vec);
    load_tile_bf16<BT, DP, TC_NT>(gs, g + rows_q, q0, Lq, 0, dh, inner, vec);
    if (threadIdx.x < BT) {
      const bool ok = q0 + threadIdx.x < Lq;
      ls[threadIdx.x] = ok ? lse[bh + q0 + threadIdx.x] * LOG2E : 0.f;
      dis[threadIdx.x] = ok ? di[bh + q0 + threadIdx.x] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < BT / 16; ++j) {  // 16 queries at a time: rows keys, columns queries
      float p[2][4], ds[2][4];
      mma_abt16<KS, LD>(p, kf, qs, j * 16, gr, t);
      mma_abt16<KS, LD>(ds, vf, gs, j * 16, gr, t);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 16 + n * 8 + t * 2 + (e & 1);
          const float pe = q0 + c < Lq ? exp2f(fmaf(p[n][e], LOG2E, -ls[c])) : 0.f;
          p[n][e] = pe;
          ds[n][e] = pe * (ds[n][e] - dis[c]);
        }
      mma_ab16<DN, LD>(acc_v, p, gs, j * 16, lane, dh);
      mma_ab16<DN, LD>(acc_k, ds, qs, j * 16, lane, dh);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = k0 + warp * 16 + gr + 8 * i;
    if (r >= Lk) continue;
    const size_t row = rows_k + (size_t)r * inner;
#pragma unroll
    for (int n = 0; n < DN; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = n * 8 + t * 2 + e;
        if (d < dh) {
          dk[row + d] = __float2bfloat16_rn(acc_k[n][2 * i + e]);
          dv[row + d] = __float2bfloat16_rn(acc_v[n][2 * i + e]);
        }
      }
  }
}

template <int DP>
cudaError_t launch_mma_dp(const bf16* q, const bf16* k, const bf16* v, const bf16* g,
                          const float* lse, const float* di, bf16* dq, bf16* dk, bf16* dv, int B,
                          int Lq, int Lk, int H, int dh, float scale, cudaStream_t stream) {
  const size_t inner = (size_t)H * dh;
  const bool vec = dh % 8 == 0 && inner % 8 == 0 && dsta::aligned16(q) && dsta::aligned16(k) &&
                   dsta::aligned16(v) && dsta::aligned16(g);
  dim3 grid_q((Lq + BT - 1) / BT, H, B), grid_k((Lk + BT - 1) / BT, H, B);
  cudaError_t err = dsta::launch_smem(flash_bwd_dq_mma_kernel<DP>, grid_q, TC_NT,
                                      mma_smem_bytes(DP), stream, q, k, v, g, lse, di, dq, Lq,
                                      Lk, H, dh, scale, vec);
  if (err != cudaSuccess) return err;
  return dsta::launch_smem(flash_bwd_dkv_mma_kernel<DP>, grid_k, TC_NT, mma_smem_bytes(DP),
                           stream, q, k, v, g, lse, di, dk, dv, Lq, Lk, H, dh, vec);
}

cudaError_t launch_mma(const bf16* q, const bf16* k, const bf16* v, const bf16* g,
                       const float* lse, const float* di, bf16* dq, bf16* dk, bf16* dv, int B,
                       int Lq, int Lk, int H, int dh, float scale, cudaStream_t s) {
  switch ((dh + 15) / 16) {
    case 1: return launch_mma_dp<16>(q, k, v, g, lse, di, dq, dk, dv, B, Lq, Lk, H, dh, scale, s);
    case 2: return launch_mma_dp<32>(q, k, v, g, lse, di, dq, dk, dv, B, Lq, Lk, H, dh, scale, s);
    case 3: return launch_mma_dp<48>(q, k, v, g, lse, di, dq, dk, dv, B, Lq, Lk, H, dh, scale, s);
    case 4: return launch_mma_dp<64>(q, k, v, g, lse, di, dq, dk, dv, B, Lq, Lk, H, dh, scale, s);
    case 5: return launch_mma_dp<80>(q, k, v, g, lse, di, dq, dk, dv, B, Lq, Lk, H, dh, scale, s);
    case 6: return launch_mma_dp<96>(q, k, v, g, lse, di, dq, dk, dv, B, Lq, Lk, H, dh, scale, s);
    case 7: return launch_mma_dp<112>(q, k, v, g, lse, di, dq, dk, dv, B, Lq, Lk, H, dh, scale, s);
    case 8: return launch_mma_dp<128>(q, k, v, g, lse, di, dq, dk, dv, B, Lq, Lk, H, dh, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---- di for the synchronous designs ----

// di[(b·H + h)·Lq + r] = Σ_d o·ḡ in f32: one warp per (b, row, head).
template <typename T>
__global__ void flash_bwd_di_kernel(const T* __restrict__ o, const T* __restrict__ g,
                                    float* __restrict__ di, int B, int Lq, int H, int dh) {
  const size_t w = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (w >= (size_t)B * Lq * H) return;
  const T* op = o + w * dh;  // [B, Lq, H, dh]: (b, r, h) is row w
  const T* gp = g + w * dh;
  float acc = 0.f;
  for (int d = lane; d < dh; d += 32) acc = fmaf(dsta::to_f32(op[d]), dsta::to_f32(gp[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  const int h = (int)(w % H), r = (int)((w / H) % Lq), b = (int)(w / ((size_t)H * Lq));
  if (lane == 0) di[((size_t)b * H + h) * Lq + r] = acc;
}

template <typename T>
cudaError_t launch_di(const T* o, const T* g, float* di, int B, int Lq, int H, int dh,
                      cudaStream_t s) {
  const size_t warps = (size_t)B * Lq * H;
  flash_bwd_di_kernel<T><<<(unsigned)((warps + 7) / 8), 256, 0, s>>>(o, g, di, B, Lq, H, dh);
  return cudaGetLastError();
}

// ---- bfloat16, wgmma fed by a TMA ring (sm_90a) ----
namespace hop = dsta::hop;

constexpr int WG_THREADS = 384;  // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int WG_ROWS = 128;     // rows a block owns: queries (dq pass) or keys (dK/dV pass)
constexpr int DQ_TILE = 64;      // keys per ring stage of the dq pass
constexpr int DKV_TILE = 64;     // queries per ring stage of the dK/dV pass
constexpr int WG_STAGES = 2;     // ring stages (4 measured no faster on the H100)
constexpr int WG_LPAD = 64;      // the scratch's rows are padded to a multiple of this
                                 // (the wrapper allocates it: cuda_flash.SCRATCH_ROWS)

template <int DH, int TILE> struct BwdWgmma {
  static constexpr int NB = (DH + 63) / 64;
  static constexpr int KS = (DH + 15) / 16;
  static constexpr int OWN_BYTES = WG_ROWS * 128 * NB;  // one of the two tiles a block owns
  static constexpr int TILE_BYTES = TILE * 128 * NB;     // one of the two streamed tiles
  // a stage: the two streamed tiles, then (dK/dV pass) lse·log2(e) and di of
  // the tile's queries
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES + 1024;
  static constexpr int BAR_OFF = 2 * OWN_BYTES + WG_STAGES * STAGE_BYTES;
  static constexpr int SMEM = BAR_OFF + 64 + WG_ROWS * 4 + 1024;  // barriers, di, slack
};

// The ring of both passes: full / empty barriers per stage, one for the owned tiles.
struct Ring {
  uint64_t *full, *empty, *own;
};

__device__ __forceinline__ Ring ring_init(unsigned char* bars) {
  Ring r{reinterpret_cast<uint64_t*>(bars), reinterpret_cast<uint64_t*>(bars) + WG_STAGES,
         reinterpret_cast<uint64_t*>(bars) + 2 * WG_STAGES};
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < WG_STAGES; ++s) {
      hop::mbar_init(&r.full[s], 1);
      hop::mbar_init(&r.empty[s], 256);  // every consumer thread releases the stage
    }
    hop::mbar_init(r.own, 1);
    hop::fence_barrier_init();
  }
  __syncthreads();
  return r;
}

template <int DH>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tg,
                          const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                          const bf16* __restrict__ o, const bf16* __restrict__ g,
                          const float* __restrict__ lse, float* __restrict__ scratch,
                          bf16* __restrict__ dq, int Lq, int Lk, int H, int Lpad, float scale) {
  using C = BwdWgmma<DH, DQ_TILE>;
  constexpr int NB = C::NB, NS = DQ_TILE / 2, ND = DH / 2, KT = DQ_TILE / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* const base = hop::align1024(smem_raw);
  unsigned char* const qs = base;                  // [NB][128 rows][128 B]
  unsigned char* const gs = base + C::OWN_BYTES;
  unsigned char* const ring = base + 2 * C::OWN_BYTES;  // stage s: K, then V
  float* const dis = reinterpret_cast<float*>(base + C::BAR_OFF + 64);  // [128] di of the rows
  const Ring r = ring_init(base + C::BAR_OFF);

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * WG_ROWS;
  const int nk = (Lk + DQ_TILE - 1) / DQ_TILE;
  const int wg = threadIdx.x / 128;
  const size_t bh = (size_t)b * H + h, BH = (size_t)gridDim.z * H;

  if (wg == 2) {  // producer
    hop::reg_dealloc<24>();
    if (threadIdx.x == 256) {
      hop::mbar_expect_tx(r.own, 2 * C::OWN_BYTES);
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        hop::tma_load_4d(qs + c * WG_ROWS * 128, &tq, r.own, 64 * c, h, q0, b);
        hop::tma_load_4d(gs + c * WG_ROWS * 128, &tg, r.own, 64 * c, h, q0, b);
      }
      for (int j = 0; j < nk; ++j) {
        const int s = j % WG_STAGES;
        if (j >= WG_STAGES) hop::mbar_wait(&r.empty[s], (j / WG_STAGES - 1) & 1);
        unsigned char* const kt = ring + s * C::STAGE_BYTES;
        hop::mbar_expect_tx(&r.full[s], 2 * C::TILE_BYTES);
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          hop::tma_load_4d(kt + c * DQ_TILE * 128, &tk, &r.full[s], 64 * c, h, j * DQ_TILE, b);
          hop::tma_load_4d(kt + C::TILE_BYTES + c * DQ_TILE * 128, &tv, &r.full[s], 64 * c, h,
                           j * DQ_TILE, b);
        }
      }
    }
  } else {  // consumers: warpgroup wg owns queries q0 + 64 wg + [0, 64)
    hop::reg_alloc<240>();
    const size_t inner = (size_t)H * DH;
    {  // di = Σ_d o·ḡ of the block's 128 rows: two threads per row
      const int row = q0 + threadIdx.x / 2, half = threadIdx.x % 2;
      float acc = 0.f;
      if (row < Lq) {
        const size_t off = ((size_t)b * Lq + row) * inner + (size_t)h * DH + half * (DH / 2);
#pragma unroll
        for (int d = 0; d < DH / 2; d += 2) {
          const float2 of = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o + off + d));
          const float2 gf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g + off + d));
          acc = fmaf(of.x, gf.x, acc);
          acc = fmaf(of.y, gf.y, acc);
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (half == 0) {
        dis[threadIdx.x / 2] = acc;
        if (row < Lpad) {
          scratch[bh * Lpad + row] = row < Lq ? lse[bh * Lq + row] * LOG2E : 0.f;
          scratch[(BH + bh) * Lpad + row] = acc;
        }
      }
      hop::named_sync(1, 256);
    }
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32, t = lane % 4;
    const int lr = wg * 64 + warp * 16 + lane / 4;  // block rows lr, lr + 8
    const unsigned char* const qw = qs + wg * 64 * 128;
    const unsigned char* const gw = gs + wg * 64 * 128;
    float lse2[2], di_r[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + lr + 8 * i;
      lse2[i] = row < Lq ? lse[bh * Lq + row] * LOG2E : 0.f;
      di_r[i] = dis[lr + 8 * i];
    }
    float sc[NS], dp[NS], acc[ND];
    uint32_t da[KT][4] = {};
#pragma unroll
    for (int i = 0; i < NS; ++i) sc[i] = dp[i] = 0.f;
#pragma unroll
    for (int i = 0; i < ND; ++i) acc[i] = 0.f;
    hop::mbar_wait(r.own, 0);

    for (int j = 0; j < nk; ++j) {
      const int st = j % WG_STAGES;
      const unsigned char* const kt = ring + st * C::STAGE_BYTES;
      const unsigned char* const vt = kt + C::TILE_BYTES;
      hop::mbar_wait(&r.full[st], (j / WG_STAGES) & 1);
      hop::fence_regs(sc);
      hop::fence_regs(dp);
      hop::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < C::KS; ++ks)
        hop::Wgmma<DQ_TILE>::ss(sc, hop::desc_kmajor(qw, WG_ROWS, ks),
                                hop::desc_kmajor(kt, DQ_TILE, ks), ks > 0);
#pragma unroll
      for (int ks = 0; ks < C::KS; ++ks)
        hop::Wgmma<DQ_TILE>::ss(dp, hop::desc_kmajor(gw, WG_ROWS, ks),
                                hop::desc_kmajor(vt, DQ_TILE, ks), ks > 0);
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(sc);
      hop::fence_regs(dp);
      // element i: row lr + 8·((i >> 1) & 1), key 8·(i / 4) + 2t + (i & 1) of the tile
      const int k0 = j * DQ_TILE;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int rr = (i >> 1) & 1;
        const bool ok = k0 + 8 * (i / 4) + 2 * t + (i & 1) < Lk;
        const float pe = ok ? hop::exp2_ftz(fmaf(sc[i], LOG2E, -lse2[rr])) : 0.f;
        sc[i] = pe * (dp[i] - di_r[rr]);  // ds
      }
      hop::acc_to_a(da, sc);
      hop::fence_regs(acc);
      hop::fence_regs(da);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) hop::Wgmma<DH>::rs(acc, da[kk], hop::desc_mnmajor(kt, DQ_TILE, kk));
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(acc);
      hop::fence_regs(da);
      hop::mbar_arrive(&r.empty[st]);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + lr + 8 * i;
      if (row >= Lq) continue;
      bf16* const out = dq + ((size_t)b * Lq + row) * inner + (size_t)h * DH + 2 * t;
#pragma unroll
      for (int c = 0; c < DH / 8; ++c)
        *reinterpret_cast<uint32_t*>(out + 8 * c) =
            pack_bf16(dsta::round_to<bf16>(acc[4 * c + 2 * i]) * scale,
                      dsta::round_to<bf16>(acc[4 * c + 2 * i + 1]) * scale);
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tg,
                           const float* __restrict__ scratch, bf16* __restrict__ dk,
                           bf16* __restrict__ dv, int Lq, int Lk, int H, int Lpad) {
  using C = BwdWgmma<DH, DKV_TILE>;
  constexpr int NB = C::NB, NS = DKV_TILE / 2, ND = DH / 2, KT = DKV_TILE / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* const base = hop::align1024(smem_raw);
  unsigned char* const ks = base;                  // [NB][128 keys][128 B]
  unsigned char* const vs = base + C::OWN_BYTES;
  unsigned char* const ring = base + 2 * C::OWN_BYTES;  // stage s: q, ḡ, lse·log2(e), di
  const Ring r = ring_init(base + C::BAR_OFF);

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * WG_ROWS;
  const int nq = (Lq + DKV_TILE - 1) / DKV_TILE;
  const int wg = threadIdx.x / 128;
  const size_t bh = (size_t)b * H + h, BH = (size_t)gridDim.z * H;

  if (wg == 2) {  // producer
    hop::reg_dealloc<24>();
    if (threadIdx.x == 256) {
      hop::mbar_expect_tx(r.own, 2 * C::OWN_BYTES);
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        hop::tma_load_4d(ks + c * WG_ROWS * 128, &tk, r.own, 64 * c, h, k0, b);
        hop::tma_load_4d(vs + c * WG_ROWS * 128, &tv, r.own, 64 * c, h, k0, b);
      }
      for (int i = 0; i < nq; ++i) {
        const int s = i % WG_STAGES;
        if (i >= WG_STAGES) hop::mbar_wait(&r.empty[s], (i / WG_STAGES - 1) & 1);
        unsigned char* const qt = ring + s * C::STAGE_BYTES;
        hop::mbar_expect_tx(&r.full[s], 2 * C::TILE_BYTES + 2 * DKV_TILE * 4);
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          hop::tma_load_4d(qt + c * DKV_TILE * 128, &tq, &r.full[s], 64 * c, h, i * DKV_TILE, b);
          hop::tma_load_4d(qt + C::TILE_BYTES + c * DKV_TILE * 128, &tg, &r.full[s], 64 * c, h,
                           i * DKV_TILE, b);
        }
        unsigned char* const sl = qt + 2 * C::TILE_BYTES;
        hop::bulk_load(sl, scratch + bh * Lpad + i * DKV_TILE, DKV_TILE * 4, &r.full[s]);
        hop::bulk_load(sl + 512, scratch + (BH + bh) * Lpad + i * DKV_TILE, DKV_TILE * 4, &r.full[s]);
      }
    }
  } else {  // consumers: warpgroup wg owns keys k0 + 64 wg + [0, 64)
    hop::reg_alloc<240>();
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32, t = lane % 4;
    const int lr = wg * 64 + warp * 16 + lane / 4;  // block rows (keys) lr, lr + 8
    const unsigned char* const kw = ks + wg * 64 * 128;
    const unsigned char* const vw = vs + wg * 64 * 128;
    float sc[NS], dp[NS], acc_k[ND], acc_v[ND];
    uint32_t pa[KT][4] = {}, da[KT][4] = {};
#pragma unroll
    for (int i = 0; i < NS; ++i) sc[i] = dp[i] = 0.f;
#pragma unroll
    for (int i = 0; i < ND; ++i) acc_k[i] = acc_v[i] = 0.f;
    hop::mbar_wait(r.own, 0);

    for (int i = 0; i < nq; ++i) {
      const int st = i % WG_STAGES;
      const unsigned char* const qt = ring + st * C::STAGE_BYTES;
      const unsigned char* const gt = qt + C::TILE_BYTES;
      const float* const ls = reinterpret_cast<const float*>(qt + 2 * C::TILE_BYTES);
      const float* const dis = ls + 128;
      hop::mbar_wait(&r.full[st], (i / WG_STAGES) & 1);
      hop::fence_regs(sc);
      hop::fence_regs(dp);
      hop::wgmma_fence();
#pragma unroll
      for (int s = 0; s < C::KS; ++s)
        hop::Wgmma<DKV_TILE>::ss(sc, hop::desc_kmajor(kw, WG_ROWS, s),
                                hop::desc_kmajor(qt, DKV_TILE, s), s > 0);
#pragma unroll
      for (int s = 0; s < C::KS; ++s)
        hop::Wgmma<DKV_TILE>::ss(dp, hop::desc_kmajor(vw, WG_ROWS, s),
                                hop::desc_kmajor(gt, DKV_TILE, s), s > 0);
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(sc);
      hop::fence_regs(dp);
      // element e: key lr + 8·((e >> 1) & 1), query c = 8·(e / 4) + 2t + (e & 1) of the tile
      const int q0 = i * DKV_TILE;
#pragma unroll
      for (int e = 0; e < NS; ++e) {
        const int c = 8 * (e / 4) + 2 * t + (e & 1);
        const float pe = q0 + c < Lq ? hop::exp2_ftz(fmaf(sc[e], LOG2E, -ls[c])) : 0.f;
        sc[e] = pe;
        dp[e] = pe * (dp[e] - dis[c]);  // ds
      }
      hop::acc_to_a(pa, sc);
      hop::acc_to_a(da, dp);
      hop::fence_regs(acc_k);
      hop::fence_regs(acc_v);
      hop::fence_regs(pa);
      hop::fence_regs(da);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) hop::Wgmma<DH>::rs(acc_v, pa[kk], hop::desc_mnmajor(gt, DKV_TILE, kk));
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) hop::Wgmma<DH>::rs(acc_k, da[kk], hop::desc_mnmajor(qt, DKV_TILE, kk));
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(acc_k);
      hop::fence_regs(acc_v);
      hop::fence_regs(pa);
      hop::fence_regs(da);
      hop::mbar_arrive(&r.empty[st]);
    }

    const size_t inner = (size_t)H * DH;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = k0 + lr + 8 * i;
      if (row >= Lk) continue;
      const size_t off = ((size_t)b * Lk + row) * inner + (size_t)h * DH + 2 * t;
#pragma unroll
      for (int c = 0; c < DH / 8; ++c) {
        *reinterpret_cast<uint32_t*>(dk + off + 8 * c) =
            pack_bf16(acc_k[4 * c + 2 * i], acc_k[4 * c + 2 * i + 1]);
        *reinterpret_cast<uint32_t*>(dv + off + 8 * c) =
            pack_bf16(acc_v[4 * c + 2 * i], acc_v[4 * c + 2 * i + 1]);
      }
    }
  }
}

template <int DH>
cudaError_t launch_wgmma_dh(const bf16* q, const bf16* k, const bf16* v, const bf16* g,
                            const bf16* o, const float* lse, float* scratch, bf16* dq, bf16* dk,
                            bf16* dv, int B, int Lq, int Lk, int H, float scale, cudaStream_t s) {
  CUtensorMap own_q, own_g, tile_k, tile_v, own_k, own_v, tile_q, tile_g;
  cudaError_t err = hop::head_map(&own_q, q, B, Lq, H, DH, WG_ROWS);
  if (err == cudaSuccess) err = hop::head_map(&own_g, g, B, Lq, H, DH, WG_ROWS);
  if (err == cudaSuccess) err = hop::head_map(&tile_k, k, B, Lk, H, DH, DQ_TILE);
  if (err == cudaSuccess) err = hop::head_map(&tile_v, v, B, Lk, H, DH, DQ_TILE);
  if (err == cudaSuccess) err = hop::head_map(&own_k, k, B, Lk, H, DH, WG_ROWS);
  if (err == cudaSuccess) err = hop::head_map(&own_v, v, B, Lk, H, DH, WG_ROWS);
  if (err == cudaSuccess) err = hop::head_map(&tile_q, q, B, Lq, H, DH, DKV_TILE);
  if (err == cudaSuccess) err = hop::head_map(&tile_g, g, B, Lq, H, DH, DKV_TILE);
  if (err != cudaSuccess) return err;
  const int Lpad = (Lq + WG_LPAD - 1) / WG_LPAD * WG_LPAD;
  err = dsta::launch_smem(flash_bwd_dq_wgmma_kernel<DH>, dim3((Lq + WG_ROWS - 1) / WG_ROWS, H, B),
                          WG_THREADS, BwdWgmma<DH, DQ_TILE>::SMEM, s, own_q, own_g, tile_k, tile_v, o, g, lse,
                          scratch, dq, Lq, Lk, H, Lpad, scale);
  if (err != cudaSuccess) return err;
  return dsta::launch_smem(flash_bwd_dkv_wgmma_kernel<DH>, dim3((Lk + WG_ROWS - 1) / WG_ROWS, H, B),
                           WG_THREADS, BwdWgmma<DH, DKV_TILE>::SMEM, s, own_k, own_v, tile_q, tile_g,
                           static_cast<const float*>(scratch), dk, dv, Lq, Lk, H, Lpad);
}

cudaError_t launch_wgmma(const bf16* q, const bf16* k, const bf16* v, const bf16* g, const bf16* o,
                         const float* lse, float* scratch, bf16* dq, bf16* dk, bf16* dv, int B,
                         int Lq, int Lk, int H, int dh, float scale, cudaStream_t s) {
  switch (dh) {
    case 40: return launch_wgmma_dh<40>(q, k, v, g, o, lse, scratch, dq, dk, dv, B, Lq, Lk, H, scale, s);
    case 64: return launch_wgmma_dh<64>(q, k, v, g, o, lse, scratch, dq, dk, dv, B, Lq, Lk, H, scale, s);
    case 80: return launch_wgmma_dh<80>(q, k, v, g, o, lse, scratch, dq, dk, dv, B, Lq, Lk, H, scale, s);
    case 128: return launch_wgmma_dh<128>(q, k, v, g, o, lse, scratch, dq, dk, dv, B, Lq, Lk, H, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (pre-scaled), g, o [B, Lq, H*dh]; k, v [B, Lk, H*dh]; lse [B*H, Lq] f32;
// dq like q, dk / dv like k, in the inputs' dtype; all contiguous.  `scale`
// is the pre-scale of q, applied to dq (its chain rule).  scratch: f32,
// 2·B·H·Lpad floats (Lpad = Lq rounded up to 64), for di (and lse·log2(e)).
// design: 1 wgmma (bf16 only), 0 the synchronous designs.
extern "C" int dsta_flash_bwd(int dtype, int design, const void* q, const void* k, const void* v,
                              const void* g, const void* o, const void* lse, void* scratch,
                              void* dq, void* dk, void* dv, int B, int Lq, int Lk, int H, int dh,
                              float scale, void* stream) {
  if (dh < 1 || dh > DMAX || Lq < 1 || Lk < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(scratch);
  if (design == 1) {
    if (dtype != dsta::kBF16) return (int)cudaErrorInvalidValue;
    return (int)launch_wgmma(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                             static_cast<const bf16*>(v), static_cast<const bf16*>(g),
                             static_cast<const bf16*>(o), l, d, static_cast<bf16*>(dq),
                             static_cast<bf16*>(dk), static_cast<bf16*>(dv), B, Lq, Lk, H, dh,
                             scale, s);
  }
  if (dtype == dsta::kF32) {
    const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
                *vf = static_cast<const float*>(v), *gf = static_cast<const float*>(g);
    cudaError_t err = launch_di(static_cast<const float*>(o), gf, d, B, Lq, H, dh, s);
    if (err != cudaSuccess) return (int)err;
    const size_t smem = simt_smem_bytes(dh);
    err = dsta::launch_smem(flash_bwd_dq_simt_kernel, dim3((Lq + BT - 1) / BT, H, B), NT, smem, s,
                            qf, kf, vf, gf, l, static_cast<const float*>(d),
                            static_cast<float*>(dq), Lq, Lk, H, dh, scale);
    if (err != cudaSuccess) return (int)err;
    return (int)dsta::launch_smem(flash_bwd_dkv_simt_kernel, dim3((Lk + BT - 1) / BT, H, B), NT,
                                  smem, s, qf, kf, vf, gf, l, static_cast<const float*>(d),
                                  static_cast<float*>(dk), static_cast<float*>(dv), Lq, Lk, H, dh);
  }
  if (dtype == dsta::kBF16) {
    const cudaError_t err = launch_di(static_cast<const bf16*>(o), static_cast<const bf16*>(g), d,
                                      B, Lq, H, dh, s);
    if (err != cudaSuccess) return (int)err;
    return (int)launch_mma(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                           static_cast<const bf16*>(v), static_cast<const bf16*>(g), l, d,
                           static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                           B, Lq, Lk, H, dh, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
