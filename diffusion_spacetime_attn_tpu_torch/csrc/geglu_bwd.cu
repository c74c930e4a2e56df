// Fused GEGLU feed-forward backward, dx only.
//
// Replaces the Pallas TPU kernel `ops/pallas_geglu.py:_ff_bwd_kernel` (launched
// by `_ff_dx_local`) of the JAX package.  With W1 = [W1h; W1g] and W2 in the
// torch layout ([2·inner, dim] and [dim, inner]) and dy the output cotangent:
//
//   h  = x·W1hᵀ + b1h,   g = x·W1gᵀ + b1g            (recomputed, f32)
//   du = dy·W2                                         [M, inner]
//   dh = du·gelu(g),     dg = du·h·gelu′(g)            rounded to x's dtype
//   dx = dh·W1h + dg·W1g
//
// with gelu′(g) = Φ(g) + g·φ(g) (exact erf), f32 accumulation, and none of
// h, g, du, dh, dg written to device memory.  The chain differentiates the
// blend weights only, so dx is the only cotangent of the hot path; dW and db
// are plain products in the wrapper.
//
// Bound on the H100: 10·M·dim·inner FLOPs (five products) against two [M, dim]
// activations in, one out and the weights: bound by operations at SD levels
// 0-2, by the weights at the mid block.
//
// Same grid and reduction as the forward (`geglu_fwd.cu`): block (64-row tile,
// inner chunk) recomputes h, g and du for its chunk one 64-column sub-tile at
// a time, keeps dh and dg for the whole chunk in shared memory, multiplies
// them by the chunk's rows of W1h and W1g, and writes its partial dx to its
// chunk's own f32 slice of the scratch ([chunks, M, dim]); `sum_slices_kernel`
// (common.cuh) sums the slices in chunk order, so the result is a fixed
// function of the inputs.  Both remaining products are NN in this layout
// (du = dy·W2, dx = dh·W1h): their B tiles are row-major [k][n] and reach the
// tensor cores through ldmatrix.trans.
//
// bf16 runs on the tensor cores (mma.sync m16n8k16, 4 warps of 16 rows) and
// takes widths that are multiples of 8 and 16-byte aligned operands; float32
// runs on the CUDA cores (256 threads, 4x4 outputs each, chunks of 64).
#include "common.cuh"

namespace {

constexpr float kInvSqrt2 = 0.70710678118654752f;
constexpr float kInvSqrt2Pi = 0.39894228040143268f;

// (dh, dg) from the recomputed h, g and du, before rounding
__device__ __forceinline__ void geglu_grads(float h, float g, float du, float& dh, float& dg) {
  const float c = 0.5f * (1.f + erff(g * kInvSqrt2));   // Φ(g) = gelu(g) / g
  const float phi = expf(-0.5f * g * g) * kInvSqrt2Pi;  // φ(g)
  dh = du * (g * c);
  dg = du * (h * (c + g * phi));
}

// ---- CUDA cores (float32) ----
constexpr int BM = 64;   // rows per block
constexpr int BI = 64;   // inner columns per block
constexpr int BK = 32;   // reduction step over dim
constexpr int BD = 64;   // output columns per W1 tile
constexpr int NT = 256;
constexpr int LDA = 65;  // padded leading dim (conflict-free smem)

// phase 1: xs, dys, whs, wgs [BK][65] and w2s [BK][65]; phase 3 aliases them
// with the W1h / W1g tiles [BI][65] each; dhs, dgs [BI][65] live after.
constexpr int PHASE1_FLOATS = 5 * BK * LDA;
constexpr int W1_FLOATS = 2 * BI * LDA;
constexpr int REGION0 = PHASE1_FLOATS > W1_FLOATS ? PHASE1_FLOATS : W1_FLOATS;
constexpr int SMEM_FLOATS = REGION0 + 2 * BI * LDA;

__global__ void __launch_bounds__(NT)
geglu_dx_partial_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                        const float* __restrict__ b1, const float* __restrict__ w2,
                        const float* __restrict__ dy, float* __restrict__ scratch, int M,
                        int dim, int inner) {
  extern __shared__ float smem[];
  float* xs = smem;                // [BK][BM+1]  x tile, k-major
  float* dys = xs + BK * LDA;      // [BK][BM+1]  dy tile, k-major
  float* whs = dys + BK * LDA;     // [BK][BI+1]  W1h tile, k-major
  float* wgs = whs + BK * LDA;     // [BK][BI+1]  W1g tile, k-major
  float* w2s = wgs + BK * LDA;     // [BK][BI+1]  W2 tile [d][i]
  float* w1hs = smem;              // [BI][BD+1]  W1h rows i, columns d (phase 3)
  float* w1gs = smem + BI * LDA;   // [BI][BD+1]  W1g rows i, columns d (phase 3)
  float* dhs = smem + REGION0;     // [BI][BM+1]  dh, k-major
  float* dgs = dhs + BI * LDA;     // [BI][BM+1]  dg, k-major

  const int m0 = blockIdx.x * BM, i0 = blockIdx.y * BI;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float* partial = scratch + (size_t)blockIdx.y * M * dim;  // this chunk's slice

  // ---- phase 1: h, g = x·W1ᵀ and du = dy·W2 over the reduction axis dim ----
  float hacc[4][4], gacc[4][4], dacc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) hacc[i][j] = gacc[i][j] = dacc[i][j] = 0.f;

  for (int k0 = 0; k0 < dim; k0 += BK) {
    for (int idx = tid; idx < BM * BK; idx += NT) {
      const int r = idx / BK, k = idx % BK;
      const bool kok = k0 + k < dim;
      const bool rok = kok && m0 + r < M;
      xs[k * LDA + r] = rok ? x[(size_t)(m0 + r) * dim + k0 + k] : 0.f;
      dys[k * LDA + r] = rok ? dy[(size_t)(m0 + r) * dim + k0 + k] : 0.f;
      const bool cok = kok && i0 + r < inner;  // r doubles as the inner column (BI == BM)
      whs[k * LDA + r] = cok ? w1[(size_t)(i0 + r) * dim + k0 + k] : 0.f;
      wgs[k * LDA + r] = cok ? w1[(size_t)(inner + i0 + r) * dim + k0 + k] : 0.f;
    }
    for (int idx = tid; idx < BK * BI; idx += NT) {
      const int k = idx / BI, c = idx % BI;
      w2s[k * LDA + c] = (k0 + k < dim && i0 + c < inner)
                             ? w2[(size_t)(k0 + k) * inner + i0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
      float a[4], da[4], bh[4], bg[4], bw[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = xs[k * LDA + ty * 4 + i];
        da[i] = dys[k * LDA + ty * 4 + i];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bh[j] = whs[k * LDA + tx + 16 * j];
        bg[j] = wgs[k * LDA + tx + 16 * j];
        bw[j] = w2s[k * LDA + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          hacc[i][j] = fmaf(a[i], bh[j], hacc[i][j]);
          gacc[i][j] = fmaf(a[i], bg[j], gacc[i][j]);
          dacc[i][j] = fmaf(da[i], bw[j], dacc[i][j]);
        }
    }
    __syncthreads();
  }

  // ---- phase 2: dh, dg ----
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = tx + 16 * j;
    const bool cok = i0 + c < inner;
    const float bh = cok ? b1[i0 + c] : 0.f;
    const float bg = cok ? b1[inner + i0 + c] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float dh, dg;
      geglu_grads(hacc[i][j] + bh, gacc[i][j] + bg, dacc[i][j], dh, dg);
      dhs[c * LDA + ty * 4 + i] = cok ? dh : 0.f;
      dgs[c * LDA + ty * 4 + i] = cok ? dg : 0.f;
    }
  }

  // ---- phase 3: partial[rows, :] = dh·W1h[i0:i0+BI, :] + dg·W1g[i0:i0+BI, :] ----
  const float* w1g = w1 + (size_t)inner * dim;
  for (int d0 = 0; d0 < dim; d0 += BD) {
    __syncthreads();  // dhs / dgs written; the previous W1 tiles consumed
    for (int idx = tid; idx < BI * BD; idx += NT) {
      const int k = idx / BD, dc = idx % BD;
      const bool ok = i0 + k < inner && d0 + dc < dim;
      const size_t o = (size_t)(i0 + k) * dim + d0 + dc;
      w1hs[k * LDA + dc] = ok ? w1[o] : 0.f;
      w1gs[k * LDA + dc] = ok ? w1g[o] : 0.f;
    }
    __syncthreads();
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int k = 0; k < BI; ++k) {
      float ah[4], ag[4], bh[4], bg[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ah[i] = dhs[k * LDA + ty * 4 + i];
        ag[i] = dgs[k * LDA + ty * 4 + i];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bh[j] = w1hs[k * LDA + tx + 16 * j];
        bg[j] = w1gs[k * LDA + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fmaf(ag[i], bg[j], fmaf(ah[i], bh[j], acc[i][j]));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = m0 + ty * 4 + i;
      if (r >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = d0 + tx + 16 * j;
        if (d < dim) partial[(size_t)r * dim + d] = acc[i][j];
      }
    }
  }
}

// ---- bfloat16: tensor cores ----
using dsta::bf16;
using dsta::ld_pair;
using dsta::ldmatrix_x2_trans;
using dsta::load_tile_bf16;
using dsta::mma_bf16;

constexpr int TC_BM = 64;   // rows per block: 4 warps x 16
constexpr int TC_BK = 32;   // reduction step over dim (phase 1)
constexpr int TC_SUB = 64;  // inner columns per sub-tile (phase 1), k step (phase 3)
constexpr int TC_BD = 64;   // output columns per W1 tile (phase 3)
constexpr int TC_NT = 128;
constexpr int LDK = TC_BK + 8;   // x / dy / W1 staging rows
constexpr int LDN = TC_SUB + 8;  // W2 [k][n] and W1 [k][n] tiles

template <int CHUNK>
__host__ __device__ constexpr int dx_smem_elems() {
  constexpr int stage = 4 * TC_BM * LDK + TC_BK * LDN;  // xs, dys, whs, wgs, w2s
  constexpr int w1 = 2 * TC_SUB * LDN;                  // w1hs, w1gs
  return (stage > w1 ? stage : w1) + 2 * TC_BM * (CHUNK + 8);
}

template <int CHUNK>  // inner columns per block
__global__ void __launch_bounds__(TC_NT)
geglu_dx_partial_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                            const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                            const bf16* __restrict__ dy, float* __restrict__ scratch, int M,
                            int dim, int inner) {
  constexpr int LDU = CHUNK + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [TC_BM][LDK]   x tile
  bf16* dys = xs + TC_BM * LDK;                   // [TC_BM][LDK]   dy tile
  bf16* whs = dys + TC_BM * LDK;                  // [TC_SUB][LDK]  W1h rows
  bf16* wgs = whs + TC_SUB * LDK;                 // [TC_SUB][LDK]  W1g rows
  bf16* w2s = wgs + TC_SUB * LDK;                 // [TC_BK][LDN]   W2 [d][i]
  bf16* w1hs = xs;                                // [TC_SUB][LDN]  W1h [i][d] (phase 3)
  bf16* w1gs = xs + TC_SUB * LDN;                 // [TC_SUB][LDN]  W1g [i][d] (phase 3)
  bf16* dhs = xs + (dx_smem_elems<CHUNK>() - 2 * TC_BM * LDU);  // [TC_BM][LDU]
  bf16* dgs = dhs + TC_BM * LDU;                                 // [TC_BM][LDU]

  const int m0 = blockIdx.x * TC_BM, i0 = blockIdx.y * CHUNK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wr = warp * 16;  // this warp's rows in the tile
  const bf16* w1g = w1 + (size_t)inner * dim;
  float* partial = scratch + (size_t)blockIdx.y * M * dim;  // this chunk's slice

  // ---- phases 1-2 per sub-tile: h, g = x·W1ᵀ, du = dy·W2; then dh, dg ----
  for (int sub = 0; sub < CHUNK / TC_SUB; ++sub) {
    const int c0 = i0 + sub * TC_SUB;
    float hacc[TC_SUB / 8][4], gacc[TC_SUB / 8][4], dacc[TC_SUB / 8][4];
#pragma unroll
    for (int n = 0; n < TC_SUB / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) hacc[n][e] = gacc[n][e] = dacc[n][e] = 0.f;

    for (int k0 = 0; k0 < dim; k0 += TC_BK) {
      __syncthreads();  // the previous step's tiles are no longer read
      load_tile_bf16<TC_BM, TC_BK, TC_NT>(xs, x, m0, M, k0, dim, dim, true);
      load_tile_bf16<TC_BM, TC_BK, TC_NT>(dys, dy, m0, M, k0, dim, dim, true);
      load_tile_bf16<TC_SUB, TC_BK, TC_NT>(whs, w1, c0, inner, k0, dim, dim, true);
      load_tile_bf16<TC_SUB, TC_BK, TC_NT>(wgs, w1g, c0, inner, k0, dim, dim, true);
      load_tile_bf16<TC_BK, TC_SUB, TC_NT>(w2s, w2, k0, dim, c0, inner, inner, true);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < TC_BK / 16; ++kk) {
        const bf16* xr = xs + (wr + g) * LDK + kk * 16 + t * 2;
        const uint32_t a[4] = {ld_pair(xr), ld_pair(xr + 8 * LDK), ld_pair(xr + 8),
                               ld_pair(xr + 8 * LDK + 8)};
        const bf16* dr = dys + (wr + g) * LDK + kk * 16 + t * 2;
        const uint32_t da[4] = {ld_pair(dr), ld_pair(dr + 8 * LDK), ld_pair(dr + 8),
                                ld_pair(dr + 8 * LDK + 8)};
        const bf16* w2r = w2s + (kk * 16 + (lane & 15)) * LDN;
#pragma unroll
        for (int n = 0; n < TC_SUB / 8; ++n) {
          const int off = (n * 8 + g) * LDK + kk * 16 + t * 2;
          mma_bf16(hacc[n], a, ld_pair(whs + off), ld_pair(whs + off + 8));
          mma_bf16(gacc[n], a, ld_pair(wgs + off), ld_pair(wgs + off + 8));
          uint32_t b0, b1v;
          ldmatrix_x2_trans(b0, b1v, w2r + n * 8);
          mma_bf16(dacc[n], da, b0, b1v);
        }
      }
    }

#pragma unroll
    for (int n = 0; n < TC_SUB / 8; ++n) {
      const int col = n * 8 + t * 2;  // and col + 1
      float bh[2], bg[2];
      bool ok[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ic = c0 + col + e;
        ok[e] = ic < inner;
        bh[e] = ok[e] ? __bfloat162float(b1[ic]) : 0.f;
        bg[e] = ok[e] ? __bfloat162float(b1[inner + ic]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // rows g and g + 8
        float dh[2], dg[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          geglu_grads(hacc[n][2 * i + e] + bh[e], gacc[n][2 * i + e] + bg[e], dacc[n][2 * i + e],
                      dh[e], dg[e]);
          if (!ok[e]) dh[e] = dg[e] = 0.f;
        }
        const int o = (wr + g + 8 * i) * LDU + sub * TC_SUB + col;
        *reinterpret_cast<__nv_bfloat162*>(dhs + o) = __floats2bfloat162_rn(dh[0], dh[1]);
        *reinterpret_cast<__nv_bfloat162*>(dgs + o) = __floats2bfloat162_rn(dg[0], dg[1]);
      }
    }
  }

  // ---- phase 3: partial = dh·W1h[i0:i0+CHUNK, :] + dg·W1g[i0:i0+CHUNK, :] ----
  for (int d0 = 0; d0 < dim; d0 += TC_BD) {
    float acc[TC_BD / 8][4];
#pragma unroll
    for (int n = 0; n < TC_BD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    for (int kb = 0; kb < CHUNK; kb += TC_SUB) {
      __syncthreads();  // dhs / dgs written; staging tiles / previous W1 tiles no longer read
      load_tile_bf16<TC_SUB, TC_BD, TC_NT>(w1hs, w1, i0 + kb, inner, d0, dim, dim, true);
      load_tile_bf16<TC_SUB, TC_BD, TC_NT>(w1gs, w1g, i0 + kb, inner, d0, dim, dim, true);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < TC_SUB / 16; ++kk) {
        const bf16* hr = dhs + (wr + g) * LDU + kb + kk * 16 + t * 2;
        const uint32_t ah[4] = {ld_pair(hr), ld_pair(hr + 8 * LDU), ld_pair(hr + 8),
                                ld_pair(hr + 8 * LDU + 8)};
        const bf16* gr = dgs + (wr + g) * LDU + kb + kk * 16 + t * 2;
        const uint32_t ag[4] = {ld_pair(gr), ld_pair(gr + 8 * LDU), ld_pair(gr + 8),
                                ld_pair(gr + 8 * LDU + 8)};
        const bf16* w1hr = w1hs + (kk * 16 + (lane & 15)) * LDN;
        const bf16* w1gr = w1gs + (kk * 16 + (lane & 15)) * LDN;
#pragma unroll
        for (int n = 0; n < TC_BD / 8; ++n) {
          uint32_t b0, b1v;
          ldmatrix_x2_trans(b0, b1v, w1hr + n * 8);
          mma_bf16(acc[n], ah, b0, b1v);
          ldmatrix_x2_trans(b0, b1v, w1gr + n * 8);
          mma_bf16(acc[n], ag, b0, b1v);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < TC_BD / 8; ++n) {
      const int col = d0 + n * 8 + t * 2;  // dim is a multiple of 8, so col + 1 < dim too
      if (col >= dim) continue;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = m0 + wr + g + 8 * i;
        if (r < M)
          *reinterpret_cast<float2*>(partial + (size_t)r * dim + col) =
              make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
      }
    }
  }
}

template <int CHUNK>
cudaError_t launch_mma(const bf16* x, const bf16* w1, const bf16* b1, const bf16* w2,
                       const bf16* dy, float* scratch, int M, int dim, int inner,
                       cudaStream_t stream) {
  const int smem = (int)sizeof(bf16) * dx_smem_elems<CHUNK>();
  cudaError_t err = cudaFuncSetAttribute(geglu_dx_partial_mma_kernel<CHUNK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((M + TC_BM - 1) / TC_BM, (inner + CHUNK - 1) / CHUNK);
  geglu_dx_partial_mma_kernel<CHUNK><<<grid, TC_NT, smem, stream>>>(x, w1, b1, w2, dy, scratch, M,
                                                                    dim, inner);
  return cudaGetLastError();
}

cudaError_t launch_partials(int dtype, const void* x, const void* w1, const void* b1,
                            const void* w2, const void* dy, float* scratch, int M, int dim,
                            int inner, cudaStream_t stream) {
  if (dtype == dsta::kF32) {
    const int smem = (int)sizeof(float) * SMEM_FLOATS;
    cudaError_t err = cudaFuncSetAttribute(geglu_dx_partial_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((M + BM - 1) / BM, (inner + BI - 1) / BI);
    geglu_dx_partial_kernel<<<grid, NT, smem, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(w1),
        static_cast<const float*>(b1), static_cast<const float*>(w2),
        static_cast<const float*>(dy), scratch, M, dim, inner);
    return cudaGetLastError();
  }
  if (dim % 8 || inner % 8 || !dsta::aligned16(x) || !dsta::aligned16(w1) ||
      !dsta::aligned16(w2) || !dsta::aligned16(dy))
    return cudaErrorInvalidValue;
  const bf16 *xb = static_cast<const bf16*>(x), *w1b = static_cast<const bf16*>(w1);
  const bf16 *b1b = static_cast<const bf16*>(b1), *w2b = static_cast<const bf16*>(w2);
  const bf16* dyb = static_cast<const bf16*>(dy);
  switch (dsta::geglu_chunk_width(dtype, M, inner)) {
    case 256: return launch_mma<256>(xb, w1b, b1b, w2b, dyb, scratch, M, dim, inner, stream);
    case 128: return launch_mma<128>(xb, w1b, b1b, w2b, dyb, scratch, M, dim, inner, stream);
    default: return launch_mma<64>(xb, w1b, b1b, w2b, dyb, scratch, M, dim, inner, stream);
  }
}

}  // namespace

// x, dy, dx [M, dim]; w1 [2*inner, dim]; b1 [2*inner]; w2 [dim, inner]; scratch
// [dsta_geglu_chunks(...), M, dim] float32 (the forward's chunk rule).  All
// contiguous; x, dy, weights, biases and dx share one dtype.  bfloat16 needs
// dim and inner multiples of 8 and x, w1, w2, dy 16-byte aligned.
extern "C" int dsta_geglu_dx(int dtype, const void* x, const void* w1, const void* b1,
                             const void* w2, const void* dy, void* scratch, void* dx, int M,
                             int dim, int inner, void* stream) {
  if (M < 1 || dim < 1 || inner < 1) return (int)cudaErrorInvalidValue;
  if (dtype != dsta::kF32 && dtype != dsta::kBF16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  cudaError_t err = launch_partials(dtype, x, w1, b1, w2, dy, sc, M, dim, inner, s);
  if (err != cudaSuccess) return (int)err;
  const int bi = dsta::geglu_chunk_width(dtype, M, inner);
  const int chunks = (inner + bi - 1) / bi;
  return (int)dsta::launch_sum_slices(dtype, sc, nullptr, nullptr, dx, (size_t)M * dim, dim,
                                      chunks, s);
}
