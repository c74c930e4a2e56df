// Fused GEGLU feed-forward forward.
//
// Replaces the Pallas TPU kernel `ops/pallas_geglu.py:_ff_kernel` (launched by
// `_ff_fwd_local`, public `geglu_ff`) of the JAX package:
//
//   h   = x·W1hᵀ + b1h,   g = x·W1gᵀ + b1g          (W1 = [W1h; W1g], torch layout)
//   u   = h·gelu_erf(g), rounded to x's dtype
//   out = u·W2ᵀ + b2 (+ residual)
//
// with f32 accumulation, and the gated [M, inner] intermediate never written
// to device memory.
//
// Bound on the H100: 6·M·dim·inner FLOPs against the weights and two or three
// [M, dim] activations; at SD levels 0-2 that is bound by operations, at the
// mid block (M=128 rows per prompt) by the 26 MB of weights.
//
// The TPU kernel kept an f32 [rows, dim] accumulator across inner tiles; at
// dim=1280 that is 320 KB for 64 rows, more than an SM holds, and tiling rows
// alone would leave level 2 and the mid block (M = 256..1024) with a handful
// of blocks each streaming every weight.  So the grid splits BOTH the rows
// and the inner dimension: block (row tile, inner chunk) computes its gated
// tile u in shared memory, multiplies it by the matching columns of W2, and
// stores its partial [rows, dim] product into its own f32 slice of the
// scratch ([chunks, M, dim]).  A second small kernel (`sum_slices_kernel`,
// common.cuh) sums the slices in
// chunk order, adds b2 and the residual and rounds to the output dtype, so
// the result is a fixed function of the inputs (no atomics, no run-to-run
// change of summation order).
//
// bf16 runs on the tensor cores (`geglu_partial_mma_kernel`, mma.sync
// m16n8k16, f32 accumulation, 4 warps of 16 rows): a block takes 64 rows and
// an inner chunk of 64, 128 or 256 columns, the widest that still gives the
// grid two blocks per SM.  The gate runs per 64-column sub-tile, and the bf16
// gated tile [64, chunk] stays in shared memory for the second product.  It
// takes widths that are multiples of 8 and 16-byte aligned operands, and
// rejects any other.  float32 runs on the CUDA cores (`geglu_partial_kernel`,
// chunks of 64): each of 256 threads owns a 4x4 block of every 64x64 tile.
#include "common.cuh"

namespace {

// ---- CUDA cores ----
constexpr int BM = 64;   // rows per block
constexpr int BI = 64;   // inner columns per block
constexpr int BK = 32;   // reduction step over dim
constexpr int BD = 64;   // output columns per W2 tile
constexpr int NT = 256;
constexpr int LDA = BM + 1;  // padded leading dims (conflict-free smem)

// shared memory: phase 1 (xs, whs, wgs; [BK][65] each) aliases the W2 tile
// of phase 3 ([BI][65]); us [BI][65] lives after it.
constexpr int PHASE1_FLOATS = 3 * BK * LDA;
constexpr int W2_FLOATS = BI * LDA;
constexpr int REGION0 = PHASE1_FLOATS > W2_FLOATS ? PHASE1_FLOATS : W2_FLOATS;
constexpr int SMEM_FLOATS = REGION0 + BI * LDA;

__global__ void __launch_bounds__(NT)
geglu_partial_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                     const float* __restrict__ b1, const float* __restrict__ w2,
                     float* __restrict__ scratch, int M, int dim, int inner) {
  __shared__ float smem[SMEM_FLOATS];
  float* xs = smem;                  // [BK][BM+1]   x tile, k-major
  float* whs = xs + BK * LDA;        // [BK][BI+1]   W1h tile, k-major
  float* wgs = whs + BK * LDA;       // [BK][BI+1]   W1g tile, k-major
  float* w2s = smem;                 // [BI][BD+1]   W2 tile (phase 3)
  float* us = smem + REGION0;        // [BI][BM+1]   gated tile, k-major

  const int m0 = blockIdx.x * BM, i0 = blockIdx.y * BI;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float* partial = scratch + (size_t)blockIdx.y * M * dim;  // this chunk's slice

  // ---- phase 1: h, g = x·W1ᵀ over the reduction axis dim ----
  float hacc[4][4], gacc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) hacc[i][j] = gacc[i][j] = 0.f;

  for (int k0 = 0; k0 < dim; k0 += BK) {
    for (int idx = tid; idx < BM * BK; idx += NT) {
      const int r = idx / BK, k = idx % BK;
      const bool kok = k0 + k < dim;
      xs[k * LDA + r] = (kok && m0 + r < M) ? x[(size_t)(m0 + r) * dim + k0 + k] : 0.f;
      const bool cok = kok && i0 + r < inner;  // r doubles as the inner column (BI == BM)
      whs[k * LDA + r] = cok ? w1[(size_t)(i0 + r) * dim + k0 + k] : 0.f;
      wgs[k * LDA + r] = cok ? w1[(size_t)(inner + i0 + r) * dim + k0 + k] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
      float a[4], bh[4], bg[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[k * LDA + ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bh[j] = whs[k * LDA + tx + 16 * j];
        bg[j] = wgs[k * LDA + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          hacc[i][j] = fmaf(a[i], bh[j], hacc[i][j]);
          gacc[i][j] = fmaf(a[i], bg[j], gacc[i][j]);
        }
    }
    __syncthreads();
  }

  // ---- phase 2: u = (h + b1h)·gelu_erf(g + b1g) ----
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = tx + 16 * j;
    const bool cok = i0 + c < inner;
    const float bh = cok ? b1[i0 + c] : 0.f;
    const float bg = cok ? b1[inner + i0 + c] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float hv = hacc[i][j] + bh;
      const float gv = gacc[i][j] + bg;
      const float u = hv * (0.5f * gv * (1.f + erff(gv * 0.70710678118654752f)));
      us[c * LDA + ty * 4 + i] = cok ? u : 0.f;
    }
  }

  // ---- phase 3: partial[rows, :] = u·W2[:, i0:i0+BI]ᵀ, one 64-column tile at a time ----
  for (int d0 = 0; d0 < dim; d0 += BD) {
    __syncthreads();  // us written / previous W2 tile consumed
    for (int idx = tid; idx < BD * BI; idx += NT) {
      const int dc = idx / BI, k = idx % BI;
      w2s[k * LDA + dc] = (d0 + dc < dim && i0 + k < inner)
                              ? w2[(size_t)(d0 + dc) * inner + i0 + k] : 0.f;
    }
    __syncthreads();
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int k = 0; k < BI; ++k) {
      float a[4], bw[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = us[k * LDA + ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bw[j] = w2s[k * LDA + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bw[j], acc[i][j]);
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
using dsta::load_tile_bf16;
using dsta::mma_bf16;

constexpr int TC_BM = 64;   // rows per block: 4 warps x 16
constexpr int TC_BK = 32;   // reduction step over dim
constexpr int TC_SUB = 64;  // inner columns per gate sub-tile
constexpr int TC_BD = 64;   // output columns per W2 tile
constexpr int TC_NT = 128;

template <int CHUNK>
__host__ __device__ constexpr int mma_smem_elems() {
  constexpr int stage = 3 * TC_BM * (TC_BK + 8), w2 = TC_BD * (CHUNK + 8);
  return (stage > w2 ? stage : w2) + TC_BM * (CHUNK + 8);
}

template <int CHUNK>  // inner columns per block
__global__ void __launch_bounds__(TC_NT)
geglu_partial_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                         const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                         float* __restrict__ scratch, int M, int dim, int inner) {
  constexpr int LDK = TC_BK + 8, LDU = CHUNK + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [TC_BM][LDK]   x tile
  bf16* whs = xs + TC_BM * LDK;                   // [TC_SUB][LDK]  W1h rows
  bf16* wgs = whs + TC_SUB * LDK;                 // [TC_SUB][LDK]  W1g rows
  bf16* w2s = xs;                                 // [TC_BD][LDU]   W2 tile (phase 3)
  bf16* us = xs + (mma_smem_elems<CHUNK>() - TC_BM * LDU);  // [TC_BM][LDU] gated tile

  const int m0 = blockIdx.x * TC_BM, i0 = blockIdx.y * CHUNK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wr = warp * 16;  // this warp's rows in the tile
  const bf16* w1g = w1 + (size_t)inner * dim;
  float* partial = scratch + (size_t)blockIdx.y * M * dim;  // this chunk's slice

  // ---- phases 1-2 per sub-tile: h, g = x·W1ᵀ; u = (h + b1h)·gelu_erf(g + b1g) ----
  for (int sub = 0; sub < CHUNK / TC_SUB; ++sub) {
    const int c0 = i0 + sub * TC_SUB;
    float hacc[TC_SUB / 8][4], gacc[TC_SUB / 8][4];
#pragma unroll
    for (int n = 0; n < TC_SUB / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) hacc[n][e] = gacc[n][e] = 0.f;

    for (int k0 = 0; k0 < dim; k0 += TC_BK) {
      __syncthreads();  // the previous step's tiles are no longer read
      load_tile_bf16<TC_BM, TC_BK, TC_NT>(xs, x, m0, M, k0, dim, dim, true);
      load_tile_bf16<TC_SUB, TC_BK, TC_NT>(whs, w1, c0, inner, k0, dim, dim, true);
      load_tile_bf16<TC_SUB, TC_BK, TC_NT>(wgs, w1g, c0, inner, k0, dim, dim, true);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < TC_BK / 16; ++kk) {
        const bf16* xr = xs + (wr + g) * LDK + kk * 16 + t * 2;
        const uint32_t a[4] = {ld_pair(xr), ld_pair(xr + 8 * LDK), ld_pair(xr + 8),
                               ld_pair(xr + 8 * LDK + 8)};
#pragma unroll
        for (int n = 0; n < TC_SUB / 8; ++n) {
          const int off = (n * 8 + g) * LDK + kk * 16 + t * 2;
          mma_bf16(hacc[n], a, ld_pair(whs + off), ld_pair(whs + off + 8));
          mma_bf16(gacc[n], a, ld_pair(wgs + off), ld_pair(wgs + off + 8));
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
        float u[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float hv = hacc[n][2 * i + e] + bh[e];
          const float gv = gacc[n][2 * i + e] + bg[e];
          u[e] = ok[e] ? hv * (0.5f * gv * (1.f + erff(gv * 0.70710678118654752f))) : 0.f;
        }
        *reinterpret_cast<__nv_bfloat162*>(us + (wr + g + 8 * i) * LDU + sub * TC_SUB + col) =
            __floats2bfloat162_rn(u[0], u[1]);
      }
    }
  }

  // ---- phase 3: partial[rows, :] = u·W2[:, i0:i0+CHUNK]ᵀ, one 64-column tile at a time ----
  for (int d0 = 0; d0 < dim; d0 += TC_BD) {
    __syncthreads();  // us written; the staging tiles / previous W2 tile no longer read
    load_tile_bf16<TC_BD, CHUNK, TC_NT>(w2s, w2, d0, dim, i0, inner, inner, true);
    __syncthreads();
    float acc[TC_BD / 8][4];
#pragma unroll
    for (int n = 0; n < TC_BD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < CHUNK / 16; ++kk) {
      const bf16* ur = us + (wr + g) * LDU + kk * 16 + t * 2;
      const uint32_t a[4] = {ld_pair(ur), ld_pair(ur + 8 * LDU), ld_pair(ur + 8),
                             ld_pair(ur + 8 * LDU + 8)};
#pragma unroll
      for (int n = 0; n < TC_BD / 8; ++n) {
        const bf16* wr2 = w2s + (n * 8 + g) * LDU + kk * 16 + t * 2;
        mma_bf16(acc[n], a, ld_pair(wr2), ld_pair(wr2 + 8));
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
cudaError_t launch_mma_bi(const bf16* x, const bf16* w1, const bf16* b1, const bf16* w2,
                          float* scratch, int M, int dim, int inner, cudaStream_t stream) {
  const int smem = (int)sizeof(bf16) * mma_smem_elems<CHUNK>();
  cudaError_t err = cudaFuncSetAttribute(geglu_partial_mma_kernel<CHUNK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((M + TC_BM - 1) / TC_BM, (inner + CHUNK - 1) / CHUNK);
  geglu_partial_mma_kernel<CHUNK><<<grid, TC_NT, smem, stream>>>(x, w1, b1, w2, scratch, M, dim,
                                                                inner);
  return cudaGetLastError();
}

bool tensor_core_ok(const void* x, const void* w1, const void* w2, int dim, int inner) {
  return dim % 8 == 0 && inner % 8 == 0 && dsta::aligned16(x) && dsta::aligned16(w1) &&
         dsta::aligned16(w2);
}

cudaError_t launch_partials(int dtype, const void* x, const void* w1, const void* b1,
                            const void* w2, float* scratch, int M, int dim, int inner,
                            cudaStream_t stream) {
  if (dtype == dsta::kF32) {
    dim3 grid((M + BM - 1) / BM, (inner + BI - 1) / BI);
    geglu_partial_kernel<<<grid, NT, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(w1),
        static_cast<const float*>(b1), static_cast<const float*>(w2), scratch, M, dim, inner);
    return cudaGetLastError();
  }
  if (!tensor_core_ok(x, w1, w2, dim, inner)) return cudaErrorInvalidValue;
  const bf16 *xb = static_cast<const bf16*>(x), *w1b = static_cast<const bf16*>(w1);
  const bf16 *b1b = static_cast<const bf16*>(b1), *w2b = static_cast<const bf16*>(w2);
  switch (dsta::geglu_chunk_width(dtype, M, inner)) {
    case 256: return launch_mma_bi<256>(xb, w1b, b1b, w2b, scratch, M, dim, inner, stream);
    case 128: return launch_mma_bi<128>(xb, w1b, b1b, w2b, scratch, M, dim, inner, stream);
    default: return launch_mma_bi<64>(xb, w1b, b1b, w2b, scratch, M, dim, inner, stream);
  }
}

}  // namespace

// The number of f32 [M, dim] slices the scratch of dsta_geglu_fwd must hold
// (one per inner chunk), or -1 for a dtype the kernel does not take.
extern "C" int dsta_geglu_chunks(int dtype, int M, int inner) {
  if (M < 1 || inner < 1 || (dtype != dsta::kF32 && dtype != dsta::kBF16)) return -1;
  const int bi = dsta::geglu_chunk_width(dtype, M, inner);
  return (inner + bi - 1) / bi;
}

// x [M, dim]; w1 [2*inner, dim]; b1 [2*inner]; w2 [dim, inner]; b2 [dim];
// res [M, dim] or null; scratch [dsta_geglu_chunks(...), M, dim] float32;
// out [M, dim].  All contiguous; x, weights, biases, res and out share one
// dtype.  bfloat16 needs dim and inner multiples of 8 and x, w1, w2 16-byte
// aligned.
extern "C" int dsta_geglu_fwd(int dtype, const void* x, const void* w1, const void* b1,
                              const void* w2, const void* b2, const void* res, void* scratch,
                              void* out, int M, int dim, int inner, void* stream) {
  if (M < 1 || dim < 1 || inner < 1) return (int)cudaErrorInvalidValue;
  if (dtype != dsta::kF32 && dtype != dsta::kBF16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  cudaError_t err = launch_partials(dtype, x, w1, b1, w2, sc, M, dim, inner, s);
  if (err != cudaSuccess) return (int)err;
  const int chunks = dsta_geglu_chunks(dtype, M, inner);
  return (int)dsta::launch_sum_slices(dtype, sc, b2, res, out, (size_t)M * dim, dim, chunks, s);
}
