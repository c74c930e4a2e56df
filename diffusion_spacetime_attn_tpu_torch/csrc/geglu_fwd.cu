// Fused GEGLU feed-forward forward.
//
// Replaces the Pallas TPU kernel `ops/pallas_geglu.py:_ff_kernel` (launched by
// `_ff_fwd_local`, public `geglu_ff`) of the JAX package:
//
//   h   = x·W1hᵀ + b1h,   g = x·W1gᵀ + b1g          (W1 = [W1h; W1g], torch layout)
//   u   = h·gelu_erf(g), rounded to x's dtype
//   out = u·W2ᵀ + b2 (+ residual)
//
// with f32 accumulation.
//
// Bound on the H100: 6·M·dim·inner FLOPs against the weights and two or three
// [M, dim] activations; at SD levels 0-2 that is bound by operations, at the
// mid block (M = 128 rows per prompt) by the 26 MB of weights.  The gate's
// erf runs on the CUDA cores: at level 0 (dim 320) its M·inner evaluations
// take about half as long as the tensor cores take for h and g.
//
// The TPU kernel kept the gated [rows, inner] tile in VMEM and an f32
// [rows, dim] accumulator across inner tiles, since a TPU core walks the
// grid in order.  On Hopper that would mean either a reduction across blocks
// or recomputing h and g once per output tile.  Two designs, by dtype
// (`ops/cuda_geglu.py:geglu_design`):
//
// wgmma (bf16, dim and inner multiples of 8, 16-byte aligned operands): two
//   persistent ping-pong GEMMs (`hop::pingpong_gemm`, hopper.cuh: TMA ring,
//   two consumer warpgroups taking 64-row tiles in turn, a producer
//   warpgroup).  `geglu_gate_wgmma_kernel` computes 64 x 128 tiles of h and
//   g (two ss wgmma accumulators over dim, W1h and W1g rows K-major) and
//   writes u = (h + b1h)·gelu_erf(g + b1g) as bf16 to u [M, inner]: u is
//   rounded to bf16 exactly where the TPU kernel rounds it, so writing it
//   changes nothing but the summation order, and it is a fifth of the bytes
//   of f32 partial sums of out per inner chunk.  One warpgroup's erf
//   epilogue runs under the other's products.  `geglu_out_wgmma_kernel`
//   computes out = u·W2ᵀ over inner (W2 rows K-major) in 64 x 160 tiles, or
//   64 x 64 where 160-wide tiles would leave SMs idle (the mid block), and
//   adds b2 and the residual in f32 before rounding once.  Rows and columns
//   past the edge arrive as zeros from TMA; the epilogues mask their
//   stores, so the garbage gate of a column past inner is never written.
//
// simt (float32): `geglu_partial_kernel` on the CUDA cores.  Block (64-row
//   tile, inner chunk of 64) keeps its gated tile in shared memory,
//   multiplies it by the matching columns of W2 and stores its partial
//   product into its own f32 slice of the scratch ([chunks, M, dim]);
//   `sum_slices_kernel` (common.cuh) sums the slices in chunk order and
//   adds b2 and the residual.  Each of 256 threads owns a 4x4 block of
//   every 64x64 tile.
//
// No design uses atomics: the result is a fixed function of the inputs.
#include "hopper.cuh"

namespace {

// u = h·gelu_erf(g) in f32
__device__ __forceinline__ float gated(float h, float g) {
  return h * (0.5f * g * (1.f + erff(g * 0.70710678118654752f)));
}

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
      us[c * LDA + ty * 4 + i] = cok ? gated(hacc[i][j] + bh, gacc[i][j] + bg) : 0.f;
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

// The simt design's launch: one block per (64-row tile, 64-column inner chunk).
cudaError_t launch_simt(const float* x, const float* w1, const float* b1, const float* w2,
                        float* scratch, int M, int dim, int inner, cudaStream_t stream) {
  dim3 grid((M + BM - 1) / BM, (inner + BI - 1) / BI);
  geglu_partial_kernel<<<grid, NT, 0, stream>>>(x, w1, b1, w2, scratch, M, dim, inner);
  return cudaGetLastError();
}

// ---- bfloat16: wgmma fed by TMA (persistent ping-pong GEMMs) ----
using dsta::bf16;
using dsta::hop::PP_BM;
namespace hop = dsta::hop;

// A: u = (x·W1hᵀ + b1h)·gelu_erf(x·W1gᵀ + b1g) in 64 x 128 tiles over dim.
// Maps: x (64-row boxes), W1 (128-row boxes).  A stage: the x tile, then the
// W1h and W1g tiles (40 KB).
struct GegluGate {
  static constexpr int BN = 128, STAGES = 4, NMAPS = 2;
  static constexpr int X_BYTES = PP_BM * 128, W_BYTES = BN * 128;
  static constexpr int STAGE_BYTES = X_BYTES + 2 * W_BYTES;
  struct Args {
    const bf16* b1;
    bf16* u;
    int M, inner;
  };
  struct Acc {
    float h[BN / 2], g[BN / 2];
    __device__ __forceinline__ void zero() {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) h[i] = g[i] = 0.f;
    }
    __device__ __forceinline__ void fence() {
      hop::fence_regs(h);
      hop::fence_regs(g);
    }
  };
  __device__ __forceinline__ static void load(unsigned char* st, const CUtensorMap* m,
                                              uint64_t* bar, int m0, int n0, int k0,
                                              const Args& a) {
    hop::tma_load_2d(st, &m[0], bar, k0, m0);
    hop::tma_load_2d(st + X_BYTES, &m[1], bar, k0, n0);
    hop::tma_load_2d(st + X_BYTES + W_BYTES, &m[1], bar, k0, a.inner + n0);
  }
  __device__ __forceinline__ static void mma(Acc& c, const unsigned char* st, int scale) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint64_t da = hop::desc_kmajor(st, PP_BM, ks);
      hop::Wgmma<BN>::ss(c.h, da, hop::desc_kmajor(st + X_BYTES, BN, ks), ks > 0 || scale);
      hop::Wgmma<BN>::ss(c.g, da, hop::desc_kmajor(st + X_BYTES + W_BYTES, BN, ks),
                         ks > 0 || scale);
    }
  }
  __device__ __forceinline__ static void epilogue(const Acc& c, const Args& a, int row0,
                                                  int col0) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = col0 + 8 * j;  // and col + 1: inner is a multiple of 8
      if (col >= a.inner) continue;
      const float bh0 = __bfloat162float(a.b1[col]), bh1 = __bfloat162float(a.b1[col + 1]);
      const float bg0 = __bfloat162float(a.b1[a.inner + col]);
      const float bg1 = __bfloat162float(a.b1[a.inner + col + 1]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row >= a.M) continue;
        const int i = 4 * j + 2 * r;
        const float u0 = gated(c.h[i] + bh0, c.g[i] + bg0);
        const float u1 = gated(c.h[i + 1] + bh1, c.g[i + 1] + bg1);
        *reinterpret_cast<uint32_t*>(a.u + (size_t)row * a.inner + col) = dsta::pack_bf16(u0, u1);
      }
    }
  }
};

// B: out = u·W2ᵀ + b2 (+ res) in 64 x BN tiles over inner.  Maps: u (64-row
// boxes), W2 (BN-row boxes).  A stage: the u tile, then the W2 tile.
template <int BN_>
struct GegluOut {
  static constexpr int BN = BN_, STAGES = BN == 64 ? 8 : 6, NMAPS = 2;
  static constexpr int A_BYTES = PP_BM * 128, STAGE_BYTES = A_BYTES + BN * 128;
  struct Args {
    const bf16 *b2, *res;
    bf16* out;
    int M, dim;
  };
  struct Acc {
    float o[BN / 2];
    __device__ __forceinline__ void zero() {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) o[i] = 0.f;
    }
    __device__ __forceinline__ void fence() { hop::fence_regs(o); }
  };
  __device__ __forceinline__ static void load(unsigned char* st, const CUtensorMap* m,
                                              uint64_t* bar, int m0, int n0, int k0,
                                              const Args&) {
    hop::tma_load_2d(st, &m[0], bar, k0, m0);
    hop::tma_load_2d(st + A_BYTES, &m[1], bar, k0, n0);
  }
  __device__ __forceinline__ static void mma(Acc& c, const unsigned char* st, int scale) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      hop::Wgmma<BN>::ss(c.o, hop::desc_kmajor(st, PP_BM, ks),
                         hop::desc_kmajor(st + A_BYTES, BN, ks), ks > 0 || scale);
  }
  __device__ __forceinline__ static void epilogue(const Acc& c, const Args& a, int row0,
                                                  int col0) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = col0 + 8 * j;  // and col + 1: dim is a multiple of 8
      if (col >= a.dim) continue;
      const float b0 = __bfloat162float(a.b2[col]), b1 = __bfloat162float(a.b2[col + 1]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row >= a.M) continue;
        const size_t o = (size_t)row * a.dim + col;
        float v0 = c.o[4 * j + 2 * r] + b0, v1 = c.o[4 * j + 2 * r + 1] + b1;
        if (a.res != nullptr) {
          v0 += __bfloat162float(a.res[o]);
          v1 += __bfloat162float(a.res[o + 1]);
        }
        *reinterpret_cast<uint32_t*>(a.out + o) = dsta::pack_bf16(v0, v1);
      }
    }
  }
};

__global__ void __launch_bounds__(hop::PP_THREADS, 1)
geglu_gate_wgmma_kernel(const __grid_constant__ hop::TensorMaps<2> maps,
                        const GegluGate::Args args, int M, int N, int K) {
  hop::pingpong_gemm<GegluGate>(maps, args, M, N, K);
}

template <int BN>
__global__ void __launch_bounds__(hop::PP_THREADS, 1)
geglu_out_wgmma_kernel(const __grid_constant__ hop::TensorMaps<2> maps,
                       const typename GegluOut<BN>::Args args, int M, int N, int K) {
  hop::pingpong_gemm<GegluOut<BN>>(maps, args, M, N, K);
}

template <int BN>
cudaError_t launch_out(const bf16* u, const bf16* w2, const bf16* b2, const bf16* res, bf16* out,
                       int M, int dim, int inner, cudaStream_t stream) {
  hop::TensorMaps<2> maps;
  cudaError_t err = hop::matrix_map(&maps.m[0], u, M, inner, PP_BM);
  if (err == cudaSuccess) err = hop::matrix_map(&maps.m[1], w2, dim, inner, BN);
  if (err != cudaSuccess) return err;
  const typename GegluOut<BN>::Args args{b2, res, out, M, dim};
  return hop::launch_pingpong<GegluOut<BN>>(geglu_out_wgmma_kernel<BN>, M, dim, stream, maps, args,
                                           M, dim, inner);
}

cudaError_t launch_wgmma(const bf16* x, const bf16* w1, const bf16* b1, const bf16* w2,
                         const bf16* b2, const bf16* res, bf16* u, bf16* out, int M, int dim,
                         int inner, cudaStream_t stream) {
  hop::TensorMaps<2> maps;
  cudaError_t err = hop::matrix_map(&maps.m[0], x, M, dim, PP_BM);
  if (err == cudaSuccess) err = hop::matrix_map(&maps.m[1], w1, 2 * inner, dim, GegluGate::BN);
  if (err != cudaSuccess) return err;
  err = hop::launch_pingpong<GegluGate>(geglu_gate_wgmma_kernel, M, inner, stream, maps,
                                        GegluGate::Args{b1, u, M, inner}, M, inner, dim);
  if (err != cudaSuccess) return err;
  if (dsta::geglu_out_width(M, dim, hop::sm_count()) == 160)
    return launch_out<160>(u, w2, b2, res, out, M, dim, inner, stream);
  return launch_out<64>(u, w2, b2, res, out, M, dim, inner, stream);
}

}  // namespace

// The number of f32 [M, dim] slices the scratch of a float32 dsta_geglu_fwd
// or dsta_geglu_dx must hold (one per 64-column inner chunk), or -1 for any
// other dtype (bfloat16 takes no slices).
extern "C" int dsta_geglu_chunks(int dtype, int M, int inner) {
  if (M < 1 || inner < 1 || dtype != dsta::kF32) return -1;
  return (inner + BI - 1) / BI;
}

// The output columns per tile (160 or 64) that the wgmma GEGLU products into
// [M, dim] take on the current device, or -1 for sizes below 1.
extern "C" int dsta_geglu_out_width(int M, int dim) {
  if (M < 1 || dim < 1) return -1;
  return dsta::geglu_out_width(M, dim, hop::sm_count());
}

// x [M, dim]; w1 [2*inner, dim]; b1 [2*inner]; w2 [dim, inner]; b2 [dim];
// res [M, dim] or null; out [M, dim].  All contiguous; x, weights, biases,
// res and out share one dtype.  bfloat16 (the wgmma design) needs dim and
// inner multiples of 8 and x, w1, w2 and scratch 16-byte aligned; scratch
// is u [M, inner] bfloat16.  float32 (simt): scratch is
// [dsta_geglu_chunks(...), M, dim] float32.
extern "C" int dsta_geglu_fwd(int dtype, const void* x, const void* w1, const void* b1,
                              const void* w2, const void* b2, const void* res, void* scratch,
                              void* out, int M, int dim, int inner, void* stream) {
  if (M < 1 || dim < 1 || inner < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dsta::kBF16) {
    if (dim % 8 || inner % 8 || !dsta::aligned16(x) || !dsta::aligned16(w1) ||
        !dsta::aligned16(w2) || !dsta::aligned16(scratch))
      return (int)cudaErrorInvalidValue;
    return (int)launch_wgmma(static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
                             static_cast<const bf16*>(b1), static_cast<const bf16*>(w2),
                             static_cast<const bf16*>(b2), static_cast<const bf16*>(res),
                             static_cast<bf16*>(scratch), static_cast<bf16*>(out), M, dim, inner,
                             s);
  }
  if (dtype != dsta::kF32) return (int)cudaErrorInvalidValue;
  float* sc = static_cast<float*>(scratch);
  cudaError_t err = launch_simt(static_cast<const float*>(x), static_cast<const float*>(w1),
                                static_cast<const float*>(b1), static_cast<const float*>(w2), sc,
                                M, dim, inner, s);
  if (err != cudaSuccess) return (int)err;
  return (int)dsta::launch_sum_slices(sc, static_cast<const float*>(b2),
                                      static_cast<const float*>(res), static_cast<float*>(out),
                                      (size_t)M * dim, dim, dsta_geglu_chunks(dtype, M, inner), s);
}
