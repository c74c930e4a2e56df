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
// with gelu′(g) = Φ(g) + g·φ(g) (exact erf), f32 accumulation.  The chain
// differentiates the blend weights only, so dx is the only cotangent of the
// hot path; dW and db are plain products in the wrapper.
//
// Bound on the H100: 10·M·dim·inner FLOPs (five products) against two [M, dim]
// activations in, one out and the weights: bound by operations at SD levels
// 0-2, by the weights at the mid block.
//
// Two designs, by dtype, as in the forward (`geglu_fwd.cu`):
//
// wgmma (bf16, dim and inner multiples of 8, 16-byte aligned operands): two
//   persistent ping-pong GEMMs (`hop::pingpong_gemm`, hopper.cuh).
//   `geglu_dgate_wgmma_kernel` computes 64 x 64 tiles of h, g and du with
//   three accumulators sharing one k-loop over dim (x against W1h and W1g
//   rows, K-major; dy against W2's columns, an MN-major B operand), and
//   writes dh and dg, each rounded to bf16 where the TPU kernel rounds them,
//   to one [M, 2·inner] tensor laid out [dh | dg]; the gate's erf and exp run
//   under the other warpgroup's products.  `geglu_dx_out_wgmma_kernel` is
//   then a single product dx = [dh | dg]·W1 over 2·inner (W1 MN-major), in
//   64 x 160 tiles (64 x 64 at the mid block) rounded once.
//
// simt (float32): block (64-row tile, 64-column inner chunk) recomputes h,
//   g and du on the CUDA cores (256 threads, 4x4 outputs each), keeps dh and
//   dg for the chunk in shared memory, multiplies them by the chunk's rows
//   of W1h and W1g and writes its partial dx to its own f32 slice of the
//   scratch ([chunks, M, dim]); `sum_slices_kernel` (common.cuh) sums the
//   slices in chunk order.
//
// No design uses atomics: the result is a fixed function of the inputs.
#include "hopper.cuh"

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

// The simt design's launch: one block per (64-row tile, 64-column inner chunk).
cudaError_t launch_simt(const float* x, const float* w1, const float* b1, const float* w2,
                        const float* dy, float* scratch, int M, int dim, int inner,
                        cudaStream_t stream) {
  const int smem = (int)sizeof(float) * SMEM_FLOATS;
  dim3 grid((M + BM - 1) / BM, (inner + BI - 1) / BI);
  return dsta::launch_smem(geglu_dx_partial_kernel, grid, NT, smem, stream, x, w1, b1, w2, dy,
                           scratch, M, dim, inner);
}

// ---- bfloat16: wgmma fed by TMA (persistent ping-pong GEMMs) ----
using dsta::bf16;
using dsta::hop::PP_BM;
namespace hop = dsta::hop;

// C: dh, dg from h = x·W1hᵀ, g = x·W1gᵀ and du = dy·W2, 64 x 64 tiles over
// dim.  Maps (64-row boxes): x, dy, W1, W2.  A stage: the x, dy, W1h, W1g
// tiles (K-major) and W2's 64 x 64 block (MN-major), 40 KB.
struct GegluDgate {
  static constexpr int BN = 64, STAGES = 4, NMAPS = 4;
  static constexpr int T = 64 * 128;  // one 64 x 64 tile
  static constexpr int STAGE_BYTES = 5 * T;
  struct Args {
    const bf16* b1;
    bf16* dhg;
    int M, inner;
  };
  struct Acc {
    float h[BN / 2], g[BN / 2], du[BN / 2];
    __device__ __forceinline__ void zero() {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) h[i] = g[i] = du[i] = 0.f;
    }
    __device__ __forceinline__ void fence() {
      hop::fence_regs(h);
      hop::fence_regs(g);
      hop::fence_regs(du);
    }
  };
  __device__ __forceinline__ static void load(unsigned char* st, const CUtensorMap* m,
                                              uint64_t* bar, int m0, int n0, int k0,
                                              const Args& a) {
    hop::tma_load_2d(st, &m[0], bar, k0, m0);                  // x
    hop::tma_load_2d(st + T, &m[1], bar, k0, m0);              // dy
    hop::tma_load_2d(st + 2 * T, &m[2], bar, k0, n0);          // W1h rows
    hop::tma_load_2d(st + 3 * T, &m[2], bar, k0, a.inner + n0);  // W1g rows
    hop::tma_load_2d(st + 4 * T, &m[3], bar, n0, k0);          // W2 [k0.., n0..]
  }
  __device__ __forceinline__ static void mma(Acc& c, const unsigned char* st, int scale) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int sc = ks > 0 || scale;
      const uint64_t dx = hop::desc_kmajor(st, PP_BM, ks);
      hop::Wgmma<BN>::ss(c.h, dx, hop::desc_kmajor(st + 2 * T, BN, ks), sc);
      hop::Wgmma<BN>::ss(c.g, dx, hop::desc_kmajor(st + 3 * T, BN, ks), sc);
      hop::Wgmma<BN>::ssT(c.du, hop::desc_kmajor(st + T, PP_BM, ks),
                          hop::desc_mnmajor(st + 4 * T, 64, ks), sc);
    }
  }
  __device__ __forceinline__ static void epilogue(const Acc& c, const Args& a, int row0,
                                                  int col0) {
    const size_t ld = 2 * (size_t)a.inner;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = col0 + 8 * j;  // and col + 1: inner is a multiple of 8
      if (col >= a.inner) continue;
      const float bh[2] = {__bfloat162float(a.b1[col]), __bfloat162float(a.b1[col + 1])};
      const float bg[2] = {__bfloat162float(a.b1[a.inner + col]),
                           __bfloat162float(a.b1[a.inner + col + 1])};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row >= a.M) continue;
        float dh[2], dg[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * r + e;
          geglu_grads(c.h[i] + bh[e], c.g[i] + bg[e], c.du[i], dh[e], dg[e]);
        }
        bf16* const o = a.dhg + (size_t)row * ld + col;
        *reinterpret_cast<uint32_t*>(o) = dsta::pack_bf16(dh[0], dh[1]);
        *reinterpret_cast<uint32_t*>(o + a.inner) = dsta::pack_bf16(dg[0], dg[1]);
      }
    }
  }
};

// D: dx = [dh | dg]·W1 over 2·inner in 64 x BN tiles.  Maps (64-row boxes):
// [dh | dg], W1.  A stage: the [dh | dg] tile (K-major), then W1's 64 rows
// x BN columns as ceil(BN / 64) boxes (MN-major).
template <int BN_>
struct GegluDxOut {
  static constexpr int BN = BN_, NB = (BN + 63) / 64, STAGES = BN == 64 ? 8 : 6, NMAPS = 2;
  static constexpr int T = 64 * 128, STAGE_BYTES = T + NB * T;
  struct Args {
    bf16* dx;
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
#pragma unroll
    for (int b = 0; b < NB; ++b) hop::tma_load_2d(st + T + b * T, &m[1], bar, n0 + 64 * b, k0);
  }
  __device__ __forceinline__ static void mma(Acc& c, const unsigned char* st, int scale) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      hop::Wgmma<BN>::ssT(c.o, hop::desc_kmajor(st, PP_BM, ks), hop::desc_mnmajor(st + T, 64, ks),
                          ks > 0 || scale);
  }
  __device__ __forceinline__ static void epilogue(const Acc& c, const Args& a, int row0,
                                                  int col0) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = col0 + 8 * j;  // and col + 1: dim is a multiple of 8
      if (col >= a.dim) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row < a.M)
          *reinterpret_cast<uint32_t*>(a.dx + (size_t)row * a.dim + col) =
              dsta::pack_bf16(c.o[4 * j + 2 * r], c.o[4 * j + 2 * r + 1]);
      }
    }
  }
};

__global__ void __launch_bounds__(hop::PP_THREADS, 1)
geglu_dgate_wgmma_kernel(const __grid_constant__ hop::TensorMaps<4> maps,
                         const GegluDgate::Args args, int M, int N, int K) {
  hop::pingpong_gemm<GegluDgate>(maps, args, M, N, K);
}

template <int BN>
__global__ void __launch_bounds__(hop::PP_THREADS, 1)
geglu_dx_out_wgmma_kernel(const __grid_constant__ hop::TensorMaps<2> maps,
                          const typename GegluDxOut<BN>::Args args, int M, int N, int K) {
  hop::pingpong_gemm<GegluDxOut<BN>>(maps, args, M, N, K);
}

template <int BN>
cudaError_t launch_dx_out(const bf16* dhg, const bf16* w1, bf16* dx, int M, int dim, int inner,
                          cudaStream_t stream) {
  hop::TensorMaps<2> maps;
  cudaError_t err = hop::matrix_map(&maps.m[0], dhg, M, 2 * inner, PP_BM);
  if (err == cudaSuccess) err = hop::matrix_map(&maps.m[1], w1, 2 * inner, dim, 64);
  if (err != cudaSuccess) return err;
  return hop::launch_pingpong<GegluDxOut<BN>>(geglu_dx_out_wgmma_kernel<BN>, M, dim, stream, maps,
                                             typename GegluDxOut<BN>::Args{dx, M, dim}, M, dim,
                                             2 * inner);
}

cudaError_t launch_wgmma(const bf16* x, const bf16* w1, const bf16* b1, const bf16* w2,
                         const bf16* dy, bf16* dhg, bf16* dx, int M, int dim, int inner,
                         cudaStream_t stream) {
  hop::TensorMaps<4> maps;
  cudaError_t err = hop::matrix_map(&maps.m[0], x, M, dim, PP_BM);
  if (err == cudaSuccess) err = hop::matrix_map(&maps.m[1], dy, M, dim, PP_BM);
  if (err == cudaSuccess) err = hop::matrix_map(&maps.m[2], w1, 2 * inner, dim, 64);
  if (err == cudaSuccess) err = hop::matrix_map(&maps.m[3], w2, dim, inner, 64);
  if (err != cudaSuccess) return err;
  err = hop::launch_pingpong<GegluDgate>(geglu_dgate_wgmma_kernel, M, inner, stream, maps,
                                         GegluDgate::Args{b1, dhg, M, inner}, M, inner, dim);
  if (err != cudaSuccess) return err;
  if (dsta::geglu_out_width(M, dim, hop::sm_count()) == 160)
    return launch_dx_out<160>(dhg, w1, dx, M, dim, inner, stream);
  return launch_dx_out<64>(dhg, w1, dx, M, dim, inner, stream);
}

}  // namespace

// x, dy, dx [M, dim]; w1 [2*inner, dim]; b1 [2*inner]; w2 [dim, inner].  All
// contiguous; x, dy, weights, biases and dx share one dtype.  bfloat16 (the
// wgmma design) needs dim and inner multiples of 8 and x, w1, w2, dy and
// scratch 16-byte aligned; scratch is [dh | dg] [M, 2*inner] bfloat16.
// float32 (simt): scratch is [dsta_geglu_chunks(...), M, dim] float32.
extern "C" int dsta_geglu_dx(int dtype, const void* x, const void* w1, const void* b1,
                             const void* w2, const void* dy, void* scratch, void* dx, int M,
                             int dim, int inner, void* stream) {
  if (M < 1 || dim < 1 || inner < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dsta::kBF16) {
    if (dim % 8 || inner % 8 || !dsta::aligned16(x) || !dsta::aligned16(w1) ||
        !dsta::aligned16(w2) || !dsta::aligned16(dy) || !dsta::aligned16(scratch))
      return (int)cudaErrorInvalidValue;
    return (int)launch_wgmma(static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
                             static_cast<const bf16*>(b1), static_cast<const bf16*>(w2),
                             static_cast<const bf16*>(dy), static_cast<bf16*>(scratch),
                             static_cast<bf16*>(dx), M, dim, inner, s);
  }
  if (dtype != dsta::kF32) return (int)cudaErrorInvalidValue;
  float* sc = static_cast<float*>(scratch);
  cudaError_t err = launch_simt(static_cast<const float*>(x), static_cast<const float*>(w1),
                                static_cast<const float*>(b1), static_cast<const float*>(w2),
                                static_cast<const float*>(dy), sc, M, dim, inner, s);
  if (err != cudaSuccess) return (int)err;
  return (int)dsta::launch_sum_slices(sc, nullptr, nullptr, static_cast<float*>(dx),
                                      (size_t)M * dim, dim, (inner + BI - 1) / BI, s);
}
