// Shared helpers for the port's hand-written Hopper kernels.
//
// The CUDA-core kernels are templated on their storage type T (float or
// __nv_bfloat16) and compute in float: tiles are converted to float when they
// are staged in shared memory, products accumulate in float registers, and
// results are rounded to T (round-to-nearest-even) once, when they are
// stored.  The tensor-core kernels take bfloat16 tiles in shared memory and
// accumulate in float with mma.sync m16n8k16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace dsta {

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back: how a value cast to the storage dtype reads.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// Reductions over the 16 lanes of a half-warp (lanes that share tid / 16).
__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---- tensor-core helpers (bf16 in, f32 accumulate) ----

using bf16 = __nv_bfloat16;

// c += a·b for one 16x8 tile: a 16x16 (row-major fragments), b 16x8.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two 8x8 b16 matrices from shared memory, transposed: lanes 0-15 give the
// row addresses (16 bytes each).
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1, const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [r0, r0 + ROWS) and columns [c0, c0 + COLS) of a row-major bf16 matrix
// [R, C] with leading dimension ld into shared memory [ROWS][COLS + 8] (the
// +8 keeps fragment and ldmatrix reads free of bank conflicts); zero outside
// the matrix.  COLS and c0 are multiples of 8.  `vec`: 16-byte loads (C and
// ld multiples of 8, src 16-byte aligned), else element by element.
template <int ROWS, int COLS, int NT>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* src, int r0, int R, int c0,
                                               int C, size_t ld, bool vec) {
  constexpr int CH = COLS / 8;
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += NT) {
    const int r = idx / CH, c = c0 + (idx % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < R && c < C) {
      const bf16* p = src + (size_t)(r0 + r) * ld + c;
      if (vec) {
        val = *reinterpret_cast<const uint4*>(p);
      } else {
        bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (c + j < C) e[j] = p[j];
      }
    }
    *reinterpret_cast<uint4*>(dst + r * (COLS + 8) + (c - c0)) = val;
  }
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Launch `kern` with `smem` bytes of dynamic shared memory (above 48 KB only
// after the attribute is raised); returns the launch's error.
template <typename... P, typename... A>
cudaError_t launch_smem(void (*kern)(P...), dim3 grid, int threads, size_t smem,
                        cudaStream_t stream, A... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// ---- GEGLU forward and dx ----

// Output columns per tile of the wgmma GEGLU products into [M, dim] (the
// forward's u·W2ᵀ and the dx's [dh | dg]·W1): 160, unless 64-wide tiles
// finish sooner on `sms` SMs, counting a tile's time as its width plus 32
// for its fill and epilogue (SD mid block: 64).
inline int geglu_out_width(int M, int dim, int sms) {
  const long rows = (M + 63) / 64;
  auto cost = [&](long bn) {
    const long tiles = rows * ((dim + bn - 1) / bn);
    return ((tiles + sms - 1) / sms) * (bn + 32);
  };
  return cost(160) <= cost(64) ? 160 : 64;
}

// ---- spacetime forward and dq pass ----

// Whether the wgmma spacetime kernels take 128-query blocks (each consumer
// warpgroup owns 64 rows and every context, so a context's K/V is read once
// per 128 queries) rather than 64-query blocks (the two warpgroups own the
// same rows and take the contexts in turn): where 64-query blocks would
// more than fill the `sms` SMs (SD levels 0 and 1).  Kernel µs per call,
// forward / dq pass, 2 prompts, on an H100 80GB HBM3 at 700 W
// (`chip_spacetime_variants.py`): level 0 35.6 / 58.1 against 46.6 / 61.7
// in 64-query blocks, level 1 14.7 / 20.4 against 19.1 / 19.7; at level 2
// and mid 64-query blocks lead (13.0 / 14.2 and 12.6 / 14.2 against 17.9 /
// 36.7 and 15.5 / 26.4 in 128-query blocks).
inline bool spacetime_wide(int Lq, int H, int B, int sms) {
  return (long)((Lq + 63) / 64) * H * B > (long)sms;
}

namespace {

// out = Σ_c scratch[c] (in chunk order) (+ bias[idx % dim]) (+ res): the
// float32 GEGLU kernels' slices; bias and res may be null.
__global__ void sum_slices_kernel(const float* __restrict__ scratch, const float* __restrict__ bias,
                                  const float* __restrict__ res, float* __restrict__ out, size_t n,
                                  int dim, int chunks) {
  for (size_t idx = blockIdx.x * (size_t)blockDim.x + threadIdx.x; idx < n;
       idx += (size_t)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int c = 0; c < chunks; ++c) v += scratch[(size_t)c * n + idx];
    if (bias != nullptr) v += bias[idx % dim];
    if (res != nullptr) v += res[idx];
    out[idx] = v;
  }
}

inline cudaError_t launch_sum_slices(const float* scratch, const float* bias, const float* res,
                                     float* out, size_t n, int dim, int chunks,
                                     cudaStream_t stream) {
  const int threads = 256;
  const size_t want = (n + threads - 1) / threads;
  const int blocks = (int)(want < 65535 ? want : 65535);
  sum_slices_kernel<<<blocks, threads, 0, stream>>>(scratch, bias, res, out, n, dim, chunks);
  return cudaGetLastError();
}

}  // namespace

}  // namespace dsta
