// Blended global+local spacetime cross-attention forward, cond half.
//
// Replaces the Pallas TPU kernel `ops/pallas_spacetime.py:_kernel` (launched by
// `_forward`, public `fused_spacetime_attention`) of the JAX package:
//
//   g_c   = softmax(q·Kcᵀ/√dh)·Vc
//   loc_n = softmax(q·Knᵀ/√dh)·Vn                       n = 1..N
//   out   = g_c + Σ_n m_n[q]·coef[b,n]·(loc_n − g_u)
//
// each softmax in f32 over the context's own keys (77 for CLIP).  The masks
// are read in q's dtype, as the TPU kernel reads them.
//
// Bound on the H100: per call the op moves q, g_u, out and every context's
// K/V once, against 4·(N+1)·Lq·Lk·dh FLOPs per head and one exp per score.
// At SD level 0 (dh 40) the exps bound it (16 a clock per SM), at levels
// 1, 2 and mid the bytes.  Every design keeps the N per-object attention
// results out of device memory (the plain version writes a [B, N, Lq,
// inner] tensor) and folds the blend weight w_n = m_n·coef_n into the
// probabilities, so one f32 accumulator gathers g_c + Σ_n w_n·loc_n and the
// epilogue subtracts (Σ_n w_n)·g_u.  Keys past Lk are masked to −inf.  The
// C entry picks the design from the dtype:
//
// wgmma (bf16; dh a multiple of 8 up to 160, Lk ≤ 80, 16-byte aligned
//   operands): `spacetime_fwd_wgmma_kernel<DN, WIDE>`.  Blocks of 384
//   threads, query tiles on blockIdx.x so that the blocks of one head run
//   together and find its K/V in L2.  A producer warpgroup loads the block's
//   q rows once and streams the N+1 contexts' K/V (80 rows: keys Lk..79 and
//   columns dh..DN arrive as zeros) through a ring of STAGES stages (TMA,
//   full/empty mbarriers; layout in `hopper.cuh`): 5 (all contexts at N =
//   4) in 64-query blocks at DN ≤ 128, else 4, 3 or 2; at DN ≤ 64 two
//   blocks share an SM.  Two consumer warpgroups run the products.  Per
//   context, S = q·Kᵀ is one wgmma m64n80 over ⌈DN/16⌉ k-steps; a row's 80
//   scores lie in one quad of lanes, so its max and sum take two shuffles
//   and no online rescaling is needed; P′ = (w / rowsum)·exp2((s − max)·
//   scale·log2 e) is rounded to bf16 as the register A operand of acc +=
//   P′·V (wgmma m64nDN, V MN-major).  scale multiplies the f32 scores, as
//   the TPU kernel scales them.  DN is the head width rounded up to 40, 64,
//   80, 128 or 160; extra columns are zeros and are not stored.  Two block
//   shapes (`dsta::spacetime_wide`):
//   - 64 queries (SD levels 2 and mid: grids of 16 and 64 blocks): both
//     warpgroups own the 64 rows and take the contexts in turn (0, 2, 4 and
//     1, 3), so one's softmax runs while the other's products do.  At the
//     end warpgroup 1 hands its accumulator and Σw to warpgroup 0 through
//     the ring stage of its last context (no copy lands there again), and
//     warpgroup 0 adds them in that fixed order, so a repeat gives the same
//     bits.
//   - 128 queries, WIDE (SD levels 0 and 1, where 64-query blocks would be
//     7.8 and 1.9 waves): each warpgroup owns 64 rows and walks every
//     context, so a context's K/V crosses from L2 once per 128 queries and
//     half as many blocks start and drain.
//
// simt (float32): `spacetime_fwd_simt_kernel` on the CUDA cores, one block
//   of 256 threads per (b, head, 64-query tile) that stages one [Lk, dh] K/V
//   pair at a time in shared memory.
#include "hopper.cuh"

namespace {

using dsta::bf16;
namespace hop = dsta::hop;

constexpr int BQ = 64;           // queries per block
constexpr int LKMAX = 80;        // keys per context (CLIP: 77)
constexpr int DMAX = 160;
constexpr float LOG2E = 1.4426950408889634f;

// ---- float32: CUDA cores ----
constexpr int NT = 256;
constexpr int KCOLS = LKMAX / 16;
constexpr int DCOLS = DMAX / 16;

constexpr size_t simt_smem_bytes(int Lk, int dh) {
  return sizeof(float) * ((size_t)(BQ + 2 * Lk) * (dh + 1) + (size_t)BQ * (LKMAX + 1));
}

__global__ void __launch_bounds__(NT)
spacetime_fwd_simt_kernel(const float* __restrict__ q, const float* __restrict__ gu,
                          const float* __restrict__ kc, const float* __restrict__ vc,
                          const float* __restrict__ lk, const float* __restrict__ lv,
                          const float* __restrict__ masks, const float* __restrict__ coef,
                          float* __restrict__ out, int N, int Lq, int Lk, int H, int dh,
                          float scale) {
  extern __shared__ float smem[];
  const int ld = dh + 1;
  float* qs = smem;             // [BQ][dh+1]
  float* ks = qs + BQ * ld;     // [Lk][dh+1]
  float* vs = ks + Lk * ld;     // [Lk][dh+1]
  float* ps = vs + Lk * ld;     // [BQ][LKMAX+1], w·p

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t inner = (size_t)H * dh;
  const size_t qoff = (size_t)b * Lq * inner + (size_t)h * dh;

  for (int idx = tid; idx < BQ * dh; idx += NT) {
    const int r = idx / dh, d = idx % dh;
    qs[r * ld + d] = (q0 + r < Lq) ? q[qoff + (size_t)(q0 + r) * inner + d] : 0.f;
  }

  float acc[4][DCOLS], wsum[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    wsum[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DCOLS; ++c) acc[i][c] = 0.f;
  }

  for (int ctx = 0; ctx <= N; ++ctx) {
    const float* kp;
    const float* vp;
    if (ctx == 0) {
      kp = kc + (size_t)b * Lk * inner;
      vp = vc + (size_t)b * Lk * inner;
    } else {
      const size_t base = ((size_t)b * N + (ctx - 1)) * Lk * inner;
      kp = lk + base;
      vp = lv + base;
    }
    kp += (size_t)h * dh;
    vp += (size_t)h * dh;

    __syncthreads();  // the previous context's ks/vs/ps are no longer read
    for (int idx = tid; idx < Lk * dh; idx += NT) {
      const int r = idx / dh, d = idx % dh;
      ks[r * ld + d] = kp[(size_t)r * inner + d];
      vs[r * ld + d] = vp[(size_t)r * inner + d];
    }
    __syncthreads();

    float w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty * 4 + i;
      if (ctx == 0) {
        w[i] = 1.f;
      } else {
        const int bn = b * N + ctx - 1;
        w[i] = (r < Lq) ? masks[(size_t)bn * Lq + r] * coef[bn] : 0.f;
        wsum[i] += w[i];
      }
    }

    float s[4][KCOLS];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) s[i][j] = 0.f;
    for (int d = 0; d < dh; ++d) {
      float a[4], kk[KCOLS];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty * 4 + i) * ld + d];
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) {
        const int c = tx + 16 * j;
        kk[j] = (c < Lk) ? ks[c * ld + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < KCOLS; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
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
      const float wn = w[i] / sum;
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) ps[(ty * 4 + i) * (LKMAX + 1) + tx + 16 * j] = s[i][j] * wn;
    }
    __syncthreads();

    for (int kk = 0; kk < Lk; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty * 4 + i) * (LKMAX + 1) + kk];
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
    const size_t row = qoff + (size_t)r * inner;
#pragma unroll
    for (int c = 0; c < DCOLS; ++c) {
      const int d = tx + 16 * c;
      if (d < dh) out[row + d] = acc[i][c] - wsum[i] * gu[row + d];
    }
  }
}

// ---- bfloat16: wgmma fed by a TMA ring (sm_90a) ----
constexpr int WG_THREADS = 384;  // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int WG_ROWS = 64;      // query rows of one wgmma (a consumer's tile)

// Per rs-product width DN and block shape: WIDE blocks own 128 queries (each
// consumer warpgroup 64 rows, every context), the others 64 (the consumer
// warpgroups take the contexts in turn).
template <int DN, bool WIDE> struct FwdWgmma {
  static constexpr int NB = (DN + 63) / 64;          // 64-column boxes per row
  static constexpr int KS = (DN + 15) / 16;          // k-steps of S = q·Kᵀ
  static constexpr int ROWS = WIDE ? 2 * WG_ROWS : WG_ROWS;
  static constexpr int QH_BYTES = WG_ROWS * 128 * NB;  // one consumer's q tile
  static constexpr int Q_BYTES = ROWS * 128 * NB;
  static constexpr int KV_BYTES = LKMAX * 128 * NB;  // one K or V tile of a context
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  // every context at once where it fits (5 at N = 4), else 4, 3 or 2
  static constexpr int STAGES = NB == 1 ? (WIDE ? 4 : 5) : NB == 2 ? (WIDE ? 4 : 5) : (WIDE ? 2 : 3);
  // At DN ≤ 64 two blocks share an SM, so one's copies and epilogue run
  // under the other's products; setmaxnreg moves registers only within a
  // block's quota (384 x 80 at two blocks), so a consumer gets 104 (256 x
  // 104 + 128 x 24 ≤ 384 x 80).  At SD level 0 (2 prompts) this takes a
  // call from 46.2 to 35.6 µs on an H100 80GB HBM3 at 700 W
  // (`chip_spacetime_variants.py`); the dq pass spills at 104 and stays at
  // one block.
  static constexpr int BLOCKS = NB == 1 ? 2 : 1;
  static constexpr int CONSUMER_REGS = BLOCKS == 2 ? 104 : 240;
  static constexpr int BAR_OFF = Q_BYTES + STAGES * STAGE_BYTES;
  static constexpr int SMEM = BAR_OFF + 128 + 1024;  // barriers, alignment slack
  // warpgroup 1's hand-off (accumulator and Σw, [ND + 2][128] f32) fits a stage
  static_assert((DN / 2 + 2) * 128 * 4 <= STAGE_BYTES, "hand-off exceeds a ring stage");
  static_assert(SMEM <= 232448, "shared memory exceeds a block's 227 KB");
  static_assert(BLOCKS * (SMEM + 1024) <= 233472, "blocks exceed an SM's 228 KB");
};

template <int DN, bool WIDE>
__global__ void __launch_bounds__(WG_THREADS, FwdWgmma<DN, WIDE>::BLOCKS)
spacetime_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tkc,
                           const __grid_constant__ CUtensorMap tvc,
                           const __grid_constant__ CUtensorMap tlk,
                           const __grid_constant__ CUtensorMap tlv, const bf16* __restrict__ gu,
                           const bf16* __restrict__ masks, const float* __restrict__ coef,
                           bf16* __restrict__ out, int N, int Lq, int Lk, int H, int dh,
                           float scale_log2) {
  using C = FwdWgmma<DN, WIDE>;
  constexpr int NB = C::NB, S = C::STAGES, NS = LKMAX / 2, ND = DN / 2, KT = LKMAX / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* const base = hop::align1024(smem_raw);
  unsigned char* const qs = base;                 // [ROWS / 64][NB][64 rows][128 B]
  unsigned char* const ring = base + C::Q_BYTES;  // stage s: K [NB][80][128 B], then V
  uint64_t* const full = reinterpret_cast<uint64_t*>(base + C::BAR_OFF);
  uint64_t* const empty = full + S;
  uint64_t* const qfull = empty + S;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * C::ROWS;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], WIDE ? 256 : 128);  // the consuming warpgroups release it
    }
    hop::mbar_init(qfull, 1);
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer: one thread issues every copy, contexts in order
    hop::reg_dealloc<24>();
    if (threadIdx.x == 256) {
      hop::mbar_expect_tx(qfull, C::Q_BYTES);
#pragma unroll
      for (int hf = 0; hf < C::ROWS / WG_ROWS; ++hf)
#pragma unroll
        for (int c = 0; c < NB; ++c)
          hop::tma_load_4d(qs + hf * C::QH_BYTES + c * WG_ROWS * 128, &tq, qfull, 64 * c, h,
                           q0 + hf * WG_ROWS, b);
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
    hop::reg_alloc<C::CONSUMER_REGS>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, t = lane % 4;
    const int r0 = q0 + (WIDE ? WG_ROWS * wg : 0) + warp * 16 + lane / 4;  // rows r0, r0 + 8
    const unsigned char* const qw = qs + (WIDE ? wg * C::QH_BYTES : 0);
    float s[NS], o[ND], wsum[2] = {0.f, 0.f};
    uint32_t p[KT][4] = {};
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < ND; ++i) o[i] = 0.f;
    hop::mbar_wait(qfull, 0);

    for (int ctx = WIDE ? 0 : wg; ctx <= N; ctx += WIDE ? 1 : 2) {
      const int st = ctx % S;
      const unsigned char* const kt = ring + st * C::STAGE_BYTES;
      float w[2] = {1.f, 1.f};  // the blend weights of rows r0, r0 + 8, loaded under the wait
      if (ctx > 0) {
        const int bn = b * N + ctx - 1;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = r0 + 8 * r;
          w[r] = row < Lq ? __bfloat162float(masks[(size_t)bn * Lq + row]) * coef[bn] : 0.f;
          wsum[r] += w[r];
        }
      }
      hop::mbar_wait(&full[st], (ctx / S) & 1);
      hop::fence_regs(s);
      hop::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < C::KS; ++ks)
        hop::Wgmma<LKMAX>::ss(s, hop::desc_kmajor(qw, WG_ROWS, ks), hop::desc_kmajor(kt, LKMAX, ks),
                              ks > 0);
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(s);

      // element i: row r0 + 8·((i >> 1) & 1), key 8·(i / 4) + 2t + (i & 1).
      // The row max is taken on the unscaled scores (scale > 0).
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        if (8 * (i / 4) + 2 * t + (i & 1) >= Lk) s[i] = -CUDART_INF_F;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
      float ms[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // the 4 lanes of a quad share a row
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        ms[r] = -mx[r] * scale_log2;
      }
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        s[i] = hop::exp2_ftz(fmaf(s[i], scale_log2, ms[(i >> 1) & 1]));
        rs[(i >> 1) & 1] += s[i];
      }
      float f[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
        f[r] = w[r] / rs[r];
      }
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] *= f[(i >> 1) & 1];
      hop::acc_to_a(p, s);

      // acc += P′·V; then the stage goes back to the producer
      const unsigned char* const vt = kt + C::KV_BYTES;
      hop::fence_regs(o);
      hop::fence_regs(p);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) hop::Wgmma<DN>::rs(o, p[kk], hop::desc_mnmajor(vt, LKMAX, kk));
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(o);
      hop::fence_regs(p);
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
        for (int i = 0; i < ND; ++i) xfer[i * 128 + tid] = o[i];
        xfer[ND * 128 + tid] = wsum[0];
        xfer[(ND + 1) * 128 + tid] = wsum[1];
        hop::named_arrive(1, 256);
      } else {
        hop::named_sync(1, 256);
#pragma unroll
        for (int i = 0; i < ND; ++i) o[i] += xfer[i * 128 + tid];
        wsum[0] += xfer[ND * 128 + tid];
        wsum[1] += xfer[(ND + 1) * 128 + tid];
      }
    }
    if (WIDE || wg == 0) {  // out = acc − Σw·g_u, columns 8c + 2t, +1 of rows r0, r0 + 8
      const size_t inner = (size_t)H * dh;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        if (row >= Lq) continue;
        const size_t off = ((size_t)b * Lq + row) * inner + (size_t)h * dh + 2 * t;
#pragma unroll
        for (int c = 0; c < DN / 8; ++c) {
          if (8 * c >= dh) break;  // dh is a multiple of 8
          const float2 g2 =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(gu + off + 8 * c));
          *reinterpret_cast<uint32_t*>(out + off + 8 * c) =
              dsta::pack_bf16(o[4 * c + 2 * r] - wsum[r] * g2.x, o[4 * c + 2 * r + 1] - wsum[r] * g2.y);
        }
      }
    }
  }
}

template <int DN, bool WIDE>
cudaError_t launch_wgmma_dn(const bf16* q, const bf16* gu, const bf16* kc, const bf16* vc,
                            const bf16* lk, const bf16* lv, const bf16* masks, const float* coef,
                            bf16* out, int B, int N, int Lq, int Lk, int H, int dh, float scale,
                            cudaStream_t stream) {
  CUtensorMap m[5];
  // with no objects the object maps describe the global context (never read)
  const bf16* lkb = N > 0 ? lk : kc;
  const bf16* lvb = N > 0 ? lv : vc;
  const int BN = N > 0 ? B * N : B;
  cudaError_t err = hop::head_map(&m[0], q, B, Lq, H, dh, WG_ROWS);
  if (err == cudaSuccess) err = hop::head_map(&m[1], kc, B, Lk, H, dh, LKMAX);
  if (err == cudaSuccess) err = hop::head_map(&m[2], vc, B, Lk, H, dh, LKMAX);
  if (err == cudaSuccess) err = hop::head_map(&m[3], lkb, BN, Lk, H, dh, LKMAX);
  if (err == cudaSuccess) err = hop::head_map(&m[4], lvb, BN, Lk, H, dh, LKMAX);
  if (err != cudaSuccess) return err;
  using C = FwdWgmma<DN, WIDE>;
  return hop::launch_raised<spacetime_fwd_wgmma_kernel<DN, WIDE>>(
      dim3((Lq + C::ROWS - 1) / C::ROWS, H, B), WG_THREADS, C::SMEM, C::SMEM, stream, m[0], m[1],
      m[2], m[3], m[4], gu, masks, coef, out, N, Lq, Lk, H, dh, scale * LOG2E);
}

template <int DN>
cudaError_t launch_wgmma_dn(const bf16* q, const bf16* gu, const bf16* kc, const bf16* vc,
                            const bf16* lk, const bf16* lv, const bf16* masks, const float* coef,
                            bf16* out, int B, int N, int Lq, int Lk, int H, int dh, float scale,
                            cudaStream_t s) {
  if (dsta::spacetime_wide(Lq, H, B, hop::sm_count()))
    return launch_wgmma_dn<DN, true>(q, gu, kc, vc, lk, lv, masks, coef, out, B, N, Lq, Lk, H, dh, scale, s);
  return launch_wgmma_dn<DN, false>(q, gu, kc, vc, lk, lv, masks, coef, out, B, N, Lq, Lk, H, dh, scale, s);
}

cudaError_t launch_wgmma(const bf16* q, const bf16* gu, const bf16* kc, const bf16* vc,
                         const bf16* lk, const bf16* lv, const bf16* masks, const float* coef,
                         bf16* out, int B, int N, int Lq, int Lk, int H, int dh, float scale,
                         cudaStream_t s) {
  if (dh % 8 != 0) return cudaErrorInvalidValue;
  if (dh <= 40) return launch_wgmma_dn<40>(q, gu, kc, vc, lk, lv, masks, coef, out, B, N, Lq, Lk, H, dh, scale, s);
  if (dh <= 64) return launch_wgmma_dn<64>(q, gu, kc, vc, lk, lv, masks, coef, out, B, N, Lq, Lk, H, dh, scale, s);
  if (dh <= 80) return launch_wgmma_dn<80>(q, gu, kc, vc, lk, lv, masks, coef, out, B, N, Lq, Lk, H, dh, scale, s);
  if (dh <= 128) return launch_wgmma_dn<128>(q, gu, kc, vc, lk, lv, masks, coef, out, B, N, Lq, Lk, H, dh, scale, s);
  return launch_wgmma_dn<160>(q, gu, kc, vc, lk, lv, masks, coef, out, B, N, Lq, Lk, H, dh, scale, s);
}

}  // namespace

// q/gu/out [B, Lq, H*dh]; kc/vc [B, Lk, H*dh]; lk/lv [B, N, Lk, H*dh] (one
// dtype, contiguous); masks [B, N, Lq] in that dtype; coef [B, N] float32.
// float32 runs the CUDA-core design, bfloat16 the wgmma design (dh a
// multiple of 8, 16-byte aligned q, K and V).
extern "C" int dsta_spacetime_fwd(int dtype, const void* q, const void* gu, const void* kc,
                                  const void* vc, const void* lk, const void* lv,
                                  const void* masks, const void* coef, void* out, int B, int N,
                                  int Lq, int Lk, int H, int dh, float scale, void* stream) {
  if (dh < 1 || dh > DMAX || Lk < 1 || Lk > LKMAX || N < 0 || B < 1 || Lq < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(coef);
  if (dtype == dsta::kF32) {
    constexpr size_t most = simt_smem_bytes(LKMAX, DMAX);
    return (int)hop::launch_raised<spacetime_fwd_simt_kernel>(
        dim3((Lq + BQ - 1) / BQ, H, B), NT, (int)simt_smem_bytes(Lk, dh), (int)most, s,
        static_cast<const float*>(q), static_cast<const float*>(gu),
        static_cast<const float*>(kc), static_cast<const float*>(vc),
        static_cast<const float*>(lk), static_cast<const float*>(lv),
        static_cast<const float*>(masks), c, static_cast<float*>(out), N, Lq, Lk, H, dh, scale);
  }
  if (dtype == dsta::kBF16)
    return (int)launch_wgmma(static_cast<const bf16*>(q), static_cast<const bf16*>(gu),
                             static_cast<const bf16*>(kc), static_cast<const bf16*>(vc),
                             static_cast<const bf16*>(lk), static_cast<const bf16*>(lv),
                             static_cast<const bf16*>(masks), c, static_cast<bf16*>(out), B, N,
                             Lq, Lk, H, dh, scale, s);
  return (int)cudaErrorInvalidValue;
}
