// Self-attention forward loops shared by `mha_fwd.cu` and `flash_fwd.cu`.
//
// o = softmax(q·Kᵀ·scale)·V per (batch, head, query tile), with a running
// max and sum over key tiles (flash-attention style), so no score leaves
// the chip.  Layouts: q [B, Lq, H*dh], k/v [B, Lk, H*dh], out like q.  When
// `lse` is not null, the row log-sum-exp of the scaled scores is written to
// lse [B*H, Lq] in f32 (the residual of the flash backward).  The running
// max and sum are kept in log2 units (2^x on the exp unit).  Three designs,
// chosen by the Python wrappers from the shape before launch:
//
// wgmma (bf16; head widths 40, 64, 80, 128, and for the MHA forward also 32
//   and 160; 16-byte aligned tensors): `attn_fwd_wgmma`.  A block owns 128
//   queries: two consumer warpgroups of 64 rows and one producer warpgroup.
//   The producer loads the Q tile once and keeps K and V tiles (64 keys at
//   dh <= 48 and at dh 160, 128 at dh 64-128) in flight through a ring of 2
//   stages in shared memory (TMA, full/empty mbarriers; layout in
//   `hopper.cuh`: a row of up to 64 columns per box, columns past dh zero,
//   so dh 32 reads half of one box and dh 160 half of its third).  Each
//   consumer computes S = Q·Kᵀ with wgmma from shared memory, the online
//   softmax in registers, and O += P·V with P as bf16 in registers (the
//   register A operand) and V as an MN-major B operand, each product a
//   wgmma stage of its own (fence, issue, wait), which ptxas keeps
//   asynchronous.  The two consumers take turns issuing S (named barriers 1
//   and 2), so that one's exponentials run while the other's products do:
//   at dh <= 40 the softmax needs more time on the exp units than the
//   products need on the tensor cores.  setmaxnreg gives the producer's
//   registers to the consumers; at dh <= 48 two blocks share an SM
//   (`FwdWgmma`).  A consumer whose 64 rows all lie past Lq only releases
//   the ring stages.  The MHA forward at dh 32 and 160 also has 64-query
//   blocks of one consumer warpgroup (`mha_wide` picks them where they fit
//   the card in one wave: SD level 2 and mid, the RDM's short levels at
//   one prompt).
//
// mma_sync (bf16, every other shape): `attn_fwd_mma`: mma.sync m16n8k16
//   with f32 accumulation, 4 warps of 16 queries, synchronous 64-key tiles.
//   The head width is padded with zeros to a multiple of 16 in shared
//   memory (the depth of one product), so dh = 40 costs the QKᵀ work of 48.
//   The scores stay in the accumulator registers, where their layout is that
//   of the PV product's A operand, so p goes to bf16 in registers; V's B
//   operand is read with ldmatrix.trans.
//
// simt (float32): `attn_fwd_simt` on the CUDA cores: each of 256 threads
//   owns a 4x4 block of the 64x64 score tile and 4 rows x ceil(dh/16)
//   columns of the output accumulator; p is rounded to T before the PV
//   product.
#pragma once

#include "hopper.cuh"

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

// ---- wgmma fed by a TMA ring (bf16, sm_90a) ----

constexpr int WG_BQ = 128;       // queries per block: two consumer warpgroups of 64
constexpr int WG_THREADS = 384;  // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int WG_STAGES = 2;     // ring stages (4 measured no faster on the H100)

// Per head width DH and query-block height BQ (128: two consumer
// warpgroups; 64: one, and the producer warpgroup 1).  dh <= 48 streams
// 64-key stages and runs two blocks on an SM, so four consumer warpgroups
// interleave their products and exponentials; setmaxnreg moves registers
// only within a block's launch quota (384 x 80 at two blocks), so a
// consumer gets 104 (256 x 104 + 128 x 24 <= 384 x 80).  At dh = 64 those
// 104 spill; dh 64-128 streams 128-key stages, one block per SM, 240
// registers a consumer (384 x 168).  dh = 160 streams 64-key stages: its Q
// tile and two 128-key stages (48 + 2 x 96 KB) would pass the 227 KB of an
// SM, 64-key ones take 48 + 96 KB.  A 64-query block (256 threads) needs no
// setmaxnreg: at one block per SM every thread may hold 255 registers, at
// two (dh <= 48) 128.
template <int DH, int BQ = WG_BQ> struct FwdWgmma {
  static constexpr int CONSUMERS = BQ / 64;         // warpgroups of 64 query rows
  static constexpr int THREADS = 128 * (CONSUMERS + 1);
  static constexpr int NB = (DH + 63) / 64;         // 64-column boxes per row
  static constexpr int KS = (DH + 15) / 16;         // k-steps of S = Q·Kᵀ
  static constexpr bool PAIR = DH <= 48;            // two blocks per SM
  static constexpr int BK = (PAIR || DH > 128) ? 64 : 128;  // keys per ring stage
  static constexpr int BLOCKS = PAIR ? 2 : 1;
  static constexpr int CONSUMER_REGS = PAIR ? 104 : 240;    // two consumers only
  static constexpr int Q_BYTES = BQ * 128 * NB;
  static constexpr int KV_BYTES = BK * 128 * NB;    // one K or V tile
  static constexpr int BAR_OFF = Q_BYTES + WG_STAGES * 2 * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + 64 + 1024;  // barriers, alignment slack
};

template <int DH, int BQ = WG_BQ>
__device__ __forceinline__ void attn_fwd_wgmma(const CUtensorMap& tq, const CUtensorMap& tk,
                                               const CUtensorMap& tv, bf16* __restrict__ out,
                                               float* __restrict__ lse, int Lq, int Lk, int H,
                                               float scale_log2) {
  using C = FwdWgmma<DH, BQ>;
  constexpr int NB = C::NB, BK = C::BK, KT = BK / 16, NS = BK / 2, ND = DH / 2;
  constexpr bool TURNS = C::CONSUMERS == 2;  // the consumers take turns issuing S
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* const base = hop::align1024(smem_raw);
  unsigned char* const qs = base;                 // [NB][BQ rows][128 B]
  unsigned char* const ring = base + C::Q_BYTES;  // stage s: K at s·2·KV, V after it
  uint64_t* const full = reinterpret_cast<uint64_t*>(base + C::BAR_OFF);
  uint64_t* const empty = full + WG_STAGES;
  uint64_t* const qfull = empty + WG_STAGES;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int nk = (Lk + BK - 1) / BK;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < WG_STAGES; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 128 * C::CONSUMERS);  // every consumer thread releases the stage
    }
    hop::mbar_init(qfull, 1);
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (wg == C::CONSUMERS) {  // producer: one thread issues every copy
    if constexpr (TURNS) hop::reg_dealloc<24>();
    if (threadIdx.x == 128 * C::CONSUMERS) {
      hop::mbar_expect_tx(qfull, C::Q_BYTES);
#pragma unroll
      for (int c = 0; c < NB; ++c) hop::tma_load_4d(qs + c * BQ * 128, &tq, qfull, 64 * c, h, q0, b);
      for (int j = 0; j < nk; ++j) {
        const int s = j % WG_STAGES;
        if (j >= WG_STAGES) hop::mbar_wait(&empty[s], (j / WG_STAGES - 1) & 1);
        unsigned char* const kt = ring + s * 2 * C::KV_BYTES;
        hop::mbar_expect_tx(&full[s], 2 * C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          hop::tma_load_4d(kt + c * BK * 128, &tk, &full[s], 64 * c, h, j * BK, b);
          hop::tma_load_4d(kt + C::KV_BYTES + c * BK * 128, &tv, &full[s], 64 * c, h, j * BK,
                           b);
        }
      }
    }
  } else {  // consumers: warpgroup wg owns queries q0 + 64 wg + [0, 64)
    if constexpr (TURNS) hop::reg_alloc<C::CONSUMER_REGS>();
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32, t = lane % 4;
    const int row0 = q0 + wg * 64 + warp * 16 + lane / 4;  // and row0 + 8
    // a warpgroup past the last query (the second of a block over L <= 64,
    // or of the last block over a ragged L) only releases the stages
    const bool rows = q0 + wg * 64 < Lq;
    const unsigned char* const qw = qs + wg * 64 * 128;
    const int me = 1 + wg, other = 2 - wg;  // named barriers: "warpgroup wg may issue"
    float s[NS], o[ND];
    uint32_t p[KT][4] = {};
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < ND; ++i) o[i] = 0.f;
    float m_i[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_i[2] = {0.f, 0.f};
    if (TURNS && wg == 1) hop::named_arrive(1, 256);  // warpgroup 0 issues first
    hop::mbar_wait(qfull, 0);

    for (int j = 0; j < nk; ++j) {
      const int st = j % WG_STAGES;
      const unsigned char* const kt = ring + st * 2 * C::KV_BYTES;
      hop::mbar_wait(&full[st], (j / WG_STAGES) & 1);
      // S = Q·Kᵀ, issued in this warpgroup's turn; the other warpgroup's
      // turn starts as soon as it is issued
      if constexpr (TURNS) hop::named_sync(me, 256);
      if (rows) {
        hop::fence_regs(s);
        hop::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < C::KS; ++ks)
          hop::Wgmma<BK>::ss(s, hop::desc_kmajor(qw, BQ, ks), hop::desc_kmajor(kt, BK, ks),
                                ks > 0);
        hop::wgmma_commit();
      }
      if (TURNS && !(wg == 1 && j == nk - 1)) hop::named_arrive(other, 256);
      if (rows) {
        hop::wgmma_wait<0>();
        hop::fence_regs(s);

        // online softmax of tile j; element i: row row0 + 8·((i >> 1) & 1),
        // key 8·(i / 4) + 2t + (i & 1) of the tile.  The row max is taken on
        // the unscaled scores (scale > 0).
        const int k0 = j * BK;
        float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
        if (k0 + BK > Lk) {
#pragma unroll
          for (int i = 0; i < NS; ++i)
            if (k0 + 8 * (i / 4) + 2 * t + (i & 1) >= Lk) s[i] = -CUDART_INF_F;
        }
#pragma unroll
        for (int i = 0; i < NS; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
        float alpha[2], ms[2], rs[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {  // the 4 lanes of a quad share a row
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m_i[r], mx[r] * scale_log2);  // finite: every tile holds a key
          alpha[r] = hop::exp2_ftz(m_i[r] - m_new);
          m_i[r] = m_new;
          ms[r] = -m_new;
        }
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          s[i] = hop::exp2_ftz(fmaf(s[i], scale_log2, ms[(i >> 1) & 1]));
          rs[(i >> 1) & 1] += s[i];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
          rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
          l_i[r] = l_i[r] * alpha[r] + rs[r];
        }
#pragma unroll
        for (int i = 0; i < ND; ++i) o[i] *= alpha[(i >> 1) & 1];
        hop::acc_to_a(p, s);

        // O += P·V; then the stage goes back to the producer
        const unsigned char* const vt = kt + C::KV_BYTES;
        hop::fence_regs(o);
        hop::fence_regs(p);
        hop::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) hop::Wgmma<DH>::rs(o, p[kk], hop::desc_mnmajor(vt, BK, kk));
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::fence_regs(o);
        hop::fence_regs(p);
      }
      hop::mbar_arrive(&empty[st]);
    }

    const size_t inner = (size_t)H * DH;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= Lq) continue;
      const float inv = 1.f / l_i[r];
      bf16* const ob = out + ((size_t)blockIdx.z * Lq + row) * inner + (size_t)h * DH + 2 * t;
#pragma unroll
      for (int c = 0; c < DH / 8; ++c)
        *reinterpret_cast<uint32_t*>(ob + 8 * c) =
            pack_bf16(o[4 * c + 2 * r] * inv, o[4 * c + 2 * r + 1] * inv);
      // m and l are in log2 units: ln Σ exp(s) = ln 2 · (m + log2 l)
      if (lse != nullptr && t == 0)
        lse[((size_t)b * H + h) * Lq + row] = 0.6931471805599453f * (m_i[r] + log2f(l_i[r]));
    }
  }
}

// The q, k and v maps of one launch of `attn_fwd_wgmma<DH, BQ>`.
template <int DH, int BQ = WG_BQ>
inline cudaError_t attn_fwd_maps(CUtensorMap (&m)[3], const void* q, const void* k, const void* v,
                                 int B, int Lq, int Lk, int H) {
  cudaError_t err = hop::head_map(&m[0], q, B, Lq, H, DH, BQ);
  if (err == cudaSuccess) err = hop::head_map(&m[1], k, B, Lk, H, DH, FwdWgmma<DH, BQ>::BK);
  if (err == cudaSuccess) err = hop::head_map(&m[2], v, B, Lk, H, DH, FwdWgmma<DH, BQ>::BK);
  return err;
}

// Whether the MHA forward at dh 32 and 160 takes 128-query blocks rather
// than 64-query ones (one consumer warpgroup): where 64-query blocks would
// take more than one wave of the card's `slots` (SMs x 64-query blocks per
// SM: 1 at dh 160, 2 at dh 32).  Kernel µs (CUPTI), 64 / 128 queries, H100
// 80GB HBM3 at 700 W (`chip_smoke.py` `profiled_ms`): SD level 2 at 2
// prompts 8.4 / 12.1 and mid 4.6 / 5.4 (dh 160, 128 and 32 blocks of 64);
// the RDM at 3 prompts (dh 32; 3024, 1512, 756 and 336 blocks of 64) level
// 0 272 / 237, level 1 44.4 / 38.9, level 2 13.1 / 11.9, mid 5.4 / 5.7; at
// 1 prompt level 2 (252) 4.9 / 6.4 and mid (112) 2.9 / 3.2.
inline bool mha_wide(int Lq, int H, int B, int slots) {
  return (long)((Lq + 63) / 64) * H * B > (long)slots;
}

}  // namespace dsta
