// Flash-attention backward for Hopper, sm_90a, CUDA C++: K2 (dQ) and K3
// (dK, dV).
//
// Replaces ray_tpu/ops/pallas/flash_attention.py::_dq_kernel (K2, launched
// by _flash_bwd_impl, pl.pallas_call at :310) and ::_dkv_kernel (K3,
// pl.pallas_call at :349).  Both recompute the probabilities from the
// forward's fp32 log-sum-exp, as _recompute_p does:
//   P  = exp(S * scale - lse), S = Q K^T, masked (pad keys, pad queries,
//        keys past the causal diagonal) to 0 (JAX: logit -1e30, exp -> 0);
//   dP = dO V^T;  dS = P * (dP - D), D = rowsum(dO * O) given in fp32;
//   K2: dQ = scale * dS K           (dS cast to K's dtype first);
//   K3: dV = P^T dO                 (P cast to dO's dtype first),
//       dK = scale * dS^T Q         (dS cast to Q's dtype first),
// with every product accumulated in fp32 and the result written in the
// input dtype.  GQA by index: q-head hi reads kv-head hi / (h / kv_h).
//
// Layouts (the Python wrapper checks them):
//   q, do [b, sq, h, d] and k, v [b, sk, kv_h, d]: any strides on b/s/h,
//     unit stride on d; for bf16 the base and those strides 16-byte
//     aligned (K2's and K3's TMA loads);
//   lse, delta [b, h, sq] contiguous fp32 (K1's lse layout);
//   lsed [b * h, 2, nq * 64] fp32, lse then D per head, zero past sq (K3,
//     bf16: rows of 64 that a bulk copy can take whole);
//   dq [b, sq, h, d], dk/dv [b, sk, kv_h, d], contiguous.
//
// What bounds them on an H100: K2 does 6*d FLOPs and K3 8*d FLOPs per
// visible (q, k) pair against ~4*d bytes per row, so at the training
// shapes (s = 2048, d = 128) both are bound by operations: the bf16 tensor
// cores' 989 TFLOP/s.
//
// K3, bf16 (the main path): flash_bwd_dkv_wgmma_kernel.  One block per
// (b*kv_h, 128-row k-tile); each of its two consumer warpgroups owns 64 k
// rows and keeps their dK and dV (64 x d fp32 each) in registers.  K and V
// stay resident in shared memory (bf16, loaded once by TMA); Q and dO
// tiles of 64 rows with their lse and D rows stream through a three-stage
// ring (TMA and bulk copies with mbarrier completion; thread 0 refills the
// stage the previous tile freed) over the n_rep grouped q-heads x the
// q-tiles from the causal diagonal on.  Everything is computed transposed
// so that each product is a wgmma with fp32 accumulators:
//   S^T  = K Q^T          SS, A = K, B = Q K-major
//   P^T  = exp(S^T * scale - lse[q]) in registers
//   dV  += bf16(P^T) dO   RS, B = dO MN-major
//   dP^T = V dO^T         SS, A = V, B = dO K-major
//   dS^T = P^T * (dP^T - D[q])
//   dK  += bf16(dS^T) Q   RS, B = Q MN-major
// dK is scaled once at the end.  The grouped q-heads sum onto their kv
// head inside the block: race-free, no atomics, as in the Pallas grid.
// k-tiles are launched heaviest (the causal start) first.
//
// K2, bf16 (the main path): flash_bwd_dq_wgmma_kernel.  One block per
// (b*h, 128-row q-tile), b*h on grid x, q-tiles launched heaviest (the
// causal diagonal's far end) first; each of its two consumer warpgroups
// owns 64 q rows and keeps their dQ (64 x d fp32) in registers, with the
// lse and D of its two rows per thread read once.  Q and dO stay resident
// in shared memory (loaded once by TMA); K and V tiles of 64 keys stream
// through a three-stage TMA ring (thread 0 refills the stage both
// warpgroups freed) up to the diagonal of the block's last row.  Per tile:
//   S   = Q K^T           SS, A = Q, B = K K-major
//   dP  = dO V^T          SS, A = dO, B = V K-major (alternating with S)
//   dS  = exp(S * scale - lse) * (dP - D) in registers (P not rounded)
//   dQ += bf16(dS) K      RS, B = the same K tile MN-major
// S and dP are summed over d one k16 slice at a time, each slice a wgmma
// into a fresh accumulator added to the sum with round-to-nearest fp32
// adds.  dS is rounded to bf16 before dS K, and a large dS whose fp32
// value lands on the other side of a rounding midpoint moves its whole
// row of dQ; summed over all of d inside the tensor cores, S and dP stand
// further from their exact values and move many times more rows of dQ
// than the plain version's fp32 sums (chip_smoke.py's dq_flipped_vs_exact
// counts them).  Only the diagonal and ragged tiles are masked; dQ is
// scaled once at the end and rows past sq are not written.
//
// K2 and K3 in float32: the first design, fp32 FMA on the CUDA cores (a
// tensor-core fp32 path would be TF32, which cannot hold the fp32
// tolerances).  K2: one block owns one (b*h, 64-row q-tile) and loops over
// the 64-row k-tiles up to the causal diagonal, dQ in registers; K3: one
// block owns one (b*kv_h, 64-row k-tile) and loops over all n_rep grouped
// q-heads x the q-tiles from the diagonal on.  Tiles are staged in shared
// memory as fp32 with rows padded by 4 floats; each thread owns a 4 x 4
// block of the 64 x 64 score tile and a 4 x (d / 16) block of the output
// rows.
//
// How the TPU design changes here: the Pallas kernels carry dQ (resp. dK,
// dV) in VMEM scratch across the sequential innermost grid dimension.
// Thread blocks on Hopper run in no order, so each block loops over the
// other side's tiles itself.  Ragged edges are masked in the kernels:
// there are no pad or head-folding copies.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

// ---- K3, bf16: wgmma + TMA ------------------------------------------------

namespace wg {

constexpr int BKR = 128;    // k rows per block: 64 per consumer warpgroup
constexpr int BQ = 64;      // q rows per streamed tile
constexpr int STAGES = 3;   // Q/dO ring depth
constexpr int NT = 256;

struct Args {
  CUtensorMap tq, tdo, tk, tv;  // box {64, 1, rows, 1} over [b, s, h, d]
  const float* lsed;            // [b * h, 2, nq * BQ]
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int sq, sk, h, kvh, n_rep, causal, nq;
  float scale;
};

template <int D>
struct Smem {
  static constexpr uint32_t KV_BYTES = BKR * D * 2;  // [D/64][BKR][64]
  static constexpr uint32_t TILE = BQ * D * 2;       // [D/64][BQ][64]
  static constexpr uint32_t STAGE_BYTES = 2 * TILE;  // Q then dO
  static constexpr uint32_t STAGE0 = 2 * KV_BYTES;   // after K and V
  static constexpr uint32_t ROWS = STAGE0 + STAGES * STAGE_BYTES;
  static constexpr uint32_t BAR = ROWS + STAGES * 2 * BQ * 4;
  static constexpr uint32_t TOTAL = BAR + 8 * (1 + 2 * STAGES) + 1024;
};

// streamed tile i of the block: grouped head i / nqb, q-tile qt0 + i % nqb
template <int D>
__device__ __forceinline__ void issue_tile(const Args& a, uint8_t* stage,
                                           float* rows, uint64_t* full,
                                           int i, int qt0, int nqb, int bi,
                                           int kvi) {
  using S = Smem<D>;
  const int hi = kvi * a.n_rep + i / nqb;
  const int q0 = (qt0 + i % nqb) * BQ;
  const long long bh = static_cast<long long>(bi) * a.h + hi;
  hopper::mbar_arrive_expect_tx(full, S::STAGE_BYTES + 2 * BQ * 4);
#pragma unroll
  for (int c = 0; c < D / 64; ++c) {
    hopper::tma_load_4d(stage + c * BQ * 128, &a.tq, full, 64 * c, hi, q0,
                        bi);
    hopper::tma_load_4d(stage + S::TILE + c * BQ * 128, &a.tdo, full, 64 * c,
                        hi, q0, bi);
  }
  const float* src = a.lsed + bh * 2 * a.nq * BQ + q0;
  hopper::bulk_load(rows, src, BQ * 4, full);
  hopper::bulk_load(rows + BQ, src + a.nq * BQ, BQ * 4, full);
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ Args a) {
  using S = Smem<D>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sk = smem;
  uint8_t* sv = smem + S::KV_BYTES;
  uint8_t* sst = smem + S::STAGE0;
  float* srows = reinterpret_cast<float*>(smem + S::ROWS);
  uint64_t* kv_bar = reinterpret_cast<uint64_t*>(smem + S::BAR);
  uint64_t* full = kv_bar + 1;
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int wgi = tid / 128;  // consumer warpgroup: k rows 64 wgi ..
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int bi = blockIdx.x / a.kvh;
  const int kvi = blockIdx.x % a.kvh;
  const int k0 = blockIdx.y * BKR;
  // q-tiles wholly above the diagonal see none of this k-tile
  const int qt0 = a.causal ? k0 / BQ : 0;
  const int nqb = max(a.nq - qt0, 0);
  const int n_tiles = a.n_rep * nqb;

  if (tid == 0) {
    hopper::mbar_init(kv_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], NT);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_arrive_expect_tx(kv_bar, 2 * S::KV_BYTES);
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      hopper::tma_load_4d(sk + c * BKR * 128, &a.tk, kv_bar, 64 * c, kvi, k0,
                          bi);
      hopper::tma_load_4d(sv + c * BKR * 128, &a.tv, kv_bar, 64 * c, kvi, k0,
                          bi);
    }
    for (int s = 0; s < STAGES && s < n_tiles; ++s)
      issue_tile<D>(a, sst + s * S::STAGE_BYTES, srows + s * 2 * BQ,
                    &full[s], s, qt0, nqb, bi, kvi);
  }

  // k rows of this thread: r_lo and r_lo + 8 (the accumulator layout)
  const int kr0 = k0 + 64 * wgi;  // this warpgroup's first k row
  const int r_lo = kr0 + 16 * warp + lane / 4;
  const int c_lo = 2 * (lane % 4);
  const uint32_t k_base = hopper::smem_u32(sk) + wgi * 64 * 128;
  const uint32_t v_base = hopper::smem_u32(sv) + wgi * 64 * 128;
  const float sl2 = a.scale * hopper::LOG2E;
  float dk[D / 2], dv[D / 2];
  hopper::zero(dk);
  hopper::zero(dv);
  hopper::mbar_wait(kv_bar, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES;
    if (tid == 0 && i >= 1 && i + STAGES - 1 < n_tiles) {
      // refill the stage tile i - 1 used, once both warpgroups freed it
      const int ps = (i - 1) % STAGES;
      hopper::mbar_wait(&empty[ps], ((i - 1) / STAGES) & 1);
      issue_tile<D>(a, sst + ps * S::STAGE_BYTES, srows + ps * 2 * BQ,
                    &full[ps], i + STAGES - 1, qt0, nqb, bi, kvi);
    }
    __syncwarp();
    const int q0 = (qt0 + i % nqb) * BQ;
    hopper::mbar_wait(&full[s], (i / STAGES) & 1);
    // every q row of the tile before this warpgroup's k rows: no work
    const bool skip = a.causal && q0 + BQ - 1 < kr0;
    if (!skip) {
      const uint32_t q_base = hopper::smem_u32(sst + s * S::STAGE_BYTES);
      const uint32_t do_base = q_base + S::TILE;
      const float* lse_s = srows + s * 2 * BQ;
      const float* dd_s = lse_s + BQ;

      float st[BQ / 2];  // S^T, then P^T, then dS^T: rows k, columns q
      hopper::zero(st);
      hopper::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        hopper::wgmma_m64n64k16_ss<0>(
            st, hopper::desc_k_major(k_base, BKR * 128, ks),
            hopper::desc_k_major(q_base, BQ * 128, ks), ks > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(st);

      const bool masked = (a.causal && q0 < kr0 + 63) || q0 + BQ > a.sq ||
                          kr0 + 64 > a.sk;
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * j + c_lo + c;
          const float neg_lse = -lse_s[col] * hopper::LOG2E;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float& x = st[4 * j + 2 * r + c];
            x = exp2f(fmaf(x, sl2, neg_lse));
            if (masked) {
              const int qp = q0 + col, kp = r_lo + 8 * r;
              if (qp >= a.sq || kp >= a.sk || (a.causal && qp < kp)) x = 0.f;
            }
          }
        }
      uint32_t pf[BQ / 16][4];  // bf16(P^T): A of dV += P^T dO
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        hopper::acc_to_a_frag(st, kk, pf[kk]);
      float dp[BQ / 2];  // dP^T = V dO^T
      hopper::zero(dp);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        if constexpr (D == 128)
          hopper::wgmma_m64n128k16_rs<1>(
              dv, pf[kk], hopper::desc_mn_major(do_base, BQ * 128, kk), 1);
        else
          hopper::wgmma_m64n64k16_rs<1>(
              dv, pf[kk], hopper::desc_mn_major(do_base, BQ * 128, kk), 1);
      }
      hopper::wgmma_commit();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        hopper::wgmma_m64n64k16_ss<0>(
            dp, hopper::desc_k_major(v_base, BKR * 128, ks),
            hopper::desc_k_major(do_base, BQ * 128, ks), ks > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dp);
      hopper::fence_regs(dv);

#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float dd = dd_s[8 * j + c_lo + c];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int e = 4 * j + 2 * r + c;
            st[e] = st[e] * (dp[e] - dd);
          }
        }
      uint32_t dsf[BQ / 16][4];  // bf16(dS^T): A of dK += dS^T Q
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        hopper::acc_to_a_frag(st, kk, dsf[kk]);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        if constexpr (D == 128)
          hopper::wgmma_m64n128k16_rs<1>(
              dk, dsf[kk], hopper::desc_mn_major(q_base, BQ * 128, kk), 1);
        else
          hopper::wgmma_m64n64k16_rs<1>(
              dk, dsf[kk], hopper::desc_mn_major(q_base, BQ * 128, kk), 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dk);
    }
    hopper::mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kp = r_lo + 8 * r;
    if (kp >= a.sk) continue;
    const long long row =
        ((static_cast<long long>(bi) * a.sk + kp) * a.kvh + kvi) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + c_lo;
      *reinterpret_cast<uint32_t*>(a.dk + row + col) = hopper::pack_bf16(
          a.scale * dk[4 * j + 2 * r], a.scale * dk[4 * j + 2 * r + 1]);
      *reinterpret_cast<uint32_t*>(a.dv + row + col) =
          hopper::pack_bf16(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
    }
  }
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lsed, void* dk,
                       void* dv, int b, int sq, int sk, int h, int kvh,
                       int causal, const long long* qs, const long long* ks,
                       const long long* vs, const long long* os, float scale,
                       cudaStream_t stream) {
  Args a;
  if (!hopper::make_bshd_map(&a.tq, q, b, sq, h, D, qs[0], qs[1], qs[2], BQ)
      || !hopper::make_bshd_map(&a.tdo, dout, b, sq, h, D, os[0], os[1],
                                os[2], BQ)
      || !hopper::make_bshd_map(&a.tk, k, b, sk, kvh, D, ks[0], ks[1], ks[2],
                                BKR)
      || !hopper::make_bshd_map(&a.tv, v, b, sk, kvh, D, vs[0], vs[1], vs[2],
                                BKR))
    return cudaErrorInvalidValue;
  a.lsed = lsed;
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.sq = sq; a.sk = sk; a.h = h; a.kvh = kvh; a.n_rep = h / kvh;
  a.causal = causal;
  a.nq = (sq + BQ - 1) / BQ;
  a.scale = scale;
  const int smem = Smem<D>::TOTAL;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_wgmma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * kvh, (sk + BKR - 1) / BKR);
  flash_bwd_dkv_wgmma_kernel<D><<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace wg

// ---- K2, bf16: wgmma + TMA ------------------------------------------------

namespace wg_dq {

constexpr int BQ = 128;     // q rows per block: 64 per consumer warpgroup
constexpr int BK = 64;      // keys per K/V tile
constexpr int STAGES = 3;   // K/V ring depth
constexpr int NT = 256;

struct Args {
  CUtensorMap tq, tdo, tk, tv;  // box {64, 1, rows, 1} over [b, s, h, d]
  const float* lse;             // [b, h, sq]
  const float* delta;           // [b, h, sq]
  __nv_bfloat16* dq;            // [b, sq, h, d], contiguous
  int sq, sk, h, n_rep, causal, nqt;
  float scale;
};

template <int D>
struct Smem {
  static constexpr uint32_t Q_BYTES = BQ * D * 2;        // [D/64][BQ][64]
  static constexpr uint32_t KV_BYTES = BK * D * 2;       // [D/64][BK][64]
  static constexpr uint32_t STAGE_BYTES = 2 * KV_BYTES;  // K then V
  static constexpr uint32_t STAGE0 = 2 * Q_BYTES;        // after Q and dO
  static constexpr uint32_t BAR = STAGE0 + STAGES * STAGE_BYTES;
  static constexpr uint32_t TOTAL = BAR + 8 * (1 + 2 * STAGES) + 1024;
};

template <int D>
__device__ __forceinline__ void issue_kv(const Args& a, uint8_t* stage,
                                         uint64_t* full, int kt, int kvi,
                                         int bi) {
  using S = Smem<D>;
  hopper::mbar_arrive_expect_tx(full, S::STAGE_BYTES);
#pragma unroll
  for (int c = 0; c < D / 64; ++c) {
    hopper::tma_load_4d(stage + c * BK * 128, &a.tk, full, 64 * c, kvi,
                        kt * BK, bi);
    hopper::tma_load_4d(stage + S::KV_BYTES + c * BK * 128, &a.tv, full,
                        64 * c, kvi, kt * BK, bi);
  }
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ Args a) {
  using S = Smem<D>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sq = smem;
  uint8_t* sdo = smem + S::Q_BYTES;
  uint8_t* skv = smem + S::STAGE0;
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(smem + S::BAR);
  uint64_t* full = q_bar + 1;
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int wgi = tid / 128;  // consumer warpgroup: q rows 64 wgi ..
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int bh = blockIdx.x;
  const int bi = bh / a.h;
  const int hi = bh % a.h;
  const int kvi = hi / a.n_rep;
  const int q0 = (a.nqt - 1 - static_cast<int>(blockIdx.y)) * BQ;

  int nk = (a.sk + BK - 1) / BK;
  // causal tile skip: up to the diagonal of the block's last real row
  if (a.causal) nk = min(nk, (min(q0 + BQ, a.sq) - 1) / BK + 1);

  if (tid == 0) {
    hopper::mbar_init(q_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], NT);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_arrive_expect_tx(q_bar, 2 * S::Q_BYTES);
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      hopper::tma_load_4d(sq + c * BQ * 128, &a.tq, q_bar, 64 * c, hi, q0,
                          bi);
      hopper::tma_load_4d(sdo + c * BQ * 128, &a.tdo, q_bar, 64 * c, hi, q0,
                          bi);
    }
    for (int s = 0; s < STAGES && s < nk; ++s)
      issue_kv<D>(a, skv + s * S::STAGE_BYTES, &full[s], s, kvi, bi);
  }

  // rows of this thread: r_lo and r_lo + 8 (the accumulator layout); their
  // lse and D, zero past sq
  const int row0 = q0 + 64 * wgi;  // this warpgroup's first q row
  const int r_lo = row0 + 16 * warp + lane / 4;
  const int c_lo = 2 * (lane % 4);
  float lse[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = r_lo + 8 * r;
    const long long at = static_cast<long long>(bh) * a.sq + qp;
    lse[r] = qp < a.sq ? a.lse[at] : 0.f;
    dd[r] = qp < a.sq ? a.delta[at] : 0.f;
  }
  const uint32_t q_base = hopper::smem_u32(sq) + wgi * 64 * 128;
  const uint32_t do_base = hopper::smem_u32(sdo) + wgi * 64 * 128;
  float dq[D / 2];
  hopper::zero(dq);
  hopper::mbar_wait(q_bar, 0);

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    if (tid == 0 && kt >= 1 && kt + STAGES - 1 < nk) {
      // refill the stage tile kt - 1 used, once both warpgroups freed it
      const int ps = (kt - 1) % STAGES;
      hopper::mbar_wait(&empty[ps], ((kt - 1) / STAGES) & 1);
      issue_kv<D>(a, skv + ps * S::STAGE_BYTES, &full[ps], kt + STAGES - 1,
                  kvi, bi);
    }
    __syncwarp();
    hopper::mbar_wait(&full[s], (kt / STAGES) & 1);
    const int k0 = kt * BK;
    // all 64 rows past sq, or every key of the tile past their diagonal
    const bool skip = row0 >= a.sq || (a.causal && k0 > row0 + 63);
    if (!skip) {
      const uint32_t k_base = hopper::smem_u32(skv + s * S::STAGE_BYTES);
      const uint32_t v_base = k_base + S::KV_BYTES;
      // S = Q K^T and dP = dO V^T, each k16 slice of d into a fresh
      // accumulator (ts, td) and summed in fp32 registers with
      // round-to-nearest adds; S and dP alternate, so one slice is in
      // flight while the other is added
      float sc[BK / 2];  // S, then dS: rows q, columns k
      float dp[BK / 2];  // dP = dO V^T
      float ts[BK / 2], td[BK / 2];
      hopper::zero(sc);
      hopper::zero(dp);
      hopper::wgmma_fence();
      hopper::wgmma_m64n64k16_ss<0>(
          ts, hopper::desc_k_major(q_base, BQ * 128, 0),
          hopper::desc_k_major(k_base, BK * 128, 0), 0);
      hopper::wgmma_commit();
      hopper::wgmma_m64n64k16_ss<0>(
          td, hopper::desc_k_major(do_base, BQ * 128, 0),
          hopper::desc_k_major(v_base, BK * 128, 0), 0);
      hopper::wgmma_commit();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const bool more = ks + 1 < D / 16;
        hopper::wgmma_wait<1>();  // S's slice ks
        hopper::fence_regs(ts);
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) sc[i] += ts[i];
        if (more) {
          hopper::wgmma_fence();
          hopper::wgmma_m64n64k16_ss<0>(
              ts, hopper::desc_k_major(q_base, BQ * 128, ks + 1),
              hopper::desc_k_major(k_base, BK * 128, ks + 1), 0);
          hopper::wgmma_commit();
          hopper::wgmma_wait<1>();  // dP's slice ks
        } else {
          hopper::wgmma_wait<0>();
        }
        hopper::fence_regs(td);
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) dp[i] += td[i];
        if (more) {
          hopper::wgmma_fence();
          hopper::wgmma_m64n64k16_ss<0>(
              td, hopper::desc_k_major(do_base, BQ * 128, ks + 1),
              hopper::desc_k_major(v_base, BK * 128, ks + 1), 0);
          hopper::wgmma_commit();
        }
      }

      // P = exp(S * scale - lse), masked only on the diagonal and ragged
      // tiles; dS = P * (dP - D) in fp32 (P is not rounded).  The exponent
      // is rounded as JAX and the plain version round it (the product,
      // then the difference) and exp is the accurate expf, so P differs
      // from theirs only through the sums S.
      const bool masked =
          (a.causal && k0 + BK - 1 > row0) || k0 + BK > a.sk;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 4 * j + 2 * r + c;
            float p = expf(__fsub_rn(__fmul_rn(sc[e], a.scale), lse[r]));
            if (masked) {
              const int kp = k0 + 8 * j + c_lo + c, qp = r_lo + 8 * r;
              if (kp >= a.sk || (a.causal && kp > qp)) p = 0.f;
            }
            sc[e] = p * (dp[e] - dd[r]);
          }
      uint32_t dsf[BK / 16][4];  // bf16(dS): A of dQ += dS K
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        hopper::acc_to_a_frag(sc, kk, dsf[kk]);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        if constexpr (D == 128)
          hopper::wgmma_m64n128k16_rs<1>(
              dq, dsf[kk], hopper::desc_mn_major(k_base, BK * 128, kk), 1);
        else
          hopper::wgmma_m64n64k16_rs<1>(
              dq, dsf[kk], hopper::desc_mn_major(k_base, BK * 128, kk), 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dq);
    }
    hopper::mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = r_lo + 8 * r;
    if (qp >= a.sq) continue;
    __nv_bfloat16* row =
        a.dq + ((static_cast<long long>(bi) * a.sq + qp) * a.h + hi) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j + c_lo) = hopper::pack_bf16(
          a.scale * dq[4 * j + 2 * r], a.scale * dq[4 * j + 2 * r + 1]);
  }
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int b, int sq, int sk, int h, int kvh,
                      int causal, const long long* qs, const long long* ks,
                      const long long* vs, const long long* os, float scale,
                      cudaStream_t stream) {
  Args a;
  if (!hopper::make_bshd_map(&a.tq, q, b, sq, h, D, qs[0], qs[1], qs[2], BQ)
      || !hopper::make_bshd_map(&a.tdo, dout, b, sq, h, D, os[0], os[1],
                                os[2], BQ)
      || !hopper::make_bshd_map(&a.tk, k, b, sk, kvh, D, ks[0], ks[1], ks[2],
                                BK)
      || !hopper::make_bshd_map(&a.tv, v, b, sk, kvh, D, vs[0], vs[1], vs[2],
                                BK))
    return cudaErrorInvalidValue;
  a.lse = lse;
  a.delta = delta;
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.sq = sq; a.sk = sk; a.h = h; a.n_rep = h / kvh; a.causal = causal;
  a.nqt = (sq + BQ - 1) / BQ;
  a.scale = scale;
  const int smem = Smem<D>::TOTAL;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * h, a.nqt);
  flash_bwd_dq_wgmma_kernel<D><<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace wg_dq

// ---- K2 and K3 in float32: fp32 FMA on the CUDA cores ---------------------

constexpr int BQ = 64;   // q rows per tile
constexpr int BK = 64;   // k rows per tile
constexpr int NT = 256;  // threads per block, a 16 x 16 grid
constexpr int PS = 64 + 4;  // padded row stride of the 64 x 64 score tiles

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  int b, sq, sk, h, kvh, causal;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;  // dO
  float scale;
};

// rows [r0, r0 + 64) of a [s, d] slice (row stride ss) into a padded fp32
// tile; rows at or past s are zero
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long ss, int r0, int s) {
  constexpr int QS = D + 4;
  for (int idx = threadIdx.x; idx < 64 * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    const int row = r0 + r;
    dst[r * QS + c] = row < s ? src[row * ss + c] : 0.f;
  }
}

// acc[i][j] = A[4ty + i] . B[tx + 16j] over D, A and B padded fp32 tiles
template <int D>
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const float* A,
                                         const float* B, int tx, int ty) {
  constexpr int QS = D + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < D; c += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(&A[(4 * ty + i) * QS + c]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(&B[(tx + 16 * j) * QS + c]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float a = acc[i][j];
        a = fmaf(av[i].x, bv[j].x, a);
        a = fmaf(av[i].y, bv[j].y, a);
        a = fmaf(av[i].z, bv[j].z, a);
        a = fmaf(av[i].w, bv[j].w, a);
        acc[i][j] = a;
      }
  }
}

// acc[i][g][c] += sum_r W[4ty + i][r] * X[r][64g + 4tx + c] over the 64
// rows r of X (W a [64][PS] score tile, X a padded [64][D + 4] tile)
template <int D>
__device__ __forceinline__ void tile_acc(float (&acc)[4][D / 64][4],
                                         const float* W, const float* X,
                                         int tx, int ty) {
  constexpr int QS = D + 4;
  constexpr int NG = D / 64;
#pragma unroll 2
  for (int r = 0; r < 64; r += 4) {
    float4 w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = *reinterpret_cast<const float4*>(&W[(4 * ty + i) * PS + r]);
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int col = 64 * g + 4 * tx;
      const float4 x0 = *reinterpret_cast<const float4*>(&X[(r + 0) * QS + col]);
      const float4 x1 = *reinterpret_cast<const float4*>(&X[(r + 1) * QS + col]);
      const float4 x2 = *reinterpret_cast<const float4*>(&X[(r + 2) * QS + col]);
      const float4 x3 = *reinterpret_cast<const float4*>(&X[(r + 3) * QS + col]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][g][0] = fmaf(w[i].w, x3.x, fmaf(w[i].z, x2.x,
                       fmaf(w[i].y, x1.x, fmaf(w[i].x, x0.x, acc[i][g][0]))));
        acc[i][g][1] = fmaf(w[i].w, x3.y, fmaf(w[i].z, x2.y,
                       fmaf(w[i].y, x1.y, fmaf(w[i].x, x0.y, acc[i][g][1]))));
        acc[i][g][2] = fmaf(w[i].w, x3.z, fmaf(w[i].z, x2.z,
                       fmaf(w[i].y, x1.z, fmaf(w[i].x, x0.z, acc[i][g][2]))));
        acc[i][g][3] = fmaf(w[i].w, x3.w, fmaf(w[i].z, x2.w,
                       fmaf(w[i].y, x1.w, fmaf(w[i].x, x0.w, acc[i][g][3]))));
      }
    }
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * 64 * (D + 4) + 64 * PS);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (4 * 64 * (D + 4) + 2 * 64 * PS + 2 * 64);
}

// K2, fp32: dQ for one (b*h, 64-row q-tile), looping over k-tiles.  In
// fp32 the casts of P and dS before their products are no-ops.
template <int D>
__global__ void __launch_bounds__(NT, 1) flash_bwd_dq_kernel(const Params p) {
  constexpr int QS = D + 4;
  constexpr int NG = D / 64;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [BQ][QS]
  float* dOs = Qs + BQ * QS;                    // [BQ][QS]
  float* Ks = dOs + BQ * QS;                    // [BK][QS]
  float* Vs = Ks + BK * QS;                     // [BK][QS]
  float* dSs = Vs + BK * QS;                    // [BQ][PS]

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // score columns tx + 16j; dQ columns 64g+4tx+c
  const int ty = tid >> 4;  // rows 4ty .. 4ty+3 of the scores and of dQ
  const int bh = blockIdx.y;
  const int bi = bh / p.h;
  const int hi = bh % p.h;
  const int kvi = hi / (p.h / p.kvh);
  const int q0 = blockIdx.x * BQ;

  const float* qg =

      static_cast<const float*>(p.q) + bi * p.q_sb + hi * p.q_sh;
  const float* og =
      static_cast<const float*>(p.dout) + bi * p.o_sb + hi * p.o_sh;
  const float* kg =
      static_cast<const float*>(p.k) + bi * p.k_sb + kvi * p.k_sh;
  const float* vg =
      static_cast<const float*>(p.v) + bi * p.v_sb + kvi * p.v_sh;

  load_tile<D>(Qs, qg, p.q_ss, q0, p.sq);
  load_tile<D>(dOs, og, p.o_ss, q0, p.sq);
  float lse[4], dd[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + 4 * ty + i;
    const long long at = static_cast<long long>(bh) * p.sq + qp;
    lse[i] = qp < p.sq ? p.lse[at] : 0.f;
    dd[i] = qp < p.sq ? p.delta[at] : 0.f;
  }

  float acc[4][NG][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][g][c] = 0.f;

  int nk = (p.sk + BK - 1) / BK;
  if (p.causal) nk = min(nk, (q0 + BQ - 1) / BK + 1);  // causal tile skip

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // last tile's readers are done; Q and dO are visible
    load_tile<D>(Ks, kg, p.k_ss, k0, p.sk);
    load_tile<D>(Vs, vg, p.v_ss, k0, p.sk);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dot<D>(s, Qs, Ks, tx, ty);
    tile_dot<D>(dp, dOs, Vs, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool ok = qp < p.sq && kp < p.sk && (!p.causal || qp >= kp);
        const float pr = ok ? expf(s[i][j] * p.scale - lse[i]) : 0.f;
        dSs[(4 * ty + i) * PS + tx + 16 * j] = pr * (dp[i][j] - dd[i]);
      }
    }
    __syncthreads();
    tile_acc<D>(acc, dSs, Ks, tx, ty);
  }

  float* dqg = static_cast<float*>(p.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + 4 * ty + i;
    if (qp >= p.sq) continue;
    float* row =
        dqg + ((static_cast<long long>(bi) * p.sq + qp) * p.h + hi) * D;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        row[64 * g + 4 * tx + c] = p.scale * acc[i][g][c];
  }
}

// K3, fp32: dK and dV for one (b*kv_h, 64-row k-tile), looping over the
// n_rep grouped q-heads and the q-tiles from the causal diagonal on.
template <int D>
__global__ void __launch_bounds__(NT, 1) flash_bwd_dkv_kernel(const Params p) {
  constexpr int QS = D + 4;
  constexpr int NG = D / 64;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // [BK][QS]
  float* Vs = Ks + BK * QS;                     // [BK][QS]
  float* Qs = Vs + BK * QS;                     // [BQ][QS]
  float* dOs = Qs + BQ * QS;                    // [BQ][QS]
  float* Ps = dOs + BQ * QS;                    // [BK][PS], P^T
  float* dSs = Ps + BK * PS;                    // [BK][PS], dS^T
  float* lse_s = dSs + BK * PS;                 // [BQ]
  float* dd_s = lse_s + BQ;                     // [BQ]

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // score columns (q rows) tx + 16j
  const int ty = tid >> 4;  // k rows 4ty .. 4ty+3 of the scores, dK, dV
  const int bkv = blockIdx.y;
  const int bi = bkv / p.kvh;
  const int kvi = bkv % p.kvh;
  const int n_rep = p.h / p.kvh;
  const int k0 = blockIdx.x * BK;

  const float* kg =

      static_cast<const float*>(p.k) + bi * p.k_sb + kvi * p.k_sh;
  const float* vg =
      static_cast<const float*>(p.v) + bi * p.v_sb + kvi * p.v_sh;
  load_tile<D>(Ks, kg, p.k_ss, k0, p.sk);
  load_tile<D>(Vs, vg, p.v_ss, k0, p.sk);

  float acc_k[4][NG][4], acc_v[4][NG][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc_k[i][g][c] = 0.f;
        acc_v[i][g][c] = 0.f;
      }

  const int nq = (p.sq + BQ - 1) / BQ;
  // q-tiles wholly above the diagonal see none of this k-tile
  const int qt0 = p.causal ? k0 / BQ : 0;

  for (int rep = 0; rep < n_rep; ++rep) {
    const int hi = kvi * n_rep + rep;
    const int bh = bi * p.h + hi;
    const float* qg =
        static_cast<const float*>(p.q) + bi * p.q_sb + hi * p.q_sh;
    const float* og =
        static_cast<const float*>(p.dout) + bi * p.o_sb + hi * p.o_sh;
    for (int qt = qt0; qt < nq; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // last tile's readers are done; K and V are visible
      load_tile<D>(Qs, qg, p.q_ss, q0, p.sq);
      load_tile<D>(dOs, og, p.o_ss, q0, p.sq);
      if (tid < BQ) {
        const int qp = q0 + tid;
        const long long at = static_cast<long long>(bh) * p.sq + qp;
        lse_s[tid] = qp < p.sq ? p.lse[at] : 0.f;
        dd_s[tid] = qp < p.sq ? p.delta[at] : 0.f;
      }
      __syncthreads();

      float st[4][4], dpt[4][4];  // S^T and dP^T: rows k, columns q
      tile_dot<D>(st, Ks, Qs, tx, ty);
      tile_dot<D>(dpt, Vs, dOs, tx, ty);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kp = k0 + 4 * ty + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qr = tx + 16 * j;
          const int qp = q0 + qr;
          const bool ok = qp < p.sq && kp < p.sk && (!p.causal || qp >= kp);
          const float pr = ok ? expf(st[i][j] * p.scale - lse_s[qr]) : 0.f;
          Ps[(4 * ty + i) * PS + qr] = pr;
          dSs[(4 * ty + i) * PS + qr] = pr * (dpt[i][j] - dd_s[qr]);
        }
      }
      __syncthreads();
      tile_acc<D>(acc_v, Ps, dOs, tx, ty);
      tile_acc<D>(acc_k, dSs, Qs, tx, ty);
    }
  }

  float* dkg = static_cast<float*>(p.dk);
  float* dvg = static_cast<float*>(p.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k0 + 4 * ty + i;
    if (kp >= p.sk) continue;
    const long long row =
        ((static_cast<long long>(bi) * p.sk + kp) * p.kvh + kvi) * D;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 64 * g + 4 * tx + c;
        dkg[row + col] = p.scale * acc_k[i][g][c];
        dvg[row + col] = acc_v[i][g][c];
      }
  }
}

template <int D>
cudaError_t launch_dq_fp32(const Params& p, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + BQ - 1) / BQ, p.b * p.h);
  flash_bwd_dq_kernel<D><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_fp32(const Params& p, cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sk + BK - 1) / BK, p.b * p.kvh);
  flash_bwd_dkv_kernel<D><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_bf16(const Params& p, const float* lsed,
                            cudaStream_t stream) {
  const long long qs[3] = {p.q_sb, p.q_ss, p.q_sh};
  const long long ks[3] = {p.k_sb, p.k_ss, p.k_sh};
  const long long vs[3] = {p.v_sb, p.v_ss, p.v_sh};
  const long long os[3] = {p.o_sb, p.o_ss, p.o_sh};
  return wg::launch_dkv<D>(p.q, p.k, p.v, p.dout, lsed, p.dk, p.dv, p.b,
                           p.sq, p.sk, p.h, p.kvh, p.causal, qs, ks, vs, os,
                           p.scale, stream);
}

template <int D>
cudaError_t launch_dq_bf16(const Params& p, cudaStream_t stream) {
  const long long qs[3] = {p.q_sb, p.q_ss, p.q_sh};
  const long long ks[3] = {p.k_sb, p.k_ss, p.k_sh};
  const long long vs[3] = {p.v_sb, p.v_ss, p.v_sh};
  const long long os[3] = {p.o_sb, p.o_ss, p.o_sh};
  return wg_dq::launch_dq<D>(p.q, p.k, p.v, p.dout, p.lse, p.delta, p.dq,
                             p.b, p.sq, p.sk, p.h, p.kvh, p.causal, qs, ks,
                             vs, os, p.scale, stream);
}

int dispatch(const Params& p, bool dkv, const float* lsed, int dtype, int d,
             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dkv) {
    if (dtype == 1 && d == 128) return launch_dkv_bf16<128>(p, lsed, st);
    if (dtype == 1 && d == 64) return launch_dkv_bf16<64>(p, lsed, st);
    if (dtype == 0 && d == 128) return launch_dkv_fp32<128>(p, st);
    if (dtype == 0 && d == 64) return launch_dkv_fp32<64>(p, st);
  } else {
    if (dtype == 1 && d == 128) return launch_dq_bf16<128>(p, st);
    if (dtype == 1 && d == 64) return launch_dq_bf16<64>(p, st);
    if (dtype == 0 && d == 128) return launch_dq_fp32<128>(p, st);
    if (dtype == 0 && d == 64) return launch_dq_fp32<64>(p, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// which: 0 = K2 (writes dq), 1 = K3 (writes dk and dv).  dtype: 0 =
// float32, 1 = bfloat16.  lsed: K3's [b * h, 2, nq * 64] lse and D rows
// (bf16 only; may be null otherwise).  Strides are in elements.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int ray_tpu_flash_bwd(
    int which, const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, const float* lsed, void* dq,
    void* dk, void* dv, int dtype, int b, int sq, int sk, int h, int kvh,
    int d, int causal,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    float scale, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.lse = lse; p.delta = delta;
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.b = b; p.sq = sq; p.sk = sk; p.h = h; p.kvh = kvh; p.causal = causal;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.scale = scale;
  return dispatch(p, which == 1, lsed, dtype, d, stream);
}

extern "C" const char* ray_tpu_flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
