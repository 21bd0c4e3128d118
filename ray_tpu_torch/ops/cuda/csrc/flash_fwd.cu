// Flash-attention forward (K1) for Hopper, sm_90a, CUDA C++.
//
// Replaces ray_tpu/ops/pallas/flash_attention.py::_fwd_kernel (launched by
// _flash_fwd_impl, pl.pallas_call at :145).  Computes causal (or full)
// softmax attention with an online softmax, GQA by index (q-head hi reads
// kv-head hi / (h / kv_h), no KV expansion), pad keys (kpos >= seq_k)
// masked with -1e30, scale d**-0.5, P cast to the input dtype before the
// PV product, fp32 accumulation.  Writes O in the input dtype and
// lse = m + log(max(l, 1e-30)) in fp32 for the backward kernels.
//
// Layouts (the Python wrapper checks them):
//   q [b, sq, h, d], k/v [b, sk, kv_h, d]: any strides on b/s/h, unit
//     stride on d; for bf16 the base and those strides 16-byte aligned
//     (TMA);
//   o [b, sq, h, d], contiguous;
//   lse [b, h, sq], contiguous fp32 (K2/K3 read it in this layout).
//
// What bounds it on an H100: at the serving and training shapes (s >=
// 256, d = 128) the work is ~4*d FLOPs per visible (q, k) pair against
// ~4*d bytes of Q/K/V/O per row, so it is bound by operations: the bf16
// tensor cores' 989 TFLOP/s.
//
// bf16 (the main path): flash_fwd_wgmma_kernel.  One block per (b*h,
// 128-row q-tile), q-tiles launched heaviest first (the causal diagonal's
// far end), so the last wave is the short tiles.  Two warpgroups, each
// owning 64 q rows (wgmma's M).
//   - Q is loaded once by TMA; K and V tiles of 128 keys stream through a
//     two-stage shared-memory ring filled by TMA with mbarrier completion
//     (thread 0 refills the stage the previous tile freed, so the next
//     tile's load overlaps this tile's math).  Tiles stay bf16 in shared
//     memory, 128-byte swizzled (hopper.cuh).
//   - S = Q Kᵀ is an SS wgmma (m64n128k16 over d) into fp32 registers; the
//     online softmax runs on the accumulator fragment (row max and sum by
//     shuffles over the 4 threads of a row; the sum is reduced once at the
//     end); the rescale of O by alpha stays in registers.
//   - P is rounded to bf16 in registers and is the register A operand of
//     O += P V (RS wgmma, V MN-major from shared memory): P never goes to
//     shared memory.
//   - Tiles wholly past the causal diagonal are never loaded; only tiles
//     that cross the diagonal or the ragged key edge are masked.
// float32: flash_fwd_kernel, the first design (fp32 FMA on the CUDA cores,
// 64 x 64 tiles): a tensor-core fp32 path would be TF32, which cannot hold
// the fp32 tolerances.
//
// How the TPU design changes here: the Pallas kernel carries m/l/acc in
// VMEM scratch across a sequential k-block grid dimension.  Thread blocks
// on Hopper run in no order, so one block owns one q-tile and loops over
// the K/V tiles itself; the causal block skip becomes the loop bound.
// There are no pad or head-folding copies: the kernels take strides and
// mask the ragged sequence edge themselves (TMA reads rows past the end as
// zeros).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

// ---- bf16: wgmma + TMA ----------------------------------------------------

namespace wg {

constexpr int BQ = 128;     // q rows per block: two consumer warpgroups
constexpr int BK = 128;     // keys per K/V tile
constexpr int STAGES = 2;   // K/V ring depth
constexpr int NT = 256;
constexpr float NEG_INF = -1e30f;

struct Args {
  CUtensorMap tq, tk, tv;  // box {64, 1, rows, 1} over [b, s, h, d]
  __nv_bfloat16* o;
  float* lse;
  int sq, sk, h, n_rep, causal, nqt;
  float scale;
};

template <int D>
struct Smem {
  static constexpr uint32_t Q_BYTES = BQ * D * 2;    // [D/64][BQ][64]
  static constexpr uint32_t KV_BYTES = BK * D * 2;   // [D/64][BK][64]
  static constexpr uint32_t STAGE_BYTES = 2 * KV_BYTES;  // K then V
  static constexpr uint32_t KV = Q_BYTES;
  static constexpr uint32_t BAR = KV + STAGES * STAGE_BYTES;
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
    flash_fwd_wgmma_kernel(const __grid_constant__ Args a) {
  using S = Smem<D>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sq = smem;
  uint8_t* skv = smem + S::KV;
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
  if (a.causal) nk = min(nk, (q0 + BQ - 1) / BK + 1);  // causal tile skip

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
    hopper::mbar_arrive_expect_tx(q_bar, S::Q_BYTES);
#pragma unroll
    for (int c = 0; c < D / 64; ++c)
      hopper::tma_load_4d(sq + c * BQ * 128, &a.tq, q_bar, 64 * c, hi, q0,
                          bi);
    for (int s = 0; s < STAGES && s < nk; ++s)
      issue_kv<D>(a, skv + s * S::STAGE_BYTES, &full[s], s, kvi, bi);
  }

  // rows of this thread: r_lo and r_lo + 8 (the accumulator layout)
  const int r_lo = q0 + 64 * wgi + 16 * warp + lane / 4;
  const int c_lo = 2 * (lane % 4);
  float o[D / 2];
  hopper::zero(o);
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};  // this thread's partial row sums
  const uint32_t q_base = hopper::smem_u32(sq) + wgi * 64 * 128;
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
    const int row_min = q0 + 64 * wgi;  // this warpgroup's first q row
    // every key of the tile past the diagonal for all 64 rows: no work
    const bool skip = a.causal && k0 > row_min + 63;
    if (!skip) {
      const uint32_t k_base = hopper::smem_u32(skv + s * S::STAGE_BYTES);
      float sc[BK / 2];
      hopper::zero(sc);
      hopper::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        hopper::wgmma_m64n128k16_ss<0>(
            sc, hopper::desc_k_major(q_base, BQ * 128, ks),
            hopper::desc_k_major(k_base, BK * 128, ks), ks > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);

      const bool masked =
          (a.causal && k0 + BK - 1 > row_min) || k0 + BK > a.sk;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] *= a.scale;
      if (masked) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int kp = k0 + 8 * j + c_lo + c;
              const int qp = r_lo + 8 * r;
              if (kp >= a.sk || (a.causal && kp > qp))
                sc[4 * j + 2 * r + c] = NEG_INF;
            }
      }
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          mx[r] = fmaxf(mx[r],
                        fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
      float alpha[2], neg_m[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = exp2f((m[r] - m_new) * hopper::LOG2E);
        m[r] = m_new;
        neg_m[r] = -m_new * hopper::LOG2E;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& x = sc[4 * j + 2 * r + c];
            x = exp2f(fmaf(x, hopper::LOG2E, neg_m[r]));
            rs[r] += x;
          }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          o[4 * j + 2 * r] *= alpha[r];
          o[4 * j + 2 * r + 1] *= alpha[r];
        }
      // P in bf16 registers is the A operand of O += P V
      uint32_t pf[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        hopper::acc_to_a_frag(sc, kk, pf[kk]);
      const uint32_t v_base = k_base + S::KV_BYTES;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        if constexpr (D == 128)
          hopper::wgmma_m64n128k16_rs<1>(
              o, pf[kk], hopper::desc_mn_major(v_base, BK * 128, kk), 1);
        else
          hopper::wgmma_m64n64k16_rs<1>(
              o, pf[kk], hopper::desc_mn_major(v_base, BK * 128, kk), 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
    }
    hopper::mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qp = r_lo + 8 * r;
    if (qp >= a.sq) continue;
    const float li = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow =
        a.o + ((static_cast<long long>(bi) * a.sq + qp) * a.h + hi) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j + c_lo) = hopper::pack_bf16(
          o[4 * j + 2 * r] / li, o[4 * j + 2 * r + 1] / li);
    if (lane % 4 == 0)
      a.lse[static_cast<long long>(bh) * a.sq + qp] = m[r] + logf(li);
  }
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* o, float* lse, int b, int sq, int sk, int h,
                         int kvh, int causal, const long long* qs,
                         const long long* ks, const long long* vs,
                         float scale, cudaStream_t stream) {
  Args a;
  if (!hopper::make_bshd_map(&a.tq, q, b, sq, h, D, qs[0], qs[1], qs[2], BQ)
      || !hopper::make_bshd_map(&a.tk, k, b, sk, kvh, D, ks[0], ks[1], ks[2],
                                BK)
      || !hopper::make_bshd_map(&a.tv, v, b, sk, kvh, D, vs[0], vs[1], vs[2],
                                BK))
    return cudaErrorInvalidValue;
  a.o = static_cast<__nv_bfloat16*>(o);
  a.lse = lse;
  a.sq = sq; a.sk = sk; a.h = h; a.n_rep = h / kvh; a.causal = causal;
  a.nqt = (sq + BQ - 1) / BQ;
  a.scale = scale;
  const int smem = Smem<D>::TOTAL;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * h, a.nqt);
  flash_fwd_wgmma_kernel<D><<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace wg

// ---- float32: the first design, fp32 FMA on the CUDA cores ----------------

constexpr int BQ = 64;   // q rows per block
constexpr int BK = 64;   // k rows per tile
constexpr int NT = 256;  // threads per block, a 16 x 16 grid
constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int b, sq, sk, h, kvh, causal;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  float scale;
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (D + 4) + BK * (D + 4) + BK * D + BQ * (BK + 4));
}

template <int D>
__global__ void __launch_bounds__(NT, 1) flash_fwd_kernel(const Params p) {
  constexpr int QS = D + 4;   // padded row stride (floats) of the Q/K tiles
  constexpr int PS = BK + 4;  // padded row stride of the P tile
  constexpr int NG = D / 64;  // float4 output column groups per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [BQ][QS]
  float* Ks = Qs + BQ * QS;                     // [BK][QS]
  float* Vs = Ks + BK * QS;                     // [BK][D]
  float* Ps = Vs + BK * D;                      // [BQ][PS]

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // S columns tx + 16j; O columns 64g + 4tx + c
  const int ty = tid >> 4;  // rows 4ty .. 4ty+3 of S, P and O
  const int bh = blockIdx.y;
  const int bi = bh / p.h;
  const int hi = bh % p.h;
  const int kvi = hi / (p.h / p.kvh);
  const int q0 = blockIdx.x * BQ;

  const float* qg = static_cast<const float*>(p.q) + bi * p.q_sb
                    + hi * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + bi * p.k_sb
                    + kvi * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + bi * p.v_sb
                    + kvi * p.v_sh;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    const int qp = q0 + r;
    Qs[r * QS + c] = qp < p.sq ? qg[qp * p.q_ss + c] : 0.f;
  }

  float m[4], l[4], acc[4][NG][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][g][c] = 0.f;
  }

  int nk = (p.sk + BK - 1) / BK;
  if (p.causal) nk = min(nk, (q0 + BQ - 1) / BK + 1);  // causal tile skip

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // last tile's readers are done; Q is visible
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int r = idx / D, c = idx % D;
      const int kp = k0 + r;
      const bool ok = kp < p.sk;  // pad rows are zero: 0 * V stays finite
      Ks[r * QS + c] = ok ? kg[kp * p.k_ss + c] : 0.f;
      Vs[r * D + c] = ok ? vg[kp * p.v_ss + c] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(4 * ty + i) * QS + c]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * QS + c]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + 4 * ty + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool ok = kp < p.sk && (!p.causal || qp >= kp);
        s[i][j] = ok ? s[i][j] * p.scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of a row are one half-warp: xor offsets < 16
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(s[i][j] - m_new);
        rs += e;
        Ps[(4 * ty + i) * PS + tx + 16 * j] = e;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][g][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&Ps[(4 * ty + i) * PS + kk]);
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const int col = 64 * g + 4 * tx;
        const float4 v0 = *reinterpret_cast<const float4*>(&Vs[(kk + 0) * D + col]);
        const float4 v1 = *reinterpret_cast<const float4*>(&Vs[(kk + 1) * D + col]);
        const float4 v2 = *reinterpret_cast<const float4*>(&Vs[(kk + 2) * D + col]);
        const float4 v3 = *reinterpret_cast<const float4*>(&Vs[(kk + 3) * D + col]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][g][0] = fmaf(pv[i].w, v3.x, fmaf(pv[i].z, v2.x,
                         fmaf(pv[i].y, v1.x, fmaf(pv[i].x, v0.x, acc[i][g][0]))));
          acc[i][g][1] = fmaf(pv[i].w, v3.y, fmaf(pv[i].z, v2.y,
                         fmaf(pv[i].y, v1.y, fmaf(pv[i].x, v0.y, acc[i][g][1]))));
          acc[i][g][2] = fmaf(pv[i].w, v3.z, fmaf(pv[i].z, v2.z,
                         fmaf(pv[i].y, v1.z, fmaf(pv[i].x, v0.z, acc[i][g][2]))));
          acc[i][g][3] = fmaf(pv[i].w, v3.w, fmaf(pv[i].z, v2.w,
                         fmaf(pv[i].y, v1.w, fmaf(pv[i].x, v0.w, acc[i][g][3]))));
        }
      }
    }
  }

  float* og = static_cast<float*>(p.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + 4 * ty + i;
    if (qp >= p.sq) continue;
    const float li = fmaxf(l[i], 1e-30f);
    float* orow =
        og + ((static_cast<long long>(bi) * p.sq + qp) * p.h + hi) * D;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        orow[64 * g + 4 * tx + c] = acc[i][g][c] / li;
    if (tx == 0)
      p.lse[static_cast<long long>(bh) * p.sq + qp] = m[i] + logf(li);
  }
}

template <int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + BQ - 1) / BQ, p.b * p.h);
  flash_fwd_kernel<D><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int ray_tpu_flash_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int dtype, int b, int sq, int sk, int h, int kvh, int d, int causal,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    float scale, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.lse = lse;
  p.b = b; p.sq = sq; p.sk = sk; p.h = h; p.kvh = kvh; p.causal = causal;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long qs[3] = {q_sb, q_ss, q_sh}, ks[3] = {k_sb, k_ss, k_sh},
                  vs[3] = {v_sb, v_ss, v_sh};
  if (dtype == 1 && d == 128)
    return wg::launch_wgmma<128>(q, k, v, o, lse, b, sq, sk, h, kvh, causal,
                                 qs, ks, vs, scale, st);
  if (dtype == 1 && d == 64)
    return wg::launch_wgmma<64>(q, k, v, o, lse, b, sq, sk, h, kvh, causal,
                                qs, ks, vs, scale, st);
  if (dtype == 0 && d == 128) return launch<128>(p, st);
  if (dtype == 0 && d == 64) return launch<64>(p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ray_tpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
