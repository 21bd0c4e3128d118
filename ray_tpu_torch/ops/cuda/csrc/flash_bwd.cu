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
//     unit stride on d;
//   lse, delta [b, h, sq] contiguous fp32 (K1's lse layout);
//   dq [b, sq, h, d], dk/dv [b, sk, kv_h, d], contiguous.
//
// What bounds them on an H100: K2 does 6*d FLOPs and K3 8*d FLOPs per
// visible (q, k) pair against ~4*d bytes per row, so at the training
// shapes (s = 2048, d = 128) both are bound by operations.  This first
// version computes in fp32 FMA on the CUDA cores, as K1 does (no tensor
// cores: mma/wgmma + TMA are the later, faster design), so its ceiling is
// the fp32 FMA rate, far below the bf16 tensor-core peak.
//
// How the TPU design changes here: the Pallas kernels carry dQ (resp. dK,
// dV) in VMEM scratch across the sequential innermost grid dimension.
// Thread blocks on Hopper run in no order, so
//   K2: one block owns one (b*h, 64-row q-tile) and loops over the 64-row
//       k-tiles up to the causal diagonal, dQ in registers;
//   K3: one block owns one (b*kv_h, 64-row k-tile) and loops over all
//       n_rep grouped q-heads x the q-tiles from the diagonal on, dK and dV
//       in registers.  The GQA reduction stays inside one block, so there
//       are no atomics and no races, as in the Pallas grid.
// Tiles are staged in shared memory as fp32 with rows padded by 4 floats
// (K2 149 KB, K3 167 KB at d = 128); each thread owns a 4 x 4 block of the
// 64 x 64 score tile and a 4 x (d / 16) block of the output rows.  Ragged
// edges are masked in the kernel: there are no pad or head-folding copies.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;   // q rows per tile
constexpr int BK = 64;   // k rows per tile
constexpr int NT = 256;  // threads per block, a 16 x 16 grid
constexpr int PS = 64 + 4;  // padded row stride of the 64 x 64 score tiles

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// x rounded to T and back: the casts of P and dS before their products
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

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
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long ss, int r0, int s) {
  constexpr int QS = D + 4;
  for (int idx = threadIdx.x; idx < 64 * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    const int row = r0 + r;
    dst[r * QS + c] = row < s ? to_f<T>(src[row * ss + c]) : 0.f;
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

// K2: dQ for one (b*h, 64-row q-tile), looping over k-tiles.
template <typename T, int D>
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

  const T* qg = static_cast<const T*>(p.q) + bi * p.q_sb + hi * p.q_sh;
  const T* og = static_cast<const T*>(p.dout) + bi * p.o_sb + hi * p.o_sh;
  const T* kg = static_cast<const T*>(p.k) + bi * p.k_sb + kvi * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + bi * p.v_sb + kvi * p.v_sh;

  load_tile<T, D>(Qs, qg, p.q_ss, q0, p.sq);
  load_tile<T, D>(dOs, og, p.o_ss, q0, p.sq);
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
    load_tile<T, D>(Ks, kg, p.k_ss, k0, p.sk);
    load_tile<T, D>(Vs, vg, p.v_ss, k0, p.sk);
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
        dSs[(4 * ty + i) * PS + tx + 16 * j] =
            round_to<T>(pr * (dp[i][j] - dd[i]));
      }
    }
    __syncthreads();
    tile_acc<D>(acc, dSs, Ks, tx, ty);
  }

  T* dqg = static_cast<T*>(p.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + 4 * ty + i;
    if (qp >= p.sq) continue;
    T* row = dqg + ((static_cast<long long>(bi) * p.sq + qp) * p.h + hi) * D;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        row[64 * g + 4 * tx + c] = from_f<T>(p.scale * acc[i][g][c]);
  }
}

// K3: dK and dV for one (b*kv_h, 64-row k-tile), looping over the n_rep
// grouped q-heads and the q-tiles from the causal diagonal on.
template <typename T, int D>
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

  const T* kg = static_cast<const T*>(p.k) + bi * p.k_sb + kvi * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + bi * p.v_sb + kvi * p.v_sh;
  load_tile<T, D>(Ks, kg, p.k_ss, k0, p.sk);
  load_tile<T, D>(Vs, vg, p.v_ss, k0, p.sk);

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
    const T* qg = static_cast<const T*>(p.q) + bi * p.q_sb + hi * p.q_sh;
    const T* og = static_cast<const T*>(p.dout) + bi * p.o_sb + hi * p.o_sh;
    for (int qt = qt0; qt < nq; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // last tile's readers are done; K and V are visible
      load_tile<T, D>(Qs, qg, p.q_ss, q0, p.sq);
      load_tile<T, D>(dOs, og, p.o_ss, q0, p.sq);
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
          Ps[(4 * ty + i) * PS + qr] = round_to<T>(pr);
          dSs[(4 * ty + i) * PS + qr] =
              round_to<T>(pr * (dpt[i][j] - dd_s[qr]));
        }
      }
      __syncthreads();
      tile_acc<D>(acc_v, Ps, dOs, tx, ty);
      tile_acc<D>(acc_k, dSs, Qs, tx, ty);
    }
  }

  T* dkg = static_cast<T*>(p.dk);
  T* dvg = static_cast<T*>(p.dv);
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
        dkg[row + col] = from_f<T>(p.scale * acc_k[i][g][c]);
        dvg[row + col] = from_f<T>(acc_v[i][g][c]);
      }
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, bool dkv, cudaStream_t stream) {
  if (dkv) {
    const size_t smem = dkv_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid((p.sk + BK - 1) / BK, p.b * p.kvh);
    flash_bwd_dkv_kernel<T, D><<<grid, NT, smem, stream>>>(p);
  } else {
    const size_t smem = dq_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid((p.sq + BQ - 1) / BQ, p.b * p.h);
    flash_bwd_dq_kernel<T, D><<<grid, NT, smem, stream>>>(p);
  }
  return cudaGetLastError();
}

int dispatch(const Params& p, bool dkv, int dtype, int d, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && d == 128) return launch<__nv_bfloat16, 128>(p, dkv, st);
  if (dtype == 1 && d == 64) return launch<__nv_bfloat16, 64>(p, dkv, st);
  if (dtype == 0 && d == 128) return launch<float, 128>(p, dkv, st);
  if (dtype == 0 && d == 64) return launch<float, 64>(p, dkv, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// which: 0 = K2 (writes dq), 1 = K3 (writes dk and dv).  dtype: 0 =
// float32, 1 = bfloat16.  Strides are in elements.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int ray_tpu_flash_bwd(
    int which, const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, void* dk, void* dv,
    int dtype, int b, int sq, int sk, int h, int kvh, int d, int causal,
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
  return dispatch(p, which == 1, dtype, d, stream);
}

extern "C" const char* ray_tpu_flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
