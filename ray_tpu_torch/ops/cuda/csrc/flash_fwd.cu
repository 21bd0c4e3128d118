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
//     stride on d;
//   o [b, sq, h, d], contiguous;
//   lse [b, h, sq], contiguous fp32 (K2/K3 will read it in this layout).
//
// What bounds it on an H100: at the serving shapes (s >= 256, d = 128) the
// work is ~4*d FLOPs per visible (q, k) pair against ~4*d bytes of Q/K/V/O
// per row, so it is bound by operations.  This first version computes in
// fp32 FMA on the CUDA cores (no tensor cores: mma/wgmma + TMA are the
// later, faster design), so its ceiling is the fp32 FMA rate, far below
// the bf16 tensor-core peak the bound is taken against.
//
// How the TPU design changes here: the Pallas kernel carries m/l/acc in
// VMEM scratch across a sequential k-block grid dimension.  Thread blocks
// on Hopper run in no order, so one block owns one (b*h, 64-row q-tile)
// and loops over 64-row K/V tiles itself; the causal block skip becomes
// the loop bound.  Tiles are 64 x 64 (not the v5e 1024 defaults), staged
// in shared memory as fp32 with padded rows so the 16-byte reads are
// bank-conflict free; m, l and the output accumulator live in registers.
// There are no pad or head-folding copies: the kernel takes strides and
// masks the ragged sequence edge itself.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;   // q rows per block
constexpr int BK = 64;   // k rows per tile
constexpr int NT = 256;  // threads per block, a 16 x 16 grid
constexpr float NEG_INF = -1e30f;

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

template <typename T, int D>
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

  const T* qg = static_cast<const T*>(p.q) + bi * p.q_sb + hi * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + bi * p.k_sb + kvi * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + bi * p.v_sb + kvi * p.v_sh;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    const int qp = q0 + r;
    Qs[r * QS + c] = qp < p.sq ? to_f<T>(qg[qp * p.q_ss + c]) : 0.f;
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
      Ks[r * QS + c] = ok ? to_f<T>(kg[kp * p.k_ss + c]) : 0.f;
      Vs[r * D + c] = ok ? to_f<T>(vg[kp * p.v_ss + c]) : 0.f;
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
        // P is cast to the value dtype before PV; l sums the fp32 values
        Ps[(4 * ty + i) * PS + tx + 16 * j] = to_f<T>(from_f<T>(e));
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

  T* og = static_cast<T*>(p.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + 4 * ty + i;
    if (qp >= p.sq) continue;
    const float li = fmaxf(l[i], 1e-30f);
    T* orow = og + ((static_cast<long long>(bi) * p.sq + qp) * p.h + hi) * D;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        orow[64 * g + 4 * tx + c] = from_f<T>(acc[i][g][c] / li);
    if (tx == 0)
      p.lse[static_cast<long long>(bh) * p.sq + qp] = m[i] + logf(li);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + BQ - 1) / BQ, p.b * p.h);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(p);
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
  if (dtype == 1 && d == 128) return launch<__nv_bfloat16, 128>(p, st);
  if (dtype == 1 && d == 64) return launch<__nv_bfloat16, 64>(p, st);
  if (dtype == 0 && d == 128) return launch<float, 128>(p, st);
  if (dtype == 0 && d == 64) return launch<float, 64>(p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ray_tpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
