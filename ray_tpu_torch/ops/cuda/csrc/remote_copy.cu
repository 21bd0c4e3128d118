// Remote copy with a completion flag (K4) for Hopper, sm_90a, CUDA C++.
//
// Replaces ray_tpu/experimental/channel/transport.py::_pallas_remote_copy
// (pl.pallas_call at :297, kernel body at :285): every device copies its
// whole array into its right neighbour's buffer with
// make_async_remote_copy(...).start() / .wait(), a send and a recv DMA
// semaphore signalling completion.  Here one hop is two kernels:
//
//   remote_copy_kernel, on the source device's stream: copies nbytes from
//     src to dst, where dst is memory of the same card or of a peer card
//     reached over NVLink (peer access enabled by
//     ray_tpu_remote_copy_enable_peer).  A grid-stride loop of 16-byte
//     loads and stores, four in flight per thread, and a scalar tail for
//     any byte count.  Completion replaces the semaphores: after a block
//     barrier, thread 0 of each block fences (cumulative, so it covers the
//     whole block's stores) and counts the block done in a scratch word;
//     the last block resets the word, fences at system scope and
//     publishes the hop's epoch to the flag with a release store at
//     system scope.
//   remote_wait_kernel, one thread on the destination device's stream:
//     spins on the flag with acquire loads until it reaches the epoch, so
//     work queued after it on that stream sees the copied bytes.  The spin
//     is bounded in time: past timeout_ns it writes 1 to a status word and
//     returns (the wrapper raises on it), so a lost hop is an error, not a
//     hung card.  No host polling.
//
// The flag, the block counter and the status word live in one small
// buffer on the destination device, allocated by the wrapper with
// torch.zeros, one for each source stream: the count of finished blocks
// and the monotone flag are right only for hops that run one after
// another.  The wrapper keeps the epoch and counts launches.
//
// What bounds it on an H100: bytes.  Each hop reads and writes nbytes and
// computes nothing.  On one card that is 2 x nbytes at 3.35 TB/s: at the
// main-path payload of 16 MiB (one Llama-2-7B pipeline-stage activation,
// [1, 2048, 4096] bf16) 2 x 16.78 MB / 3.35 TB/s = 10.0 us per hop.
// Across NVLink the stores go to the peer at 450 GB/s each way: 16.78 MB /
// 450 GB/s = 37.3 us per hop.  The design keeps enough 16-byte accesses in
// flight to stream at that rate (four per thread, one resident wave of up
// to eight blocks of 256 threads per SM) and does nothing else.  Measured
// on an H100 (chip_smoke.py): the bare copy streams as fast as copy_; the
// completion costs a few microseconds more, and a system-scope fence in
// every block instead of the last one only would cost twice that.
//
// How the TPU design changes here: a TPU core's DMA engine moves the whole
// array and raises a semaphore in the receiver's memory; the receiver's
// kernel waits on it.  An H100 has no such engine addressable from a
// kernel, so the SMs move the bytes themselves through the peer mapping,
// and the semaphore becomes a flag word in the receiver's memory, set by
// the last sender block with release semantics and waited on with acquire
// semantics.  Hops to devices of other processes (CUDA IPC handles) are
// not handled here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;      // threads per block
constexpr int UNROLL = 4;    // 16-byte accesses in flight per thread

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned long long load_acquire_sys(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release_sys(unsigned long long* p,
                                                  unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__global__ void __launch_bounds__(NT) remote_copy_kernel(
    const uint4* __restrict__ src, uint4* __restrict__ dst,
    unsigned long long n16, const unsigned char* __restrict__ src_tail,
    unsigned char* __restrict__ dst_tail, unsigned int tail,
    unsigned int* counter, unsigned long long* flag,
    unsigned long long epoch) {
  const unsigned long long stride =
      static_cast<unsigned long long>(gridDim.x) * NT;
  const unsigned long long first =
      static_cast<unsigned long long>(blockIdx.x) * NT + threadIdx.x;
  unsigned long long i = first;
  for (; i + (UNROLL - 1) * stride < n16; i += UNROLL * stride) {
    uint4 r[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) r[u] = src[i + u * stride];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) dst[i + u * stride] = r[u];
  }
  for (; i < n16; i += stride) dst[i] = src[i];
  if (first < tail) dst_tail[first] = src_tail[first];

  // The barrier orders every thread's stores before thread 0's fence,
  // which is cumulative, so the block's stores are performed before it
  // counts.  The blocks all run on this device, so a device-scope fence
  // suffices between them; the last block's system-scope fence carries
  // everything it has observed to the other devices before the flag.
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const unsigned int done = atomicAdd(counter, 1u);
    if (done == gridDim.x - 1) {  // the last block: all stores are out
      *counter = 0;               // ready for the next hop on this pair
      __threadfence_system();
      store_release_sys(flag, epoch);
    }
  }
}

__global__ void remote_wait_kernel(const unsigned long long* flag,
                                   unsigned long long epoch, int* status,
                                   unsigned long long timeout_ns) {
  const unsigned long long t0 = global_ns();
  while (load_acquire_sys(flag) < epoch) {
    if (global_ns() - t0 > timeout_ns) {
      *status = 1;
      return;
    }
    __nanosleep(128);
  }
}

// Runs fn with `device` current and restores the caller's device.
template <typename F>
int on_device(int device, F fn) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = fn();
  const cudaError_t reset = cudaSetDevice(prev);
  return err != cudaSuccess ? err : reset;
}

}  // namespace

// One hop's copy on `device` (the source's), on `stream`.  `words` is the
// destination's completion buffer: u64 flag, u32 block counter, i32 status.
extern "C" int ray_tpu_remote_copy(const void* src, void* dst,
                                   unsigned long long nbytes, void* words,
                                   unsigned long long epoch, int blocks,
                                   int device, void* stream) {
  return on_device(device, [&]() {
    const unsigned long long n16 = nbytes / 16;
    auto* flag = static_cast<unsigned long long*>(words);
    auto* counter = reinterpret_cast<unsigned int*>(flag + 1);
    remote_copy_kernel<<<blocks, NT, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(src), static_cast<uint4*>(dst), n16,
        static_cast<const unsigned char*>(src) + 16 * n16,
        static_cast<unsigned char*>(dst) + 16 * n16,
        static_cast<unsigned int>(nbytes - 16 * n16), counter, flag, epoch);
    return cudaGetLastError();
  });
}

// One hop's wait on `device` (the destination's), on `stream`.
extern "C" int ray_tpu_remote_wait(void* words, unsigned long long epoch,
                                   unsigned long long timeout_ns, int device,
                                   void* stream) {
  return on_device(device, [&]() {
    auto* flag = static_cast<unsigned long long*>(words);
    auto* status = reinterpret_cast<int*>(flag + 2);
    remote_wait_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
        flag, epoch, status, timeout_ns);
    return cudaGetLastError();
  });
}

// Lets kernels on `device` store into memory of `peer`; "already enabled"
// is success.
extern "C" int ray_tpu_remote_copy_enable_peer(int device, int peer) {
  return on_device(device, [&]() {
    cudaError_t err = cudaDeviceEnablePeerAccess(peer, 0);
    if (err == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();  // clear the sticky-until-read error
      err = cudaSuccess;
    }
    return err;
  });
}

extern "C" const char* ray_tpu_remote_copy_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
