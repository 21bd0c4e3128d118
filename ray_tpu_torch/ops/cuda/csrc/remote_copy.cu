// Remote copy (K4) for Hopper, sm_90a, CUDA C++: TMA bulk copies through
// shared memory, and a completion flag only where another card waits.
//
// Replaces ray_tpu/experimental/channel/transport.py::_pallas_remote_copy
// (pl.pallas_call at :297, kernel body at :285): every device copies its
// whole array into its right neighbour's buffer with
// make_async_remote_copy(...).start() / .wait(), a send and a recv DMA
// semaphore signalling completion.
//
// remote_copy_bulk_kernel, on the source device's stream, copies nbytes
// from src to dst, where dst is memory of the same card or of a peer card
// reached over NVLink (peer access enabled by
// ray_tpu_remote_copy_enable_peer).  A persistent grid of at most one
// block per SM, and never more blocks than chunks:
//   - The whole 16-byte vectors are cut into chunks of STAGE_BYTES (the
//     last one shorter), dealt to the blocks in turn: block b takes chunks
//     b, b + blocks, ..., so the grid sweeps the array as one window.
//     Each block streams its chunks through a ring of STAGES stages in
//     shared memory.  One thread issues every load (cp.async.bulk global
//     -> shared, completing on the stage's mbarrier, under an L2
//     evict-first policy since the source is read once) and, as each
//     lands, the bulk store of that stage (cp.async.bulk shared -> global,
//     one bulk group per stage), refilling a stage once the store before
//     it has read it (wait_group.read 1).  The same bulk stores go to a
//     peer: over NVLink the block's threads storing each stage with
//     16-byte st.global were no faster (PERF.md).  A copy below one stage
//     is one chunk of one block.
//   - The last nbytes % 16 bytes go by byte loads and stores in the last
//     block: one launch for every byte count, 0 included.
// The ring, 8 stages of 16 KB, is the fastest of the rings read on the
// card (PERF.md).
// No thread touches the whole vectors' bytes, so the copy costs one
// instruction stream per SM instead of 256 threads' loads and stores.
// Dealing the chunks in turn, and not one contiguous span per block, is a
// reading on the card: with one span per block, some blocks finished far
// later than others, and the slowest set the time.
//
// Completion, only when `words` is given (the wrapper gives it for a hop
// onto another card, whose stream cannot see this one's order): the
// issuing thread waits for its bulk stores to complete (wait_group 0, not
// .read), fences the async proxy against the generic one (the waiter reads
// with generic loads), and then thread 0 of each block counts the block
// done with a release; the last block, whose count acquires all the
// others, resets the count and publishes the hop's epoch to the flag with
// a release store at system scope.  One arrival per block, about 132 per
// hop.
// remote_wait_kernel, one thread on the destination device's stream,
// spins on the flag with acquire loads until it reaches the epoch, so work
// queued after it on that stream sees the copied bytes.  The spin is
// bounded in time: past timeout_ns it writes 1 to a status word and
// returns (the wrapper raises on it), so a lost hop is an error, not a
// hung card.  The flag, the block count and the status word live in one
// small buffer on the destination device, one for each source stream.  A
// hop within one card needs none of it: the copy and the later work share
// the stream, whose order already gives them the bytes.
//
// What bounds it on an H100: bytes.  Each hop reads and writes nbytes and
// computes nothing.  On one card that is 2 x nbytes at 3.35 TB/s: at the
// main-path payload of 16 MiB (one Llama-2-7B pipeline-stage activation,
// [1, 2048, 4096] bf16) 2 x 16.78 MB / 3.35 TB/s = 10.0 us per hop.
// Across NVLink the bytes go to the peer at 450 GB/s each way: 16.78 MB /
// 450 GB/s = 37.3 us per hop.  PERF.md holds the times this design
// reaches against both bounds, with the card and its power limit.
//
// How the TPU design changes here: a TPU core's DMA engine moves the whole
// array and raises a semaphore in the receiver's memory; the receiver's
// kernel waits on it.  The nearest thing an H100 kernel can drive is each
// SM's TMA unit, which moves bulk spans between global and shared memory;
// so each SM streams its chunks through shared memory, and the semaphore
// becomes a flag word in the receiver's memory, set by the last block with
// release semantics and waited on with acquire semantics.  Hops to devices
// of other processes (CUDA IPC handles) are not handled here.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::bulk_commit;
using hopper::bulk_store;
using hopper::mbar_arrive_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;

constexpr int NT = 256;                   // threads per block
constexpr int STAGES = 8;                 // a block's ring of shared memory
constexpr int STAGE_BYTES = 16 * 1024;    // a multiple of 16
constexpr int SMEM = STAGES * STAGE_BYTES;

struct Hop {
  const unsigned char* src;
  unsigned char* dst;
  unsigned long long n16;        // whole 16-byte vectors
  unsigned int tail;             // bytes past them, < 16
  unsigned int* counter;         // null: no completion
  unsigned long long* flag;
  unsigned long long epoch;
};

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

__device__ __forceinline__ unsigned int arrive_acq_rel_gpu(unsigned int* p) {
  unsigned int old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
               : "=r"(old) : "l"(p) : "memory");
  return old;
}

// The chunks of one block.  The 16 n16 bytes of whole vectors are cut into
// chunks of STAGE_BYTES (the last one shorter); block b takes chunks b,
// b + blocks, b + 2 blocks, ..., so at any moment the grid streams one
// window of the array.  Its k-th chunk lands in stage k % STAGES on that
// stage's (k / STAGES)-th phase.
struct Chunks {
  const unsigned char* src;
  unsigned char* dst;
  unsigned long long bytes;  // 16 n16
  unsigned char* ring;
  uint64_t* bars;
  uint64_t policy;           // L2 evict-first: the source is read once

  __device__ long long count() const {
    const long long total =
        static_cast<long long>((bytes + STAGE_BYTES - 1) / STAGE_BYTES);
    return (total - blockIdx.x + gridDim.x - 1) / gridDim.x;
  }
  __device__ unsigned long long offset(long long k) const {
    return (blockIdx.x + static_cast<unsigned long long>(k) * gridDim.x) *
           STAGE_BYTES;
  }
  __device__ uint32_t len(long long k) const {
    const unsigned long long left = bytes - offset(k);
    return static_cast<uint32_t>(left < STAGE_BYTES ? left : STAGE_BYTES);
  }
  __device__ unsigned char* stage(long long k) const {
    return ring + static_cast<size_t>(k % STAGES) * STAGE_BYTES;
  }
  __device__ uint64_t* bar(long long k) const { return bars + k % STAGES; }
  __device__ uint32_t parity(long long k) const {
    return static_cast<uint32_t>((k / STAGES) & 1);
  }
  __device__ void load(long long k) const {
    mbar_arrive_expect_tx(bar(k), len(k));
    hopper::bulk_load_policy(stage(k), src + offset(k), len(k), bar(k),
                             policy);
  }
};

// One thread moves all the block's chunks: loads run up to STAGES
// ahead, each landed stage leaves by one bulk store, and the stage of the
// store before is refilled as soon as that store has read it.
__device__ void stream_bulk_stores(const Chunks& s, bool complete) {
  const long long n = s.count();
  for (long long k = 0; k < n && k < STAGES; ++k) s.load(k);
  for (long long k = 0; k < n; ++k) {
    mbar_wait(s.bar(k), s.parity(k));
    bulk_store(s.dst + s.offset(k), s.stage(k), s.len(k));
    bulk_commit();
    if (k >= 1 && k - 1 + STAGES < n) {
      hopper::bulk_wait_read<1>();  // store k - 1 has read its stage
      s.load(k - 1 + STAGES);
    }
  }
  if (complete) {
    hopper::bulk_wait<0>();  // every store's bytes are written
    hopper::fence_proxy_async_global();
  } else {
    hopper::bulk_wait_read<0>();  // the ring outlives every store's read
  }
}

__global__ void __launch_bounds__(NT, 1) remote_copy_bulk_kernel(
    const Hop h) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t bars[STAGES];

  const bool complete = h.counter != nullptr;
  if (h.n16) {
    if (threadIdx.x == 0) {
      for (int i = 0; i < STAGES; ++i) mbar_init(&bars[i], 1);
      hopper::fence_barrier_init();
    }
    __syncthreads();
    const Chunks s{h.src, h.dst, 16 * h.n16, ring, bars,
                   hopper::evict_first_policy()};
    if (threadIdx.x == 0) stream_bulk_stores(s, complete);
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x < h.tail) {
    h.dst[16 * h.n16 + threadIdx.x] = h.src[16 * h.n16 + threadIdx.x];
  }
  if (!complete) return;

  // The barrier orders every thread's stores (and thread 0's fenced bulk
  // stores) before thread 0's release, which is cumulative, so the
  // block's bytes are performed before it counts.  The blocks all run on
  // this device, so device scope suffices between them.  The last block's
  // count acquires every other block's release, and its release store at
  // system scope, cumulative too, carries all of it to the waiter on the
  // other device: no separate system fence before it, which would cost
  // as much again (PERF.md).
  __syncthreads();
  if (threadIdx.x == 0 && arrive_acq_rel_gpu(h.counter) == gridDim.x - 1) {
    *h.counter = 0;  // ready for the next hop of this completion
    store_release_sys(h.flag, h.epoch);
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

// Whether the kernel may take SMEM bytes of dynamic shared memory on each
// device: the attribute is raised once per device, not on every launch.
bool smem_raised[64];

}  // namespace

// One hop's copy on `device` (the source's), on `stream`.  `words` is the
// destination's completion buffer (u64 flag, u32 block count, i32 status),
// or null for a hop that needs no completion.  `blocks` (at most one per
// SM, at most one per chunk) comes from the wrapper.
extern "C" int ray_tpu_remote_copy(const void* src, void* dst,
                                   unsigned long long nbytes, void* words,
                                   unsigned long long epoch, int blocks,
                                   int device, void* stream) {
  if (blocks < 1 || device < 0 || device >= 64) return cudaErrorInvalidValue;
  return on_device(device, [&]() {
    if (!smem_raised[device]) {
      const cudaError_t err = cudaFuncSetAttribute(
          remote_copy_bulk_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
      if (err != cudaSuccess) return err;
      smem_raised[device] = true;
    }
    auto* flag = static_cast<unsigned long long*>(words);
    const unsigned long long n16 = nbytes / 16;
    const Hop h{static_cast<const unsigned char*>(src),
                static_cast<unsigned char*>(dst), n16,
                static_cast<unsigned int>(nbytes - 16 * n16),
                flag ? reinterpret_cast<unsigned int*>(flag + 1) : nullptr,
                flag, epoch};
    remote_copy_bulk_kernel<<<blocks, NT, SMEM,
                              static_cast<cudaStream_t>(stream)>>>(h);
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
