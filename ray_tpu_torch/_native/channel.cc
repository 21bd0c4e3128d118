// Native data plane for the port's shared-memory channels.
//
// The port's copy of ray_tpu/_native/channel.cc, the C++ side of the
// mutable-object substrate (WriteAcquire/WriteRelease/ReadAcquire/
// ReadRelease over one versioned shm buffer).  It keeps the EXACT segment
// layout of the Python plane in
// ray_tpu_torch/experimental/channel/shared_memory_channel.py (and of the
// reference's), so native and pure-Python endpoints of either package
// interoperate on one channel:
//
//   [u64 version][u64 payload_len][u64 flags = n_readers | CLOSED_BIT]
//   [u64 ack[r] x n_readers][payload bytes]
//
// One writer, N readers, no cross-process locks: the writer owns version/
// payload_len/payload, each reader owns its ack slot.  This file adds what
// Python cannot: real atomics with acquire/release ordering and futex
// blocking (FUTEX_WAIT on the low 32 bits of the version / ack words)
// instead of spin+sleep polling.  Futex waits use a bounded timeout so a
// mixed native/Python channel (the Python side never calls futex_wake)
// stays live.
//
// Built on first use by ray_tpu_torch/_native/build.py (g++ alone); bound
// with ctypes.

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <ctime>

#include <fcntl.h>
#include <linux/futex.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <sys/syscall.h>
#include <unistd.h>

namespace {

constexpr uint64_t kClosedBit = 1ull << 63;
// Set in the flags word by a creator whose process has this native lib;
// pure-Python peers on weakly-ordered hosts refuse to attach (the Python
// writer's plain stores lack release ordering vs our acquire loads).
constexpr uint64_t kNativeBit = 1ull << 62;
constexpr size_t kHdr = 24;  // version, payload_len, flags

struct Handle {
  uint8_t* base = nullptr;
  size_t total = 0;
  uint64_t buffer_size = 0;
  uint64_t n_readers = 0;
  char name[256] = {0};
};

inline std::atomic<uint64_t>* word(Handle* h, size_t off) {
  return reinterpret_cast<std::atomic<uint64_t>*>(h->base + off);
}

inline std::atomic<uint64_t>* version_w(Handle* h) { return word(h, 0); }
inline std::atomic<uint64_t>* len_w(Handle* h) { return word(h, 8); }
inline std::atomic<uint64_t>* flags_w(Handle* h) { return word(h, 16); }
inline std::atomic<uint64_t>* ack_w(Handle* h, uint64_t r) {
  return word(h, kHdr + 8 * r);
}
inline uint8_t* payload(Handle* h) {
  return h->base + kHdr + 8 * h->n_readers;
}

inline bool is_closed(Handle* h) {
  return (flags_w(h)->load(std::memory_order_acquire) & kClosedBit) != 0;
}

// Wait on the low 32 bits of a u64 state word while it equals `seen_lo`.
// Bounded (2 ms) so progress never depends on a wake (pure-Python peers
// don't futex_wake).
inline void futex_wait_lo32(std::atomic<uint64_t>* w, uint32_t seen_lo) {
  timespec ts{0, 2 * 1000 * 1000};
  syscall(SYS_futex, reinterpret_cast<uint32_t*>(w), FUTEX_WAIT, seen_lo,
          &ts, nullptr, 0);
}

inline void futex_wake_all(std::atomic<uint64_t>* w) {
  syscall(SYS_futex, reinterpret_cast<uint32_t*>(w), FUTEX_WAKE, INT32_MAX,
          nullptr, nullptr, 0);
}

inline double now_s() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + ts.tv_nsec * 1e-9;
}

Handle* map_segment(const char* name, size_t total_hint, bool create,
                    uint64_t buffer_size, uint64_t n_readers) {
  char path[260];
  snprintf(path, sizeof(path), "/%s", name);
  int fd = create ? shm_open(path, O_CREAT | O_EXCL | O_RDWR, 0600)
                  : shm_open(path, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  size_t total = total_hint;
  if (create) {
    if (ftruncate(fd, (off_t)total) != 0) {
      close(fd);
      shm_unlink(path);
      return nullptr;
    }
  } else {
    struct stat st;
    if (fstat(fd, &st) != 0) {
      close(fd);
      return nullptr;
    }
    total = (size_t)st.st_size;
  }
  void* mem = mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;
  auto* h = new Handle();
  h->base = static_cast<uint8_t*>(mem);
  h->total = total;
  snprintf(h->name, sizeof(h->name), "%s", name);
  if (create) {
    memset(h->base, 0, kHdr + 8 * n_readers);
    flags_w(h)->store(n_readers | kNativeBit, std::memory_order_release);
    h->buffer_size = buffer_size;
    h->n_readers = n_readers;
  } else {
    // Validate before trusting: the shm namespace is shared with other
    // segment kinds, and attaching a non-channel must fail cleanly (the
    // Python fallback raises) rather than index out of the mapping.
    if (total < kHdr) {
      munmap(mem, total);
      delete h;
      return nullptr;
    }
    uint64_t flags = flags_w(h)->load(std::memory_order_acquire);
    uint64_t n = flags & ~(kClosedBit | kNativeBit);
    if (n == 0 || n > 4096 || kHdr + 8 * n > total) {
      munmap(mem, total);
      delete h;
      return nullptr;
    }
    h->n_readers = n;
    h->buffer_size = total - kHdr - 8 * n;
  }
  return h;
}

}  // namespace

extern "C" {

void* rtpu_ch_create(const char* name, uint64_t buffer_size,
                     uint64_t n_readers) {
  size_t total = kHdr + 8 * n_readers + buffer_size;
  return map_segment(name, total, /*create=*/true, buffer_size, n_readers);
}

void* rtpu_ch_attach(const char* name) {
  return map_segment(name, 0, /*create=*/false, 0, 0);
}

uint64_t rtpu_ch_buffer_size(void* hv) {
  return static_cast<Handle*>(hv)->buffer_size;
}

uint64_t rtpu_ch_num_readers(void* hv) {
  return static_cast<Handle*>(hv)->n_readers;
}

// 0 ok; -1 timeout; -2 closed; -3 payload too large.
int64_t rtpu_ch_write(void* hv, const uint8_t* data, uint64_t len,
                      double timeout_s) {
  auto* h = static_cast<Handle*>(hv);
  if (len > h->buffer_size) return -3;
  if (is_closed(h)) return -2;
  uint64_t v = version_w(h)->load(std::memory_order_acquire);
  double deadline = timeout_s < 0 ? -1.0 : now_s() + timeout_s;
  // WriteAcquire: all readers must have consumed version v.
  for (uint64_t r = 0; r < h->n_readers; ++r) {
    for (;;) {
      uint64_t a = ack_w(h, r)->load(std::memory_order_acquire);
      if (a >= v) break;
      if (is_closed(h)) return -2;
      if (deadline >= 0 && now_s() > deadline) return -1;
      futex_wait_lo32(ack_w(h, r), (uint32_t)a);
    }
  }
  memcpy(payload(h), data, len);
  len_w(h)->store(len, std::memory_order_release);
  // WriteRelease: publish the new version and wake blocked readers.
  version_w(h)->store(v + 2, std::memory_order_release);
  futex_wake_all(version_w(h));
  return 0;
}

// >= 0: payload length, value published and NOT yet acked (call
// rtpu_ch_read_release after copying); -1 timeout; -2 closed.
int64_t rtpu_ch_read_acquire(void* hv, uint64_t slot, double timeout_s) {
  auto* h = static_cast<Handle*>(hv);
  uint64_t last = ack_w(h, slot)->load(std::memory_order_acquire);
  double deadline = timeout_s < 0 ? -1.0 : now_s() + timeout_s;
  for (;;) {
    uint64_t v = version_w(h)->load(std::memory_order_acquire);
    if (v > last) break;
    if (is_closed(h)) return -2;
    if (deadline >= 0 && now_s() > deadline) return -1;
    futex_wait_lo32(version_w(h), (uint32_t)v);
  }
  if (is_closed(h)) return -2;
  return (int64_t)len_w(h)->load(std::memory_order_acquire);
}

const uint8_t* rtpu_ch_payload(void* hv) {
  return payload(static_cast<Handle*>(hv));
}

// ReadRelease: ack the version read and wake a waiting writer.
void rtpu_ch_read_release(void* hv, uint64_t slot) {
  auto* h = static_cast<Handle*>(hv);
  uint64_t v = version_w(h)->load(std::memory_order_acquire);
  ack_w(h, slot)->store(v, std::memory_order_release);
  futex_wake_all(ack_w(h, slot));
}

int rtpu_ch_is_closed(void* hv) {
  return is_closed(static_cast<Handle*>(hv)) ? 1 : 0;
}

void rtpu_ch_close(void* hv) {
  auto* h = static_cast<Handle*>(hv);
  flags_w(h)->fetch_or(kClosedBit, std::memory_order_acq_rel);
  // wake everyone so blocked peers observe the close promptly
  futex_wake_all(version_w(h));
  for (uint64_t r = 0; r < h->n_readers; ++r) futex_wake_all(ack_w(h, r));
}

void rtpu_ch_detach(void* hv) {
  auto* h = static_cast<Handle*>(hv);
  munmap(h->base, h->total);
  delete h;
}

void rtpu_ch_destroy(void* hv) {
  auto* h = static_cast<Handle*>(hv);
  rtpu_ch_close(hv);
  char path[260];
  snprintf(path, sizeof(path), "/%s", h->name);
  munmap(h->base, h->total);
  shm_unlink(path);
  delete h;
}

}  // extern "C"
