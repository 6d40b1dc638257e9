// Lock-free single-producer shared-memory ring buffer for image frames.
//
// TPU-native equivalent of the reference's mmf (memory-mapped-file) image
// transport (lcmtypes/mmf_image_t.lcm + lcm_util/image_subscriber.hpp): the
// producer writes frames into a mapped file; consumers map the same file and
// read frames in place — no serialization, no copies on the publish path.
//
// Design: a fixed number of equally-sized slots. Each slot carries a seqlock
// (even = stable, odd = being written). The producer overwrites the oldest
// slot; readers validate the sequence before/after copying out (or can pass
// the mapped pointer straight to the data loader for zero-copy ingest).
//
// Built as a plain shared library (no pybind11); Python binds via ctypes.

#include <atomic>
#include <cstdint>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x0CEA55F00D000001ULL;

struct RingHeader {
  uint64_t magic;
  uint32_t n_slots;
  uint32_t slot_bytes;           // payload capacity per slot
  std::atomic<uint64_t> head;    // next sequence number to write (starts 1)
  char pad[64 - sizeof(uint64_t)];
};

struct SlotHeader {
  std::atomic<uint64_t> seq;     // 0 = empty; odd = writing; even = stable
  int64_t timestamp_ns;
  uint32_t payload_bytes;
  uint32_t width, height, channels, dtype;  // dtype: 0=u8, 1=f32
  char pad[16];
};

struct Ring {
  int fd;
  uint8_t* base;
  size_t map_bytes;
  RingHeader* header;
};

inline SlotHeader* slot_at(Ring* r, uint32_t idx) {
  size_t stride = sizeof(SlotHeader) + r->header->slot_bytes;
  return reinterpret_cast<SlotHeader*>(
      r->base + sizeof(RingHeader) + static_cast<size_t>(idx) * stride);
}

inline uint8_t* slot_payload(SlotHeader* s) {
  return reinterpret_cast<uint8_t*>(s) + sizeof(SlotHeader);
}

}  // namespace

extern "C" {

// Create (producer) or open (consumer) a ring at `path`.
void* shm_ring_create(const char* path, uint32_t n_slots, uint32_t slot_bytes) {
  size_t stride = sizeof(SlotHeader) + slot_bytes;
  size_t total = sizeof(RingHeader) + stride * n_slots;
  int fd = ::open(path, O_RDWR | O_CREAT, 0644);
  if (fd < 0) return nullptr;
  if (::ftruncate(fd, static_cast<off_t>(total)) != 0) {
    ::close(fd);
    return nullptr;
  }
  void* base = ::mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  Ring* r = new Ring{fd, static_cast<uint8_t*>(base), total,
                     reinterpret_cast<RingHeader*>(base)};
  std::memset(base, 0, sizeof(RingHeader));
  r->header->magic = kMagic;
  r->header->n_slots = n_slots;
  r->header->slot_bytes = slot_bytes;
  r->header->head.store(1, std::memory_order_release);
  for (uint32_t i = 0; i < n_slots; ++i) {
    slot_at(r, i)->seq.store(0, std::memory_order_relaxed);
  }
  return r;
}

void* shm_ring_open(const char* path) {
  int fd = ::open(path, O_RDWR);
  if (fd < 0) return nullptr;
  struct stat st;
  if (::fstat(fd, &st) != 0 || st.st_size < (off_t)sizeof(RingHeader)) {
    ::close(fd);
    return nullptr;
  }
  void* base =
      ::mmap(nullptr, st.st_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  Ring* r = new Ring{fd, static_cast<uint8_t*>(base),
                     static_cast<size_t>(st.st_size),
                     reinterpret_cast<RingHeader*>(base)};
  if (r->header->magic != kMagic) {
    ::munmap(base, st.st_size);
    ::close(fd);
    delete r;
    return nullptr;
  }
  return r;
}

void shm_ring_close(void* handle) {
  Ring* r = static_cast<Ring*>(handle);
  if (!r) return;
  ::munmap(r->base, r->map_bytes);
  ::close(r->fd);
  delete r;
}

// Producer: write a frame; returns its sequence number (0 on failure).
uint64_t shm_ring_write(void* handle, int64_t timestamp_ns, const uint8_t* data,
                        uint32_t n_bytes, uint32_t width, uint32_t height,
                        uint32_t channels, uint32_t dtype) {
  Ring* r = static_cast<Ring*>(handle);
  if (!r || n_bytes > r->header->slot_bytes) return 0;
  uint64_t seq = r->header->head.fetch_add(1, std::memory_order_acq_rel);
  SlotHeader* s = slot_at(r, static_cast<uint32_t>(seq % r->header->n_slots));
  // Seqlock: odd while writing. The release fence keeps the payload stores
  // from being reordered BEFORE the odd marker on weakly-ordered CPUs (the
  // odd store alone only orders writes preceding it).
  s->seq.store(2 * seq - 1, std::memory_order_relaxed);
  std::atomic_thread_fence(std::memory_order_release);
  s->timestamp_ns = timestamp_ns;
  s->payload_bytes = n_bytes;
  s->width = width;
  s->height = height;
  s->channels = channels;
  s->dtype = dtype;
  std::memcpy(slot_payload(s), data, n_bytes);
  s->seq.store(2 * seq, std::memory_order_release);
  return seq;
}

uint64_t shm_ring_latest_seq(void* handle) {
  Ring* r = static_cast<Ring*>(handle);
  if (!r) return 0;
  return r->header->head.load(std::memory_order_acquire) - 1;
}

// Consumer: copy frame `seq` out. Returns payload bytes, or 0 if the slot
// was overwritten/invalid. Metadata returned through out params.
uint32_t shm_ring_read(void* handle, uint64_t seq, uint8_t* out,
                       uint32_t out_capacity, int64_t* timestamp_ns,
                       uint32_t* width, uint32_t* height, uint32_t* channels,
                       uint32_t* dtype) {
  Ring* r = static_cast<Ring*>(handle);
  if (!r || seq == 0) return 0;
  SlotHeader* s = slot_at(r, static_cast<uint32_t>(seq % r->header->n_slots));
  uint64_t before = s->seq.load(std::memory_order_acquire);
  if (before != 2 * seq) return 0;  // not this frame anymore (or mid-write)
  uint32_t n = s->payload_bytes;
  if (n > out_capacity) return 0;
  *timestamp_ns = s->timestamp_ns;
  *width = s->width;
  *height = s->height;
  *channels = s->channels;
  *dtype = s->dtype;
  std::memcpy(out, slot_payload(s), n);
  // Acquire fence: the payload loads above must complete before the
  // validating seq re-load (LoadLoad ordering), or a torn frame could pass.
  std::atomic_thread_fence(std::memory_order_acquire);
  uint64_t after = s->seq.load(std::memory_order_relaxed);
  if (after != 2 * seq) return 0;  // torn read: producer lapped us
  return n;
}

uint32_t shm_ring_slot_bytes(void* handle) {
  Ring* r = static_cast<Ring*>(handle);
  return r ? r->header->slot_bytes : 0;
}

}  // extern "C"
