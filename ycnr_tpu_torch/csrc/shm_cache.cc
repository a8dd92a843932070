// Cross-process shared recommendation cache (the reference's Redis role,
// SURVEY.md C8) over POSIX shared memory.
//
// serve/cache.py's RecCache is process-local: a fleet of serving processes
// attached to one shm factor store (native/shm_store.cc) recomputes the
// same top-N lists independently. This segment shares those results:
//
//   ycnr_cache_create(name, capacity, n_max) -> handle   (power-of-2 cap)
//   ycnr_cache_attach(name)                 -> handle (or NULL)
//   ycnr_cache_put(handle, key, epoch, items*, count) -> 1 stored / 0 busy
//   ycnr_cache_get(handle, key, epoch, out_items*)    -> count or -1 miss
//   ycnr_cache_stats(handle, out[3])   (capacity, n_max, live-ish entries)
//   ycnr_cache_detach(handle), ycnr_cache_unlink(name)
//
// Design (multi-writer safe, wait-free readers):
// * direct-mapped open addressing: slot = mix(key) & (capacity-1); a
//   colliding put simply overwrites — it is a cache, losing an entry is
//   always correct.
// * per-slot seqlock, multi-writer via CAS even->odd: a writer that loses
//   the CAS just skips the put (another writer is filling the slot).
// * every entry is stamped with the FACTOR EPOCH it was computed from
//   (the shm factor store's published epoch): readers pass their current
//   epoch and reject mismatches, so a trainer republish invalidates the
//   whole cache implicitly — no cross-process flush protocol at all.
// * same formal-memory-model caveat as shm_store.cc's seqlock (release
//   fence orders the plain payload stores on real targets; see the note
//   there), plus CAS gives writer exclusion per slot.
//
// Build: g++ -O3 -shared -fPIC shm_cache.cc -o libycnr_cache.so

#include <atomic>
#include <cstdint>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x59434e5243484531ull;  // "YCNRCHE1"
constexpr uint32_t kVersion = 1;

struct Header {
  uint64_t magic;
  uint32_t version;
  uint32_t n_max;       // item slots per entry
  uint64_t capacity;    // power of two
  int64_t total_bytes;
};

struct Slot {
  std::atomic<uint32_t> seq;  // even = stable, odd = writer active
  uint32_t count;             // valid items (<= n_max)
  uint64_t key;
  int64_t epoch;              // factor epoch the entry was computed from
  // int32 items[n_max] follow
};

static_assert(sizeof(Slot) % 8 == 0, "slot header must stay aligned");

size_t slot_bytes(uint32_t n_max) {
  return sizeof(Slot) + sizeof(int32_t) * (size_t)n_max;
}

Slot* slot_at(Header* h, uint64_t idx) {
  char* base = reinterpret_cast<char*>(h) + sizeof(Header);
  return reinterpret_cast<Slot*>(base + idx * slot_bytes(h->n_max));
}

int32_t* slot_items(Slot* s) {
  return reinterpret_cast<int32_t*>(reinterpret_cast<char*>(s)
                                    + sizeof(Slot));
}

uint64_t mix(uint64_t x) {  // splitmix64 finalizer
  x += 0x9e3779b97f4a7c15ull;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
  return x ^ (x >> 31);
}

}  // namespace

extern "C" {

void* ycnr_cache_attach(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || (size_t)st.st_size < sizeof(Header)) {
    close(fd);
    return nullptr;
  }
  void* p = mmap(nullptr, (size_t)st.st_size, PROT_READ | PROT_WRITE,
                 MAP_SHARED, fd, 0);
  close(fd);
  if (p == MAP_FAILED) return nullptr;
  Header* h = static_cast<Header*>(p);
  if (h->magic != kMagic || h->version != kVersion
      || h->total_bytes != (int64_t)st.st_size
      || sizeof(Header) + h->capacity * slot_bytes(h->n_max)
             != (size_t)st.st_size) {
    munmap(p, (size_t)st.st_size);
    return nullptr;
  }
  return p;
}

void* ycnr_cache_create(const char* name, uint64_t capacity,
                        uint32_t n_max) {
  if (capacity == 0 || (capacity & (capacity - 1)) != 0 || n_max == 0) {
    return nullptr;  // capacity must be a power of two
  }
  // adopt an existing compatible segment (any number of processes may race
  // through create; the cache has no single-writer notion)
  void* existing = ycnr_cache_attach(name);
  if (existing) {
    Header* eh = static_cast<Header*>(existing);
    if (eh->capacity == capacity && eh->n_max == n_max) return existing;
    munmap(existing, (size_t)eh->total_bytes);
    return nullptr;  // dimension mismatch: caller must unlink explicitly
  }
  size_t total = sizeof(Header) + capacity * slot_bytes(n_max);
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) {
    // lost a creation race: give the winner a moment to finish
    for (int t = 0; t < 20; t++) {
      usleep(10 * 1000);
      existing = ycnr_cache_attach(name);
      if (existing) {
        Header* eh = static_cast<Header*>(existing);
        if (eh->capacity == capacity && eh->n_max == n_max) return existing;
        munmap(existing, (size_t)eh->total_bytes);
        return nullptr;
      }
    }
    return nullptr;
  }
  if (ftruncate(fd, (off_t)total) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* p = mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (p == MAP_FAILED) return nullptr;
  Header* h = static_cast<Header*>(p);
  h->version = kVersion;
  h->n_max = n_max;
  h->capacity = capacity;
  h->total_bytes = (int64_t)total;
  // slots are zero (ftruncate): seq 0 (stable), epoch 0, key 0 — a key-0
  // epoch-0 probe could false-hit slot 0's zeros, so readers also check
  // count != 0 || key matches; epoch is required > 0 by the Python layer
  std::atomic_thread_fence(std::memory_order_release);
  h->magic = kMagic;
  return p;
}

int ycnr_cache_put(void* handle, uint64_t key, int64_t epoch,
                   const int32_t* items, uint32_t count) {
  Header* h = static_cast<Header*>(handle);
  if (count > h->n_max) return 0;
  Slot* s = slot_at(h, mix(key) & (h->capacity - 1));
  uint32_t seq = s->seq.load(std::memory_order_relaxed);
  if (seq & 1) return 0;  // another writer is on this slot: skip
  if (!s->seq.compare_exchange_strong(seq, seq + 1,
                                      std::memory_order_acquire)) {
    return 0;  // lost the race: skip (cache semantics)
  }
  s->key = key;
  s->epoch = epoch;
  s->count = count;
  memcpy(slot_items(s), items, sizeof(int32_t) * count);
  std::atomic_thread_fence(std::memory_order_release);
  s->seq.store(seq + 2, std::memory_order_release);
  return 1;
}

// -> count (>=0) on hit for (key, epoch); -1 on miss/stale/torn.
int ycnr_cache_get(void* handle, uint64_t key, int64_t epoch,
                   int32_t* out_items) {
  Header* h = static_cast<Header*>(handle);
  Slot* s = slot_at(h, mix(key) & (h->capacity - 1));
  for (int attempt = 0; attempt < 4; attempt++) {
    uint32_t s1 = s->seq.load(std::memory_order_acquire);
    if (s1 & 1) continue;  // writer in flight
    if (s->key != key || s->epoch != epoch) return -1;
    uint32_t count = s->count;
    if (count > h->n_max) return -1;  // torn/garbage
    memcpy(out_items, slot_items(s), sizeof(int32_t) * count);
    std::atomic_thread_fence(std::memory_order_acquire);
    if (s->seq.load(std::memory_order_relaxed) == s1) return (int)count;
  }
  return -1;  // treated as a miss; the caller recomputes
}

int ycnr_cache_stats(void* handle, int64_t out[3]) {
  Header* h = static_cast<Header*>(handle);
  out[0] = (int64_t)h->capacity;
  out[1] = (int64_t)h->n_max;
  int64_t live = 0;
  for (uint64_t j = 0; j < h->capacity; j++) {
    Slot* s = slot_at(h, j);
    if (s->epoch > 0 && !(s->seq.load(std::memory_order_relaxed) & 1)) {
      live++;
    }
  }
  out[2] = live;
  return 0;
}

int ycnr_cache_detach(void* handle) {
  Header* h = static_cast<Header*>(handle);
  return munmap(handle, (size_t)h->total_bytes);
}

int ycnr_cache_unlink(const char* name) { return shm_unlink(name); }

}  // extern "C"
