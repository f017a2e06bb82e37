// Shared-memory SPSC ring buffer — the DataLoader's native transport.
//
// Reference parity: paddle/fluid/operators/reader/blocking_queue.h (the
// C++ bounded blocking queue feeding readers) and the shared-memory numpy
// transport of fluid/dataloader (core._array_to_share_memory_tensor).
//
// Design: one ring per worker process (single producer = the worker,
// single consumer = the host loader).  A POSIX shm segment holds a header
// (capacity, head, tail, POSIX process-shared semaphores for item/space
// counting) followed by the data area.  Records are length-prefixed and
// wrap byte-wise, so arbitrary-size batches stream through a fixed
// segment without per-batch allocations or pickling through a pipe.
//
// Exposed as a plain C ABI loaded via ctypes (no pybind dependency).
#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <fcntl.h>
#include <semaphore.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Header {
  uint64_t capacity;          // data area bytes
  std::atomic<uint64_t> head; // next read offset  (consumer-owned)
  std::atomic<uint64_t> tail; // next write offset (producer-owned)
  sem_t bytes_used;           // counts committed records (items)
  sem_t shutdown;             // posted once on close_producer
  std::atomic<int> closed;
};

struct Ring {
  Header* h;
  uint8_t* data;
  size_t map_len;
  int fd;
};

int wait_sem(sem_t* s, int timeout_ms) {
  if (timeout_ms < 0) return sem_wait(s);
  struct timespec ts;
  clock_gettime(CLOCK_REALTIME, &ts);
  ts.tv_sec += timeout_ms / 1000;
  ts.tv_nsec += (long)(timeout_ms % 1000) * 1000000L;
  if (ts.tv_nsec >= 1000000000L) { ts.tv_sec += 1; ts.tv_nsec -= 1000000000L; }
  return sem_timedwait(s, &ts);
}

uint64_t used_bytes(Header* h) {
  uint64_t head = h->head.load(std::memory_order_acquire);
  uint64_t tail = h->tail.load(std::memory_order_acquire);
  return tail - head;  // monotonically increasing offsets
}

void copy_in(Ring* r, uint64_t off, const void* src, uint64_t n) {
  uint64_t cap = r->h->capacity;
  uint64_t pos = off % cap;
  uint64_t first = (n < cap - pos) ? n : cap - pos;
  memcpy(r->data + pos, src, first);
  if (n > first) memcpy(r->data, (const uint8_t*)src + first, n - first);
}

void copy_out(Ring* r, uint64_t off, void* dst, uint64_t n) {
  uint64_t cap = r->h->capacity;
  uint64_t pos = off % cap;
  uint64_t first = (n < cap - pos) ? n : cap - pos;
  memcpy(dst, r->data + pos, first);
  if (n > first) memcpy((uint8_t*)dst + first, r->data, n - first);
}

}  // namespace

extern "C" {

// create (host side); returns opaque handle or null
void* shm_ring_create(const char* name, uint64_t capacity) {
  shm_unlink(name);
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  size_t len = sizeof(Header) + capacity;
  if (ftruncate(fd, (off_t)len) != 0) { close(fd); return nullptr; }
  void* mem = mmap(nullptr, len, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (mem == MAP_FAILED) { close(fd); return nullptr; }
  Header* h = (Header*)mem;
  h->capacity = capacity;
  h->head.store(0); h->tail.store(0); h->closed.store(0);
  sem_init(&h->bytes_used, 1, 0);
  sem_init(&h->shutdown, 1, 0);
  Ring* r = new Ring{h, (uint8_t*)mem + sizeof(Header), len, fd};
  return r;
}

void* shm_ring_attach(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return nullptr; }
  void* mem = mmap(nullptr, (size_t)st.st_size, PROT_READ | PROT_WRITE,
                   MAP_SHARED, fd, 0);
  if (mem == MAP_FAILED) { close(fd); return nullptr; }
  Header* h = (Header*)mem;
  Ring* r = new Ring{h, (uint8_t*)mem + sizeof(Header),
                     (size_t)st.st_size, fd};
  return r;
}

// producer: blocking push of one length-prefixed record.
// returns 0 ok, -1 timeout, -2 record too large, -3 ring closed
int shm_ring_push(void* ring, const void* buf, uint64_t n, int timeout_ms) {
  Ring* r = (Ring*)ring;
  Header* h = r->h;
  uint64_t need = n + 8;
  if (need > h->capacity) return -2;
  // wait for space: poll head movement (consumer posts no space sem; the
  // producer spins with a short sleep — batches are large and rare, so
  // this costs microseconds, not a hot loop)
  int waited = 0;
  while (h->capacity - used_bytes(h) < need) {
    if (h->closed.load()) return -3;
    struct timespec ts{0, 2000000};  // 2 ms
    nanosleep(&ts, nullptr);
    waited += 2;
    if (timeout_ms >= 0 && waited > timeout_ms) return -1;
  }
  uint64_t tail = h->tail.load(std::memory_order_relaxed);
  uint64_t len_le = n;
  copy_in(r, tail, &len_le, 8);
  copy_in(r, tail + 8, buf, n);
  h->tail.store(tail + need, std::memory_order_release);
  sem_post(&h->bytes_used);
  return 0;
}

// consumer: wait for a record, return its size (without consuming), or
// -1 timeout, -3 closed-and-empty
int64_t shm_ring_peek_size(void* ring, int timeout_ms) {
  Ring* r = (Ring*)ring;
  Header* h = r->h;
  if (wait_sem(&h->bytes_used, timeout_ms) != 0) {
    if (h->closed.load() && used_bytes(h) == 0) return -3;
    return -1;
  }
  // put the token back; pop will re-take it
  sem_post(&h->bytes_used);
  if (used_bytes(h) == 0) {
    // the token was close_producer's shutdown post, not a record
    return h->closed.load() ? -3 : -1;
  }
  uint64_t head = h->head.load(std::memory_order_relaxed);
  uint64_t len;
  copy_out(r, head, &len, 8);
  return (int64_t)len;
}

// consumer: copy one record into out (must be >= its size) and consume it
int64_t shm_ring_pop(void* ring, void* out, uint64_t out_cap,
                     int timeout_ms) {
  Ring* r = (Ring*)ring;
  Header* h = r->h;
  if (wait_sem(&h->bytes_used, timeout_ms) != 0) {
    if (h->closed.load() && used_bytes(h) == 0) return -3;
    return -1;
  }
  if (used_bytes(h) == 0) {
    sem_post(&h->bytes_used);  // keep the shutdown token for other waiters
    return h->closed.load() ? -3 : -1;
  }
  uint64_t head = h->head.load(std::memory_order_relaxed);
  uint64_t len;
  copy_out(r, head, &len, 8);
  if (len > out_cap) { sem_post(&h->bytes_used); return -2; }
  copy_out(r, head + 8, out, len);
  h->head.store(head + len + 8, std::memory_order_release);
  return (int64_t)len;
}

void shm_ring_close_producer(void* ring) {
  Ring* r = (Ring*)ring;
  r->h->closed.store(1);
  sem_post(&r->h->bytes_used);  // wake a blocked consumer
}

void shm_ring_detach(void* ring) {
  Ring* r = (Ring*)ring;
  munmap((void*)r->h, r->map_len);
  close(r->fd);
  delete r;
}

void shm_ring_unlink(const char* name) { shm_unlink(name); }

}  // extern "C"
