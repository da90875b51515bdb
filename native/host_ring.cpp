// afp native host runtime: bounded block ring buffers + real-time pacer.
//
// Native equivalent of the reference's host-side streaming machinery
// (SURVEY.md §2.3/§2.4): PortAudio's callback/queue layer
// (reference/stream_process_EQ_GUI.py:47-48, 462-484) becomes a pair of
// bounded ring buffers with the same backpressure semantics — put_nowait +
// drop-on-full ("Output queue full, dropping frame",
// stream_process_AGC.py:198-199) and timeout'd blocking gets
// (stream_process_AGC.py:111-115) — plus a monotonic-clock pacer that stands
// in for the sound card's DMA tick so latency semantics are testable without
// audio hardware (the "simulated-clock stream driver").
//
// Exposed as a C ABI for ctypes. Blocks are fixed-size float32 frames;
// capacity and block size are set at creation (static shapes, like the
// device side).

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

using Clock = std::chrono::steady_clock;

struct Ring {
  std::vector<float> data;      // capacity * block_floats
  size_t capacity = 0;          // in blocks
  size_t block_floats = 0;
  size_t head = 0;              // next pop position (blocks)
  size_t size = 0;              // occupied blocks
  // stats (reference-visible counters, SURVEY.md §5.5)
  std::atomic<uint64_t> pushes{0};
  std::atomic<uint64_t> pops{0};
  std::atomic<uint64_t> drops{0};      // push on full
  std::atomic<uint64_t> underruns{0};  // pop on empty
  std::mutex mu;
  std::condition_variable not_full;
  std::condition_variable not_empty;
};

struct Pacer {
  Clock::time_point next;
  std::chrono::nanoseconds period{0};
  std::atomic<uint64_t> ticks{0};
  std::atomic<uint64_t> overruns{0};  // ticks that were already late
};

}  // namespace

extern "C" {

// ---------------- ring buffer ----------------

void* afp_ring_create(uint64_t capacity_blocks, uint64_t block_floats) {
  if (capacity_blocks == 0 || block_floats == 0) return nullptr;
  Ring* r = new Ring();
  r->capacity = capacity_blocks;
  r->block_floats = block_floats;
  r->data.resize(capacity_blocks * block_floats);
  return r;
}

void afp_ring_destroy(void* h) { delete static_cast<Ring*>(h); }

// push_nowait: 0 on success, -1 if full (block dropped; drop counter bumps)
int afp_ring_push(void* h, const float* block) {
  Ring* r = static_cast<Ring*>(h);
  std::unique_lock<std::mutex> lk(r->mu);
  if (r->size == r->capacity) {
    r->drops.fetch_add(1, std::memory_order_relaxed);
    return -1;
  }
  size_t slot = (r->head + r->size) % r->capacity;
  std::memcpy(&r->data[slot * r->block_floats], block,
              r->block_floats * sizeof(float));
  r->size++;
  lk.unlock();
  r->not_empty.notify_one();
  r->pushes.fetch_add(1, std::memory_order_relaxed);
  return 0;
}

// blocking push with timeout_ms (<0 = wait forever): 0 ok, -1 timeout
int afp_ring_push_blocking(void* h, const float* block, double timeout_ms) {
  Ring* r = static_cast<Ring*>(h);
  std::unique_lock<std::mutex> lk(r->mu);
  auto pred = [r] { return r->size < r->capacity; };
  if (timeout_ms < 0) {
    r->not_full.wait(lk, pred);
  } else if (!r->not_full.wait_for(
                 lk, std::chrono::duration<double, std::milli>(timeout_ms),
                 pred)) {
    r->drops.fetch_add(1, std::memory_order_relaxed);
    return -1;
  }
  size_t slot = (r->head + r->size) % r->capacity;
  std::memcpy(&r->data[slot * r->block_floats], block,
              r->block_floats * sizeof(float));
  r->size++;
  lk.unlock();
  r->not_empty.notify_one();
  r->pushes.fetch_add(1, std::memory_order_relaxed);
  return 0;
}

// pop_nowait: 0 on success, -1 if empty (underrun counter bumps)
int afp_ring_pop(void* h, float* out) {
  Ring* r = static_cast<Ring*>(h);
  std::unique_lock<std::mutex> lk(r->mu);
  if (r->size == 0) {
    r->underruns.fetch_add(1, std::memory_order_relaxed);
    return -1;
  }
  std::memcpy(out, &r->data[r->head * r->block_floats],
              r->block_floats * sizeof(float));
  r->head = (r->head + 1) % r->capacity;
  r->size--;
  lk.unlock();
  r->not_full.notify_one();
  r->pops.fetch_add(1, std::memory_order_relaxed);
  return 0;
}

// blocking pop with timeout_ms (<0 = wait forever): 0 ok, -1 timeout
int afp_ring_pop_blocking(void* h, float* out, double timeout_ms) {
  Ring* r = static_cast<Ring*>(h);
  std::unique_lock<std::mutex> lk(r->mu);
  auto pred = [r] { return r->size > 0; };
  if (timeout_ms < 0) {
    r->not_empty.wait(lk, pred);
  } else if (!r->not_empty.wait_for(
                 lk, std::chrono::duration<double, std::milli>(timeout_ms),
                 pred)) {
    r->underruns.fetch_add(1, std::memory_order_relaxed);
    return -1;
  }
  std::memcpy(out, &r->data[r->head * r->block_floats],
              r->block_floats * sizeof(float));
  r->head = (r->head + 1) % r->capacity;
  r->size--;
  lk.unlock();
  r->not_full.notify_one();
  r->pops.fetch_add(1, std::memory_order_relaxed);
  return 0;
}

uint64_t afp_ring_size(void* h) {
  Ring* r = static_cast<Ring*>(h);
  std::lock_guard<std::mutex> lk(r->mu);
  return r->size;
}

void afp_ring_stats(void* h, uint64_t* pushes, uint64_t* pops, uint64_t* drops,
                    uint64_t* underruns) {
  Ring* r = static_cast<Ring*>(h);
  *pushes = r->pushes.load();
  *pops = r->pops.load();
  *drops = r->drops.load();
  *underruns = r->underruns.load();
}

// ---------------- pacer (simulated sound-card clock) ----------------

void* afp_pacer_create(double period_seconds) {
  // mirror afp_ring_create's zero-guard: a non-positive period would make
  // afp_pacer_wait divide by a zero duration (UB/SIGFPE from a ctypes call)
  if (!(period_seconds > 0.0)) return nullptr;
  Pacer* p = new Pacer();
  p->period = std::chrono::nanoseconds(
      static_cast<int64_t>(period_seconds * 1e9));
  if (p->period.count() <= 0) {  // sub-nanosecond periods truncate to 0
    delete p;
    return nullptr;
  }
  p->next = Clock::now() + p->period;
  return p;
}

void afp_pacer_destroy(void* h) { delete static_cast<Pacer*>(h); }

// Sleep until the next block boundary. Returns the number of ticks that were
// MISSED (0 = on time) — the dropped-frame signal, like a real sound card.
// A missed tick is a deadline that passed WHOLE before this call: arriving
// exactly on the deadline, or late by less than one period, still serves
// that tick (0 missed — the engine's own overrun counter tracks
// processing_time > block_time separately, metrics.py).  When behind, the
// schedule resynchronizes past `now`.
int afp_pacer_wait(void* h) {
  Pacer* p = static_cast<Pacer*>(h);
  auto now = Clock::now();
  int late = 0;
  if (now < p->next) {
    std::this_thread::sleep_until(p->next);
    p->next += p->period;
  } else {
    // full periods behind = deadlines skipped entirely; the tick served by
    // THIS call is the first deadline not strictly before `now`
    late = static_cast<int>((now - p->next) / p->period);
    p->next += p->period * (late + 1);
    if (late > 0) p->overruns.fetch_add(late, std::memory_order_relaxed);
  }
  p->ticks.fetch_add(1, std::memory_order_relaxed);
  return late;
}

uint64_t afp_pacer_ticks(void* h) { return static_cast<Pacer*>(h)->ticks.load(); }
uint64_t afp_pacer_overruns(void* h) {
  return static_cast<Pacer*>(h)->overruns.load();
}

}  // extern "C"
