// Native batched-read engine for the hash plane's disk stage.
//
// The reference's storage path is one async seek/read per block
// (storage.ts:150-172 fsStorage.get); the Python port of that is fine
// for the swarm's 16 KiB blocks but cannot feed a GPU verifier at GiB/s:
// per-call overhead (Python frames, GIL, one syscall per segment through
// a shared file cursor) dominates. This engine is the C++ data-loader
// the batch path calls instead:
//
// - the caller flattens a piece batch into (file, file_offset, out_offset,
//   length) segments — multi-file boundary spanning already resolved;
// - a persistent thread pool services segments with positional pread(2)
//   (no shared cursor, no locking between readers) straight into the
//   caller's staging buffer (the pinned buffer the GPU copy reads from);
// - file descriptors are opened once per batch and shared read-only
//   across threads (pread is thread-safe by contract).
//
// Exposed as a tiny C ABI for ctypes — no pybind11 in this image.
// Build: torrent_tpu_torch/native/build.py (g++ -O2 -shared -fPIC -pthread).
// A copy of torrent_tpu/native/io_engine.cpp without its RC4 routines,
// which serve the peer wire protocol, not the hash plane.

#include <atomic>
#include <cerrno>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <memory>
#include <mutex>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Segment {
  int32_t file_index;   // index into the batch's path table
  int64_t file_offset;  // byte offset within that file
  int64_t out_offset;   // byte offset within the output buffer
  int64_t length;       // bytes to read
};

// Read one segment fully; returns 0 on success, else errno-style code.
// Short reads past EOF are reported as EIO-like failure (-1): a piece
// that cannot be fully read must not verify.
int read_segment(int fd, const Segment& seg, uint8_t* out) {
  int64_t done = 0;
  while (done < seg.length) {
    ssize_t n = pread(fd, out + seg.out_offset + done,
                      static_cast<size_t>(seg.length - done),
                      static_cast<off_t>(seg.file_offset + done));
    if (n < 0) {
      if (errno == EINTR) continue;
      return errno ? errno : -1;
    }
    if (n == 0) return -1;  // EOF before the segment was satisfied
    done += n;
  }
  return 0;
}

// All per-batch state lives in one heap object handed to workers via
// shared_ptr, so a straggler thread that wakes late can only ever touch
// ITS batch's counters — never a newer batch's (claiming an index from a
// fresh batch's counter while holding stale segment pointers would
// double-claim segments and return before the buffer is complete).
// `done` is flipped and cv_done notified under the mutex; checking the
// predicate under the same mutex in submit() makes the wakeup lossless.
struct Batch {
  const Segment* segs;
  const int* fds;
  uint8_t* out;
  int32_t* statuses;
  int64_t n_segs;
  std::atomic<int64_t> next{0};
  std::atomic<int64_t> remaining;
};

struct Pool {
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_work, cv_done;
  std::shared_ptr<Batch> current;  // guarded by mu
  uint64_t generation = 0;         // guarded by mu
  bool batch_done = false;         // guarded by mu
  bool shutting_down = false;

  explicit Pool(int n_threads) {
    for (int i = 0; i < n_threads; ++i) {
      workers.emplace_back([this] { run(); });
    }
  }

  ~Pool() {
    {
      std::lock_guard<std::mutex> lock(mu);
      shutting_down = true;
    }
    cv_work.notify_all();
    for (auto& t : workers) t.join();
  }

  void run() {
    uint64_t seen = 0;
    for (;;) {
      std::shared_ptr<Batch> batch;
      {
        std::unique_lock<std::mutex> lock(mu);
        cv_work.wait(lock, [&] { return shutting_down || generation != seen; });
        if (shutting_down) return;
        seen = generation;
        batch = current;
      }
      for (;;) {
        int64_t i = batch->next.fetch_add(1);
        if (i >= batch->n_segs) break;
        const Segment& s = batch->segs[i];
        batch->statuses[i] = read_segment(batch->fds[s.file_index], s, batch->out);
        if (batch->remaining.fetch_sub(1) == 1) {
          std::lock_guard<std::mutex> lock(mu);
          batch_done = true;
          cv_done.notify_all();
        }
      }
    }
  }

  // Returns 0 if every segment read cleanly; else the first error code.
  int submit(const Segment* s, int64_t n, const int* f, uint8_t* o,
             int32_t* st) {
    if (n == 0) return 0;
    auto batch = std::make_shared<Batch>();
    batch->segs = s;
    batch->fds = f;
    batch->out = o;
    batch->statuses = st;
    batch->n_segs = n;
    batch->remaining.store(n);
    {
      std::lock_guard<std::mutex> lock(mu);
      current = batch;
      batch_done = false;
      ++generation;
    }
    cv_work.notify_all();
    {
      std::unique_lock<std::mutex> lock(mu);
      cv_done.wait(lock, [&] { return batch_done; });
    }
    for (int64_t i = 0; i < n; ++i)
      if (st[i] != 0) return st[i];
    return 0;
  }
};

}  // namespace

extern "C" {

// Opaque engine handle.
void* tt_io_create(int n_threads) {
  if (n_threads < 1) n_threads = 1;
  if (n_threads > 64) n_threads = 64;
  return new Pool(n_threads);
}

void tt_io_destroy(void* engine) { delete static_cast<Pool*>(engine); }

// Read a batch of segments from a set of files into `out`.
//
// paths:      NUL-terminated UTF-8 file paths, n_files of them
// segs:       packed int64 quads [file_index, file_offset, out_offset, length]
//             (file_index stored as int64 for a uniform array layout)
// statuses:   caller-allocated int32[n_segs] scratch (per-segment errno)
//
// Returns 0 on full success; first nonzero errno otherwise (including
// -1 for EOF-short reads and open() failures reported per segment).
int tt_io_read_batch(void* engine, const char** paths, int32_t n_files,
                     const int64_t* segs, int64_t n_segs, uint8_t* out,
                     int32_t* statuses) {
  Pool* pool = static_cast<Pool*>(engine);
  std::vector<int> fds(n_files, -1);
  for (int32_t i = 0; i < n_files; ++i) {
    fds[i] = open(paths[i], O_RDONLY | O_CLOEXEC);
  }
  std::vector<Segment> packed(static_cast<size_t>(n_segs));
  int rc = 0;
  for (int64_t i = 0; i < n_segs; ++i) {
    const int64_t* q = segs + i * 4;
    packed[i].file_index = static_cast<int32_t>(q[0]);
    packed[i].file_offset = q[1];
    packed[i].out_offset = q[2];
    packed[i].length = q[3];
    if (q[0] < 0 || q[0] >= n_files || fds[q[0]] < 0) {
      // missing file: fail fast before touching the pool
      statuses[i] = ENOENT;
      rc = ENOENT;
    } else {
      statuses[i] = 0;
    }
  }
  if (rc == 0) {
    rc = pool->submit(packed.data(), n_segs, fds.data(), out, statuses);
  }
  for (int fd : fds)
    if (fd >= 0) close(fd);
  return rc;
}

}  // extern "C"
