// Native host-side data pipeline: memory-mapped .npy reader + threaded
// random-row prefetcher.
//
// The reference's training scripts load FNO Navier-Stokes trajectories and
// stored Gaussian fits from disk on the hot path (main_pn.py:36-49,142-149;
// test_initialize.py:41-47).  This library provides the production equivalent
// for the host: zero-copy mmap of .npy arrays and a background thread pool
// that materializes randomly sampled row batches into a ring of reusable
// buffers, so device feeds never wait on the filesystem or the Python heap.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread npy_loader.cc -o libpigs_host.so
// (pigs_tpu_torch/native/__init__.py builds it under build/pigs_tpu_torch/
// native/ at the root of the checkout and binds it with ctypes).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <queue>
#include <random>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct NpyFile {
  int fd = -1;
  void* map = nullptr;
  size_t map_size = 0;
  const char* data = nullptr;  // start of array payload
  long long nbytes = 0;
  std::vector<long long> shape;
  std::string dtype;
  bool fortran = false;
  std::string error;
};

// Minimal .npy v1/v2 header parser (format spec: numpy/lib/format.py).
bool parse_header(NpyFile* f) {
  const unsigned char* p = reinterpret_cast<const unsigned char*>(f->map);
  if (f->map_size < 10 || std::memcmp(p, "\x93NUMPY", 6) != 0) {
    f->error = "not a .npy file";
    return false;
  }
  int major = p[6];
  size_t header_len, header_off;
  if (major == 1) {
    header_len = p[8] | (p[9] << 8);
    header_off = 10;
  } else {
    header_len = p[8] | (p[9] << 8) | (p[10] << 16)
                 | (static_cast<size_t>(p[11]) << 24);
    header_off = 12;
  }
  if (header_off + header_len > f->map_size) {
    f->error = "truncated header";
    return false;
  }
  std::string h(reinterpret_cast<const char*>(p) + header_off, header_len);

  auto find_value = [&](const std::string& key) -> std::string {
    size_t k = h.find("'" + key + "'");
    if (k == std::string::npos) return "";
    size_t colon = h.find(':', k);
    size_t start = h.find_first_not_of(" ", colon + 1);
    return h.substr(start);
  };

  std::string descr = find_value("descr");
  if (descr.size() < 2 || descr[0] != '\'') {
    f->error = "unsupported descr";
    return false;
  }
  f->dtype = descr.substr(1, descr.find('\'', 1) - 1);

  std::string fortran = find_value("fortran_order");
  f->fortran = fortran.rfind("True", 0) == 0;
  if (f->fortran) {
    // The raw payload of an F-ordered array would be silently transposed if
    // exposed as C-order; report an error so the Python side falls back to
    // np.load (which honors the flag).
    f->error = "fortran_order not supported by the native reader";
    return false;
  }

  std::string shape_s = find_value("shape");
  size_t open = shape_s.find('(');
  size_t close = shape_s.find(')');
  if (open == std::string::npos || close == std::string::npos) {
    f->error = "bad shape";
    return false;
  }
  std::string dims = shape_s.substr(open + 1, close - open - 1);
  long long total = 1;
  size_t pos = 0;
  while (pos < dims.size()) {
    size_t comma = dims.find(',', pos);
    std::string tok = dims.substr(pos, comma == std::string::npos
                                           ? std::string::npos
                                           : comma - pos);
    size_t first = tok.find_first_not_of(" ");
    if (first != std::string::npos) {
      tok = tok.substr(first);
      if (!tok.empty()) {
        f->shape.push_back(std::stoll(tok));
        total *= f->shape.back();
      }
    }
    if (comma == std::string::npos) break;
    pos = comma + 1;
  }
  f->data = reinterpret_cast<const char*>(p) + header_off + header_len;
  f->nbytes = static_cast<long long>(f->map_size - header_off - header_len);
  return true;
}

struct Prefetcher {
  NpyFile* file = nullptr;
  long long rows_per_batch = 0;
  long long row_bytes = 0;
  long long n_rows = 0;
  int depth = 0;

  std::vector<std::vector<char>> buffers;
  std::vector<std::vector<long long>> indices;
  std::queue<int> ready;       // filled slots
  std::queue<int> free_slots;  // reusable slots
  std::mutex mu;
  std::condition_variable cv_ready, cv_free, cv_done;
  int consumers = 0;  // callers inside pigs_prefetch_next (teardown guard)
  int out_slots = 0;  // slots handed out by next() and not yet release()d:
                      // destroy() must not free buffers while the caller is
                      // still reading a returned slot (the reader's memcpy
                      // happens AFTER next() returns)
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
  std::mt19937_64 rng;
  std::mutex rng_mu;

  void worker() {
    while (!stop.load()) {
      int slot;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_free.wait(lk, [&] { return stop.load() || !free_slots.empty(); });
        if (stop.load()) return;
        slot = free_slots.front();
        free_slots.pop();
      }
      // Sample row indices and copy rows.
      {
        std::lock_guard<std::mutex> lk(rng_mu);
        for (long long i = 0; i < rows_per_batch; ++i) {
          indices[slot][i] = static_cast<long long>(rng() % n_rows);
        }
      }
      char* dst = buffers[slot].data();
      for (long long i = 0; i < rows_per_batch; ++i) {
        std::memcpy(dst + i * row_bytes,
                    file->data + indices[slot][i] * row_bytes, row_bytes);
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        ready.push(slot);
      }
      cv_ready.notify_one();
    }
  }
};

}  // namespace

extern "C" {

void* pigs_npy_open(const char* path) {
  auto* f = new NpyFile();
  f->fd = open(path, O_RDONLY);
  if (f->fd < 0) {
    f->error = "open failed";
    return f;
  }
  struct stat st;
  fstat(f->fd, &st);
  f->map_size = static_cast<size_t>(st.st_size);
  f->map = mmap(nullptr, f->map_size, PROT_READ, MAP_PRIVATE, f->fd, 0);
  if (f->map == MAP_FAILED) {
    f->map = nullptr;
    f->error = "mmap failed";
    return f;
  }
  madvise(f->map, f->map_size, MADV_WILLNEED);
  parse_header(f);
  return f;
}

const char* pigs_npy_error(void* h) {
  auto* f = static_cast<NpyFile*>(h);
  return f->error.empty() ? nullptr : f->error.c_str();
}

int pigs_npy_ndim(void* h) {
  return static_cast<int>(static_cast<NpyFile*>(h)->shape.size());
}

const long long* pigs_npy_shape(void* h) {
  return static_cast<NpyFile*>(h)->shape.data();
}

const char* pigs_npy_dtype(void* h) {
  return static_cast<NpyFile*>(h)->dtype.c_str();
}

const void* pigs_npy_data(void* h) {
  return static_cast<NpyFile*>(h)->data;
}

long long pigs_npy_nbytes(void* h) {
  return static_cast<NpyFile*>(h)->nbytes;
}

void pigs_npy_close(void* h) {
  auto* f = static_cast<NpyFile*>(h);
  if (f->map) munmap(f->map, f->map_size);
  if (f->fd >= 0) close(f->fd);
  delete f;
}

void* pigs_prefetch_create(void* npy, long long rows_per_batch, int depth,
                           int num_threads, unsigned long long seed) {
  auto* f = static_cast<NpyFile*>(npy);
  if (f->shape.empty()) return nullptr;
  auto* p = new Prefetcher();
  p->file = f;
  p->rows_per_batch = rows_per_batch;
  p->n_rows = f->shape[0];
  p->row_bytes = f->nbytes / f->shape[0];
  p->depth = depth;
  p->rng.seed(seed);
  p->buffers.resize(depth);
  p->indices.resize(depth);
  for (int i = 0; i < depth; ++i) {
    p->buffers[i].resize(static_cast<size_t>(rows_per_batch * p->row_bytes));
    p->indices[i].resize(static_cast<size_t>(rows_per_batch));
    p->free_slots.push(i);
  }
  for (int i = 0; i < num_threads; ++i) {
    p->workers.emplace_back([p] { p->worker(); });
  }
  return p;
}

const void* pigs_prefetch_next(void* ph, long long* out_indices,
                               int* out_slot) {
  auto* p = static_cast<Prefetcher*>(ph);
  int slot;
  {
    std::unique_lock<std::mutex> lk(p->mu);
    // Teardown guard: destroy() waits until no consumer is inside this
    // function before deleting the Prefetcher (the mutex/condvar a blocked
    // consumer sits on must not be freed under it).
    ++p->consumers;
    // Wake on stop too — a destroyed/stopping prefetcher must not deadlock a
    // consumer blocked here.
    p->cv_ready.wait(lk, [&] { return p->stop.load() || !p->ready.empty(); });
    if (p->ready.empty()) {
      *out_slot = -1;
      --p->consumers;
      p->cv_done.notify_all();
      return nullptr;
    }
    slot = p->ready.front();
    p->ready.pop();
  }
  std::memcpy(out_indices, p->indices[slot].data(),
              sizeof(long long) * p->rows_per_batch);
  *out_slot = slot;
  const void* data = p->buffers[slot].data();
  {
    std::lock_guard<std::mutex> lk(p->mu);
    --p->consumers;
    // The slot stays pinned until pigs_prefetch_release — the caller reads
    // the returned buffer after this function returns.
    ++p->out_slots;
  }
  p->cv_done.notify_all();
  return data;
}

// Return a slot obtained from pigs_prefetch_next once its buffer has been
// consumed; workers may then refill it.
void pigs_prefetch_release(void* ph, int slot) {
  auto* p = static_cast<Prefetcher*>(ph);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->free_slots.push(slot);
    if (p->out_slots > 0) --p->out_slots;
  }
  p->cv_free.notify_one();
  p->cv_done.notify_all();
}

void pigs_prefetch_destroy(void* ph) {
  auto* p = static_cast<Prefetcher*>(ph);
  p->stop.store(true);
  p->cv_free.notify_all();
  p->cv_ready.notify_all();
  for (auto& t : p->workers) t.join();
  {
    // Don't free the mutex/condvars while a woken consumer is still inside
    // pigs_prefetch_next, nor the ring buffers while a returned slot is
    // still being read (next()'s caller memcpys after it returns; every
    // next() must be paired with release() before destroy()).
    std::unique_lock<std::mutex> lk(p->mu);
    p->cv_done.wait(lk, [&] { return p->consumers == 0 && p->out_slots == 0; });
  }
  delete p;
}

}  // extern "C"
