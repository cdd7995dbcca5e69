// Native minibatch data loader for the SVGP input pipeline of
// edrgp_tpu_torch.
//
// The same code and C ABI as the JAX package's native/dataloader.cpp: a
// memory-mapped dataset, a producer thread that gathers rows into a ring of
// reusable batch buffers (Fisher-Yates-shuffled epochs or with-replacement
// sampling from SplitMix64), and a blocking consumer API surfaced to Python
// via ctypes (edrgp_tpu_torch/data.py).  Both packages draw the same rows
// for the same seed.
//
// File format (written by edrgp_tpu_torch.data.write_dataset):
//   magic "EDRG" | uint32 version | int64 n_rows | int64 row_floats |
//   float32 data [n_rows * row_floats]  (row = X features then y)
//
// Build: edrgp_tpu_torch.data.build_native() compiles this file at first
// use with g++ -O3 -std=c++17 -fPIC -shared -pthread into
// build/edrgp_tpu_torch/libedrgp_data-<hash>.so.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <queue>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Header {
  char magic[4];
  uint32_t version;
  int64_t n_rows;
  int64_t row_floats;
};

// SplitMix64 — tiny, seedable, statistically solid for shuffling.
struct Rng {
  uint64_t state;
  explicit Rng(uint64_t seed) : state(seed) {}
  uint64_t next() {
    uint64_t z = (state += 0x9e3779b97f4a7c15ULL);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
  }
  // unbiased bounded draw (Lemire)
  uint64_t bounded(uint64_t n) {
    __uint128_t m = (__uint128_t)next() * n;
    uint64_t l = (uint64_t)m;
    if (l < n) {
      uint64_t t = (0 - n) % n;
      while (l < t) {
        m = (__uint128_t)next() * n;
        l = (uint64_t)m;
      }
    }
    return (uint64_t)(m >> 64);
  }
};

struct Stream;

struct Dataset {
  int fd = -1;
  const float* data = nullptr;   // mapped payload (past header)
  size_t map_len = 0;
  void* map_base = nullptr;
  int64_t n_rows = 0;
  int64_t row_floats = 0;
  Stream* stream = nullptr;
};

struct Stream {
  Dataset* ds;
  int64_t batch;
  bool with_replacement;
  Rng rng;
  std::vector<int64_t> perm;     // epoch permutation (without-replacement)
  int64_t cursor = 0;

  // ring of filled buffers
  std::vector<std::vector<float>> buffers;
  std::queue<int> filled;        // buffer indices ready for the consumer
  std::queue<int> empty;         // buffer indices ready for the producer
  std::mutex mu;
  std::condition_variable cv_filled, cv_empty;
  std::atomic<bool> stop{false};
  std::thread worker;

  Stream(Dataset* d, int64_t b, bool wr, uint64_t seed, int n_buffers)
      : ds(d), batch(b), with_replacement(wr), rng(seed) {
    buffers.resize(n_buffers);
    for (int i = 0; i < n_buffers; ++i) {
      buffers[i].resize(batch * ds->row_floats);
      empty.push(i);
    }
    if (!with_replacement) {
      perm.resize(ds->n_rows);
      for (int64_t i = 0; i < ds->n_rows; ++i) perm[i] = i;
      reshuffle();
    }
    worker = std::thread([this] { produce(); });
  }

  void reshuffle() {
    for (int64_t i = ds->n_rows - 1; i > 0; --i) {
      int64_t j = (int64_t)rng.bounded(i + 1);
      std::swap(perm[i], perm[j]);
    }
    cursor = 0;
  }

  void fill(std::vector<float>& buf) {
    const int64_t rf = ds->row_floats;
    for (int64_t k = 0; k < batch; ++k) {
      int64_t row;
      if (with_replacement) {
        row = (int64_t)rng.bounded(ds->n_rows);
      } else {
        if (cursor >= ds->n_rows) reshuffle();
        row = perm[cursor++];
      }
      std::memcpy(buf.data() + k * rf, ds->data + row * rf,
                  rf * sizeof(float));
    }
  }

  void produce() {
    while (true) {
      int idx;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_empty.wait(lk, [this] { return stop.load() || !empty.empty(); });
        if (stop.load()) return;
        idx = empty.front();
        empty.pop();
      }
      fill(buffers[idx]);
      {
        std::lock_guard<std::mutex> lk(mu);
        filled.push(idx);
      }
      cv_filled.notify_one();
    }
  }

  // blocking: copy the next ready batch into out
  void next(float* out) {
    int idx;
    {
      std::unique_lock<std::mutex> lk(mu);
      cv_filled.wait(lk, [this] { return !filled.empty(); });
      idx = filled.front();
      filled.pop();
    }
    std::memcpy(out, buffers[idx].data(),
                buffers[idx].size() * sizeof(float));
    {
      std::lock_guard<std::mutex> lk(mu);
      empty.push(idx);
    }
    cv_empty.notify_one();
  }

  ~Stream() {
    stop.store(true);
    cv_empty.notify_all();
    if (worker.joinable()) worker.join();
  }
};

}  // namespace

extern "C" {

// Returns an opaque handle (heap pointer) or nullptr on failure.
void* edr_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || (size_t)st.st_size < sizeof(Header)) {
    ::close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (base == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  const Header* h = reinterpret_cast<const Header*>(base);
  if (std::memcmp(h->magic, "EDRG", 4) != 0 || h->version != 1) {
    munmap(base, st.st_size);
    ::close(fd);
    return nullptr;
  }
  size_t need = sizeof(Header) +
                (size_t)h->n_rows * h->row_floats * sizeof(float);
  if ((size_t)st.st_size < need) {
    munmap(base, st.st_size);
    ::close(fd);
    return nullptr;
  }
  madvise(base, st.st_size, MADV_RANDOM);
  auto* ds = new Dataset;
  ds->fd = fd;
  ds->map_base = base;
  ds->map_len = st.st_size;
  ds->n_rows = h->n_rows;
  ds->row_floats = h->row_floats;
  ds->data = reinterpret_cast<const float*>(
      static_cast<const char*>(base) + sizeof(Header));
  return ds;
}

int64_t edr_n_rows(void* handle) {
  return static_cast<Dataset*>(handle)->n_rows;
}

int64_t edr_row_floats(void* handle) {
  return static_cast<Dataset*>(handle)->row_floats;
}

// with_replacement != 0 → i.i.d. sampling (SVI default);
// == 0 → shuffled epochs.
int edr_start_stream(void* handle, int64_t batch, int with_replacement,
                     uint64_t seed, int n_buffers) {
  auto* ds = static_cast<Dataset*>(handle);
  if (ds->stream) return -1;
  if (batch <= 0 || n_buffers <= 0) return -2;
  ds->stream = new Stream(ds, batch, with_replacement != 0, seed, n_buffers);
  return 0;
}

// Blocks until a batch is ready; out must hold batch*row_floats floats.
int edr_next_batch(void* handle, float* out) {
  auto* ds = static_cast<Dataset*>(handle);
  if (!ds->stream) return -1;
  ds->stream->next(out);
  return 0;
}

void edr_close(void* handle) {
  auto* ds = static_cast<Dataset*>(handle);
  delete ds->stream;
  if (ds->map_base) munmap(ds->map_base, ds->map_len);
  if (ds->fd >= 0) ::close(ds->fd);
  delete ds;
}

}  // extern "C"
