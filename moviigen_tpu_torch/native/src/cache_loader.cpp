// Native async file reader pool for tensor-cache loading.
//
// Role: the host-side data plane of the training/preprocessing pipelines —
// the niche filled in the reference stack by torch's C++ DataLoader workers
// and decord's decode threads (SURVEY §2.4). Python's file reads hold the
// GIL and serialize against the trainer's kernel launches; this pool
// performs reads on native threads into caller-provided (numpy) buffers,
// so batch assembly overlaps device compute with zero Python-side copies.
//
// C ABI (ctypes-friendly):
//   clp_create(num_threads)             -> pool handle
//   clp_submit(pool, path, dst, off, n) -> ticket (>=0) or -1
//   clp_wait(pool, ticket)              -> bytes read, or <0 on error
//   clp_destroy(pool)
//
// Build (native/loader.py, at first use, into moviigen_tpu_torch/_build/):
//   g++ -O2 -shared -fPIC -pthread -o cache_loader-<hash>.so cache_loader.cpp

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Task {
  int64_t ticket;
  std::string path;
  void* dst;
  uint64_t offset;
  uint64_t size;
};

struct Result {
  int64_t bytes;  // >=0 read bytes; <0 errno-style error
};

class Pool {
 public:
  explicit Pool(int num_threads) : next_ticket_(0), stop_(false) {
    if (num_threads < 1) num_threads = 1;
    for (int i = 0; i < num_threads; ++i) {
      threads_.emplace_back([this] { Work(); });
    }
  }

  ~Pool() {
    {
      std::lock_guard<std::mutex> g(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : threads_) t.join();
  }

  int64_t Submit(const char* path, void* dst, uint64_t offset,
                 uint64_t size) {
    std::lock_guard<std::mutex> g(mu_);
    int64_t ticket = next_ticket_++;
    queue_.push_back(Task{ticket, path, dst, offset, size});
    cv_.notify_one();
    return ticket;
  }

  int64_t Wait(int64_t ticket) {
    std::unique_lock<std::mutex> g(mu_);
    done_cv_.wait(g, [this, ticket] {
      return results_.count(ticket) > 0;
    });
    int64_t bytes = results_[ticket].bytes;
    results_.erase(ticket);
    return bytes;
  }

 private:
  void Work() {
    for (;;) {
      Task task;
      {
        std::unique_lock<std::mutex> g(mu_);
        cv_.wait(g, [this] { return stop_ || !queue_.empty(); });
        if (stop_ && queue_.empty()) return;
        task = std::move(queue_.front());
        queue_.pop_front();
      }
      int64_t bytes = Read(task);
      {
        std::lock_guard<std::mutex> g(mu_);
        results_[task.ticket] = Result{bytes};
      }
      done_cv_.notify_all();
    }
  }

  static int64_t Read(const Task& t) {
    FILE* f = std::fopen(t.path.c_str(), "rb");
    if (!f) return -1;
    if (t.offset && std::fseek(f, static_cast<long>(t.offset), SEEK_SET)) {
      std::fclose(f);
      return -2;
    }
    size_t n = std::fread(t.dst, 1, t.size, f);
    std::fclose(f);
    return static_cast<int64_t>(n);
  }

  std::mutex mu_;
  std::condition_variable cv_;
  std::condition_variable done_cv_;
  std::deque<Task> queue_;
  std::unordered_map<int64_t, Result> results_;
  std::vector<std::thread> threads_;
  int64_t next_ticket_;
  bool stop_;
};

}  // namespace

extern "C" {

void* clp_create(int num_threads) { return new Pool(num_threads); }

int64_t clp_submit(void* pool, const char* path, void* dst,
                   uint64_t offset, uint64_t size) {
  if (!pool || !path || !dst) return -1;
  return static_cast<Pool*>(pool)->Submit(path, dst, offset, size);
}

int64_t clp_wait(void* pool, int64_t ticket) {
  if (!pool) return -1;
  return static_cast<Pool*>(pool)->Wait(ticket);
}

void clp_destroy(void* pool) { delete static_cast<Pool*>(pool); }

}  // extern "C"
