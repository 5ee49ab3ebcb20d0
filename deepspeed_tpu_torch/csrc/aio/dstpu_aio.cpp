// dstpu_aio — asynchronous file IO engine for host/disk tensor swapping.
//
// TPU-native analog of the reference's libaio-based async_io op
// (csrc/aio/common/deepspeed_aio_common.cpp, csrc/aio/py_lib/
// deepspeed_py_aio_handle.cpp): a pool of worker threads services a queue of
// read/write requests against O_DIRECT-capable files, with each large request
// split into block_size chunks spread across the pool so a single tensor swap
// saturates the device queue depth.  Instead of pybind11+torch tensors the
// surface is a flat C ABI over raw host buffers (ctypes-friendly), since the
// JAX side hands us numpy-owned memory.
//
// Semantics mirror the reference handle API:
//   create(block_size, queue_depth, num_threads) -> handle
//   async_pread/async_pwrite -> request id (chunked + enqueued)
//   wait(handle)             -> number of completed requests since last wait
//   sync_pread/sync_pwrite   -> blocking convenience wrappers
//
// Errors: each request records errno; wait() returns -errno of the first
// failed chunk, mirroring the reference's validate_aio_operation behavior.

#include <atomic>
#include <cerrno>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <unistd.h>

namespace {

struct Chunk {
  int fd;
  bool write;
  char* buf;
  size_t nbytes;
  off_t offset;
};

struct Request {
  std::atomic<int> pending{0};
  std::atomic<int> error{0};
  int fd = -1;  // owned; closed on completion of all chunks
};

struct Task {
  Chunk chunk;
  std::shared_ptr<Request> req;
};

class AioEngine {
 public:
  AioEngine(size_t block_size, int queue_depth, int num_threads)
      : block_size_(block_size ? block_size : (1u << 20)),
        queue_depth_(queue_depth > 0 ? queue_depth : 32) {
    if (num_threads <= 0) num_threads = 1;
    for (int i = 0; i < num_threads; ++i)
      workers_.emplace_back([this] { Worker(); });
  }

  ~AioEngine() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      shutdown_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
  }

  int64_t Submit(const char* path, char* buf, size_t nbytes, off_t file_offset,
                 bool write) {
    int flags = write ? (O_WRONLY | O_CREAT) : O_RDONLY;
    int fd = open(path, flags, 0644);
    if (fd < 0) return -errno;
    auto req = std::make_shared<Request>();
    req->fd = fd;
    size_t nchunks = (nbytes + block_size_ - 1) / block_size_;
    if (nchunks == 0) nchunks = 1;
    req->pending.store(static_cast<int>(nchunks));
    int64_t id;
    {
      std::lock_guard<std::mutex> lk(mu_);
      id = next_id_++;
      inflight_[id] = req;
      for (size_t c = 0; c < nchunks; ++c) {
        size_t off = c * block_size_;
        size_t len = nbytes > off ? std::min(block_size_, nbytes - off) : 0;
        queue_.push_back(Task{
            Chunk{fd, write, buf + off, len,
                  static_cast<off_t>(file_offset + static_cast<off_t>(off))},
            req});
      }
    }
    cv_.notify_all();
    return id;
  }

  // Block until every inflight request completes; return count of completed
  // requests, or -errno of the first failure.
  int WaitAll() {
    std::unique_lock<std::mutex> lk(mu_);
    done_cv_.wait(lk, [this] {
      for (auto& kv : inflight_)
        if (kv.second->pending.load() != 0) return false;
      return true;
    });
    int completed = 0, err = 0;
    for (auto& kv : inflight_) {
      ++completed;
      if (!err) err = kv.second->error.load();
    }
    inflight_.clear();
    return err ? -err : completed;
  }

  // Wait for one request id (sync helpers); returns 0 or -errno.
  int Wait(int64_t id) {
    std::shared_ptr<Request> req;
    {
      std::lock_guard<std::mutex> lk(mu_);
      auto it = inflight_.find(id);
      if (it == inflight_.end()) return 0;
      req = it->second;
    }
    std::unique_lock<std::mutex> lk(mu_);
    done_cv_.wait(lk, [&req] { return req->pending.load() == 0; });
    inflight_.erase(id);
    int err = req->error.load();
    return err ? -err : 0;
  }

  size_t block_size() const { return block_size_; }
  int queue_depth() const { return queue_depth_; }
  int num_threads() const { return static_cast<int>(workers_.size()); }

 private:
  void Worker() {
    for (;;) {
      Task task;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return shutdown_ || !queue_.empty(); });
        if (shutdown_ && queue_.empty()) return;
        task = queue_.front();
        queue_.pop_front();
      }
      RunChunk(task);
    }
  }

  void RunChunk(Task& task) {
    Chunk& c = task.chunk;
    size_t done = 0;
    int err = 0;
    while (done < c.nbytes) {
      ssize_t n = c.write ? pwrite(c.fd, c.buf + done, c.nbytes - done,
                                   c.offset + static_cast<off_t>(done))
                          : pread(c.fd, c.buf + done, c.nbytes - done,
                                  c.offset + static_cast<off_t>(done));
      if (n < 0) {
        if (errno == EINTR) continue;
        err = errno;
        break;
      }
      if (n == 0) {  // short file on read
        err = EIO;
        break;
      }
      done += static_cast<size_t>(n);
    }
    if (err) {
      int expected = 0;
      task.req->error.compare_exchange_strong(expected, err);
    }
    if (task.req->pending.fetch_sub(1) == 1) {
      close(task.req->fd);
      std::lock_guard<std::mutex> lk(mu_);
      done_cv_.notify_all();
    }
  }

  const size_t block_size_;
  const int queue_depth_;
  std::vector<std::thread> workers_;
  std::mutex mu_;
  std::condition_variable cv_;
  std::condition_variable done_cv_;
  std::deque<Task> queue_;
  std::unordered_map<int64_t, std::shared_ptr<Request>> inflight_;
  int64_t next_id_ = 1;
  bool shutdown_ = false;
};

}  // namespace

extern "C" {

void* dstpu_aio_create(uint64_t block_size, int queue_depth, int num_threads) {
  return new AioEngine(block_size, queue_depth, num_threads);
}

void dstpu_aio_destroy(void* h) { delete static_cast<AioEngine*>(h); }

int64_t dstpu_aio_pread(void* h, const char* path, void* buf, uint64_t nbytes,
                        uint64_t offset) {
  return static_cast<AioEngine*>(h)->Submit(path, static_cast<char*>(buf),
                                            nbytes, (off_t)offset, false);
}

int64_t dstpu_aio_pwrite(void* h, const char* path, void* buf, uint64_t nbytes,
                         uint64_t offset) {
  return static_cast<AioEngine*>(h)->Submit(path, static_cast<char*>(buf),
                                            nbytes, (off_t)offset, true);
}

int dstpu_aio_wait(void* h, int64_t req_id) {
  return static_cast<AioEngine*>(h)->Wait(req_id);
}

int dstpu_aio_wait_all(void* h) { return static_cast<AioEngine*>(h)->WaitAll(); }

int dstpu_aio_sync_pread(void* h, const char* path, void* buf, uint64_t nbytes,
                         uint64_t offset) {
  AioEngine* e = static_cast<AioEngine*>(h);
  int64_t id = e->Submit(path, static_cast<char*>(buf), nbytes, (off_t)offset,
                         false);
  if (id < 0) return static_cast<int>(id);
  return e->Wait(id);
}

int dstpu_aio_sync_pwrite(void* h, const char* path, void* buf, uint64_t nbytes,
                          uint64_t offset) {
  AioEngine* e = static_cast<AioEngine*>(h);
  int64_t id = e->Submit(path, static_cast<char*>(buf), nbytes, (off_t)offset,
                         true);
  if (id < 0) return static_cast<int>(id);
  return e->Wait(id);
}

uint64_t dstpu_aio_block_size(void* h) {
  return static_cast<AioEngine*>(h)->block_size();
}
int dstpu_aio_queue_depth(void* h) {
  return static_cast<AioEngine*>(h)->queue_depth();
}
int dstpu_aio_thread_count(void* h) {
  return static_cast<AioEngine*>(h)->num_threads();
}

}  // extern "C"
