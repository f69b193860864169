// Threaded batched gather for the replay hot path, C ABI for ctypes.
//
// The learner must never stall on host-side batch assembly (SURVEY.md 'hard
// parts': replay throughput). Assembling a [B, chunk, ...] batch from B
// trajectory windows is B*K memcpys; doing them from Python serializes on
// the interpreter. This kernel performs all copies with a small thread
// pool; the Python side passes (src pointer, dst offset, nbytes) triples.
//
// Build: g++ -O2 -shared -fPIC -pthread -o libfastcopy.so fastcopy.cpp

#include <cstdint>
#include <cstring>

#include <atomic>
#include <thread>
#include <vector>

extern "C" {

// srcs[i] points at the first byte of window i; dst_offsets[i] is the byte
// offset into dst; nbytes[i] is the window's byte length.
void fast_gather(const char** srcs, const int64_t* dst_offsets,
                 const int64_t* nbytes, int64_t count, char* dst,
                 int n_threads) {
  if (n_threads <= 1 || count < 4) {
    for (int64_t i = 0; i < count; ++i) {
      std::memcpy(dst + dst_offsets[i], srcs[i],
                  static_cast<size_t>(nbytes[i]));
    }
    return;
  }
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    while (true) {
      const int64_t i = next.fetch_add(1);
      if (i >= count) return;
      std::memcpy(dst + dst_offsets[i], srcs[i],
                  static_cast<size_t>(nbytes[i]));
    }
  };
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

}  // extern "C"
