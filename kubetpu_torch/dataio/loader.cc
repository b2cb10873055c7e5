// kubetpu_torch native data loader — memory-mapped token-file reader (the
// port's own copy of kubetpu/dataio/loader.cc).
//
// The runtime around the TPU compute path is native where the reference's
// would be (SURVEY.md §2 note on native components; the reference itself
// ships no data loader — its only native code is the NVML probe). This is
// the input-pipeline analog of tpuinfo/gpuinfo: a small C++ component
// behind a stable C ABI, loaded from Python with ctypes (no pybind11 in
// this environment).
//
// Design: the corpus is one flat binary file of little-endian token ids
// (uint16 or uint32). The file is mmap'd — the OS page cache is the
// buffer pool, nothing is read eagerly — and batch assembly is a C-speed
// gather of [offset, offset+seq) windows into a caller-provided int32
// buffer (the int32 token batches), replacing per-sequence Python slicing.
//
// C ABI (every function returns 0/NULL on failure; see errno):
//   ktpu_open(path, dtype_bytes) -> handle      dtype_bytes in {2, 4}
//   ktpu_num_tokens(handle) -> long long
//   ktpu_gather(handle, offsets, n, seq, out)   out: n*seq int32, row-major
//   ktpu_close(handle)
//
// Build: at first use, by kubetpu_torch/jobs/native_data.py (g++ -O2 -Wall
// -Wextra -std=c++17 -shared -fPIC) into build/kubetpu_torch/.

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Handle {
  void* base = nullptr;
  long long file_bytes = 0;
  int dtype_bytes = 0;
};

}  // namespace

extern "C" {

void* ktpu_open(const char* path, int dtype_bytes) {
  if (dtype_bytes != 2 && dtype_bytes != 4) return nullptr;
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size <= 0) {
    close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);  // the mapping keeps the file alive
  if (base == MAP_FAILED) return nullptr;
  Handle* h = new Handle();
  h->base = base;
  h->file_bytes = st.st_size;
  h->dtype_bytes = dtype_bytes;
  return h;
}

long long ktpu_num_tokens(void* handle) {
  if (!handle) return 0;
  Handle* h = static_cast<Handle*>(handle);
  return h->file_bytes / h->dtype_bytes;
}

// Gather n windows of seq tokens each at the given token offsets into
// out (n*seq int32, row-major). Returns the number of rows written; rows
// whose window would run past the end of the file are skipped (callers
// pre-validate offsets, this is the memory-safety backstop).
int ktpu_gather(void* handle, const long long* offsets, int n, int seq,
                int32_t* out) {
  if (!handle || !offsets || !out || n <= 0 || seq <= 0) return 0;
  Handle* h = static_cast<Handle*>(handle);
  long long total = h->file_bytes / h->dtype_bytes;
  int written = 0;
  for (int i = 0; i < n; i++) {
    long long off = offsets[i];
    // no-overflow form: total >= 0 and seq > 0, so `total - seq` cannot
    // overflow, while `off + seq` would be UB for off near LLONG_MAX —
    // a compiler may elide an overflowing check, gutting the backstop
    if (off < 0 || off > total - seq) continue;
    int32_t* row = out + static_cast<long long>(written) * seq;
    if (h->dtype_bytes == 2) {
      const uint16_t* src = static_cast<const uint16_t*>(h->base) + off;
      for (int t = 0; t < seq; t++) row[t] = src[t];
    } else {
      const uint32_t* src = static_cast<const uint32_t*>(h->base) + off;
      for (int t = 0; t < seq; t++) row[t] = static_cast<int32_t>(src[t]);
    }
    written++;
  }
  return written;
}

void ktpu_close(void* handle) {
  if (!handle) return;
  Handle* h = static_cast<Handle*>(handle);
  if (h->base) munmap(h->base, h->file_bytes);
  delete h;
}

}  // extern "C"
