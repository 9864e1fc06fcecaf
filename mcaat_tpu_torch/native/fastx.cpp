// fastx — the port's parser of plain (uncompressed) FASTQ.
//
// The file is mapped, never streamed through zlib, and cut into one byte
// range a thread. A first pass counts each range's newlines; their prefix
// sum gives every range the global index of its first line, so line
// index mod 4 marks the records exactly (the 4-line rule of the shared
// parser, native/mcaat_host.cpp: a record is the sequence line at index
// 4r + 1; nothing is guessed from '@' or '+'). A second pass records each
// sequence line's offset and length; the caller then allocates the
// [R, max_len] uint8 matrix and the int32 lengths, and a third pass codes
// every sequence straight into its row (A=0 C=1 G=2 T=3, any other byte 3,
// as the shared parser's lookup) and zeroes the padding.
//
// Lines are the shared parser's (LineReader::getline): split at '\n', one
// '\r' dropped before a '\n', the bytes after the last '\n' a line of
// their own when there are any (kept whole, '\r' included).
//
// Threads are std::thread, joined before each call returns: no thread
// team outlives a call (the ordering stage forks its pool later).
//
// C ABI (ctypes): mcaat_fastq_index, mcaat_fastq_fill, mcaat_fastq_close.

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Lut {
  uint8_t code[256];
  Lut() {
    memset(code, 3, sizeof(code));
    code[(int)'A'] = 0; code[(int)'a'] = 0;
    code[(int)'C'] = 1; code[(int)'c'] = 1;
    code[(int)'G'] = 2; code[(int)'g'] = 2;
  }
};
const Lut g_lut;

struct Index {
  const char* data = nullptr;
  size_t size = 0;
  std::vector<int64_t> start;  // a record's sequence line: first byte
  std::vector<int32_t> len;    // and its length, '\r' dropped
  int32_t max_len = 0;
};

// Run fn(t) for t in [0, n) on n threads (the caller's is thread 0).
template <class F>
void run_threads(int n, F fn) {
  std::vector<std::thread> pool;
  pool.reserve(n > 1 ? n - 1 : 0);
  for (int t = 1; t < n; ++t) pool.emplace_back(fn, t);
  fn(0);
  for (auto& th : pool) th.join();
}

int64_t count_newlines(const char* p, int64_t n) {
  int64_t c = 0;
  for (int64_t i = 0; i < n; ++i) c += p[i] == '\n';
  return c;
}

}  // namespace

extern "C" {

// Index the plain FASTQ file at `path` over byte ranges: `cuts` holds
// n_cuts ascending offsets from 0 to the file's size (n_cuts - 1 ranges,
// a thread each), or is NULL for `n_threads` equal ranges. Writes the
// record count and the longest sequence; returns a handle for
// mcaat_fastq_fill and mcaat_fastq_close, or NULL when the file cannot be
// mapped or is empty.
void* mcaat_fastq_index(const char* path, int n_threads, const int64_t* cuts,
                        int n_cuts, int64_t* n_reads_out,
                        int32_t* max_len_out) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size <= 0) {
    close(fd);
    return nullptr;
  }
  size_t size = (size_t)st.st_size;
  void* map = mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (map == MAP_FAILED) return nullptr;
  madvise(map, size, MADV_WILLNEED);
  auto* ix = new Index();
  ix->data = (const char*)map;
  ix->size = size;
  const char* d = ix->data;
  const int64_t S = (int64_t)size;

  std::vector<int64_t> cut;
  if (cuts != nullptr && n_cuts >= 2) {
    cut.assign(cuts, cuts + n_cuts);
  } else {
    int n = std::max(1, n_threads);
    for (int t = 0; t <= n; ++t) cut.push_back(S * t / n);
  }
  const int T = (int)cut.size() - 1;

  // pass 1: newlines a range, then the index of the first line a range
  std::vector<int64_t> nl(T + 1, 0);
  run_threads(T, [&](int t) { nl[t + 1] = count_newlines(d + cut[t], cut[t + 1] - cut[t]); });
  for (int t = 0; t < T; ++t) nl[t + 1] += nl[t];
  const int64_t n_lines = nl[T] + (d[S - 1] != '\n' ? 1 : 0);
  const int64_t R = (n_lines + 2) / 4;  // lines 1, 5, 9, ... below n_lines
  ix->start.resize(R);
  ix->len.resize(R);

  // pass 2: the sequence lines that start in each range
  std::vector<int32_t> tmax(T, 0);
  run_threads(T, [&](int t) {
    int64_t x = cut[t], end = cut[t + 1];
    int64_t line = nl[t];  // newlines before x
    if (x > 0 && d[x - 1] != '\n') {  // x is inside a line: skip to the next
      const void* p = memchr(d + x, '\n', (size_t)(end - x));
      if (p == nullptr) return;
      x = (const char*)p - d + 1;
      ++line;
    }
    int32_t m = 0;
    while (x < end) {
      const char* p = (const char*)memchr(d + x, '\n', (size_t)(S - x));
      int64_t stop = p ? p - d : S;
      if ((line & 3) == 1) {
        int64_t n = stop - x;
        if (p && n > 0 && d[stop - 1] == '\r') --n;
        ix->start[line >> 2] = x;
        ix->len[line >> 2] = (int32_t)n;
        m = std::max(m, (int32_t)n);
      }
      if (p == nullptr) break;
      x = stop + 1;
      ++line;
    }
    tmax[t] = m;
  });
  for (int32_t m : tmax) ix->max_len = std::max(ix->max_len, m);
  *n_reads_out = R;
  *max_len_out = ix->max_len;
  return ix;
}

// Code every record into `codes` ([n_reads, max_len] uint8, row-major;
// the padding zeroed) and `lengths` ([n_reads] int32), records dealt in
// contiguous blocks over `n_threads` threads.
void mcaat_fastq_fill(void* handle, uint8_t* codes, int32_t* lengths,
                      int n_threads) {
  auto* ix = (Index*)handle;
  const int64_t R = (int64_t)ix->start.size();
  const int64_t m = ix->max_len;
  if (R == 0) return;
  const int T = (int)std::max<int64_t>(1, std::min<int64_t>(n_threads, R));
  const uint8_t* lut = g_lut.code;
  run_threads(T, [&](int t) {
    for (int64_t r = R * t / T, hi = R * (t + 1) / T; r < hi; ++r) {
      const uint8_t* src = (const uint8_t*)ix->data + ix->start[r];
      uint8_t* dst = codes + r * m;
      const int32_t n = ix->len[r];
      for (int32_t i = 0; i < n; ++i) dst[i] = lut[src[i]];
      if (n < m) memset(dst + n, 0, (size_t)(m - n));
      lengths[r] = n;
    }
  });
}

void mcaat_fastq_close(void* handle) {
  auto* ix = (Index*)handle;
  munmap((void*)ix->data, ix->size);
  delete ix;
}

}  // extern "C"
