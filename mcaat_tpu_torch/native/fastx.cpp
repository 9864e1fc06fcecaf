// fastx — the port's parser of FASTQ, plain or gzipped.
//
// A plain file is mapped, never streamed through zlib, and cut into one
// byte range a thread. A first pass counts each range's newlines; their
// prefix sum gives every range the global index of its first line, so line
// index mod 4 marks the records exactly (the 4-line rule of the shared
// parser, native/mcaat_host.cpp: a record is the sequence line at index
// 4r + 1; nothing is guessed from '@' or '+'). A second pass records each
// sequence line's offset and length; the caller then allocates the
// [R, max_len] uint8 matrix and the int32 lengths, and a third pass codes
// every sequence straight into its row (A=0 C=1 G=2 T=3, any other byte 3,
// as the shared parser's lookup) and zeroes the padding.
//
// A gzipped file is inflated whole into one host buffer by zlib's inflate
// (-lz), every member of a concatenated file in turn (as gzread reads
// them); the buffer then takes the same passes as a mapped file. The
// files of one call inflate at once, one thread a file. A file that does
// not inflate exactly (a corrupt or truncated stream, bytes after the last
// member) or whose first inflated byte is not '@' gets no handle: the
// caller parses it with the shared reader, which decides what such input
// gives.
//
// Lines are the shared parser's (LineReader::getline): split at '\n', one
// '\r' dropped before a '\n', the bytes after the last '\n' a line of
// their own when there are any (kept whole, '\r' included).
//
// Threads are std::thread, joined before each call returns: no thread
// team outlives a call (the ordering stage forks its pool later).
//
// C ABI (ctypes): mcaat_fastq_index, mcaat_gzip_index, mcaat_fastq_fill,
// mcaat_fastq_close.

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#include <zlib.h>

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
  bool mapped = false;  // munmap the bytes on close, else free them
  std::vector<int64_t> start;  // a record's sequence line: first byte
  std::vector<int32_t> len;    // and its length, '\r' dropped
  int32_t max_len = 0;
};

void release(Index* ix) {
  if (ix->mapped) {
    munmap((void*)ix->data, ix->size);
  } else {
    free((void*)ix->data);
  }
  delete ix;
}

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

// Index ix's bytes (non-empty) over byte ranges: n_cuts ascending offsets
// from 0 to the size, or n_threads equal ranges when cuts is NULL.
void index_bytes(Index* ix, int n_threads, const int64_t* cuts, int n_cuts) {
  const char* d = ix->data;
  const int64_t S = (int64_t)ix->size;

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
}

// The whole file at `path`, mapped read-only; NULL when it cannot be
// opened or mapped or is empty.
const char* map_file(const char* path, size_t* size) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size <= 0) {
    close(fd);
    return nullptr;
  }
  *size = (size_t)st.st_size;
  void* map = mmap(nullptr, *size, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (map == MAP_FAILED) return nullptr;
  madvise(map, *size, MADV_WILLNEED);
  return (const char*)map;
}

// A growing malloc'd output buffer.
struct Out {
  char* p = nullptr;
  size_t used = 0, cap = 0;
  bool grow(size_t want) {
    if (want <= cap) return true;
    char* q = (char*)realloc(p, want);
    if (q == nullptr) return false;
    p = q;
    cap = want;
    return true;
  }
  char* take(size_t* n) {  // the bytes, or NULL with nothing inflated
    *n = used;
    if (used == 0) {
      free(p);
      return nullptr;
    }
    return p;
  }
};

// The first guess of the inflated size: the last member's ISIZE (the
// length modulo 2^32), at least the compressed size.
size_t first_guess(const uint8_t* in, size_t n) {
  uint32_t isize = 0;
  if (n >= 4) memcpy(&isize, in + n - 4, 4);  // little-endian hosts only
  return std::max<size_t>({(size_t)isize, n, 1 << 16});
}

char* inflate_zlib(const uint8_t* in, size_t n, size_t* out_n) {
  const size_t step = (size_t)1 << 30;  // zlib counts in 32-bit uInt
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, 15 + 16) != Z_OK) return nullptr;
  Out out;
  bool ok = out.grow(first_guess(in, n));
  size_t pos = 0;
  while (ok) {
    if (out.used == out.cap && !out.grow(2 * out.cap)) {
      ok = false;
      break;
    }
    zs.next_in = (Bytef*)(in + pos);
    zs.avail_in = (uInt)std::min(n - pos, step);
    zs.next_out = (Bytef*)(out.p + out.used);
    zs.avail_out = (uInt)std::min(out.cap - out.used, step);
    const uInt avail_in = zs.avail_in, avail_out = zs.avail_out;
    int r = inflate(&zs, Z_NO_FLUSH);
    pos += avail_in - zs.avail_in;
    out.used += avail_out - zs.avail_out;
    if (r == Z_STREAM_END) {
      if (pos == n) break;
      ok = inflateReset(&zs) == Z_OK;  // the next member
    } else if (r != Z_OK) {
      ok = false;  // a corrupt stream, or its input ended inside a member
    }
  }
  inflateEnd(&zs);
  if (!ok) {
    free(out.p);
    return nullptr;
  }
  return out.take(out_n);
}

// Inflate the gzipped file at `path` whole; NULL when it did not inflate
// exactly or gave no bytes.
char* inflate_file(const char* path, size_t* out_n) {
  size_t n = 0;
  const char* map = map_file(path, &n);
  if (map == nullptr) return nullptr;
  madvise((void*)map, n, MADV_SEQUENTIAL);
  char* out = inflate_zlib((const uint8_t*)map, n, out_n);
  munmap((void*)map, n);
  return out;
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
  size_t size = 0;
  const char* map = map_file(path, &size);
  if (map == nullptr) return nullptr;
  auto* ix = new Index();
  ix->data = map;
  ix->size = size;
  ix->mapped = true;
  index_bytes(ix, n_threads, cuts, n_cuts);
  *n_reads_out = (int64_t)ix->start.size();
  *max_len_out = ix->max_len;
  return ix;
}

// Inflate the n_files gzipped files `paths` at once (one thread a file,
// up to n_threads), then index each inflated FASTQ buffer over n_threads
// equal ranges, one file after the other.
// Writes, a file, a handle for mcaat_fastq_fill and mcaat_fastq_close
// (NULL where the file did not inflate exactly or does not start with
// '@'), its record count and longest sequence.
void mcaat_gzip_index(const char* const* paths, int n_files, int n_threads, void** handles,
                      int64_t* n_reads_out, int32_t* max_len_out) {
  std::vector<char*> buf(n_files, nullptr);
  std::vector<size_t> size(n_files, 0);
  std::atomic<int> next(0);
  run_threads(std::max(1, std::min(n_threads, n_files)), [&](int) {
    for (int f = next++; f < n_files; f = next++) {
      buf[f] = inflate_file(paths[f], &size[f]);
    }
  });
  for (int f = 0; f < n_files; ++f) {
    handles[f] = nullptr;
    n_reads_out[f] = 0;
    max_len_out[f] = 0;
    if (buf[f] == nullptr) continue;
    auto* ix = new Index();
    ix->data = buf[f];
    ix->size = size[f];
    if (buf[f][0] != '@') {  // FASTA or other text: the shared reader's
      release(ix);
      continue;
    }
    index_bytes(ix, n_threads, nullptr, 0);
    handles[f] = ix;
    n_reads_out[f] = (int64_t)ix->start.size();
    max_len_out[f] = ix->max_len;
  }
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

void mcaat_fastq_close(void* handle) { release((Index*)handle); }

}  // extern "C"
