// fuzz — the report's host-route similarity scores in compiled code.
//
// The arithmetic of report/fuzz.py, exactly, so that every score is the
// double the Python computes, bit for bit:
//
// - LCS: Hyyro's bit-parallel update over one 64-bit word, with a match
//   mask a byte value of the first string (so strings of at most 64
//   bytes), iterated over the bytes of the second;
// - ratio: 100.0 * (2.0 * lcs) / total, in that order, and 100.0 when
//   both strings are empty;
// - partial_ratio: the plain ratio on equal lengths; 100.0 or 0.0 for an
//   empty shorter string; otherwise the ratio of the shorter against every
//   clipped window longer[max(0, s) : max(0, s + ls)] for s in
//   [-(ls - 1), ll), empty windows skipped, the best updated on strictly
//   greater and the scan stopped at >= 100.0.
//
// Only products and a quotient of exact integers: nothing for the
// compiler to contract or reassociate (and the build passes no
// -ffast-math). Each string's masks are built once a call.
//
// Strings come as a padded uint8 matrix (one row a string, `stride`
// bytes apart) and int32 lengths.
//
// C ABI (ctypes): mcaat_fuzz_ratio_all_pairs, mcaat_fuzz_substring_keep,
// mcaat_fuzz_pair_scores.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Masks {
  uint64_t m[256];
};

void build_masks(const uint8_t* s, int n, Masks* out) {
  memset(out->m, 0, sizeof(out->m));
  for (int i = 0; i < n; ++i) out->m[s[i]] |= uint64_t{1} << i;
}

// LCS of a string of length m (its masks ma) and b[0:n].
int lcs(const Masks& ma, int m, const uint8_t* b, int n) {
  if (m == 0 || n == 0) return 0;
  const uint64_t full = m == 64 ? ~uint64_t{0} : (uint64_t{1} << m) - 1;
  uint64_t s = full;
  for (int j = 0; j < n; ++j) {
    const uint64_t u = s & ma.m[b[j]];
    s = ((s + u) | (s - u)) & full;
  }
  return m - __builtin_popcountll(s);
}

double ratio_of(int common, int total) {
  if (total == 0) return 100.0;
  return 100.0 * (2.0 * static_cast<double>(common)) / static_cast<double>(total);
}

struct Str {
  const uint8_t* s;
  int n;
  const Masks* masks;
};

double partial_ratio(const Str& a, const Str& b) {
  const Str& sh = a.n <= b.n ? a : b;
  const Str& lg = a.n <= b.n ? b : a;
  const int ls = sh.n, ll = lg.n;
  if (ls == 0) return ll == 0 ? 100.0 : 0.0;
  if (ls == ll) return ratio_of(lcs(*sh.masks, ls, lg.s, ll), ls + ll);
  double best = 0.0;
  for (int start = -(ls - 1); start < ll; ++start) {
    const int lo = start > 0 ? start : 0;
    int hi = start + ls > 0 ? start + ls : 0;
    if (hi > ll) hi = ll;
    if (hi <= lo) continue;
    const double score = ratio_of(lcs(*sh.masks, ls, lg.s + lo, hi - lo), ls + (hi - lo));
    if (score > best) {
      best = score;
      if (best >= 100.0) break;
    }
  }
  return best;
}

std::vector<Masks> all_masks(const uint8_t* strs, int64_t stride, const int32_t* lens,
                             int64_t n) {
  std::vector<Masks> masks(n);
  for (int64_t i = 0; i < n; ++i) build_masks(strs + i * stride, lens[i], &masks[i]);
  return masks;
}

}  // namespace

extern "C" {

// ratio(s_i, s_j) for every pair i < j in row order (i, then j):
// n (n - 1) / 2 doubles into out.
void mcaat_fuzz_ratio_all_pairs(const uint8_t* strs, int64_t stride, const int32_t* lens,
                                int32_t n, double* out) {
  const std::vector<Masks> masks = all_masks(strs, stride, lens, n);
  int64_t k = 0;
  for (int i = 0; i < n; ++i)
    for (int j = i + 1; j < n; ++j)
      out[k++] = ratio_of(lcs(masks[i], lens[i], strs + j * stride, lens[j]), lens[i] + lens[j]);
}

// The substring filter's greedy scan over strings already in its order:
// string i is kept unless partial_ratio(s_i, s_k) >= 90.0 for some kept
// k, the kept tried in the order they were kept and the first such one
// ending the try. The kept indices go into kept (ascending), the number
// of partial_ratio calls into *pairs; returns the number kept.
int32_t mcaat_fuzz_substring_keep(const uint8_t* strs, int64_t stride, const int32_t* lens,
                                  int32_t n, int32_t* kept, int64_t* pairs) {
  const std::vector<Masks> masks = all_masks(strs, stride, lens, n);
  int32_t n_kept = 0;
  int64_t calls = 0;
  for (int i = 0; i < n; ++i) {
    const Str a{strs + i * stride, lens[i], &masks[i]};
    bool drop = false;
    for (int k = 0; k < n_kept && !drop; ++k) {
      const int j = kept[k];
      ++calls;
      drop = partial_ratio(a, Str{strs + j * stride, lens[j], &masks[j]}) >= 90.0;
    }
    if (!drop) kept[n_kept++] = i;
  }
  *pairs = calls;
  return n_kept;
}

// One score a pair (a_i, b_i): partial_ratio when `partial` is nonzero,
// else ratio.
void mcaat_fuzz_pair_scores(const uint8_t* a, const int32_t* la, const uint8_t* b,
                            const int32_t* lb, int64_t stride, int64_t n, int32_t partial,
                            double* out) {
  Masks ma, mb;
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* sa = a + i * stride;
    const uint8_t* sb = b + i * stride;
    build_masks(sa, la[i], &ma);
    if (partial) {
      build_masks(sb, lb[i], &mb);
      out[i] = partial_ratio(Str{sa, la[i], &ma}, Str{sb, lb[i], &mb});
    } else {
      out[i] = ratio_of(lcs(ma, la[i], sb, lb[i]), la[i] + lb[i]);
    }
  }
}

}  // extern "C"
