// split — the spacer-ordering stage's SCC split in compiled code.
//
// One call over the graph's [N, 4] out table (int32, -1 for an empty
// slot) and its validity mask does what ordering/ordering.py's Python
// route does in three steps (the valid CSR, the Tarjan walk, the
// per-component loop):
//
// - an iterative Tarjan over the valid nodes, roots in ascending id, each
//   node's neighbours in slot order, a neighbour taken only when it is
//   valid, so that components come out in the order the Python walk emits
//   them and each one's nodes in its stack-pop order;
// - for each component of more than one node, its internal edges: each
//   node's out-slots, in slot order, whose target lies in the component
//   (repeated targets and self loops kept, as the Python route keeps them);
// - a component with no internal edge is dropped, and the subgraphs are
//   numbered in emission order among those kept.
//
// Outputs, into buffers the caller sizes for the worst case:
// label[v]       the index of v's subgraph, -1 when v is in none;
// order          the subgraphs' nodes, one after another, each in pop order;
// node_off[i]    where subgraph i starts in order (i in [0, count]);
// deg[p]         the internal edges of node order[p];
// targets        those edges' targets, node by node in order, slot order;
// edge_off[i]    where subgraph i starts in targets (i in [0, count]).
//
// C ABI (ctypes): mcaat_split.

#include <climits>
#include <cstdint>
#include <utility>
#include <vector>

extern "C" {

// Returns the number of subgraphs, or -1 when a slot names a node outside
// [0, n) (the caller then keeps the Python route, which raises).
int64_t mcaat_split(const int32_t* out, const uint8_t* valid, int64_t n, int32_t* label,
                    int32_t* order, int64_t* node_off, uint8_t* deg, int32_t* targets,
                    int64_t* edge_off) {
  for (int64_t i = 0; i < 4 * n; ++i)
    if (out[i] >= n) return -1;
  // One 8-byte record a node, so that a neighbour costs one cache line:
  // its DFS index (kInvalid for an invalid node, -1 before its visit,
  // kDone once its component is popped, which no lowlink then takes) and
  // its lowlink.
  constexpr int32_t kInvalid = -2, kDone = INT32_MAX;
  struct State {
    int32_t index, low;
  };
  std::vector<State> st(n);
  for (int64_t v = 0; v < n; ++v) {
    st[v] = {valid[v] ? -1 : kInvalid, 0};
    label[v] = -1;
  }
  std::vector<int32_t> stack;
  std::vector<std::pair<int32_t, int32_t>> work;  // (node, next slot)
  int32_t counter = 0;
  int64_t count = 0, pos = 0, epos = 0;
  node_off[0] = 0;
  edge_off[0] = 0;
  for (int64_t root = 0; root < n; ++root) {
    if (st[root].index != -1) continue;
    st[root] = {counter, counter};
    ++counter;
    stack.push_back(static_cast<int32_t>(root));
    work.emplace_back(static_cast<int32_t>(root), 0);
    while (!work.empty()) {
      const int32_t node = work.back().first;
      int32_t slot = work.back().second;
      bool advanced = false;
      while (slot < 4) {
        const int32_t nb = out[4 * static_cast<int64_t>(node) + slot];
        ++slot;
        if (nb < 0) continue;
        const int32_t idx = st[nb].index;
        if (idx == -1) {
          work.back().second = slot;
          st[nb] = {counter, counter};
          ++counter;
          stack.push_back(nb);
          work.emplace_back(nb, 0);
          advanced = true;
          break;
        }
        // a node on the stack: visited (not kInvalid) and not kDone, which
        // is above every lowlink
        if (idx >= 0 && idx < st[node].low) st[node].low = idx;
      }
      if (advanced) continue;
      work.pop_back();
      const int32_t low = st[node].low;
      if (low == st[node].index) {
        int64_t size = 0;
        for (;;) {
          const int32_t w = stack.back();
          stack.pop_back();
          st[w].index = kDone;
          order[pos + size++] = w;
          if (w == node) break;
        }
        if (size > 1) {
          const int32_t id = static_cast<int32_t>(count);
          for (int64_t p = pos; p < pos + size; ++p) label[order[p]] = id;
          int64_t e = epos;
          for (int64_t p = pos; p < pos + size; ++p) {
            const int32_t* row = out + 4 * static_cast<int64_t>(order[p]);
            uint8_t d = 0;
            for (int s = 0; s < 4; ++s) {
              if (row[s] >= 0 && label[row[s]] == id) {
                targets[e++] = row[s];
                ++d;
              }
            }
            deg[p] = d;
          }
          if (e > epos) {
            pos += size;
            epos = e;
            node_off[++count] = pos;
            edge_off[count] = epos;
          } else {  // no internal edge: not a subgraph
            for (int64_t p = pos; p < pos + size; ++p) label[order[p]] = -1;
          }
        }
      }
      if (!work.empty()) {
        const int32_t parent = work.back().first;
        if (low < st[parent].low) st[parent].low = low;
      }
    }
  }
  return count;
}

}  // extern "C"
