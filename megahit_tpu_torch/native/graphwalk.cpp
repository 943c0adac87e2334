// Native host-side unitig chain ranking.
//
// The reference builds unitigs by parallel marker-protected chain
// walks (src/assembly/unitig_graph.cpp:13-138). The CUDA path is
// log-round pointer doubling (graph/unitig.py _list_rank); this is
// the host equivalent: one O(E)
// sequential pointer walk over the simple-path links. Chains are
// discovered at their heads (prv < 0) scanning ascending, remaining
// unvisited valid edges are pure cycles discovered at their min-index
// member - exactly the semantics build_unitig_graph derives from
// _list_rank's (end, start, pos, min_reach).
//
// Build: g++ -O3 -shared -fPIC graphwalk.cpp -o libgraphwalk.so

#include <cstddef>
#include <cstdint>
#include <vector>

using std::size_t;

extern "C" {

// chain_rank: fill per-edge (chain_start, chain_end, pos, is_cycle).
// pos = distance from the chain anchor (head for chains, min-index
// member for cycles). Invalid edges get self-chains with pos 0.
void chain_rank(const int32_t* nxt, const int32_t* prv,
                const uint8_t* valid, int64_t e,
                int32_t* chain_start, int32_t* chain_end,
                int32_t* pos, uint8_t* is_cycle) {
  for (int64_t i = 0; i < e; ++i) pos[i] = -1;
  std::vector<int32_t> buf;
  buf.reserve(1024);
  // pass 1: chains from their heads
  for (int64_t i = 0; i < e; ++i) {
    if (!valid[i]) {
      chain_start[i] = (int32_t)i;
      chain_end[i] = (int32_t)i;
      pos[i] = 0;
      is_cycle[i] = 0;
      continue;
    }
    if (prv[i] >= 0) continue;  // interior or cycle member
    buf.clear();
    int32_t cur = (int32_t)i;
    for (;;) {
      buf.push_back(cur);
      int32_t n = nxt[cur];
      if (n < 0) break;
      cur = n;
    }
    int32_t endv = cur;
    for (size_t j = 0; j < buf.size(); ++j) {
      int32_t x = buf[j];
      chain_start[x] = (int32_t)i;
      chain_end[x] = endv;
      pos[x] = (int32_t)j;
      is_cycle[x] = 0;
    }
  }
  // pass 2: cycles (valid, still unvisited); scanning ascending makes
  // the discovery edge the min-index member
  for (int64_t i = 0; i < e; ++i) {
    if (!valid[i] || pos[i] >= 0) continue;
    buf.clear();
    int32_t cur = (int32_t)i;
    do {
      buf.push_back(cur);
      cur = nxt[cur];
    } while (cur != (int32_t)i);
    int32_t endv = prv[i];
    for (size_t j = 0; j < buf.size(); ++j) {
      int32_t x = buf[j];
      chain_start[x] = (int32_t)i;
      chain_end[x] = endv;
      pos[x] = (int32_t)j;
      is_cycle[x] = 1;
    }
  }
}

// collect_chain_edges: walk nxt from each start for len edges,
// appending edge indices to out (caller sizes out = sum(lens)).
// Returns the number written.
int64_t collect_chain_edges(const int32_t* nxt, const int32_t* starts,
                            const int32_t* lens, int64_t n,
                            int32_t* out) {
  int64_t w = 0;
  for (int64_t i = 0; i < n; ++i) {
    int32_t cur = starts[i];
    for (int32_t j = 0; j < lens[i]; ++j) {
      out[w++] = cur;
      cur = nxt[cur];
    }
  }
  return w;
}

}  // extern "C"
