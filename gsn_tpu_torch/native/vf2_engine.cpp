// VF2-style subgraph-isomorphism counting engine.
//
// Native replacement for graph-tool's C++ matcher used by the reference
// (utils_graph_processing.py:116,156 via gt_topology.subgraph_isomorphism).
// Enumerates all injective mappings of a small pattern H into a host
// graph G — monomorphisms (induced=0) or induced isomorphisms
// (induced=1) — accumulating per-node vertex-orbit counts or per-edge
// edge-orbit counts. |Aut(H)| normalization is applied by the Python
// caller so float semantics stay in one place.
//
// Exposed via a C ABI for ctypes (no pybind11 in this image).
//
// Design notes:
// - host adjacency is a bitset matrix (words of 64): candidate filtering
//   is word-parallel AND of neighbor rows;
// - pattern search order is max-connectivity-first with degree
//   tie-break (same ordering as gsn_tpu_torch.counting.vf2, so enumeration
//   counts agree exactly with the Python oracle);
// - degree pruning: host candidate must have degree >= pattern degree.

#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

using u64 = uint64_t;
using i32 = int32_t;
using i64 = int64_t;

struct BitMatrix {
  int n = 0;
  int words = 0;
  std::vector<u64> bits;

  void init(int n_) {
    n = n_;
    words = (n + 63) / 64;
    bits.assign(static_cast<size_t>(n) * words, 0);
  }
  inline u64* row(int v) { return bits.data() + static_cast<size_t>(v) * words; }
  inline const u64* row(int v) const {
    return bits.data() + static_cast<size_t>(v) * words;
  }
  inline void set(int u, int v) { row(u)[v >> 6] |= (1ULL << (v & 63)); }
  inline bool get(int u, int v) const {
    return (row(u)[v >> 6] >> (v & 63)) & 1ULL;
  }
};

struct Pattern {
  int n;
  std::vector<std::vector<int>> adj;       // adjacency lists
  std::vector<int> order;                  // search order (position->vertex)
  std::vector<int> pos_of;                 // vertex -> position
  std::vector<std::vector<int>> nbr_prev;  // per position: earlier positions adjacent
  std::vector<std::vector<int>> non_prev;  // per position: earlier positions non-adjacent
  std::vector<int> deg;
};

void build_pattern(const i32* edges, i64 num_edges, int n, Pattern& p) {
  p.n = n;
  p.adj.assign(n, {});
  std::vector<std::vector<bool>> am(n, std::vector<bool>(n, false));
  for (i64 e = 0; e < num_edges; ++e) {
    int u = edges[2 * e], v = edges[2 * e + 1];
    if (u == v || am[u][v]) continue;
    am[u][v] = am[v][u] = true;
    p.adj[u].push_back(v);
    p.adj[v].push_back(u);
  }
  p.deg.resize(n);
  for (int v = 0; v < n; ++v) p.deg[v] = static_cast<int>(p.adj[v].size());

  // greedy max-connectivity order (ties by degree) — mirrors
  // gsn_tpu_torch/counting/vf2.py::_pattern_order
  std::vector<bool> in_order(n, false);
  p.order.clear();
  {
    int best = 0;
    for (int v = 1; v < n; ++v)
      if (p.deg[v] > p.deg[best]) best = v;
    p.order.push_back(best);
    in_order[best] = true;
  }
  while (static_cast<int>(p.order.size()) < n) {
    int best = -1, best_conn = -1, best_deg = -1;
    for (int v = 0; v < n; ++v) {
      if (in_order[v]) continue;
      int conn = 0;
      for (int u : p.adj[v])
        if (in_order[u]) ++conn;
      if (conn > best_conn || (conn == best_conn && p.deg[v] > best_deg)) {
        best = v;
        best_conn = conn;
        best_deg = p.deg[v];
      }
    }
    p.order.push_back(best);
    in_order[best] = true;
  }
  p.pos_of.assign(n, -1);
  for (int i = 0; i < n; ++i) p.pos_of[p.order[i]] = i;

  p.nbr_prev.assign(n, {});
  p.non_prev.assign(n, {});
  for (int idx = 0; idx < n; ++idx) {
    int v = p.order[idx];
    for (int jdx = 0; jdx < idx; ++jdx) {
      int u = p.order[jdx];
      if (am[v][u])
        p.nbr_prev[idx].push_back(jdx);
      else
        p.non_prev[idx].push_back(jdx);
    }
  }
}

// Generic enumerator: calls Visitor(mapping_by_position) per embedding.
template <typename Visitor>
void enumerate(const Pattern& p, const BitMatrix& host,
               const std::vector<int>& host_deg, bool induced, Visitor&& visit) {
  const int n = p.n, hn = host.n, words = host.words;
  if (n > hn) return;

  std::vector<int> mapping(n);                     // position -> host vertex
  std::vector<u64> used(words, 0);
  std::vector<std::vector<u64>> cand(n, std::vector<u64>(words));
  std::vector<int> cursor_word(n), cursor_bit(n);

  // full-host mask template
  std::vector<u64> full(words, ~0ULL);
  if (hn & 63) full[words - 1] = (1ULL << (hn & 63)) - 1;

  auto compute_cand = [&](int idx) {
    u64* c = cand[idx].data();
    std::memcpy(c, full.data(), words * sizeof(u64));
    for (int jdx : p.nbr_prev[idx]) {
      const u64* r = host.row(mapping[jdx]);
      for (int w = 0; w < words; ++w) c[w] &= r[w];
    }
    for (int w = 0; w < words; ++w) c[w] &= ~used[w];
    if (induced) {
      for (int jdx : p.non_prev[idx]) {
        const u64* r = host.row(mapping[jdx]);
        for (int w = 0; w < words; ++w) c[w] &= ~r[w];
      }
    }
  };

  int idx = 0;
  compute_cand(0);
  std::vector<u64> scratch(words);
  // stack-based DFS over candidate bitsets
  std::vector<std::vector<u64>> rem(n, std::vector<u64>(words));
  rem[0] = cand[0];
  while (idx >= 0) {
    // pop next candidate from rem[idx]
    int h = -1;
    u64* r = rem[idx].data();
    for (int w = 0; w < words; ++w) {
      if (r[w]) {
        int b = __builtin_ctzll(r[w]);
        r[w] &= r[w] - 1;
        h = (w << 6) | b;
        break;
      }
    }
    if (h < 0) {  // exhausted -> backtrack
      --idx;
      if (idx >= 0) {
        int hv = mapping[idx];
        used[hv >> 6] &= ~(1ULL << (hv & 63));
      }
      continue;
    }
    if (host_deg[h] < p.deg[p.order[idx]]) continue;
    mapping[idx] = h;
    if (idx + 1 == n) {
      visit(mapping);
    } else {
      used[h >> 6] |= 1ULL << (h & 63);
      ++idx;
      compute_cand(idx);
      rem[idx] = cand[idx];
    }
  }
}

// ---------------------------------------------------------------------------
// Directed patterns (reference --directed flag; gt directed VF2).
// Search order uses the union adjacency (same greedy as the Python
// oracle gsn_tpu_torch/counting/vf2.py::enumerate_directed_subgraph_isomorphisms).
// ---------------------------------------------------------------------------

struct DirPattern {
  int n;
  std::vector<int> order;
  std::vector<int> pos_of;
  // per order position: earlier positions u such that...
  std::vector<std::vector<int>> pred_prev;      // pattern edge u -> v
  std::vector<std::vector<int>> succ_prev;      // pattern edge v -> u
  std::vector<std::vector<int>> non_pred_prev;  // no edge u -> v (induced)
  std::vector<std::vector<int>> non_succ_prev;  // no edge v -> u (induced)
  std::vector<int> out_deg, in_deg;
};

void build_dir_pattern(const i32* edges, i64 num_edges, int n,
                       DirPattern& p) {
  p.n = n;
  std::vector<std::vector<bool>> out_am(n, std::vector<bool>(n, false));
  for (i64 e = 0; e < num_edges; ++e) {
    int u = edges[2 * e], v = edges[2 * e + 1];
    if (u == v) continue;
    out_am[u][v] = true;
  }
  p.out_deg.assign(n, 0);
  p.in_deg.assign(n, 0);
  std::vector<int> union_deg(n, 0);
  for (int u = 0; u < n; ++u)
    for (int v = 0; v < n; ++v) {
      if (out_am[u][v]) {
        ++p.out_deg[u];
        ++p.in_deg[v];
      }
      if (u != v && (out_am[u][v] || out_am[v][u]) && v > u) {
        ++union_deg[u];
        ++union_deg[v];
      }
    }

  // greedy max-connectivity order over the union adjacency
  std::vector<bool> in_order(n, false);
  p.order.clear();
  {
    int best = 0;
    for (int v = 1; v < n; ++v)
      if (union_deg[v] > union_deg[best]) best = v;
    p.order.push_back(best);
    in_order[best] = true;
  }
  auto connected = [&](int a, int b) { return out_am[a][b] || out_am[b][a]; };
  while (static_cast<int>(p.order.size()) < n) {
    int best = -1, best_conn = -1, best_deg = -1;
    for (int v = 0; v < n; ++v) {
      if (in_order[v]) continue;
      int conn = 0;
      for (int u = 0; u < n; ++u)
        if (in_order[u] && connected(u, v)) ++conn;
      if (conn > best_conn ||
          (conn == best_conn && union_deg[v] > best_deg)) {
        best = v;
        best_conn = conn;
        best_deg = union_deg[v];
      }
    }
    p.order.push_back(best);
    in_order[best] = true;
  }
  p.pos_of.assign(n, -1);
  for (int i = 0; i < n; ++i) p.pos_of[p.order[i]] = i;

  p.pred_prev.assign(n, {});
  p.succ_prev.assign(n, {});
  p.non_pred_prev.assign(n, {});
  p.non_succ_prev.assign(n, {});
  for (int idx = 0; idx < n; ++idx) {
    int v = p.order[idx];
    for (int jdx = 0; jdx < idx; ++jdx) {
      int u = p.order[jdx];
      if (out_am[u][v])
        p.pred_prev[idx].push_back(jdx);
      else
        p.non_pred_prev[idx].push_back(jdx);
      if (out_am[v][u])
        p.succ_prev[idx].push_back(jdx);
      else
        p.non_succ_prev[idx].push_back(jdx);
    }
  }
}

// Directed enumerator: m(v) must lie in out(m(u)) for every pattern edge
// u->v with u placed earlier, in in(m(u)) for v->u; induced additionally
// forbids host edges between images of pattern non-edges per direction.
template <typename Visitor>
void enumerate_dir(const DirPattern& p, const BitMatrix& h_out,
                   const BitMatrix& h_in, const std::vector<int>& hd_out,
                   const std::vector<int>& hd_in, bool induced,
                   Visitor&& visit) {
  const int n = p.n, hn = h_out.n, words = h_out.words;
  if (n > hn) return;

  std::vector<int> mapping(n);
  std::vector<u64> used(words, 0);
  std::vector<u64> full(words, ~0ULL);
  if (hn & 63) full[words - 1] = (1ULL << (hn & 63)) - 1;

  std::vector<std::vector<u64>> rem(n, std::vector<u64>(words));

  auto compute_cand = [&](int idx) {
    u64* c = rem[idx].data();
    std::memcpy(c, full.data(), words * sizeof(u64));
    for (int jdx : p.pred_prev[idx]) {
      const u64* r = h_out.row(mapping[jdx]);
      for (int w = 0; w < words; ++w) c[w] &= r[w];
    }
    for (int jdx : p.succ_prev[idx]) {
      const u64* r = h_in.row(mapping[jdx]);
      for (int w = 0; w < words; ++w) c[w] &= r[w];
    }
    for (int w = 0; w < words; ++w) c[w] &= ~used[w];
    if (induced) {
      for (int jdx : p.non_pred_prev[idx]) {
        const u64* r = h_out.row(mapping[jdx]);
        for (int w = 0; w < words; ++w) c[w] &= ~r[w];
      }
      for (int jdx : p.non_succ_prev[idx]) {
        const u64* r = h_in.row(mapping[jdx]);
        for (int w = 0; w < words; ++w) c[w] &= ~r[w];
      }
    }
  };

  int idx = 0;
  compute_cand(0);
  while (idx >= 0) {
    int h = -1;
    u64* r = rem[idx].data();
    for (int w = 0; w < words; ++w) {
      if (r[w]) {
        int b = __builtin_ctzll(r[w]);
        r[w] &= r[w] - 1;
        h = (w << 6) | b;
        break;
      }
    }
    if (h < 0) {
      --idx;
      if (idx >= 0) {
        int hv = mapping[idx];
        used[hv >> 6] &= ~(1ULL << (hv & 63));
      }
      continue;
    }
    int v = p.order[idx];
    if (hd_out[h] < p.out_deg[v] || hd_in[h] < p.in_deg[v]) continue;
    mapping[idx] = h;
    if (idx + 1 == n) {
      visit(mapping);
    } else {
      used[h >> 6] |= 1ULL << (h & 63);
      ++idx;
      compute_cand(idx);
    }
  }
}

void build_host_directed(const i32* edges, i64 num_edges, int n,
                         BitMatrix& h_out, BitMatrix& h_in,
                         std::vector<int>& deg_out,
                         std::vector<int>& deg_in) {
  h_out.init(n);
  h_in.init(n);
  for (i64 e = 0; e < num_edges; ++e) {
    int u = edges[2 * e], v = edges[2 * e + 1];
    if (u == v) continue;
    h_out.set(u, v);
    h_in.set(v, u);
  }
  deg_out.assign(n, 0);
  deg_in.assign(n, 0);
  for (int v = 0; v < n; ++v) {
    int d = 0;
    const u64* r = h_out.row(v);
    for (int w = 0; w < h_out.words; ++w) d += __builtin_popcountll(r[w]);
    deg_out[v] = d;
    d = 0;
    const u64* ri = h_in.row(v);
    for (int w = 0; w < h_in.words; ++w) d += __builtin_popcountll(ri[w]);
    deg_in[v] = d;
  }
}

void build_host(const i32* edges, i64 num_edges, int n, BitMatrix& host,
                std::vector<int>& deg) {
  host.init(n);
  for (i64 e = 0; e < num_edges; ++e) {
    int u = edges[2 * e], v = edges[2 * e + 1];
    if (u == v) continue;
    host.set(u, v);
    host.set(v, u);
  }
  deg.assign(n, 0);
  for (int v = 0; v < n; ++v) {
    int d = 0;
    const u64* r = host.row(v);
    for (int w = 0; w < host.words; ++w) d += __builtin_popcountll(r[w]);
    deg[v] = d;
  }
}

}  // namespace

extern "C" {

// counts: [num_host_nodes * num_orbits] raw (un-normalized) increments.
// Returns number of embeddings enumerated.
i64 vf2_vertex_counts(const i32* host_edges, i64 num_host_edges,
                      i32 num_host_nodes, const i32* pat_edges,
                      i64 num_pat_edges, i32 num_pat_nodes,
                      const i32* orbit_membership, i32 num_orbits,
                      i32 induced, double* counts) {
  Pattern p;
  build_pattern(pat_edges, num_pat_edges, num_pat_nodes, p);
  BitMatrix host;
  std::vector<int> host_deg;
  build_host(host_edges, num_host_edges, num_host_nodes, host, host_deg);

  i64 total = 0;
  enumerate(p, host, host_deg, induced != 0, [&](const std::vector<int>& m) {
    ++total;
    for (int idx = 0; idx < p.n; ++idx) {
      int pat_v = p.order[idx];
      counts[static_cast<size_t>(m[idx]) * num_orbits +
             orbit_membership[pat_v]] += 1.0;
    }
  });
  return total;
}

// pat_dir_edges: [2 * num_pat_dir_edges] directed pattern edges (both
// directions), edge_orbit_membership aligned with them.
// host edge lookup: dense [num_host_nodes * num_host_nodes] int32 of row
// ids into the counts matrix (-1 when absent), built by the caller.
// counts: [num_host_edges_rows * num_edge_orbits].
i64 vf2_edge_counts(const i32* host_edges, i64 num_host_edges,
                    i32 num_host_nodes, const i32* edge_row_lookup,
                    const i32* pat_edges, i64 num_pat_edges,
                    i32 num_pat_nodes, const i32* pat_dir_edges,
                    i64 num_pat_dir_edges, const i32* edge_orbit_membership,
                    i32 num_edge_orbits, i32 induced, double* counts) {
  Pattern p;
  build_pattern(pat_edges, num_pat_edges, num_pat_nodes, p);
  BitMatrix host;
  std::vector<int> host_deg;
  build_host(host_edges, num_host_edges, num_host_nodes, host, host_deg);

  const i64 n = num_host_nodes;
  std::vector<int> inv_pos(p.n);  // pattern vertex -> mapping position
  for (int i = 0; i < p.n; ++i) inv_pos[p.order[i]] = i;

  i64 total = 0;
  enumerate(p, host, host_deg, induced != 0, [&](const std::vector<int>& m) {
    ++total;
    for (i64 e = 0; e < num_pat_dir_edges; ++e) {
      int pu = pat_dir_edges[2 * e], pv = pat_dir_edges[2 * e + 1];
      int hu = m[inv_pos[pu]], hv = m[inv_pos[pv]];
      i32 row = edge_row_lookup[hu * n + hv];
      if (row >= 0)
        counts[static_cast<size_t>(row) * num_edge_orbits +
               edge_orbit_membership[e]] += 1.0;
    }
  });
  return total;
}

// Directed variants: host_edges / pat_edges are *directed* (u, v) pairs.
i64 vf2_vertex_counts_dir(const i32* host_edges, i64 num_host_edges,
                          i32 num_host_nodes, const i32* pat_edges,
                          i64 num_pat_edges, i32 num_pat_nodes,
                          const i32* orbit_membership, i32 num_orbits,
                          i32 induced, double* counts) {
  DirPattern p;
  build_dir_pattern(pat_edges, num_pat_edges, num_pat_nodes, p);
  BitMatrix h_out, h_in;
  std::vector<int> dout, din;
  build_host_directed(host_edges, num_host_edges, num_host_nodes, h_out,
                      h_in, dout, din);
  i64 total = 0;
  enumerate_dir(p, h_out, h_in, dout, din, induced != 0,
                [&](const std::vector<int>& m) {
                  ++total;
                  for (int idx = 0; idx < p.n; ++idx) {
                    int pat_v = p.order[idx];
                    counts[static_cast<size_t>(m[idx]) * num_orbits +
                           orbit_membership[pat_v]] += 1.0;
                  }
                });
  return total;
}

i64 vf2_edge_counts_dir(const i32* host_edges, i64 num_host_edges,
                        i32 num_host_nodes, const i32* edge_row_lookup,
                        const i32* pat_edges, i64 num_pat_edges,
                        i32 num_pat_nodes, const i32* pat_dir_edges,
                        i64 num_pat_dir_edges,
                        const i32* edge_orbit_membership,
                        i32 num_edge_orbits, i32 induced, double* counts) {
  DirPattern p;
  build_dir_pattern(pat_edges, num_pat_edges, num_pat_nodes, p);
  BitMatrix h_out, h_in;
  std::vector<int> dout, din;
  build_host_directed(host_edges, num_host_edges, num_host_nodes, h_out,
                      h_in, dout, din);
  const i64 n = num_host_nodes;
  i64 total = 0;
  enumerate_dir(p, h_out, h_in, dout, din, induced != 0,
                [&](const std::vector<int>& m) {
                  ++total;
                  for (i64 e = 0; e < num_pat_dir_edges; ++e) {
                    int pu = pat_dir_edges[2 * e];
                    int pv = pat_dir_edges[2 * e + 1];
                    int hu = m[p.pos_of[pu]], hv = m[p.pos_of[pv]];
                    i32 row = edge_row_lookup[hu * n + hv];
                    if (row >= 0)
                      counts[static_cast<size_t>(row) * num_edge_orbits +
                             edge_orbit_membership[e]] += 1.0;
                  }
                });
  return total;
}

// ---------------------------------------------------------------------------
// Batch API: many host graphs, one pattern, OpenMP fan-out.  Graphs are
// flattened: edges_flat[2*edge_starts[g] .. 2*edge_starts[g+1]) with
// *graph-local* vertex ids; counts land at node_starts[g]*num_orbits
// (vertex scope) / edge_starts[g]*num_orbits (edge scope).  Returns the
// total number of embeddings across the batch.
// ---------------------------------------------------------------------------

i64 vf2_vertex_counts_batch(
    const i32* edges_flat, const i64* edge_starts, const i32* num_nodes,
    const i64* node_starts, i32 num_graphs, const i32* pat_edges,
    i64 num_pat_edges, i32 num_pat_nodes, const i32* orbit_membership,
    i32 num_orbits, i32 induced, i32 directed, double* counts,
    i32 num_threads) {
  Pattern p;
  DirPattern dp;
  if (directed)
    build_dir_pattern(pat_edges, num_pat_edges, num_pat_nodes, dp);
  else
    build_pattern(pat_edges, num_pat_edges, num_pat_nodes, p);

  i64 total = 0;
#ifdef _OPENMP
  if (num_threads > 0) omp_set_num_threads(num_threads);
#pragma omp parallel for schedule(dynamic) reduction(+ : total)
#endif
  for (i32 g = 0; g < num_graphs; ++g) {
    const i32* edges = edges_flat + 2 * edge_starts[g];
    const i64 ne = edge_starts[g + 1] - edge_starts[g];
    const int n = num_nodes[g];
    double* c = counts + node_starts[g] * num_orbits;
    if (directed) {
      BitMatrix h_out, h_in;
      std::vector<int> dout, din;
      build_host_directed(edges, ne, n, h_out, h_in, dout, din);
      enumerate_dir(dp, h_out, h_in, dout, din, induced != 0,
                    [&](const std::vector<int>& m) {
                      ++total;
                      for (int idx = 0; idx < dp.n; ++idx)
                        c[static_cast<size_t>(m[idx]) * num_orbits +
                          orbit_membership[dp.order[idx]]] += 1.0;
                    });
    } else {
      BitMatrix host;
      std::vector<int> deg;
      build_host(edges, ne, n, host, deg);
      enumerate(p, host, deg, induced != 0,
                [&](const std::vector<int>& m) {
                  ++total;
                  for (int idx = 0; idx < p.n; ++idx)
                    c[static_cast<size_t>(m[idx]) * num_orbits +
                      orbit_membership[p.order[idx]]] += 1.0;
                });
    }
  }
  return total;
}

i64 vf2_edge_counts_batch(
    const i32* edges_flat, const i64* edge_starts, const i32* num_nodes,
    i32 num_graphs, const i32* pat_edges, i64 num_pat_edges,
    i32 num_pat_nodes, const i32* pat_dir_edges, i64 num_pat_dir_edges,
    const i32* edge_orbit_membership, i32 num_edge_orbits, i32 induced,
    i32 directed, double* counts, i32 num_threads) {
  Pattern p;
  DirPattern dp;
  std::vector<int> inv_pos;
  if (directed) {
    build_dir_pattern(pat_edges, num_pat_edges, num_pat_nodes, dp);
    inv_pos = dp.pos_of;
  } else {
    build_pattern(pat_edges, num_pat_edges, num_pat_nodes, p);
    inv_pos = p.pos_of;
  }

  i64 total = 0;
#ifdef _OPENMP
  if (num_threads > 0) omp_set_num_threads(num_threads);
#pragma omp parallel for schedule(dynamic) reduction(+ : total)
#endif
  for (i32 g = 0; g < num_graphs; ++g) {
    const i32* edges = edges_flat + 2 * edge_starts[g];
    const i64 ne = edge_starts[g + 1] - edge_starts[g];
    const int n = num_nodes[g];
    double* c = counts + edge_starts[g] * num_edge_orbits;
    // per-graph dense (u, v) -> local edge row lookup
    std::vector<i32> lookup(static_cast<size_t>(n) * n, -1);
    for (i64 e = 0; e < ne; ++e)
      lookup[static_cast<size_t>(edges[2 * e]) * n + edges[2 * e + 1]] =
          static_cast<i32>(e);
    auto visit = [&](const std::vector<int>& m) {
      ++total;
      for (i64 e = 0; e < num_pat_dir_edges; ++e) {
        int pu = pat_dir_edges[2 * e], pv = pat_dir_edges[2 * e + 1];
        int hu = m[inv_pos[pu]], hv = m[inv_pos[pv]];
        i32 row = lookup[static_cast<size_t>(hu) * n + hv];
        if (row >= 0)
          c[static_cast<size_t>(row) * num_edge_orbits +
            edge_orbit_membership[e]] += 1.0;
      }
    };
    if (directed) {
      BitMatrix h_out, h_in;
      std::vector<int> dout, din;
      build_host_directed(edges, ne, n, h_out, h_in, dout, din);
      enumerate_dir(dp, h_out, h_in, dout, din, induced != 0, visit);
    } else {
      BitMatrix host;
      std::vector<int> deg;
      build_host(edges, ne, n, host, deg);
      enumerate(p, host, deg, induced != 0, visit);
    }
  }
  return total;
}

// Count monomorphisms H -> H (= |Aut| for equal vertex/edge counts).
i64 vf2_count_automorphisms(const i32* pat_edges, i64 num_pat_edges,
                            i32 num_pat_nodes) {
  Pattern p;
  build_pattern(pat_edges, num_pat_edges, num_pat_nodes, p);
  BitMatrix host;
  std::vector<int> deg;
  build_host(pat_edges, num_pat_edges, num_pat_nodes, host, deg);
  i64 total = 0;
  enumerate(p, host, deg, false, [&](const std::vector<int>&) { ++total; });
  return total;
}

}  // extern "C"
