// Standalone C++ exerciser for the port's native sampler (sampler.cpp,
// the JAX package's verbatim) — built by run_sanitizers.sh under
// ASan/UBSan and TSan. Exercises: random graphs, overflow paths,
// duplicate-hit relabeling, the mirror by src, both partitioners, and
// concurrent sampling from several threads with one workspace a thread
// (the sampler's threading model).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <random>
#include <thread>
#include <vector>

extern "C" {
void* sptpu_ws_create(int64_t max_nodes);
void sptpu_ws_destroy(void* p);
int32_t sptpu_sample_batch(void* ws, const int64_t* rowptr,
                           const int32_t* col, int64_t num_nodes,
                           const int64_t* seeds,
                           int32_t num_seeds, const int32_t* fanouts,
                           int32_t num_hops, uint64_t rng_seed,
                           const int32_t* node_caps,
                           const int64_t* edge_offsets,
                           const int32_t* edge_caps, int32_t* out_n_id,
                           int32_t* out_level_sizes, int32_t* out_edge_src,
                           int32_t* out_edge_dst, int32_t* out_edge_counts,
                           int32_t* out_overflow);
void sptpu_mirror_by_src(const int32_t* src, const int32_t* dst,
                         int32_t count, int32_t cap, int32_t in_cap,
                         int32_t* counts_ws, int32_t* msrc, int32_t* mdst);
void sptpu_partition_ml(const int64_t* rowptr, const int32_t* col,
                        int64_t V, int32_t k, const double* weights,
                        int32_t nw, const double* caps, uint64_t seed,
                        int32_t refine_passes, int64_t coarsest,
                        int32_t* labels);
void sptpu_partition(const int64_t* rowptr, const int32_t* col, int64_t V,
                     int32_t k, const double* weights, int32_t nw,
                     const double* caps, uint64_t seed,
                     int32_t refine_passes, int32_t* labels);
}

namespace {

struct Graph {
  std::vector<int64_t> rowptr;
  std::vector<int32_t> col;
};

Graph make_graph(int32_t v, int32_t avg_deg, uint64_t seed) {
  std::mt19937_64 gen(seed);
  std::vector<std::vector<int32_t>> adj(v);
  for (int32_t u = 0; u < v; ++u) {
    const int32_t d = (int32_t)(gen() % (2 * avg_deg));
    for (int32_t j = 0; j < d; ++j) adj[u].push_back((int32_t)(gen() % v));
  }
  Graph g;
  g.rowptr.assign(v + 1, 0);
  for (int32_t u = 0; u < v; ++u) g.rowptr[u + 1] = g.rowptr[u] + adj[u].size();
  g.col.reserve(g.rowptr[v]);
  for (auto& a : adj)
    for (auto c : a) g.col.push_back(c);
  return g;
}

int run_batches(const Graph& g, int32_t seed_base, bool tight_caps) {
  const int32_t L = 3;
  int32_t fanouts[L] = {10, 5, 3};
  const int32_t B = 64;
  int32_t node_caps[L + 1];
  int32_t edge_caps[L];
  int64_t edge_offsets[L + 1] = {0};
  node_caps[0] = B;
  for (int32_t h = 0; h < L; ++h) {
    const int32_t grow = tight_caps ? 64 : node_caps[h] * (fanouts[h] + 1);
    node_caps[h + 1] = node_caps[h] + grow;
    edge_caps[h] = tight_caps ? 128 : node_caps[h] * fanouts[h] + 64;
    edge_offsets[h + 1] = edge_offsets[h] + edge_caps[h];
  }
  const int64_t V = (int64_t)g.rowptr.size() - 1;
  std::vector<int32_t> n_id(node_caps[L]);
  std::vector<int32_t> level_sizes(L + 1);
  std::vector<int32_t> esrc(edge_offsets[L]), edst(edge_offsets[L]);
  std::vector<int32_t> ecnt(L), ovf(2);
  void* ws = sptpu_ws_create(node_caps[L]);

  std::mt19937_64 gen(seed_base);
  int failures = 0;
  for (int iter = 0; iter < 50; ++iter) {
    std::vector<int64_t> seeds;
    std::vector<char> used(V, 0);
    while ((int32_t)seeds.size() < B) {
      int64_t s = (int64_t)(gen() % V);
      if (!used[s]) {
        used[s] = 1;
        seeds.push_back(s);
      }
    }
    const int32_t rc = sptpu_sample_batch(
        ws, g.rowptr.data(), g.col.data(), V, seeds.data(), B, fanouts, L,
        seed_base * 1000003ULL + iter, node_caps, edge_offsets, edge_caps,
        n_id.data(), level_sizes.data(), esrc.data(), edst.data(),
        ecnt.data(), ovf.data());
    if (rc != 0) ++failures;
    // invariant spot checks
    for (int32_t h = 0; h < L; ++h) {
      if (ecnt[h] > edge_caps[h]) ++failures;
      for (int32_t e = 0; e < ecnt[h]; ++e) {
        if (edst[edge_offsets[h] + e] >= level_sizes[h]) ++failures;
        if (esrc[edge_offsets[h] + e] >= level_sizes[h + 1]) ++failures;
      }
    }
    if (!tight_caps && (ovf[0] || ovf[1])) ++failures;
    // mirror every hop and verify it is a sorted permutation of the edges
    std::vector<int32_t> cws(node_caps[L] + 1), msrc(edge_offsets[L]),
        mdst(edge_offsets[L]);
    for (int32_t h = 0; h < L; ++h) {
      sptpu_mirror_by_src(esrc.data() + edge_offsets[h],
                          edst.data() + edge_offsets[h], ecnt[h],
                          edge_caps[h], node_caps[h + 1], cws.data(),
                          msrc.data() + edge_offsets[h],
                          mdst.data() + edge_offsets[h]);
      int64_t sum_src = 0, sum_msrc = 0;
      for (int32_t e = 0; e < ecnt[h]; ++e) {
        sum_src += esrc[edge_offsets[h] + e];
        sum_msrc += msrc[edge_offsets[h] + e];
        if (e && msrc[edge_offsets[h] + e] < msrc[edge_offsets[h] + e - 1])
          ++failures;  // must be nondecreasing
      }
      if (sum_src != sum_msrc) ++failures;  // same multiset of srcs
      for (int32_t e = ecnt[h]; e < edge_caps[h]; ++e)
        if (msrc[edge_offsets[h] + e] != node_caps[h + 1]) ++failures;
    }
  }
  sptpu_ws_destroy(ws);
  return failures;
}

int run_partition(const Graph& g) {
  const int64_t V = (int64_t)g.rowptr.size() - 1;
  const int32_t k = 6, nw = 2;
  std::vector<double> w(V * nw);
  for (int64_t v = 0; v < V; ++v) {
    w[v * nw + 0] = 1.0;
    w[v * nw + 1] = (double)(g.rowptr[v + 1] - g.rowptr[v]);
  }
  double caps[nw];
  for (int32_t c = 0; c < nw; ++c) {
    double tot = 0, mx = 0;
    for (int64_t v = 0; v < V; ++v) {
      tot += w[v * nw + c];
      if (w[v * nw + c] > mx) mx = w[v * nw + c];
    }
    caps[c] = tot / k * 1.1 + mx;
  }
  std::vector<int32_t> labels(V);
  sptpu_partition(g.rowptr.data(), g.col.data(), V, k, w.data(), nw, caps,
                  7, 3, labels.data());
  std::vector<int32_t> ml(V);
  sptpu_partition_ml(g.rowptr.data(), g.col.data(), V, k, w.data(), nw,
                     caps, 7, 3, /*coarsest=*/1024, ml.data());
  int failures = 0;
  std::vector<double> loads(k * nw, 0.0);
  for (int64_t v = 0; v < V; ++v) {
    if (labels[v] < 0 || labels[v] >= k) { ++failures; continue; }
    if (ml[v] < 0 || ml[v] >= k) ++failures;
    for (int32_t c = 0; c < nw; ++c) loads[labels[v] * nw + c] += w[v * nw + c];
  }
  return failures;
}

}  // namespace

int main() {
  Graph g = make_graph(20000, 12, 42);
  int failures = run_batches(g, 1, /*tight_caps=*/false);
  failures += run_batches(g, 2, /*tight_caps=*/true);

  // concurrent sampling: one workspace per thread, shared graph
  std::vector<std::thread> threads;
  std::vector<int> results(4, 0);
  for (int t = 0; t < 4; ++t) {
    threads.emplace_back([&, t] { results[t] = run_batches(g, 100 + t, false); });
  }
  for (auto& th : threads) th.join();
  for (int r : results) failures += r;
  failures += run_partition(g);

  if (failures) {
    std::fprintf(stderr, "FAILED: %d invariant violations\n", failures);
    return 1;
  }
  std::printf("sampler_test OK\n");
  return 0;
}
