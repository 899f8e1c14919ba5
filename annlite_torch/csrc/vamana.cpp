// Vamana-style graph builder (DiskANN: Subramanya et al., NeurIPS'19).
//
// Host-side native component of annlite_torch: builds a single-layer
// fixed-degree proximity graph and exports it as a dense padded int32
// adjacency [N, R] for the batched beam search on the card in
// annlite_torch/ops/beam.py.
//
// The port's own copy of native/vamana.cpp: the code is the same, only
// these header lines differ (tests/test_torch_vamana.py holds the two equal
// with comments stripped).  annlite_torch/index/vamana_lib.py compiles it
// with g++ at first use into build/annlite_torch/<hash>/libvamana.so.
//
// One layer and a uniform degree bound mean the adjacency is a rectangular
// tensor the device can gather from directly: no pointer chasing, no level
// hierarchy.  Search on the host is only used during construction.
//
// Exposed as a C ABI for ctypes.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <queue>
#include <random>
#include <thread>
#include <vector>

namespace {

struct Graph {
    int dim;
    int R;           // max degree
    float alpha;     // robust-prune slack
    int metric;      // 0 = squared L2, 1 = inner product distance (1 - dot)
    int L_build;     // beam width during construction
    std::vector<float> data;            // [n, dim]
    std::vector<std::vector<int>> nbrs; // adjacency, each <= R
    std::vector<std::unique_ptr<std::mutex>> locks;
    int medoid = 0;
    std::mt19937 rng{42};

    size_t size() const { return nbrs.size(); }

    const float* vec(int i) const { return data.data() + (size_t)i * dim; }

    float dist(const float* a, const float* b) const {
        if (metric == 1) {
            float dot = 0.f;
            for (int d = 0; d < dim; ++d) dot += a[d] * b[d];
            return 1.0f - dot;
        }
        float s = 0.f;
        for (int d = 0; d < dim; ++d) {
            float t = a[d] - b[d];
            s += t * t;
        }
        return s;
    }
};

// Greedy best-first search over the current graph; returns the visited set
// (candidate pool for pruning) and fills `out` with the closest L ids.
void greedy_search(const Graph& g, const float* q, int start, int L,
                   std::vector<std::pair<float, int>>& visited_out) {
    struct Cand { float d; int id; };
    auto cmp_min = [](const Cand& a, const Cand& b) { return a.d > b.d; };
    std::priority_queue<Cand, std::vector<Cand>, decltype(cmp_min)> frontier(cmp_min);
    // max-heap of current best L
    std::priority_queue<std::pair<float, int>> best;
    std::vector<char> seen(g.size(), 0);

    float d0 = g.dist(q, g.vec(start));
    frontier.push({d0, start});
    best.push({d0, start});
    seen[start] = 1;
    visited_out.clear();

    while (!frontier.empty()) {
        Cand c = frontier.top();
        frontier.pop();
        if ((int)best.size() >= L && c.d > best.top().first) break;
        visited_out.push_back({c.d, c.id});
        // snapshot neighbors under lock (build is concurrent)
        std::vector<int> nb;
        {
            std::lock_guard<std::mutex> lk(*g.locks[c.id]);
            nb = g.nbrs[c.id];
        }
        for (int v : nb) {
            if (v < 0 || seen[v]) continue;
            seen[v] = 1;
            float dv = g.dist(q, g.vec(v));
            if ((int)best.size() < L || dv < best.top().first) {
                frontier.push({dv, v});
                best.push({dv, v});
                if ((int)best.size() > L) best.pop();
            }
        }
    }
}

// RobustPrune (DiskANN Alg. 2): keep a diverse neighbor set of size <= R.
void robust_prune(const Graph& g, int p,
                  std::vector<std::pair<float, int>>& pool,
                  std::vector<int>& out) {
    std::sort(pool.begin(), pool.end());
    pool.erase(std::unique(pool.begin(), pool.end(),
                           [](auto& a, auto& b) { return a.second == b.second; }),
               pool.end());
    out.clear();
    std::vector<char> removed(pool.size(), 0);
    for (size_t i = 0; i < pool.size() && (int)out.size() < g.R; ++i) {
        if (removed[i]) continue;
        int p_star = pool[i].second;
        if (p_star == p) continue;
        out.push_back(p_star);
        // drop candidates that are alpha-closer to p_star than to p
        for (size_t j = i + 1; j < pool.size(); ++j) {
            if (removed[j]) continue;
            float d_pj = pool[j].first;
            float d_sj = g.dist(g.vec(p_star), g.vec(pool[j].second));
            if (g.alpha * d_sj <= d_pj) removed[j] = 1;
        }
    }
}

void insert_point(Graph& g, int p) {
    std::vector<std::pair<float, int>> visited;
    greedy_search(g, g.vec(p), g.medoid, g.L_build, visited);
    // include current neighbors of p (re-insert path)
    {
        std::lock_guard<std::mutex> lk(*g.locks[p]);
        for (int v : g.nbrs[p]) visited.push_back({g.dist(g.vec(p), g.vec(v)), v});
    }
    std::vector<int> pruned;
    robust_prune(g, p, visited, pruned);
    // saturate: alpha-diversity can collapse an outlier's out-degree to ~2
    // (every cluster-mate prunes the rest); fill back up with the nearest
    // remaining candidates (diskann's saturate_graph behaviour)
    if ((int)pruned.size() < g.R) {
        for (auto& [d, v] : visited) {
            if ((int)pruned.size() >= g.R) break;
            if (v == p) continue;
            if (std::find(pruned.begin(), pruned.end(), v) == pruned.end())
                pruned.push_back(v);
        }
    }
    {
        std::lock_guard<std::mutex> lk(*g.locks[p]);
        g.nbrs[p] = pruned;
    }
    // back-edges with degree repair
    bool has_inlink = false;
    for (int v : pruned) {
        std::lock_guard<std::mutex> lk(*g.locks[v]);
        auto& nv = g.nbrs[v];
        if (std::find(nv.begin(), nv.end(), p) != nv.end()) {
            has_inlink = true;
            continue;
        }
        if ((int)nv.size() < g.R) {
            nv.push_back(p);
            has_inlink = true;
        } else {
            std::vector<std::pair<float, int>> pool;
            pool.reserve(nv.size() + 1);
            for (int u : nv) pool.push_back({g.dist(g.vec(v), g.vec(u)), u});
            pool.push_back({g.dist(g.vec(v), g.vec(p)), p});
            std::vector<int> np;
            robust_prune(g, v, pool, np);
            nv = np;
            if (std::find(nv.begin(), nv.end(), p) != nv.end()) has_inlink = true;
        }
    }
    // guarantee reachability: an outlier whose back-edges were all pruned
    // would be invisible to every search — force one in-link at its nearest
    // neighbor, evicting that node's farthest edge
    if (!has_inlink && !pruned.empty()) {
        int v = pruned[0];
        std::lock_guard<std::mutex> lk(*g.locks[v]);
        auto& nv = g.nbrs[v];
        if ((int)nv.size() < g.R) {
            nv.push_back(p);
        } else if (!nv.empty()) {
            size_t worst = 0;
            float wd = -1.f;
            for (size_t i = 0; i < nv.size(); ++i) {
                float di = g.dist(g.vec(v), g.vec(nv[i]));
                if (di > wd) { wd = di; worst = i; }
            }
            nv[worst] = p;
        }
    }
}

int compute_medoid(const Graph& g) {
    // centroid then nearest point (sampled for big n)
    size_t n = g.size();
    if (n == 0) return 0;
    std::vector<double> c(g.dim, 0.0);
    size_t step = std::max<size_t>(1, n / 10000);
    size_t cnt = 0;
    for (size_t i = 0; i < n; i += step, ++cnt)
        for (int d = 0; d < g.dim; ++d) c[d] += g.vec(i)[d];
    std::vector<float> cf(g.dim);
    for (int d = 0; d < g.dim; ++d) cf[d] = (float)(c[d] / cnt);
    int best = 0;
    float bd = g.dist(cf.data(), g.vec(0));
    for (size_t i = step; i < n; i += step) {
        float di = g.dist(cf.data(), g.vec(i));
        if (di < bd) { bd = di; best = (int)i; }
    }
    return best;
}

}  // namespace

extern "C" {

void* vamana_create(int dim, int max_degree, float alpha, int metric, int l_build) {
    auto* g = new Graph();
    g->dim = dim;
    g->R = max_degree;
    g->alpha = alpha;
    g->metric = metric;
    g->L_build = l_build > 0 ? l_build : 64;
    return g;
}

void vamana_destroy(void* h) { delete (Graph*)h; }

int vamana_size(void* h) { return (int)((Graph*)h)->size(); }

int vamana_medoid(void* h) { return ((Graph*)h)->medoid; }

// Append n points and link them into the graph (parallel across points).
void vamana_add(void* h, const float* x, int n, int n_threads) {
    Graph& g = *(Graph*)h;
    int n0 = (int)g.size();
    g.data.insert(g.data.end(), x, x + (size_t)n * g.dim);
    g.nbrs.resize(n0 + n);
    g.locks.reserve(n0 + n);
    for (int i = 0; i < n; ++i) g.locks.emplace_back(new std::mutex());

    if (n0 == 0) {
        g.medoid = compute_medoid(g);
        // bootstrap: connect a small random seed set densely
        int seed_n = std::min(n, g.R + 1);
        for (int i = 0; i < seed_n; ++i)
            for (int j = 0; j < seed_n; ++j)
                if (i != j && (int)g.nbrs[i].size() < g.R) g.nbrs[i].push_back(j);
    }

    if (n_threads <= 0)
        n_threads = std::max(1u, std::thread::hardware_concurrency());
    int seed_n = (n0 == 0) ? std::min(n, g.R + 1) : 0;
    std::atomic<int> next(seed_n);
    auto worker = [&]() {
        for (;;) {
            int i = next.fetch_add(1);
            if (i >= n) return;
            insert_point(g, n0 + i);
        }
    };
    std::vector<std::thread> ts;
    for (int t = 0; t < n_threads; ++t) ts.emplace_back(worker);
    for (auto& t : ts) t.join();
    // re-insert the bootstrap seed clique: its members start linked only to
    // each other, so without this pass their proper out/back-edges are never
    // built.  Do NOT clear first: insert_point replaces the out-edges anyway
    // (current neighbors join the prune pool), and clearing the medoid's own
    // edges mid-pass strands greedy_search at an edgeless entry point —
    // every later re-insert then sees a single-node visited set and the
    // graph partitions (observed: 9.6% reachability on a 250-row build).
    for (int i = 0; i < seed_n; ++i) insert_point(g, i);
    // refresh medoid occasionally (cheap)
    g.medoid = compute_medoid(g);
}

// In-place point update (hnswlib `updatePoint` /
// `repairConnectionsForUpdate` parity, hnswalg.h:958-1096): overwrite the
// stored vectors, then re-insert each updated point — insert_point rebuilds
// its out-edges from a fresh greedy-search pool (old neighbors included)
// and re-wires back-edges at the new location.  Stale in-edges from the old
// neighborhood are left in place: they are still valid routing edges (their
// distance is just recomputed on traversal), merely suboptimal, and decay
// as their owners are themselves updated/pruned.
void vamana_update(void* h, const int32_t* ids, const float* x, int n) {
    Graph& g = *(Graph*)h;
    for (int i = 0; i < n; ++i) {
        int p = ids[i];
        std::memcpy(g.data.data() + (size_t)p * g.dim,
                    x + (size_t)i * g.dim, (size_t)g.dim * sizeof(float));
    }
    for (int i = 0; i < n; ++i) insert_point(g, ids[i]);
}

// Export dense padded adjacency [n, R], pad = -1.
void vamana_get_adjacency(void* h, int32_t* out) {
    Graph& g = *(Graph*)h;
    size_t n = g.size();
    for (size_t i = 0; i < n; ++i) {
        auto& nb = g.nbrs[i];
        size_t k = 0;
        for (; k < nb.size() && (int)k < g.R; ++k) out[i * g.R + k] = nb[k];
        for (; (int)k < g.R; ++k) out[i * g.R + k] = -1;
    }
}

// Restore a previously-built graph (snapshot load): points + adjacency.
void vamana_load(void* h, const float* x, const int32_t* adj, int n) {
    Graph& g = *(Graph*)h;
    g.data.assign(x, x + (size_t)n * g.dim);
    g.nbrs.assign(n, {});
    g.locks.clear();
    g.locks.reserve(n);
    for (int i = 0; i < n; ++i) {
        g.locks.emplace_back(new std::mutex());
        for (int r = 0; r < g.R; ++r) {
            int v = adj[(size_t)i * g.R + r];
            if (v >= 0) g.nbrs[i].push_back(v);
        }
    }
    g.medoid = compute_medoid(g);
}

// Host-side reference search (for tests / parity checks with the device
// beam search).  Returns ids of the top-k.
void vamana_search(void* h, const float* q, int k, int L, int32_t* out_ids,
                   float* out_dists) {
    Graph& g = *(Graph*)h;
    std::vector<std::pair<float, int>> visited;
    greedy_search(g, q, g.medoid, std::max(k, L), visited);
    std::sort(visited.begin(), visited.end());
    int m = std::min<int>(k, (int)visited.size());
    for (int i = 0; i < m; ++i) {
        out_ids[i] = visited[i].second;
        out_dists[i] = visited[i].first;
    }
    for (int i = m; i < k; ++i) { out_ids[i] = -1; out_dists[i] = 3.4e38f; }
}

}  // extern "C"
