// Host-side preprocessing kernels for eigd_tpu.
//
// The reference reaches native code through SciPy bindings (SuperLU, ARPACK,
// cKDTree — SURVEY.md §2.3). Here the factorization and eigensolve live on
// the accelerator; what remains naturally host-side is mesh/graph setup, and
// that is what this module provides, exposed through a plain C ABI for
// ctypes:
//
//  * radius_neighbors : uniform-grid spatial hashing neighbor search
//    (replaces scipy.spatial.KDTree in the density filter, node_filter.py:67)
//  * weld_nodes       : coordinate deduplication for panel meshes (wingbox)
//  * rcm_ordering     : reverse Cuthill-McKee band-reducing permutation for
//    banded/block factorizations of grid problems
//
// Build: g++ -O3 -shared -fPIC -o libhostkernels.so host_kernels.cpp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <deque>
#include <unordered_map>
#include <vector>

// ---------------------------------------------------------------------------
// Spatial hashing helpers (C++ linkage)
// ---------------------------------------------------------------------------

namespace {

struct GridHash {
  double cell;
  double mins[3];
  int dim;
  std::unordered_map<int64_t, std::vector<int>> cells;

  int64_t key(const double* p) const {
    int64_t k = 0;
    for (int d = 0; d < dim; ++d) {
      int64_t c = (int64_t)std::floor((p[d] - mins[d]) / cell);
      k = k * 73856093 + c * 19349663 + c;
      k ^= (c + 0x9e3779b97f4a7c15ULL + (k << 6) + (k >> 2));
    }
    return k;
  }
};

static void build_hash(GridHash& h, const double* X, int n, int dim,
                       double cell) {
  h.cell = cell;
  h.dim = dim;
  for (int d = 0; d < dim; ++d) {
    double mn = X[d];
    for (int i = 1; i < n; ++i) mn = std::min(mn, X[i * dim + d]);
    h.mins[d] = mn;
  }
  for (int i = 0; i < n; ++i) h.cells[h.key(X + i * dim)].push_back(i);
}

// Visit every point within `r` of point p (conservative cell sweep).
template <typename F>
static void for_neighbors(const GridHash& h, const double* X, int n,
                          const double* p, double r, F&& f) {
  int span = (int)std::ceil(r / h.cell);
  int lo[3] = {0, 0, 0}, hi[3] = {0, 0, 0};
  for (int d = 0; d < h.dim; ++d) {
    int64_t c = (int64_t)std::floor((p[d] - h.mins[d]) / h.cell);
    lo[d] = (int)(c - span);
    hi[d] = (int)(c + span);
  }
  // iterate cells in the box
  double q[3];
  std::vector<int64_t> keys;
  for (int a = lo[0]; a <= hi[0]; ++a) {
    for (int b = (h.dim > 1 ? lo[1] : 0); b <= (h.dim > 1 ? hi[1] : 0); ++b) {
      for (int c = (h.dim > 2 ? lo[2] : 0); c <= (h.dim > 2 ? hi[2] : 0);
           ++c) {
        q[0] = h.mins[0] + (a + 0.5) * h.cell;
        if (h.dim > 1) q[1] = h.mins[1] + (b + 0.5) * h.cell;
        if (h.dim > 2) q[2] = h.mins[2] + (c + 0.5) * h.cell;
        auto it = h.cells.find(h.key(q));
        if (it == h.cells.end()) continue;
        for (int j : it->second) {
          double d2 = 0.0;
          for (int d = 0; d < h.dim; ++d) {
            double dd = p[d] - X[j * h.dim + d];
            d2 += dd * dd;
          }
          if (d2 <= r * r) f(j, std::sqrt(d2));
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// radius_neighbors: two-phase (count, fill) API.
//   phase 1: counts[i] = number of neighbors of node i within r0.
//   phase 2: fill idx (n, kmax) and wts (n, kmax) ELL arrays with the
//            reference filter weights (r0 - dist) / sum (node_filter.py:74-83)
// ---------------------------------------------------------------------------

int radius_neighbor_counts(const double* X, int n, int dim, double r0,
                           int32_t* counts) {
  GridHash h;
  build_hash(h, X, n, dim, r0);
  int kmax = 0;
  for (int i = 0; i < n; ++i) {
    int c = 0;
    for_neighbors(h, X, n, X + i * dim, r0,
                  [&](int, double) { ++c; });
    counts[i] = c;
    kmax = std::max(kmax, c);
  }
  return kmax;
}

void radius_neighbors_ell(const double* X, int n, int dim, double r0,
                          int kmax, int32_t* idx, double* wts) {
  GridHash h;
  build_hash(h, X, n, dim, r0);
  std::vector<int> nbr;
  std::vector<double> w;
  for (int i = 0; i < n; ++i) {
    nbr.clear();
    w.clear();
    for_neighbors(h, X, n, X + i * dim, r0, [&](int j, double dist) {
      nbr.push_back(j);
      w.push_back(r0 - dist);
    });
    double s = 0.0;
    for (double v : w) s += v;
    for (size_t k = 0; k < nbr.size() && (int)k < kmax; ++k) {
      idx[(size_t)i * kmax + k] = nbr[k];
      wts[(size_t)i * kmax + k] = w[k] / s;
    }
    for (int k = (int)nbr.size(); k < kmax; ++k) {
      idx[(size_t)i * kmax + k] = 0;
      wts[(size_t)i * kmax + k] = 0.0;
    }
  }
}

// ---------------------------------------------------------------------------
// weld_nodes: labels[i] = index of the representative node for X[i]
// (first occurrence wins); returns the number of unique nodes.
// ---------------------------------------------------------------------------

int weld_nodes(const double* X, int n, int dim, double tol, int32_t* labels) {
  GridHash h;
  build_hash(h, X, n, dim, std::max(tol, 1e-300) * 4.0);
  int nunique = 0;
  std::vector<int32_t> rep(n, -1);
  for (int i = 0; i < n; ++i) {
    int found = -1;
    for_neighbors(h, X, n, X + i * dim, tol, [&](int j, double) {
      if (j < i && rep[j] >= 0 && found < 0) found = rep[j];
    });
    if (found < 0) {
      rep[i] = nunique++;
    } else {
      rep[i] = found;
    }
    labels[i] = rep[i];
  }
  return nunique;
}

// ---------------------------------------------------------------------------
// rcm_ordering: reverse Cuthill-McKee on a CSR graph.
// ---------------------------------------------------------------------------

void rcm_ordering(int n, const int32_t* rowptr, const int32_t* colidx,
                  int32_t* perm) {
  std::vector<int> degree(n);
  for (int i = 0; i < n; ++i) degree[i] = rowptr[i + 1] - rowptr[i];
  std::vector<char> visited(n, 0);
  std::vector<int> order;
  order.reserve(n);
  std::vector<int> nbrs;

  for (;;) {
    // find the unvisited node of minimum degree (peripheral-ish seed)
    int seed = -1;
    for (int i = 0; i < n; ++i) {
      if (!visited[i] && (seed < 0 || degree[i] < degree[seed])) seed = i;
    }
    if (seed < 0) break;
    std::deque<int> queue{seed};
    visited[seed] = 1;
    while (!queue.empty()) {
      int u = queue.front();
      queue.pop_front();
      order.push_back(u);
      nbrs.clear();
      for (int p = rowptr[u]; p < rowptr[u + 1]; ++p) {
        int v = colidx[p];
        if (!visited[v]) {
          visited[v] = 1;
          nbrs.push_back(v);
        }
      }
      std::sort(nbrs.begin(), nbrs.end(),
                [&](int a, int b) { return degree[a] < degree[b]; });
      for (int v : nbrs) queue.push_back(v);
    }
  }
  // reverse
  for (int i = 0; i < n; ++i) perm[i] = order[n - 1 - i];
}

}  // extern "C"
