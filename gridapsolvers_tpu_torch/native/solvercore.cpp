// Native host-side kernels: the port's own copy of
// gridapsolvers_tpu/native/solvercore.cpp, unchanged but for this header.
//
// The reference's performance-critical host work lives in linked native
// libraries (MPI/PETSc/MUMPS/... — SURVEY.md §2.9). Our device compute path
// is XLA/Pallas; this library covers the setup-time host hot spots that are
// slow in pure Python/NumPy:
//
//   - COO -> padded-ELL packing (assembly exit point)
//   - greedy graph coloring (multicolor Gauss-Seidel setup)
//   - CSR row-union patch tables (Vanka patch construction)
//   - reverse Cuthill-McKee ordering (bandwidth reduction for ELL locality)
//
// Built as a plain shared library, loaded via ctypes (no pybind11 in the
// image); every entry point has a NumPy fallback in native/__init__.py.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

extern "C" {

// Sort-free COO->ELL: counts per row, then fills slots in (row, col) order.
// rows/cols must be pre-sorted lexicographically with duplicates summed by
// the caller OR dups are summed here via the (row,col)-sorted invariant.
// Returns max row degree, or -1 if it exceeds max_width (when max_width>0).
int64_t ell_from_sorted_coo(
    int64_t n_rows, int64_t n_cols, int64_t nnz,
    const int64_t* rows, const int64_t* cols, const double* vals,
    int64_t max_width,
    double* out_vals /* n_rows*K */, int32_t* out_cols /* n_rows*K */,
    int64_t K) {
  // initialize padding: value 0, col = min(row, n_cols-1)
  for (int64_t r = 0; r < n_rows; ++r) {
    int32_t pad = (int32_t)std::min(r, n_cols - 1);
    for (int64_t k = 0; k < K; ++k) {
      out_vals[r * K + k] = 0.0;
      out_cols[r * K + k] = pad;
    }
  }
  int64_t max_deg = 0;
  int64_t i = 0;
  while (i < nnz) {
    int64_t r = rows[i];
    int64_t slot = 0;
    while (i < nnz && rows[i] == r) {
      int64_t c = cols[i];
      double v = vals[i];
      ++i;
      while (i < nnz && rows[i] == r && cols[i] == c) {
        v += vals[i];
        ++i;
      }
      if (slot >= K) return -1;
      out_vals[r * K + slot] = v;
      out_cols[r * K + slot] = (int32_t)c;
      ++slot;
    }
    max_deg = std::max(max_deg, slot);
    if (max_width > 0 && slot > max_width) return -1;
  }
  return max_deg;
}

// Greedy coloring over an ELL adjacency (cols padded with self-loops).
// Returns the number of colors.
int32_t greedy_color(int64_t n, int64_t K, const int32_t* cols,
                     int32_t* out_colors) {
  std::fill(out_colors, out_colors + n, -1);
  std::vector<int32_t> used;
  int32_t ncolors = 0;
  for (int64_t i = 0; i < n; ++i) {
    used.assign(ncolors, 0);
    for (int64_t k = 0; k < K; ++k) {
      int32_t c = cols[i * K + k];
      if (c != (int32_t)i && c >= 0 && c < n && out_colors[c] >= 0)
        used[out_colors[c]] = 1;
    }
    int32_t col = 0;
    while (col < ncolors && used[col]) ++col;
    if (col == ncolors) ++ncolors;
    out_colors[i] = col;
  }
  return ncolors;
}

// Pass 1: width of each seed row's union patch (unique cols + seed).
// indptr: n_rows+1 (int64), indices: nnz (int32).
int64_t patch_widths(const int64_t* indptr, const int32_t* indices,
                     int64_t lo, int64_t hi, int64_t* out_widths) {
  int64_t maxw = 0;
  std::vector<int32_t> buf;
  for (int64_t p = lo; p < hi; ++p) {
    buf.assign(indices + indptr[p], indices + indptr[p + 1]);
    buf.push_back((int32_t)p);
    std::sort(buf.begin(), buf.end());
    buf.erase(std::unique(buf.begin(), buf.end()), buf.end());
    out_widths[p - lo] = (int64_t)buf.size();
    maxw = std::max(maxw, (int64_t)buf.size());
  }
  return maxw;
}

// Pass 2: fill the padded patch table (width W, dummy index = dummy).
void patch_fill(const int64_t* indptr, const int32_t* indices, int64_t lo,
                int64_t hi, int64_t W, int32_t dummy, int32_t* out_table) {
  std::vector<int32_t> buf;
  for (int64_t p = lo; p < hi; ++p) {
    buf.assign(indices + indptr[p], indices + indptr[p + 1]);
    buf.push_back((int32_t)p);
    std::sort(buf.begin(), buf.end());
    buf.erase(std::unique(buf.begin(), buf.end()), buf.end());
    int64_t row = (p - lo) * W;
    int64_t i = 0;
    for (; i < (int64_t)buf.size(); ++i) out_table[row + i] = buf[i];
    for (; i < W; ++i) out_table[row + i] = dummy;
  }
}

// Reverse Cuthill-McKee over an ELL adjacency. out_perm: new ordering.
void rcm_order(int64_t n, int64_t K, const int32_t* cols, int32_t* out_perm) {
  std::vector<int64_t> deg(n, 0);
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t k = 0; k < K; ++k) {
      int32_t c = cols[i * K + k];
      if (c != (int32_t)i && c >= 0 && c < n) ++deg[i];
    }
  }
  std::vector<char> seen(n, 0);
  std::vector<int32_t> order;
  order.reserve(n);
  for (int64_t start = 0; start < n; ++start) {
    // pick the unvisited node of minimum degree as component seed
    if (seen[start]) continue;
    int64_t seed = start;
    for (int64_t i = 0; i < n; ++i)
      if (!seen[i] && deg[i] < deg[seed]) seed = i;
    std::queue<int32_t> q;
    q.push((int32_t)seed);
    seen[seed] = 1;
    std::vector<int32_t> nb;
    while (!q.empty()) {
      int32_t u = q.front();
      q.pop();
      order.push_back(u);
      nb.clear();
      for (int64_t k = 0; k < K; ++k) {
        int32_t c = cols[(int64_t)u * K + k];
        if (c != u && c >= 0 && c < n && !seen[c]) {
          nb.push_back(c);
          seen[c] = 1;
        }
      }
      std::sort(nb.begin(), nb.end(),
                [&](int32_t a, int32_t b) { return deg[a] < deg[b]; });
      for (int32_t c : nb) q.push(c);
    }
  }
  // reverse
  for (int64_t i = 0; i < n; ++i) out_perm[i] = order[n - 1 - i];
}

}  // extern "C"
