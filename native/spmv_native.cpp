// Native host-side hot loops for spmv_acc_tpu.
//
// The reference implements its ingest and analyze passes in C++ with OpenMP
// (cli/csr_mtx_reader.hpp:116-162 OMP number parsing; cli/sort_omp.hpp:12-62
// task-parallel quicksort; csr_adaptive_plus_analyze.cpp:12-98 block analyze).
// This library is this package's equivalent: exported as a C ABI consumed via
// ctypes (io/native.py), with pure-numpy fallbacks when the .so is absent.
//
// Build: make -C native   (g++ -O3 -march=native -fopenmp -shared -fPIC)

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// Parallel text-number parsing (csr_mtx_reader.hpp fast_parse_vector analog).
// Parses whitespace-separated doubles from buf[0..len) into out (capacity cap).
// Returns the number parsed, or -1 on overflow.
// ---------------------------------------------------------------------------
int64_t parse_doubles(const char* buf, int64_t len, double* out, int64_t cap,
                      int32_t num_threads) {
  if (num_threads <= 1) {
    const char* p = buf;
    const char* end = buf + len;
    int64_t n = 0;
    while (p < end) {
      while (p < end && isspace((unsigned char)*p)) ++p;
      if (p >= end) break;
      char* q;
      double v = strtod(p, &q);
      if (q == p) { ++p; continue; }
      if (n >= cap) return -1;
      out[n++] = v;
      p = q;
    }
    return n;
  }
  // parallel: split at whitespace boundaries
  int T = num_threads;
  std::vector<std::pair<const char*, const char*>> ranges(T);
  int64_t chunk = len / T;
  const char* start = buf;
  for (int t = 0; t < T; ++t) {
    const char* e = (t == T - 1) ? buf + len : buf + (t + 1) * chunk;
    // advance e to the next whitespace so tokens are not split
    while (e < buf + len && !isspace((unsigned char)*e)) ++e;
    ranges[t] = {start, e};
    start = e;
  }
  std::vector<std::vector<double>> partial(T);
  std::vector<std::thread> threads;
  for (int t = 0; t < T; ++t) {
    threads.emplace_back([&, t]() {
      const char* p = ranges[t].first;
      const char* end = ranges[t].second;
      auto& o = partial[t];
      o.reserve((end - p) / 4);
      while (p < end) {
        while (p < end && isspace((unsigned char)*p)) ++p;
        if (p >= end) break;
        char* q;
        double v = strtod(p, &q);
        if (q == p) { ++p; continue; }
        o.push_back(v);
        p = q;
      }
    });
  }
  for (auto& th : threads) th.join();
  int64_t n = 0;
  for (int t = 0; t < T; ++t) {
    if (n + (int64_t)partial[t].size() > cap) return -1;
    memcpy(out + n, partial[t].data(), partial[t].size() * sizeof(double));
    n += partial[t].size();
  }
  return n;
}

// ---------------------------------------------------------------------------
// COO -> CSR: counting sort by row then stable order by column within rows
// (cli/sparse_format.h:100-128 + sort_omp.hpp analog; O(nnz + m) instead of
// a comparison sort when input columns are appended in file order).
// ---------------------------------------------------------------------------
int32_t coo_to_csr(const int32_t* rows, const int32_t* cols, const double* vals,
                   int64_t nnz, int32_t m,
                   int32_t* row_ptr /* m+1 */, int32_t* out_cols,
                   double* out_vals) {
  std::vector<int64_t> count(m + 1, 0);
  for (int64_t i = 0; i < nnz; ++i) {
    int32_t r = rows[i];
    if (r < 0 || r >= m) return -1;
    count[r + 1]++;
  }
  for (int32_t r = 0; r < m; ++r) count[r + 1] += count[r];
  // place by row (stable)
  std::vector<int64_t> cursor(count.begin(), count.end() - 1);
  std::vector<int64_t> perm(nnz);
  for (int64_t i = 0; i < nnz; ++i) perm[cursor[rows[i]]++] = i;
  // sort within each row by column (rows are usually short: insertion-friendly)
#if defined(_OPENMP)
#pragma omp parallel for schedule(dynamic, 1024)
#endif
  for (int32_t r = 0; r < m; ++r) {
    int64_t a = count[r], b = count[r + 1];
    std::sort(perm.begin() + a, perm.begin() + b,
              [&](int64_t i, int64_t j) { return cols[i] < cols[j]; });
  }
  for (int32_t r = 0; r <= m; ++r) row_ptr[r] = (int32_t)count[r];
  for (int64_t k = 0; k < nnz; ++k) {
    out_cols[k] = cols[perm[k]];
    out_vals[k] = vals[perm[k]];
  }
  return 0;
}

// ---------------------------------------------------------------------------
// ILU(0) factorization — in-pattern incomplete LU, classic IKJ with a sorted
// two-pointer row merge (columns are sorted per CSR row, so the "U(k, j) for j
// in row i's pattern" intersection is a linear merge instead of a hash probe).
// Sequential across rows by data flow (the reference's factorization analog
// lives host-side too).  lu holds a copy of values on entry; on exit strictly-
// lower entries hold L (unit diag implicit), diagonal + upper hold U.
// Returns 0, or -(i+1) if row i lacks a diagonal entry.
// ---------------------------------------------------------------------------
int64_t ilu0_factor(const int64_t* rp, const int32_t* ci, double* lu,
                    int64_t m) {
  std::vector<int64_t> diag(m, -1);
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < m; ++i)
    for (int64_t p = rp[i]; p < rp[i + 1]; ++p)
      if (ci[p] == i) { diag[i] = p; break; }
  for (int64_t i = 0; i < m; ++i)
    if (diag[i] < 0) return -(i + 1);
  for (int64_t i = 0; i < m; ++i) {
    for (int64_t p = rp[i]; p < rp[i + 1]; ++p) {
      const int64_t k = ci[p];
      if (k >= i) break;
      const double lik = lu[p] / lu[diag[k]];
      lu[p] = lik;
      int64_t q = p + 1, s = diag[k] + 1;
      const int64_t qe = rp[i + 1], se = rp[k + 1];
      while (q < qe && s < se) {
        const int32_t cq = ci[q], cs = ci[s];
        if (cq == cs) { lu[q] -= lik * lu[s]; ++q; ++s; }
        else if (cq < cs) ++q;
        else ++s;
      }
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Dependency levels for a level-scheduled triangular solve: level[i] =
// 1 + max(level[j]) over off-diagonal deps j (j < i lower / j > i upper).
// One sequential O(nnz) pass (forward for lower, backward for upper).
// Returns the number of levels (max level + 1), or 0 when m == 0.
// ---------------------------------------------------------------------------
int64_t trisolve_levels(const int64_t* rp, const int32_t* ci, int64_t m,
                        int32_t lower, int32_t* level) {
  int32_t maxl = -1;
  if (lower) {
    for (int64_t i = 0; i < m; ++i) {
      int32_t lv = 0;
      for (int64_t p = rp[i]; p < rp[i + 1]; ++p) {
        const int64_t j = ci[p];
        if (j < i && level[j] + 1 > lv) lv = level[j] + 1;
      }
      level[i] = lv;
      if (lv > maxl) maxl = lv;
    }
  } else {
    for (int64_t i = m - 1; i >= 0; --i) {
      int32_t lv = 0;
      for (int64_t p = rp[i]; p < rp[i + 1]; ++p) {
        const int64_t j = ci[p];
        if (j > i && level[j] + 1 > lv) lv = level[j] + 1;
      }
      level[i] = lv;
      if (lv > maxl) maxl = lv;
    }
  }
  return (int64_t)maxl + 1;
}

// Version marker for the ctypes loader.
int32_t spmv_native_abi_version() { return 6; }

}  // extern "C"
