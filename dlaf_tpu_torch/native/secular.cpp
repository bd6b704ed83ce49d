// Native secular-equation root solver for the D&C tridiagonal eigensolver.
//
// The port's copy of dlaf_tpu/native/secular.cpp, built from this file.
// Counterpart of DLA-Future's per-eigenvalue LAPACK laed4 calls
// (eigensolver/tridiag_solver/merge.h:590-629 runs laed4 on the CPU;
// without a LAPACK to link the solver is implemented here): for each i in
// 0..k-1 find the root lambda_i of
//
//     f(lambda) = 1 + rho * sum_j z_j^2 / (d_j - lambda) = 0
//
// in the open interval (d_i, d_{i+1}) (last interval: (d_{k-1},
// d_{k-1} + rho * sum z^2)), with d ascending, z nonzero, rho > 0.
//
// Representation matches the numpy and torch twins of
// dlaf_tpu_torch/eigensolver/tridiag_solver.py: the root is returned
// as (anchor index, offset) with the anchor chosen as the nearest pole by
// the sign of f at the interval midpoint, so downstream pole differences
// d_j - lambda_i never suffer cancellation.
//
// Method: safeguarded Newton on g(mu) = f(d_anchor + mu), which is strictly
// increasing across each interval; the bracket is maintained and any Newton
// step leaving it falls back to bisection — unconditionally convergent,
// typically ~4-6 evaluations vs the vectorized bisection's 90.
//
// Threaded with std::thread across roots (each root is independent).

#include <atomic>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

struct Problem {
  const double* d;
  const double* zsq;  // z_j^2, precomputed
  double rho;
  std::int64_t k;
};

// g(mu) and g'(mu) about the anchor pole: delta_j = d_j - d_anchor.
inline void eval(const Problem& p, double danchor, double mu, double* g,
                 double* gp) {
  double s = 0.0, sp = 0.0;
  for (std::int64_t j = 0; j < p.k; ++j) {
    const double inv = 1.0 / ((p.d[j] - danchor) - mu);
    const double t = p.zsq[j] * inv;
    s += t;
    sp += t * inv;
  }
  *g = 1.0 + p.rho * s;
  *gp = p.rho * sp;  // > 0: g strictly increasing in mu
}

void solve_range(const Problem& p, double zsum, std::int64_t i0,
                 std::int64_t i1, std::int64_t* anchor, double* mu_out) {
  for (std::int64_t i = i0; i < i1; ++i) {
    const double di = p.d[i];
    const double upper = (i + 1 < p.k) ? p.d[i + 1] : p.d[p.k - 1] + p.rho * zsum;
    const double gap = upper - di;

    // anchor by the sign of f at the midpoint (matches the Python twins)
    double g, gp;
    eval(p, 0.0, di + 0.5 * gap, &g, &gp);
    std::int64_t a = (g >= 0.0 || i + 1 >= p.k) ? i : i + 1;
    if (i == p.k - 1) a = p.k - 1;
    const double da = p.d[a];
    double lo = (a == i) ? 0.0 : di - upper;  // left- vs right-anchored
    double hi = (a == i) ? gap : 0.0;

    // safeguarded Newton on the bracket [lo, hi]; the returned root is the
    // evaluated point with the smallest |g| (Newton converges one-sided, so
    // the bracket midpoint can lag far behind the best iterate)
    // iteration cap: near-deflated z entries put roots ~eps^2 * gap from
    // their pole, and the bisection-dominated phase needs ~log2(gap/mu)
    // halvings to get there (the worst case observed is ~1e-28 offsets, i.e.
    // >90 halvings) — 300 bounds even denormal-scale descents
    double mu = 0.5 * (lo + hi);
    double best_mu = mu, best_ag = HUGE_VAL;
    for (int it = 0; it < 300; ++it) {
      eval(p, da, mu, &g, &gp);
      if (std::isfinite(g) && std::fabs(g) < best_ag) {
        best_ag = std::fabs(g);
        best_mu = mu;
      }
      if (g >= 0.0)
        hi = mu;
      else
        lo = mu;
      double step_mu;
      if (gp > 0.0 && std::isfinite(g)) {
        step_mu = mu - g / gp;
        if (!(step_mu > lo && step_mu < hi)) step_mu = 0.5 * (lo + hi);
      } else {
        step_mu = 0.5 * (lo + hi);
      }
      // downstream eigenvector coefficients need RELATIVE accuracy in the
      // offset mu (the anchor pole difference is exactly -mu), so stop on
      // the bracket being tight relative to |mu|, not to the interval size
      const double width = hi - lo;
      const double scale = std::fmax(std::fabs(best_mu), 1e-300);
      if (width <= 4.0 * 2.220446049250313e-16 * scale || best_ag == 0.0) break;
      if (step_mu == mu) break;  // no representable progress
      mu = step_mu;
    }
    anchor[i] = a;
    mu_out[i] = best_mu;
  }
}

}  // namespace

// nthreads_req <= 0: auto (hardware concurrency, bounded by roots per
// thread); >= 1: forced worker count — results are bitwise identical at
// any count (each root is solved independently from read-only inputs),
// which tests/test_torch_tridiag_solver.py pins with a forced-4 run.
extern "C" int dlaf_secular_roots_d_nt(const double* d, const double* z,
                                       double rho, std::int64_t k,
                                       std::int64_t* anchor, double* mu,
                                       std::int64_t nthreads_req) {
  if (k <= 0) return 0;
  std::vector<double> zsq(static_cast<size_t>(k));
  double zsum = 0.0;
  for (std::int64_t j = 0; j < k; ++j) {
    zsq[static_cast<size_t>(j)] = z[j] * z[j];
    zsum += zsq[static_cast<size_t>(j)];
  }
  Problem p{d, zsq.data(), rho, k};

  std::int64_t nthreads;
  if (nthreads_req >= 1) {
    nthreads = std::min<std::int64_t>(nthreads_req, k);
  } else {
    const unsigned hw = std::thread::hardware_concurrency();
    const std::int64_t min_per_thread = 64;
    nthreads = std::min<std::int64_t>(hw ? hw : 1,
                                      (k + min_per_thread - 1) / min_per_thread);
  }
  if (nthreads <= 1) {
    solve_range(p, zsum, 0, k, anchor, mu);
    return 0;
  }
  std::vector<std::thread> threads;
  const std::int64_t chunk = (k + nthreads - 1) / nthreads;
  for (std::int64_t t = 0; t < nthreads; ++t) {
    const std::int64_t i0 = t * chunk;
    const std::int64_t i1 = std::min(k, i0 + chunk);
    if (i0 >= i1) break;
    threads.emplace_back(
        [&p, zsum, i0, i1, anchor, mu] { solve_range(p, zsum, i0, i1, anchor, mu); });
  }
  for (auto& th : threads) th.join();
  return 0;
}

extern "C" int dlaf_secular_roots_d(const double* d, const double* z,
                                    double rho, std::int64_t k,
                                    std::int64_t* anchor, double* mu) {
  return dlaf_secular_roots_d_nt(d, z, rho, k, anchor, mu, 0);
}
