// Native deflation scan for the D&C tridiagonal eigensolver merge.
//
// The port's copy of dlaf_tpu/native/deflate.cpp, built from this file.
// Counterpart of DLA-Future's vectorized C++ deflation
// (eigensolver/tridiag_solver/merge.h:443-508, LAPACK dlaed2 semantics):
// given the sorted poles d, the normalized coupling weights z, and the
// z-based liveness precomputed by the caller, rotate the z weight of
// near-equal pole pairs onto the earlier live pole (Givens), deflating the
// later one. The scan is inherently sequential (each rotation updates the
// running anchor's z weight, which feeds later rotations), which makes it
// an interpreter bottleneck in Python at n ~ 32k; here it is a single O(n)
// pass (the previous-live index is carried, not re-scanned).
//
// In/out: z (modified), live (uint8, modified). Outputs: up to n Givens
// rotations as (i, j, c, s) quadruples. Returns the rotation count, or -1
// on bad arguments.

#include <cmath>
#include <cstdint>

extern "C" int64_t dlaf_deflate_scan_d(const double* d, double* z,
                                       uint8_t* live, int64_t n, double tol,
                                       int64_t* giv_i, int64_t* giv_j,
                                       double* giv_c, double* giv_s) {
  if (n < 0 || (n > 0 && (!d || !z || !live))) return -1;
  int64_t g = 0;
  int64_t prev = -1;  // latest live index before j (post-deflation)
  for (int64_t j = 0; j < n; ++j) {
    if (!live[j]) continue;
    if (prev >= 0 && d[j] - d[prev] <= tol) {
      double r = std::hypot(z[prev], z[j]);
      if (r == 0.0) {
        prev = j;  // both weights zero: j stays live, becomes the anchor
        continue;
      }
      giv_i[g] = prev;
      giv_j[g] = j;
      giv_c[g] = z[prev] / r;
      giv_s[g] = z[j] / r;
      z[prev] = r;
      z[j] = 0.0;
      live[j] = 0;
      ++g;
    } else {
      prev = j;
    }
  }
  return g;
}
